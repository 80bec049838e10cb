"""Aggregator rounds back to back, in a process of their own.

``python -m portbench.traffic.rounds SPEC OUT`` builds the port's
``SliceAggregator`` as its command line builds it (round tracing, the
federated query plane and the stream hub on, as by default) over the
targets and flags in the JSON file ``SPEC``, warms it with a few rounds,
prints ``{"ready": ...}`` and waits for a line on standard input. Then it
calls ``poll_once()`` back to back for the window's seconds, timing each
round by the host clock (and, when the spec says ``trace``, each fetch),
keeps the wall times at which a round started and ended and its published
exposition for a share of the rounds drawn from the seed and the last, writes everything to the JSON file ``OUT`` and
prints ``{"done": ...}``.

The aggregator runs here, and not in the harness, so that its process
holds nothing of the benchmark's: no other thread, and no object of the
harness for its collector to walk.
"""

from __future__ import annotations

import json
import random
import sys
import time


class Aggregator:
    """The port's flat slice aggregator, wired as its ``main()`` wires it."""

    def __init__(self, targets: list[str], flags: dict, fetch) -> None:
        from tpu_pod_exporter_torch.aggregate import SliceAggregator
        from tpu_pod_exporter_torch.fleet import FleetQueryPlane
        from tpu_pod_exporter_torch.metrics.registry import SnapshotStore
        from tpu_pod_exporter_torch.stream import attach_stream
        from tpu_pod_exporter_torch.trace import Tracer, TraceStore

        timeout, interval = flags["timeout_s"], flags["interval_s"]
        backoff = max(2.0 * interval, timeout)
        traces = TraceStore(max_traces=256)
        self.store = SnapshotStore()
        self.agg = SliceAggregator(
            tuple(targets), self.store, timeout_s=timeout, fetch=fetch,
            breaker_failures=flags["breaker_failures"], breaker_backoff_s=backoff,
            breaker_backoff_max_s=max(120.0, backoff),
            tracer=Tracer(traces, slow_poll_s=0.0, root_name="round"))
        self.fleet = FleetQueryPlane(
            self.agg.targets, timeout_s=timeout, breakers=self.agg.breakers,
            tracer=Tracer(traces, slow_poll_s=0.0, root_name="query"),
            generation_fn=lambda: self.agg.rounds, targets_fn=lambda: self.agg.targets)
        self.agg.set_fleet(self.fleet)
        self.hub, self.pump = attach_stream(self.agg, self.fleet)

    def published(self) -> tuple[float, str]:
        """The current snapshot's time and exposition."""
        snap = self.store.current()
        return snap.timestamp, snap.encode().decode()

    def close(self) -> None:
        self.pump.close()
        self.hub.close()
        self.fleet.close()
        self.agg.close()


def main(argv: list[str]) -> int:
    spec = json.loads(open(argv[0]).read())
    from tpu_pod_exporter_torch.aggregate import default_fetch

    spans: list[tuple[float, float]] = []

    def timed_fetch(target: str, timeout_s: float, traceparent: str | None = None) -> str:
        t0 = time.perf_counter()
        try:
            return default_fetch(target, timeout_s, traceparent=traceparent)
        finally:
            spans.append((t0, time.perf_counter()))

    agg = Aggregator(spec["targets"], spec["flags"], timed_fetch if spec["trace"] else default_fetch)
    try:
        for _ in range(spec["warm_rounds"]):
            agg.agg.poll_once()
        self_start = agg.published()[1]
        print(json.dumps({"ready": True}), flush=True)
        sys.stdin.readline()
        rng = random.Random(f"judge-{spec['seed']}")
        rounds_ms, fetch_ms, kept = [], [], []
        start = time.perf_counter()
        while time.perf_counter() - start < spec["seconds"]:
            spans.clear()
            wall = time.time()
            t0 = time.perf_counter()
            agg.agg.poll_once()
            rounds_ms.append((time.perf_counter() - t0) * 1000.0)
            end = time.time()
            if spans:
                fetch_ms.append((max(e for _s, e in spans) - min(s for s, _e in spans)) * 1000.0)
            if rng.random() < spec["judged_share"]:
                kept.append((wall, end, *agg.published()))
        kept.append((wall, end, *agg.published()))
        self_end = agg.published()[1]
    finally:
        agg.close()
    with open(argv[1], "w") as f:
        json.dump({"rounds_ms": rounds_ms, "fetch_ms": fetch_ms, "kept": kept,
                   "self_start": self_start, "self_end": self_end}, f)
    print(json.dumps({"done": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
