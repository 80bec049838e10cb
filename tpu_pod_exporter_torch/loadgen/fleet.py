"""Fleet-mode load generation: N simulated exporters in one process.

The other loadgen modes drive real accelerators; this one drives the
*observability plane at fleet shape*. It runs N lightweight simulated
exporters (real ``Collector`` + ``HistoryStore`` + ``MetricsServer`` over a
scripted ``FakeBackend``, each on its own ephemeral port with a distinct
host topology) inside one process, so tests and CI can stand up a 64-host
slice in a couple of seconds and point a real aggregator at it.

``python -m tpu_pod_exporter_torch.loadgen.fleet`` is the fleet-query acceptance
harness (``make fleet-query-demo``): it builds the fleet, aggregates it,
runs federated ``/api/v1/query_range`` queries through the real HTTP
stack with tracing and persistence ON, kills one target mid-run, and
asserts (1) a full merge with per-target staleness, (2) ``partial: true``
with the remaining targets merged after the kill, and (3) a fleet-query
p99 latency budget — the CI gate for the federated query plane.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time
import urllib.request


def _build_exporter(idx: int, chips: int, state_dir: str | None,
                    trace: bool):
    """One simulated exporter: scripted fake backend, real collector,
    history (tiers on), optional persistence, HTTP server on port 0."""
    from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
    from tpu_pod_exporter_torch.backend.fake import FakeBackend, FakeChipScript
    from tpu_pod_exporter_torch.collector import Collector
    from tpu_pod_exporter_torch.history import HistoryStore
    from tpu_pod_exporter_torch.metrics import SnapshotStore
    from tpu_pod_exporter_torch.server import MetricsServer
    from tpu_pod_exporter_torch.topology import detect_host_topology

    # Distinct, deterministic telemetry per host so merged fleet answers
    # are checkable: duty ramps with the poll index offset by host, HBM
    # grows host-dependently.
    script = FakeChipScript(
        hbm_used_bytes=lambda step, i=idx: float((i + 1) * 2**30 + step * 2**20),
        duty_cycle_percent=lambda step, i=idx: float((i * 7 + step) % 100),
        ici_bytes_per_step=1e6,
    )
    backend = FakeBackend(chips=chips, script=script)
    topo = detect_host_topology(
        env={}, accelerator="v5p-64", slice_name="sim-slice",
        host=f"sim-host-{idx:02d}", worker_id=str(idx),
    )
    store = SnapshotStore()
    history = HistoryStore(capacity=256, max_series=2048, retention_s=0.0)
    trace_store = tracer = None
    if trace:
        from tpu_pod_exporter_torch.trace import Tracer, TraceStore

        trace_store = TraceStore(max_traces=16)
        tracer = Tracer(trace_store, slow_poll_s=0.0)
    persister = None
    if state_dir:
        from tpu_pod_exporter_torch.persist import StatePersister

        persister = StatePersister(
            state_dir, history=history,
            exposition_fn=lambda s=store: s.current(),
        )
        persister.start()
    collector = Collector(
        backend, FakeAttribution(), store, topology=topo,
        history=history, tracer=tracer, persister=persister,
    )
    server = MetricsServer(store, host="127.0.0.1", port=0,
                           history=history, trace=trace_store)
    server.start()
    return {
        "idx": idx,
        "collector": collector,
        "history": history,
        "server": server,
        "trace_store": trace_store,
        "persister": persister,
        "target": f"127.0.0.1:{server.port}",
        "alive": True,
    }


class FleetSim:
    """N simulated exporters, ticked from the caller's thread (scripted
    scenario timelines need deterministic poll ordering, not N loops)."""

    def __init__(self, n_targets: int, chips: int = 4,
                 persist: bool = True, trace: bool = True,
                 state_root: str | None = None) -> None:
        self._tmp = None
        if persist and state_root is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="fleet-sim-")
            state_root = self._tmp.name
        self.state_root = state_root
        self.exporters = [
            _build_exporter(
                i, chips,
                f"{state_root}/target-{i:02d}" if persist and state_root else None,
                trace,
            )
            for i in range(n_targets)
        ]
        self.chips = chips

    @property
    def targets(self) -> tuple[str, ...]:
        return tuple(e["target"] for e in self.exporters)

    def tick(self) -> None:
        for e in self.exporters:
            if e["alive"]:
                e["collector"].poll_once()

    def kill(self, idx: int) -> str:
        """Stop one exporter's HTTP server (its port starts refusing —
        the clean-death shape; wedges are chaos.py's job)."""
        e = self.exporters[idx]
        if e["alive"]:
            e["alive"] = False
            e["server"].stop()
        return e["target"]

    def scrape_spans_recorded(self) -> int:
        """Node-side /api/v1 serve spans recorded under REMOTE (fleet
        query) trace contexts — proof the traceparent propagated."""
        total = 0
        for e in self.exporters:
            ts = e["trace_store"]
            if ts is not None:
                total += len(ts.scrapes(64))
        return total

    def close(self) -> None:
        for e in self.exporters:
            if e["alive"]:
                e["server"].stop()
            if e["persister"] is not None:
                e["persister"].close()
            e["collector"].close()
        if self._tmp is not None:
            self._tmp.cleanup()


def _get_json(url: str, timeout_s: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:  # noqa: S310 — loopback demo
        return json.loads(resp.read())


def _percentile(xs: list[float], q: float) -> float:
    ys = sorted(xs)
    return ys[min(int(q * (len(ys) - 1) + 0.5), len(ys) - 1)]


def run_demo(n_targets: int, chips: int, polls: int, interval_s: float,
             queries: int, budget_ms: float, kill_one: bool,
             persist: bool) -> dict:
    """The acceptance scenario; returns a result dict with ``ok``."""
    from tpu_pod_exporter_torch.aggregate import SliceAggregator
    from tpu_pod_exporter_torch.fleet import FleetQueryPlane
    from tpu_pod_exporter_torch.metrics import SnapshotStore
    from tpu_pod_exporter_torch.persist import BreakerStateFile
    from tpu_pod_exporter_torch.server import MetricsServer
    from tpu_pod_exporter_torch.trace import Tracer, TraceStore

    result: dict = {"targets": n_targets, "chips": chips, "ok": False,
                    "tracing": True, "persistence": persist}
    sim = FleetSim(n_targets, chips=chips, persist=persist, trace=True)
    agg_server = None
    fleet = None
    agg = None
    try:
        for _ in range(polls):
            sim.tick()
            time.sleep(interval_s)

        trace_store = TraceStore(max_traces=128)
        store = SnapshotStore()
        agg = SliceAggregator(
            sim.targets, store, timeout_s=1.0,
            tracer=Tracer(trace_store, slow_poll_s=0.0, root_name="round"),
            breaker_store=(
                BreakerStateFile(f"{sim.state_root}/agg-breakers.json")
                if persist and sim.state_root else None
            ),
        )
        fleet = FleetQueryPlane(
            sim.targets, timeout_s=1.0, breakers=agg.breakers,
            tracer=Tracer(trace_store, slow_poll_s=0.0, root_name="query"),
            generation_fn=lambda: agg.rounds,
        )
        agg.set_fleet(fleet)
        agg.poll_once()
        agg_server = MetricsServer(store, host="127.0.0.1", port=0,
                                   fleet=fleet, trace=trace_store,
                                   debug_vars=agg.debug_vars)
        agg_server.start()
        base = f"http://127.0.0.1:{agg_server.port}"

        # --- full merge: one query answers for the whole fleet ----------
        now = time.time()
        # .3f, not .0f: rounding `end` to whole seconds can land it BEFORE
        # the just-primed samples and fake an empty fleet.
        doc = _get_json(
            f"{base}/api/v1/query_range?metric=tpu_tensorcore_duty_cycle_percent"
            f"&start={now - 120:.3f}&end={now:.3f}&step=1"
        )
        result["full_merge"] = {
            "merged_series": doc["fleet"]["merged_series"],
            "ok_targets": doc["fleet"]["ok"],
            "partial": doc["partial"],
            "staleness_present": all(
                st.get("staleness_s") is not None
                for st in doc["targets"].values()
            ),
        }
        if doc["partial"] or doc["fleet"]["ok"] != n_targets:
            result["error"] = f"expected full merge from {n_targets}: {doc['fleet']}"
            return result
        if doc["fleet"]["merged_series"] != n_targets * chips:
            result["error"] = (
                f"merged {doc['fleet']['merged_series']} series, "
                f"expected {n_targets * chips}"
            )
            return result
        if not result["full_merge"]["staleness_present"]:
            result["error"] = "per-target staleness missing"
            return result

        # --- p99 latency budget (cache-busted: every query a fresh grid) -
        metrics = ("tpu_tensorcore_duty_cycle_percent", "tpu_hbm_used_bytes")
        tails: list[float] = []
        for q in range(queries):
            sim.tick()  # keep data moving while querying
            now = time.time()
            url = (
                f"{base}/api/v1/query_range?metric={metrics[q % 2]}"
                f"&start={now - 60 - q:.3f}&end={now:.3f}&step=1"
            )
            t0 = time.perf_counter()
            doc = _get_json(url)
            tails.append(time.perf_counter() - t0)
            if doc["partial"]:
                result["error"] = f"unexpected partial at query {q}: {doc['targets']}"
                return result
        p99 = _percentile(tails, 0.99)
        result["query_p99_ms"] = round(p99 * 1e3, 2)
        result["query_p50_ms"] = round(_percentile(tails, 0.5) * 1e3, 2)
        result["budget_ms"] = budget_ms

        # --- traceparent propagation: node-side serve spans joined -------
        result["node_side_query_spans"] = sim.scrape_spans_recorded()
        if result["node_side_query_spans"] == 0:
            result["error"] = "no node-side /api/v1 spans recorded (traceparent lost)"
            return result

        # --- kill one target mid-query → partial, remainder merged -------
        if kill_one:
            victim_idx = n_targets // 2
            killed = {}

            def _kill() -> None:
                time.sleep(0.002)  # land inside the fan-out below
                killed["target"] = sim.kill(victim_idx)

            # New aggregator round first: the result cache keys on the
            # round generation, and the kill assertions below must observe
            # live fan-outs, not a pre-kill cached envelope.
            agg.poll_once()
            killer = threading.Thread(target=_kill, name="fleet-demo-kill",
                                      daemon=True)
            killer.start()
            now = time.time()
            _get_json(
                f"{base}/api/v1/query_range?metric=tpu_tensorcore_duty_cycle_percent"
                f"&start={now - 120:.3f}&end={now:.3f}&step=1"
            )  # the mid-kill query: partial OR full depending on the race
            killer.join(timeout=5)
            agg.poll_once()  # next round: fresh generation after the kill
            now = time.time()
            doc = _get_json(
                f"{base}/api/v1/query_range?metric=tpu_tensorcore_duty_cycle_percent"
                f"&start={now - 120:.3f}&end={now:.3f}&step=1"
            )
            result["after_kill"] = {
                "killed": killed.get("target"),
                "partial": doc["partial"],
                "ok_targets": doc["fleet"]["ok"],
                "merged_series": doc["fleet"]["merged_series"],
                "victim_state": doc["targets"][killed["target"]]["state"],
            }
            if not doc["partial"]:
                result["error"] = "killed target did not yield partial=true"
                return result
            if doc["fleet"]["ok"] != n_targets - 1:
                result["error"] = (
                    f"expected {n_targets - 1} ok targets after kill, "
                    f"got {doc['fleet']['ok']}"
                )
                return result
            if doc["fleet"]["merged_series"] != (n_targets - 1) * chips:
                result["error"] = (
                    f"expected {(n_targets - 1) * chips} merged series "
                    f"after kill, got {doc['fleet']['merged_series']}"
                )
                return result

        if p99 > budget_ms / 1e3:
            result["error"] = (
                f"fleet query p99 {p99 * 1e3:.1f}ms exceeds budget "
                f"{budget_ms:.0f}ms"
            )
            return result
        result["ok"] = True
        return result
    finally:
        if agg_server is not None:
            agg_server.stop()
        if fleet is not None:
            fleet.close()
        if agg is not None:
            agg.close()
        sim.close()


# --- Sharded aggregation tree harness (make shard-demo) ----------------------
#
# The fleet-query demo above runs REAL per-target collectors; at 1000
# targets that shape is all overhead and no signal. This harness keeps the
# leaf/root tier fully real (real LeafAggregator/RootAggregator processes-
# in-threads, real HTTP between every tier) and makes only the NODE tier
# synthetic: one ThreadingHTTPServer serving a deterministic exposition
# per target path, so a 1000-target fleet stands up in milliseconds and a
# flat single-aggregator ORACLE over the same scrape set is cheap enough
# to assert byte-level rollup equality at every checkpoint.


class SynthTargetFarm:
    """N synthetic node targets behind ONE HTTP server.

    ``/t/<idx>/metrics`` answers a deterministic exposition for target
    ``idx`` at the farm's current round — values are pure functions of
    (idx, round), so every scraper (leaf A, its HA twin, the oracle) that
    scrapes within one farm round sees identical bytes, which is what
    makes exact root-vs-oracle comparison possible. ``tick()`` advances
    the round (HBM grows, duty cycles shift). Targets in ``dead`` answer
    503 — permanently-down hosts for the breaker-carryover assertions."""

    def __init__(self, n_targets: int, chips: int = 2, n_slices: int = 8,
                 host: str = "127.0.0.1", port: int = 0,
                 gpu_slices: int = 0) -> None:
        import http.server

        self.n_targets = n_targets
        self.chips = chips
        self.n_slices = n_slices
        # Mixed fleet: the LAST gpu_slices slices are GPU node pools —
        # their targets publish the gpu_* node surface (backend/nvml.py's
        # namespace) instead of tpu_*, still pure functions of
        # (idx, round), so the flat oracle sees identical bytes and
        # per-family root-vs-oracle equality stays exact.
        if not 0 <= gpu_slices <= n_slices:
            raise ValueError("gpu_slices must be within [0, n_slices]")
        self.gpu_slices = gpu_slices
        self.round = 0
        self.dead: set[int] = set()
        self.allocated = n_targets  # grows via add_targets
        # Scenario-engine knobs (tpu_pod_exporter_torch.loadgen.scenario):
        # `hot` targets publish spiked duty/HBM (the hotspot(pod) event —
        # values stay pure functions of (idx, round), so the oracle sees
        # the same spike and rollup equality is preserved); `pod_gen`
        # rotates every target's pod name (the label-churn half of a
        # churn storm — workload label sets turn over wholesale).
        self.hot: set[int] = set()
        self.pod_gen = 0
        # Dashboard-storm realism knob: a target's /api/v1 value advances
        # only every api_churn-th round for it (staggered by idx), so per
        # round only ~1/api_churn of the fleet's series change — the
        # changed-series-only delta stream has something to be sparse
        # about. 1 (default) = every value changes every round, the
        # pre-existing behavior every other harness assumes.
        self.api_churn = 1
        self._api_epoch = time.time()
        farm = self

        class _FarmHandler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self) -> None:  # noqa: N802 — stdlib API
                path, _, query = self.path.partition("?")
                parts = path.split("/")
                # /t/<idx>/metrics
                if (len(parts) == 4 and parts[1] == "t"
                        and parts[3] == "metrics"):
                    try:
                        idx = int(parts[2])
                    except ValueError:
                        idx = -1
                    if 0 <= idx < farm.allocated and idx not in farm.dead:
                        body = farm.body(idx).encode()
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "text/plain; charset=utf-8")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                # /t/<idx>/api/v1/<route> — a minimal node-side history
                # answer so the federated query plane (leaf FleetQueryPlane
                # → RootQueryPlane) can be exercised over real HTTP at
                # fleet shape (the scenario engine's query-seam drills).
                if (len(parts) >= 6 and parts[1] == "t" and parts[3] == "api"
                        and parts[4] == "v1"):
                    try:
                        idx = int(parts[2])
                    except ValueError:
                        idx = -1
                    if 0 <= idx < farm.allocated and idx not in farm.dead:
                        body = farm.api_body(idx, parts[5], query).encode()
                        self.send_response(200)
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                self.send_response(503)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, fmt: str, *args) -> None:
                pass  # 3k requests/round; access logs would drown the demo

        class _FarmServer(http.server.ThreadingHTTPServer):
            daemon_threads = True
            request_queue_size = 256

        self._httpd = _FarmServer((host, port), _FarmHandler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="tpu-synth-farm", daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def url(self, idx: int) -> str:
        return f"http://127.0.0.1:{self.port}/t/{idx}/metrics"

    def targets(self, n: int | None = None) -> tuple[str, ...]:
        return tuple(self.url(i) for i in range(n or self.n_targets))

    def add_targets(self, k: int) -> tuple[str, ...]:
        """Allocate k new target indices (a scale-up churn wave)."""
        start = self.allocated
        self.allocated += k
        return tuple(self.url(i) for i in range(start, self.allocated))

    def slice_targets(self, sl: int) -> tuple[int, ...]:
        """Target indices of one slice (the preempt(slice-N) victim set)."""
        return tuple(
            i for i in range(self.allocated) if i % self.n_slices == sl
        )

    def pod_of(self, idx: int) -> str:
        return f"job-{(idx + self.pod_gen) % 31}"

    def family_of_slice(self, sl: int) -> str:
        return "gpu" if sl >= self.n_slices - self.gpu_slices else "tpu"

    def family_of(self, idx: int) -> str:
        return self.family_of_slice(idx % self.n_slices)

    def tick(self) -> None:
        self.round += 1

    def body(self, idx: int) -> str:
        """Deterministic exposition for one target at the current round.
        Shapes every family the aggregator tier folds: per-chip presence/
        HBM(-or-GPU-memory)/duty(-or-utilization)/ICI, host identity with
        a multislice group, pod rollups. GPU-slice targets publish the
        gpu_* node surface — no ICI (GPUs serve none here) and no
        multislice group (a TPU-fabric concept)."""
        r = self.round
        sl = idx % self.n_slices
        gpu = self.family_of_slice(sl) == "gpu"
        host = f"host-{idx:04d}"
        accel = "a100-sim" if gpu else "v5p-sim"
        base = (
            f'accelerator="{accel}",slice_name="slice-{sl}",host="{host}",'
            f'worker_id="{idx}"'
        )
        pod = self.pod_of(idx)
        hot = idx in self.hot
        lines: list[str] = []
        hbm_total = float((80 if gpu else 96) * 2**30)
        pod_hbm = 0.0
        p = "gpu" if gpu else "tpu"
        duty_name = ("gpu_utilization_percent" if gpu
                     else "tpu_tensorcore_duty_cycle_percent")
        for c in range(self.chips):
            cl = (f'chip_id="{c}",device_path="",{base},pod="{pod}",'
                  f'namespace="sim",container="worker"')
            hbm = float((idx + 1) * 2**20 + r * 65536 + c * 4096)
            if hot:
                # A hotspot pod near-fills its HBM (additive, not a
                # factor: normal values scale with idx, and a hotspot
                # must dominate the workload rollups at ANY fleet size).
                hbm += float(64 * 2**30)
            pod_hbm += hbm
            duty = float((idx * 7 + c * 13 + r) % 100)
            if hot:
                duty = 90.0 + float((idx * 7 + c * 13 + r) % 10)
            kind = 'device_kind="A100-sim"' if gpu else 'device_kind=""'
            lines.append(f'{p}_chip_info{{{cl},{kind},coords=""}} 1')
            lines.append(f'{p}_hbm_used_bytes{{{cl}}} {hbm:.1f}')
            lines.append(f'{p}_hbm_total_bytes{{{cl}}} {hbm_total:.1f}')
            lines.append(f'{duty_name}{{{cl}}} {duty:.1f}')
            if not gpu:
                lines.append(
                    f'tpu_ici_link_bandwidth_bytes_per_second{{{cl},link="0"}} '
                    f'{float((idx + r) % 7) * 1e6:.1f}')
        if gpu:
            lines.append(
                f'tpu_host_info{{{base},multislice_group="",num_slices=""}} 1')
            lines.append(
                f'gpu_pod_chip_count{{pod="{pod}",namespace="sim",{base}}} '
                f'{self.chips}')
            lines.append(
                f'gpu_pod_memory_used_bytes{{pod="{pod}",namespace="sim",'
                f'{base}}} {pod_hbm:.1f}')
        else:
            lines.append(
                f'tpu_host_info{{{base},multislice_group="ms-{sl % 2}",'
                f'num_slices="{(self.n_slices - self.gpu_slices + 1) // 2}"}} 1')
            lines.append(
                f'tpu_pod_chip_count{{pod="{pod}",namespace="sim",{base}}} '
                f'{self.chips}')
            lines.append(
                f'tpu_pod_hbm_used_bytes{{pod="{pod}",namespace="sim",{base}}} '
                f'{pod_hbm:.1f}')
        return "\n".join(lines) + "\n"

    def api_body(self, idx: int, route: str, query: str) -> str:
        """One deterministic /api/v1 JSON answer for a target: a single
        per-host series row in the node-local window_stats/query_range
        shape (labels + stats + last_sample_wall_ts — the fields the
        federated merge and its freshest-wins keying consume)."""
        import urllib.parse

        params = dict(urllib.parse.parse_qsl(query))
        metric = params.get("metric", "tpu_hbm_used_bytes")
        sl = f"slice-{idx % self.n_slices}"
        want_slice = params.get("match[slice_name]")
        if want_slice and want_slice != sl:
            # Label-matched queries cut the row set the way real node
            # history does — a dashboard panel watching one slice must
            # not stream every host in the fleet.
            if route == "series":
                return json.dumps([])
            return json.dumps({"status": "ok", "data": {"result": []}})
        churn = max(self.api_churn, 1)
        # The value's round component advances when (round + idx) % churn
        # wraps — staggered per target, pure function of (idx, round).
        vround = self.round - (self.round + idx) % churn
        value = float((idx + 1) * 2**20 + vround * 65536)
        row = {
            "metric": metric,
            "labels": {"host": f"host-{idx:04d}",
                       "slice_name": sl},
            # samples rides the VALUE round too: a live `self.round` here
            # would mark every row changed every round and defeat the
            # api_churn sparsity the delta drills measure.
            "stats": {"last": value, "min": value, "max": value,
                      "mean": value, "samples": max(vround, 1)},
            # Deterministic per (idx, value round): a row whose value did
            # not advance is byte-identical across polls, so the delta
            # stream ships ONLY genuinely-changed series (a wall-clock
            # stamp here would mark every row changed every round).
            "last_sample_wall_ts": round(self._api_epoch + vround, 3),
        }
        if route == "series":
            return json.dumps([row])
        return json.dumps({"status": "ok", "data": {"result": [row]}})

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def _node_addr_of(target: str) -> str:
    """Farm target URL (``…/t/<idx>/metrics``) → partition-switchboard
    address ``node:<idx>`` (chaos.PartitionState selectors)."""
    parts = target.split("/")
    if len(parts) >= 2 and "t" in parts:
        try:
            return f"node:{int(parts[parts.index('t') + 1])}"
        except (ValueError, IndexError):
            pass
    return "node:?"


class _SimLeaf:
    """One in-process leaf: a real :class:`~tpu_pod_exporter_torch.shard.\
LeafAggregator` plus its own real HTTP server (the root scrapes it over
    the wire). ``kill()`` is SIGKILL-shaped from every observer's view:
    the HTTP port stops answering and the in-flight round is never served;
    ``restart`` (see _ShardSim.restart) builds a FRESH leaf on the same
    state dir and the same port."""

    def __init__(self, name: str, shard_id: str, leaf_id: str, smap,
                 targets_file: str, state_dir: str, hook,
                 round_ref: list[int], timeout_s: float,
                 port: int = 0, net=None,
                 breaker_backoff_s: float = 30.0,
                 breaker_backoff_max_s: float = 60.0,
                 query_plane: bool = False) -> None:
        from tpu_pod_exporter_torch.aggregate import default_fetch
        from tpu_pod_exporter_torch.chaos import PartitionedFetch
        from tpu_pod_exporter_torch.metrics import SnapshotStore
        from tpu_pod_exporter_torch.persist import BreakerStateFile, ShardMapFile
        from tpu_pod_exporter_torch.server import MetricsServer
        from tpu_pod_exporter_torch.shard import LeafAggregator

        self.name = name
        self.alive = True
        self.hook = hook
        self._round_ref = round_ref
        self._calls = 0
        self._lock = threading.Lock()
        self._default_fetch = default_fetch
        self.store = SnapshotStore()
        # The leaf→node scrape seam: scenario partitions are injected by
        # wrapping the SAME fetch the leaf would use anyway (chaos.
        # PartitionedFetch) — the aggregator cannot tell chaos from a
        # genuinely unreachable node, which is the point.
        fetch = self._fetch
        if net is not None:
            fetch = PartitionedFetch(
                net, f"leaf:{name}", _node_addr_of, self._fetch)
        self.agg = LeafAggregator(
            shard_id, leaf_id, smap,
            shard_map_store=ShardMapFile(f"{state_dir}/{name}-shardmap.json"),
            targets_file=targets_file,
            store=self.store,
            timeout_s=timeout_s,
            fetch=fetch,
            breaker_failures=2,
            # Long by default: the shard-demo's quarantine must outlive the
            # demo; the scenario engine shortens it so healed partitions
            # re-admit their targets within the settle budget.
            breaker_backoff_s=breaker_backoff_s,
            breaker_backoff_max_s=breaker_backoff_max_s,
            breaker_store=BreakerStateFile(
                f"{state_dir}/{name}-breakers.json"),
        )
        # The leaf's federated /api/v1 plane — the fan-out seam of the
        # two-level query path, partitioned through the SAME switchboard.
        self.fleet = None
        if query_plane:
            from tpu_pod_exporter_torch.fleet import (
                FleetQueryPlane,
                default_api_fetch,
            )

            api_fetch = default_api_fetch
            if net is not None:
                def _plain_api(url: str, timeout_s: float) -> dict:
                    return default_api_fetch(url, timeout_s)

                api_fetch = PartitionedFetch(
                    net, f"leaf:{name}", _node_addr_of, _plain_api)
            self.fleet = FleetQueryPlane(
                self.agg.targets,
                timeout_s=timeout_s,
                fetch=api_fetch,
                breakers=self.agg.breakers,
                generation_fn=lambda: self.agg.rounds,
                targets_fn=lambda: self.agg.targets,
            )
        self.server = MetricsServer(self.store, host="127.0.0.1", port=port,
                                    ready_detail_fn=self.agg.ready_detail,
                                    fleet=self.fleet)
        self.server.start()
        self.addr = f"127.0.0.1:{self.server.port}"

    def _fetch(self, target: str, timeout_s: float) -> str:
        with self._lock:
            idx = self._calls
            self._calls += 1
        if self.hook is not None:
            self.hook.on_scrape(self.name, self._round_ref[0], idx)
        if not self.alive:
            raise ConnectionError("leaf dead (chaos kill)")
        return self._default_fetch(target, timeout_s)

    def begin_round(self) -> None:
        with self._lock:
            self._calls = 0

    def kill(self) -> None:
        if self.alive:
            self.alive = False
            self.server.stop()

    def close(self) -> None:
        if self.alive:
            self.server.stop()
            self.alive = False
        if self.fleet is not None:
            self.fleet.close()
        self.agg.close()

    def discard(self) -> None:
        """Tear down WITHOUT the graceful hooks: agg.close() force-saves
        breaker state, and a SIGKILLed process gets no close() — the
        demo's carryover assertion must prove the TRANSITION-TIME saves
        alone, or a regression there would be masked by this very
        harness. Only the worker threads are reaped."""
        if self.alive:
            self.server.stop()
            self.alive = False
        self.agg._pool.shutdown(wait=False)


class _ShardSim:
    """The whole tree, in one process: synthetic target farm, real leaf
    tier (HA pairs, each with HTTP server + state dir), real root, plus a
    flat single-aggregator ORACLE over the same targets file. Rounds are
    caller-driven (the scenario timeline needs deterministic ordering);
    leaves poll concurrently, the way independent processes would."""

    def __init__(self, n_targets: int, shards: int, ha: bool,
                 chips: int, state_root: str, timeout_s: float = 5.0,
                 net=None, stale_serve_s: float = 0.0,
                 leaf_breaker_backoff_s: float = 30.0,
                 leaf_breaker_backoff_max_s: float = 60.0,
                 root_breaker_backoff_s: float = 10.0,
                 root_breaker_backoff_max_s: float = 120.0,
                 n_slices: int = 8, query_plane: bool = False,
                 store_factory=None, gpu_slices: int = 0) -> None:
        import os

        from tpu_pod_exporter_torch.aggregate import SliceAggregator, default_fetch
        from tpu_pod_exporter_torch.chaos import PartitionedFetch
        from tpu_pod_exporter_torch.metrics import SnapshotStore
        from tpu_pod_exporter_torch.persist import ShardMapFile
        from tpu_pod_exporter_torch.shard import (
            ShardMap,
            default_shards,
        )

        os.makedirs(state_root, exist_ok=True)
        self.state_root = state_root
        self.timeout_s = timeout_s
        self.net = net
        self.farm = SynthTargetFarm(n_targets, chips=chips,
                                    n_slices=n_slices,
                                    gpu_slices=gpu_slices)
        self.targets_file = os.path.join(state_root, "targets.txt")
        self.write_targets(self.farm.targets())
        self.smap = ShardMap(default_shards(shards))
        self.round_ref = [0]
        self.hook = None  # set via arm_timeline before the driver runs
        self.leaves: dict[str, _SimLeaf] = {}
        self._leaf_meta: dict[str, tuple[str, str, int]] = {}
        self._leaf_kw = {
            "net": net,
            "breaker_backoff_s": leaf_breaker_backoff_s,
            "breaker_backoff_max_s": leaf_breaker_backoff_max_s,
            "query_plane": query_plane,
        }
        self.topology: dict[str, tuple[str, ...]] = {}
        for si in range(shards):
            shard_id = f"shard-{si}"
            addrs = []
            for suffix in ("a", "b") if ha else ("a",):
                name = f"{si}{suffix}"
                leaf = _SimLeaf(
                    name, shard_id, name, self.smap, self.targets_file,
                    state_root, None, self.round_ref, timeout_s,
                    **self._leaf_kw,
                )
                self.leaves[name] = leaf
                self._leaf_meta[name] = (shard_id, name, leaf.server.port)
                addrs.append(leaf.addr)
            self.topology[shard_id] = tuple(addrs)
        self.root_store = SnapshotStore()
        # The root→leaf scrape seam, same PartitionedFetch wrapper as the
        # leaf→node seam (addresses are fixed, so addr→leaf is a dict).
        self.leaf_addr_of = {
            leaf.addr: f"leaf:{name}" for name, leaf in self.leaves.items()
        }
        root_fetch = default_fetch
        if net is not None:
            root_fetch = PartitionedFetch(
                net, "root",
                lambda t: self.leaf_addr_of.get(t, "leaf:?"),
                default_fetch,
            )
        # Root construction goes through _build_root so root_restart
        # events (the store-continuity drill) can rebuild a FRESH root —
        # and a fresh FleetStore replaying the same dir — mid-run. The
        # SnapshotStore is shared across rebuilds: the engine's root
        # MetricsServer keeps serving the last published (stale) view
        # through the downtime, exactly like a real root's kubelet gap.
        self._store_factory = store_factory
        self._root_kwargs = dict(
            timeout_s=timeout_s,
            fetch=root_fetch,
            targets_file=self.targets_file,
            shard_map=self.smap,
            breaker_backoff_s=root_breaker_backoff_s,
            breaker_backoff_max_s=root_breaker_backoff_max_s,
            stale_serve_s=stale_serve_s,
        )
        self._root_shardmap_path = os.path.join(
            state_root, "root-shardmap.json")
        self.root_down = False
        self.root = self._build_root()
        # The correctness oracle: ONE flat aggregator over the same
        # targets file (breakers off so it re-scrapes dead targets every
        # round, matching what "a target is down" means to the fleet).
        self.oracle_store = SnapshotStore()
        self.oracle = SliceAggregator(
            (), self.oracle_store, timeout_s=timeout_s,
            breaker_failures=0, targets_file=self.targets_file,
        )
        self._pool = None

    # -------------------------------------------------------------- plumbing

    def _build_root(self):
        from tpu_pod_exporter_torch.persist import ShardMapFile
        from tpu_pod_exporter_torch.shard import RootAggregator

        fleet_store = (self._store_factory()
                       if self._store_factory is not None else None)
        return RootAggregator(
            self.topology, self.root_store,
            shard_map_store=ShardMapFile(self._root_shardmap_path),
            fleet_store=fleet_store,
            **self._root_kwargs,
        )

    def kill_root(self) -> None:
        """SIGKILL-shaped root death: no graceful close (a killed process
        force-saves nothing — the store must prove its per-append WAL
        durability alone). Worker threads are reaped; the store's file
        handles close (flushed appends are already in the page cache,
        which survives a process kill)."""
        if self.root_down:
            return
        self.root_down = True
        self.root._pool.shutdown(wait=False)
        if self.root._fleet_store is not None:
            for buf in self.root._fleet_store._buffers:
                buf.close()

    def restart_root(self) -> None:
        """A fresh root on the same state dirs; with a store factory the
        fresh FleetStore replays its tiers from disk — the continuity
        boundary the store_continuity drill queries across. The killed
        root is released first: a restarted process never holds its
        predecessor's memory."""
        self.root = None
        self.root = self._build_root()
        self.root_down = False

    def write_targets(self, targets) -> None:
        import os

        from tpu_pod_exporter_torch.persist import atomic_write

        atomic_write(
            self.targets_file, ("\n".join(targets) + "\n").encode("utf-8"))
        # mtime granularity on some filesystems is 1s; the reload check is
        # mtime-based, and demo rounds are subsecond — force a visible bump.
        st = os.stat(self.targets_file)
        os.utime(self.targets_file, (st.st_atime, st.st_mtime + 2.0))

    def arm_timeline(self, timeline: str) -> None:
        from tpu_pod_exporter_torch.chaos import LeafKillHook, parse_leaf_timeline

        self.hook = LeafKillHook(
            parse_leaf_timeline(timeline),
            kill_fn=lambda name: self.leaves[name].kill(),
            restart_fn=self.restart,
        )
        for leaf in self.leaves.values():
            leaf.hook = self.hook

    def restart(self, name: str) -> None:
        """A fresh leaf on the same state dir AND the same port (the root's
        topology is fixed addresses) — the restart half of the kill event."""
        shard_id, leaf_id, port = self._leaf_meta[name]
        old = self.leaves[name]
        # discard(), never close(): the dead leaf must leave behind only
        # what its transition-time saves already fsynced (see discard).
        old.discard()
        self.leaves[name] = _SimLeaf(
            name, shard_id, leaf_id, self.smap, self.targets_file,
            self.state_root, self.hook, self.round_ref, self.timeout_s,
            port=port, **self._leaf_kw,
        )

    def run_round(self) -> dict:
        """One driver round: advance the farm, fire timeline events, poll
        every live leaf concurrently, then the root. Returns timings."""
        from concurrent.futures import ThreadPoolExecutor

        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=max(len(self.leaves), 1),
                thread_name_prefix="tpu-shard-sim",
            )
        self.farm.tick()
        r = self.round_ref[0]
        if self.net is not None:
            # Flapping cuts key off the driver round (chaos.Cut).
            self.net.advance(r)
        if self.hook is not None:
            self.hook.begin_round(r)
        t0 = time.perf_counter()
        live = [l for l in self.leaves.values() if l.alive]
        for leaf in live:
            leaf.begin_round()
        list(self._pool.map(lambda l: l.agg.poll_once(), live))
        t1 = time.perf_counter()
        if not self.root_down:
            self.root.poll_once()
        t2 = time.perf_counter()
        self.round_ref[0] = r + 1
        return {"leaf_tier_s": t1 - t0, "root_s": t2 - t1,
                "full_s": t2 - t0}

    def poll_leaves(self, names) -> None:
        for name in names:
            leaf = self.leaves[name]
            if leaf.alive:
                leaf.begin_round()
                leaf.agg.poll_once()

    def root_body(self) -> str:
        return self.root_store.current().encode().decode()

    def oracle_body(self) -> str:
        self.oracle.poll_once()
        return self.oracle_store.current().encode().decode()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        for leaf in self.leaves.values():
            leaf.close()
        self.root.close()
        self.oracle.close()
        self.farm.close()


# Rollup families the oracle comparison covers — everything emit_rollups
# produces plus the per-target passthrough both tiers publish.
_ORACLE_FAMILIES = (
    "tpu_fleet_family_hosts_reporting",
    "tpu_fleet_family_chip_count",
    "tpu_fleet_family_hbm_used_bytes",
    "tpu_fleet_family_hbm_total_bytes",
    "tpu_slice_hosts_reporting",
    "tpu_slice_chip_count",
    "tpu_slice_hbm_used_bytes",
    "tpu_slice_hbm_total_bytes",
    "tpu_slice_hbm_used_percent",
    "tpu_slice_tensorcore_duty_cycle_avg_percent",
    "tpu_slice_ici_bytes_per_second",
    "tpu_multislice_slices_reporting",
    "tpu_multislice_expected_slices",
    "tpu_multislice_hosts_reporting",
    "tpu_multislice_chip_count",
    "tpu_multislice_hbm_used_bytes",
    "tpu_multislice_ici_bytes_per_second",
    "tpu_workload_chip_count",
    "tpu_workload_hbm_used_bytes",
    "tpu_workload_hosts",
    "tpu_aggregator_target_up",
)


def _family_values(text: str, families=_ORACLE_FAMILIES) -> dict:
    from tpu_pod_exporter_torch.metrics.parse import parse_families

    fams = parse_families(text)
    out = {}
    for name in families:
        for s in fams.get(name, ()):
            out[(name, tuple(sorted(s.labels.items())))] = s.value
    return out


def _compare_oracle(root_map: dict, oracle_map: dict) -> list[str]:
    """Root-vs-flat-oracle rollup diff (empty = identical modulo float
    summation order, hence the 1e-9 relative tolerance)."""
    import math

    problems = []
    missing = set(oracle_map) - set(root_map)
    extra = set(root_map) - set(oracle_map)
    for k in sorted(missing)[:5]:
        problems.append(f"missing from root: {k}")
    for k in sorted(extra)[:5]:
        problems.append(f"extra at root: {k}")
    for k in oracle_map:
        if k in root_map and not math.isclose(
            root_map[k], oracle_map[k], rel_tol=1e-9, abs_tol=1e-9
        ):
            problems.append(
                f"value drift {k}: root={root_map[k]!r} "
                f"oracle={oracle_map[k]!r}")
            if len(problems) > 8:
                break
    return problems


def run_shard_demo(n_targets: int, shards: int, ha: bool, chips: int,
                   churn: int, round_budget_s: float, stale_budget_s: float,
                   state_root: str, gpu_slices: int = 2) -> dict:
    """The sharded-tree acceptance scenario (``make shard-demo``):

    1. prime the tree; two permanently-dead targets teach the owning
       leaves a quarantine (breaker carryover fodder);
    2. baseline: root rollups equal the flat single-aggregator oracle;
    3. freshest-wins: every HA pair is staggered one farm round apart —
       the root must publish the FRESHER half's values;
    4. kill one HA leaf MID-ROUND (chaos LeafKillHook) → zero series
       lost vs the pre-kill layout, values still oracle-equal, twin
       staleness within budget;
    5. restart the leaf on its state dir → quarantines carried over,
       leaf_up recovers;
    6. churn wave: remove/add ``churn`` targets via the targets file →
       assignment moves ≤ changed + targets/shards, every tier reshards
       live (no restarts), rollups oracle-equal again;
    7. round-time budget over the whole run.
    """
    import math

    from tpu_pod_exporter_torch.metrics.parse import parse_families
    from tpu_pod_exporter_torch.shard import count_moves

    result: dict = {
        "ok": False, "targets": n_targets, "shards": shards, "ha": ha,
        "chips": chips, "gpu_slices": gpu_slices,
    }
    if not ha:
        result["error"] = "shard demo needs --ha (the failover is the point)"
        return result
    # Mixed fleet by default (gpu_slices of the farm's 8 slices are GPU
    # node pools): both device families ride one tree, and the oracle
    # comparison below covers the per-family rollups too.
    sim = _ShardSim(n_targets, shards, ha, chips, state_root,
                    gpu_slices=gpu_slices)
    timings: list[dict] = []
    try:
        # Two permanently-dead targets (and their leaf quarantines).
        sim.farm.dead = {0, 1}
        dead_urls = [sim.farm.url(0), sim.farm.url(1)]
        victim_shard = sim.smap.assign(dead_urls[0])
        victim = f"{victim_shard.rsplit('-', 1)[1]}a"
        twin = f"{victim_shard.rsplit('-', 1)[1]}b"
        shard_size = sum(
            1 for t in sim.farm.targets()
            if sim.smap.assign(t) == victim_shard
        )
        # Rounds 0-2 prime, 3-4 are the staggered freshest-wins phase,
        # the kill lands mid-round 5, the restart in round 7.
        kill_round = 5
        sim.arm_timeline(
            f"kill:{victim}@{kill_round}#{max(shard_size // 2, 1)},"
            f"restart:{victim}@{kill_round + 2}"
        )
        result["victim"] = {"leaf": victim, "twin": twin,
                            "shard": victim_shard,
                            "shard_targets": shard_size}

        # --- rounds 0-2: prime; breakers learn the dead targets --------
        for _ in range(3):
            timings.append(sim.run_round())

        # --- baseline: root == flat oracle ------------------------------
        root_map = _family_values(sim.root_body())
        oracle_map = _family_values(sim.oracle_body())
        problems = _compare_oracle(root_map, oracle_map)
        if problems:
            result["error"] = f"baseline oracle mismatch: {problems[:3]}"
            return result
        result["baseline"] = {"rollup_series": len(root_map),
                              "oracle_equal": True}
        # Per-family rollups against the arithmetic ground truth: every
        # live target contributes `chips` chips to exactly its own
        # family's fleet count — mixed sums that crossed families would
        # land on the right total while being family-wrong, so the split
        # is checked against first principles, not just the oracle.
        fam_expected: dict[str, float] = {}
        for i in range(sim.farm.allocated):
            if i not in sim.farm.dead:
                fam = sim.farm.family_of(i)
                fam_expected[fam] = fam_expected.get(fam, 0.0) + chips
        fam_reported = {
            s.labels["family"]: s.value
            for s in parse_families(sim.root_body()).get(
                "tpu_fleet_family_chip_count", ())
        }
        result["baseline"]["family_chips"] = fam_reported
        if fam_reported != fam_expected:
            result["error"] = (
                f"per-family fleet chips {fam_reported} != expected "
                f"{fam_expected} (family-correctness violated)")
            return result
        if gpu_slices > 0 and "gpu" not in fam_reported:
            result["error"] = "mixed demo reported no GPU family chips"
            return result
        baseline_series = set(root_map)
        quarantined = [
            t for t, br in (sim.leaves[victim].agg.breakers or {}).items()
            if t in dead_urls and br.state != "closed"
        ]
        result["baseline"]["quarantined_dead_targets"] = len(quarantined)

        # --- freshest-wins: stagger every HA pair one farm round --------
        sim.farm.tick()
        sim.poll_leaves([n for n in sim.leaves if n.endswith("a")])
        sim.round_ref[0] += 1
        sim.farm.tick()
        sim.poll_leaves([n for n in sim.leaves if n.endswith("b")])
        sim.round_ref[0] += 1
        sim.root.poll_once()
        fresh_map = _family_values(sim.root_body())
        fresh_oracle = _family_values(sim.oracle_body())
        problems = _compare_oracle(fresh_map, fresh_oracle)
        if problems:
            result["error"] = (
                f"freshest-wins violated (root served the stale HA half): "
                f"{problems[:3]}")
            return result
        result["freshest_wins"] = {"oracle_equal_at_newer_round": True}

        # --- kill one HA leaf mid-round ---------------------------------
        t_kill = sim.run_round()  # the hook fires inside the victim's poll
        timings.append(t_kill)
        if (sim.round_ref[0] - 1, "kill", victim) not in sim.hook.executed:
            result["error"] = (
                f"timeline did not fire the kill: {sim.hook.executed}")
            return result
        body = sim.root_body()
        kill_map = _family_values(body)
        lost = baseline_series - set(kill_map)
        result["kill"] = {
            "executed": list(sim.hook.executed),
            "series_before": len(baseline_series),
            "series_after": len(kill_map),
            "series_lost": sorted(lost)[:5],
        }
        if lost:
            result["error"] = f"{len(lost)} series lost after leaf kill"
            return result
        problems = _compare_oracle(kill_map, _family_values(sim.oracle_body()))
        if problems:
            result["error"] = f"post-kill oracle mismatch: {problems[:3]}"
            return result
        fams = parse_families(body)
        leaf_up = {
            (s.labels["shard"], s.labels["leaf"]): s.value
            for s in fams.get("tpu_root_leaf_up", ())
        }
        victim_addr = sim.leaves[victim].addr
        twin_addr = sim.leaves[twin].addr
        if leaf_up.get((victim_shard, victim_addr)) != 0.0:
            result["error"] = f"victim leaf_up should be 0: {leaf_up}"
            return result
        if leaf_up.get((victim_shard, twin_addr)) != 1.0:
            result["error"] = f"twin leaf_up should be 1: {leaf_up}"
            return result
        stale = {
            s.labels["leaf"]: s.value
            for s in fams.get("tpu_root_leaf_staleness_seconds", ())
            if s.labels["shard"] == victim_shard
        }
        twin_stale = stale.get(twin_addr, math.inf)
        result["kill"]["twin_staleness_s"] = round(twin_stale, 3)
        budget = max(stale_budget_s, 2.0 * t_kill["full_s"])
        if twin_stale > budget:
            result["error"] = (
                f"twin staleness {twin_stale:.2f}s exceeds one-round budget "
                f"{budget:.2f}s")
            return result

        # one more round with the leaf down: the shard stays covered.
        timings.append(sim.run_round())

        # --- restart: state carryover -----------------------------------
        timings.append(sim.run_round())  # restart event fires, leaf re-polls
        if (kill_round + 2, "restart", victim) not in sim.hook.executed:
            result["error"] = (
                f"timeline did not fire the restart: {sim.hook.executed}")
            return result
        restarted = sim.leaves[victim].agg
        carried = [
            t for t, br in (restarted.breakers or {}).items()
            if t in dead_urls and br.state != "closed"
        ]
        fams = parse_families(sim.root_body())
        leaf_up = {
            s.labels["leaf"]: s.value
            for s in fams.get("tpu_root_leaf_up", ())
            if s.labels["shard"] == victim_shard
        }
        result["restart"] = {
            "dead_target_quarantines_carried": len(carried),
            "leaf_up_after": leaf_up.get(victim_addr),
        }
        if len(quarantined) and not carried:
            result["error"] = (
                "restarted leaf re-learned its quarantines from scratch "
                "(breaker carryover broken)")
            return result
        if leaf_up.get(victim_addr) != 1.0:
            result["error"] = f"restarted leaf not up at root: {leaf_up}"
            return result

        # --- churn wave --------------------------------------------------
        old_targets = sim.farm.targets(sim.farm.allocated)
        old_live = tuple(
            t for i, t in enumerate(old_targets) if i not in sim.farm.dead
        )
        removed = list(old_live[2:2 + churn // 2])
        added = list(sim.farm.add_targets(churn - churn // 2))
        new_targets = tuple(
            t for t in old_targets if t not in removed
        ) + tuple(added)
        moves = count_moves(
            sim.smap.assignments(old_targets),
            sim.smap.assignments(new_targets),
        )
        bound = churn + max(len(new_targets) // shards, 1)
        result["churn"] = {
            "removed": len(removed), "added": len(added),
            "assignment_moves": moves, "bound": bound,
        }
        if moves > bound:
            result["error"] = (
                f"churn wave moved {moves} assignments, bound {bound}")
            return result
        sim.write_targets(new_targets)
        timings.append(sim.run_round())  # reload + reshard + re-aggregate
        fams = parse_families(sim.root_body())
        leaf_targets = sum(
            s.value for s in fams.get("tpu_root_shard_targets", ())
        )
        result["churn"]["leaf_reported_targets"] = int(leaf_targets)
        if int(leaf_targets) != len(new_targets):
            result["error"] = (
                f"leaves report {int(leaf_targets)} targets after churn, "
                f"want {len(new_targets)}")
            return result
        reshard_total = sum(
            s.value for s in fams.get("tpu_root_reshard_moves_total", ())
        )
        result["churn"]["root_reshard_moves_total"] = reshard_total
        if reshard_total < moves:
            result["error"] = (
                f"root reshard counter {reshard_total} below the observed "
                f"{moves} moves")
            return result
        problems = _compare_oracle(
            _family_values(sim.root_body()), _family_values(sim.oracle_body())
        )
        if problems:
            result["error"] = f"post-churn oracle mismatch: {problems[:3]}"
            return result

        # --- budgets ------------------------------------------------------
        result["timings"] = {
            "rounds": len(timings),
            "full_max_s": round(max(t["full_s"] for t in timings), 3),
            "full_mean_s": round(
                sum(t["full_s"] for t in timings) / len(timings), 3),
            "root_max_s": round(max(t["root_s"] for t in timings), 3),
            "budget_s": round_budget_s,
        }
        if result["timings"]["full_max_s"] > round_budget_s:
            result["error"] = (
                f"round time {result['timings']['full_max_s']}s exceeds "
                f"budget {round_budget_s}s")
            return result
        result["ok"] = True
        return result
    finally:
        sim.close()


# ------------------------------------------------- dashboard storm (mode 3)


class _ReplicaSim:
    """One in-process stateless read replica: a read-only RootAggregator
    over the same leaf topology, its own two-level query plane with the
    generation-keyed cache, a stream hub, and a real HTTP server —
    exactly what ``tpu-pod-exporter-shard --role replica`` builds.
    Rounds are caller-ticked like everything else in the sim."""

    def __init__(self, name: str, topology, root_url: str,
                 timeout_s: float = 5.0, max_subscribers: int = 20000,
                 heartbeat_s: float = 5.0, full_sync_s: float = 20.0) -> None:
        from tpu_pod_exporter_torch.metrics import SnapshotStore
        from tpu_pod_exporter_torch.server import MetricsServer
        from tpu_pod_exporter_torch.shard import (
            ReplicaSourceProxy,
            RootAggregator,
            RootQueryPlane,
        )
        from tpu_pod_exporter_torch.stream import StreamHub, plane_poll_fn

        self.name = name
        self.alive = True
        self.store = SnapshotStore()
        self.root = RootAggregator(topology, self.store,
                                   timeout_s=timeout_s)
        self.plane = ReplicaSourceProxy(
            RootQueryPlane(topology, timeout_s=timeout_s + 0.5,
                           leaf_breakers=self.root._breakers,
                           generation_fn=lambda: self.root.rounds),
            replica_id=name, root_url=root_url,
        )
        self.root.emit_hooks.append(self.plane.emit)
        self.poll_fn = plane_poll_fn(self.plane)
        self.hub = StreamHub(self.poll_fn, lambda: self.root.rounds,
                             heartbeat_s=heartbeat_s,
                             full_sync_s=full_sync_s,
                             max_subscribers=max_subscribers)
        self.root.emit_hooks.append(self.hub.emit)
        self.server = MetricsServer(self.store, host="127.0.0.1", port=0,
                                    fleet=self.plane, stream_hub=self.hub)
        self.server.start()
        self.addr = ("127.0.0.1", self.server.port)

    def tick_round(self) -> None:
        if not self.alive:
            return
        self.root.poll_once()
        self.hub.on_round(self.root.rounds)

    def kill(self) -> None:
        """Replica death mid-stream: the server drops every subscriber
        connection (they must reconnect to a peer); nothing durable is
        lost because a replica owns nothing durable."""
        if not self.alive:
            return
        self.alive = False
        self.server.stop()

    def close(self) -> None:
        self.kill()
        self.hub.close()
        self.plane.close()
        self.root.close()


class _StormSubscribers:
    """5-10k concurrent SSE subscriptions across a few selector loops.

    Each connection applies its frames through a
    :class:`~tpu_pod_exporter_torch.stream.StreamReplay` (so gaps/dups/replay
    state are tracked per subscriber), records per-frame push latency
    (receiver wall clock minus the frame's emission ts — one process, one
    clock), and on EOF reconnects to a live peer endpoint — the
    replica-kill degradation story. Connections are sharded over
    ``workers`` independent selector threads so the measurement harness
    itself does not become the latency bottleneck at 5k+ subscribers.
    ``drop_one_delta`` is the NEGATIVE control: one delta frame per
    connection is discarded before replay, which the equality invariant
    must catch."""

    def __init__(self, drop_one_delta: bool = False,
                 workers: int = 4) -> None:
        import selectors
        import socket as socket_mod

        self._selectors = selectors
        self._socket = socket_mod
        self._lock = threading.Lock()
        self._stopping = False
        self.drop_one_delta = drop_one_delta
        self.conns: dict[int, dict] = {}
        self._next_id = 0
        self._endpoints: list[tuple[str, tuple[str, int]]] = []
        self._dead_endpoints: set[str] = set()
        self.connect_failures = 0
        self._workers: list[dict] = []
        for i in range(max(1, workers)):
            sel = selectors.DefaultSelector()
            wr, ww = socket_mod.socketpair()
            wr.setblocking(False)
            ww.setblocking(False)
            sel.register(wr, selectors.EVENT_READ, None)
            w = {"sel": sel, "wake_r": wr, "wake_w": ww, "pending": [],
                 "idx": i}
            w["thread"] = threading.Thread(
                target=self._run, args=(w,),
                name=f"tpu-dash-storm-{i}", daemon=True)
            self._workers.append(w)
            w["thread"].start()

    # ------------------------------------------------------------- control

    def _post(self, w, fn) -> None:
        with self._lock:
            w["pending"].append(fn)
        try:
            w["wake_w"].send(b"\x00")
        except OSError:
            pass

    def set_endpoints(self, endpoints) -> None:
        """[(label, (host, port)), ...] — reconnect targets."""
        with self._lock:
            self._endpoints = list(endpoints)

    def mark_dead(self, label: str) -> None:
        with self._lock:
            self._dead_endpoints.add(label)

    def open(self, n: int, shapes, spread=None) -> None:
        """Open n subscriptions round-robin across live endpoints (or
        ``spread``, a list of labels) and shapes, sharded over the
        worker loops."""
        from tpu_pod_exporter_torch.stream import stream_path

        with self._lock:
            eps = {label: addr for label, addr in self._endpoints}
            labels = spread or [label for label, _ in self._endpoints]
        per = [[] for _ in self._workers]
        for i in range(n):
            per[i % len(per)].append(
                (labels[i % len(labels)], shapes[i % len(shapes)]))
        for w, batch in zip(self._workers, per):
            def start(w=w, batch=batch) -> None:
                for label, shape in batch:
                    self._connect(w, label, eps[label], shape,
                                  stream_path(shape))
            self._post(w, start)

    def _connect(self, w, label, addr, shape, path) -> int | None:
        from tpu_pod_exporter_torch.stream import SseParser, StreamReplay

        sock = self._socket.socket()
        sock.setblocking(False)
        try:
            sock.connect_ex(addr)
        except OSError:
            self.connect_failures += 1
            sock.close()
            return None
        with self._lock:
            cid = self._next_id
            self._next_id += 1
        conn = {
            "id": cid, "sock": sock, "label": label, "shape": shape,
            "worker": w,
            "out": bytearray(
                f"GET {path} HTTP/1.1\r\nHost: storm\r\n"
                f"Accept: text/event-stream\r\n\r\n".encode()),
            "head": bytearray(), "in_body": False,
            "parser": SseParser(), "replay": StreamReplay(),
            "latencies": [], "reconnects": 0, "dropped": False,
            "status": 0, "closed": False,
        }
        with self._lock:
            self.conns[cid] = conn
        w["sel"].register(
            sock,
            self._selectors.EVENT_READ | self._selectors.EVENT_WRITE,
            conn,
        )
        return cid

    # ---------------------------------------------------------------- loop

    def _run(self, w) -> None:
        sel = w["sel"]
        EVENT_READ = self._selectors.EVENT_READ
        EVENT_WRITE = self._selectors.EVENT_WRITE
        while not self._stopping:
            for key, mask in sel.select(0.2):
                if key.fileobj is w["wake_r"]:
                    try:
                        while w["wake_r"].recv(4096):
                            pass
                    except OSError:
                        pass
                    continue
                conn = key.data
                if conn["closed"]:
                    continue
                if mask & EVENT_WRITE and conn["out"]:
                    try:
                        n = conn["sock"].send(conn["out"])
                        del conn["out"][:n]
                    except (BlockingIOError, InterruptedError):
                        pass
                    except OSError:
                        self._drop(conn)
                        continue
                    if not conn["out"]:
                        sel.modify(conn["sock"], EVENT_READ, conn)
                if mask & EVENT_READ:
                    self._readable(conn)
            with self._lock:
                pending, w["pending"] = w["pending"], []
            for fn in pending:
                try:
                    fn()
                except Exception:  # noqa: BLE001 — storm must keep running
                    pass
        for conn in list(self.conns.values()):
            if conn["worker"] is w:
                self._drop(conn, reconnect=False)
        sel.close()
        w["wake_r"].close()
        w["wake_w"].close()

    def _readable(self, conn) -> None:
        try:
            data = conn["sock"].recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(conn)
            return
        if not data:
            self._drop(conn)
            return
        if not conn["in_body"]:
            conn["head"] += data
            idx = conn["head"].find(b"\r\n\r\n")
            if idx < 0:
                return
            head = bytes(conn["head"][:idx])
            rest = bytes(conn["head"][idx + 4:])
            parts = head.split(b"\r\n", 1)[0].split()
            conn["status"] = int(parts[1]) if len(parts) > 1 else 0
            conn["in_body"] = True
            conn["head"] = bytearray()
            if conn["status"] != 200:
                self._drop(conn, reconnect=False)
                return
            data = rest
            if not data:
                return
        now_wall = time.time()
        frames = conn["parser"].feed(data)
        with self._lock:
            for frame in frames:
                if (self.drop_one_delta and not conn["dropped"]
                        and frame.get("type") == "delta"):
                    # NEGATIVE CONTROL: a lost delta the client never
                    # applied — the replay-equality invariant must flag
                    # this subscriber.
                    conn["dropped"] = True
                    continue
                conn["replay"].apply(frame, recv_wall=now_wall)
                if frame.get("type") in ("delta", "full_sync"):
                    lat = conn["replay"].last_latency_s
                    if lat is not None:
                        conn["latencies"].append(lat)

    def _drop(self, conn, reconnect: bool = True) -> None:
        if conn["closed"]:
            return
        conn["closed"] = True
        try:
            conn["worker"]["sel"].unregister(conn["sock"])
        except (KeyError, ValueError):
            pass
        try:
            conn["sock"].close()
        except OSError:
            pass
        with self._lock:
            self.conns.pop(conn["id"], None)
        if not reconnect or self._stopping:
            return
        # Reconnect to a LIVE peer: the kill degradation contract — a
        # dead replica's viewers land on the survivors with a fresh
        # snapshot; everyone else's stream is untouched.
        from tpu_pod_exporter_torch.stream import stream_path

        with self._lock:
            live = [(label, addr) for label, addr in self._endpoints
                    if label not in self._dead_endpoints]
        if not live:
            return
        label, addr = live[conn["id"] % len(live)]
        cid = self._connect(conn["worker"], label, addr, conn["shape"],
                            stream_path(conn["shape"]))
        if cid is not None:
            with self._lock:
                self.conns[cid]["reconnects"] = conn["reconnects"] + 1

    # ------------------------------------------------------------ snapshots

    def live(self) -> int:
        with self._lock:
            return sum(1 for c in self.conns.values() if not c["closed"])

    def wait_snapshots(self, n: int, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                ready = sum(1 for c in self.conns.values()
                            if c["replay"].seq is not None)
            if ready >= n:
                return True
            time.sleep(0.05)
        return False

    def wait_caught_up(self, label_seqs: dict, timeout_s: float) -> int:
        """Block until every live subscriber of each label has replayed
        up to its SHAPE's current seq (``label_seqs``: label → the
        endpoint hub's ``shape_seqs()``); returns the laggard count left
        at timeout. Seq-based, not generation-based: a shape whose rows
        did not change this round legitimately ships nothing."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                lag = 0
                for c in self.conns.values():
                    if c["closed"] or c["replay"].seq is None:
                        continue
                    seqs = label_seqs.get(c["label"])
                    if seqs is None:
                        continue
                    want = seqs.get(c["shape"].key)
                    if want is not None and c["replay"].seq < want:
                        lag += 1
            if lag == 0 or time.monotonic() >= deadline:
                return lag
            time.sleep(0.02)

    def sample(self, k: int):
        """(label, shape, rows-by-key copy, generation) for k live,
        synced subscribers — the replay-equality check's subjects."""
        out = []
        with self._lock:
            for c in self.conns.values():
                if c["closed"] or c["replay"].seq is None:
                    continue
                out.append((c["label"], c["shape"],
                            dict(c["replay"].rows), c["replay"].generation))
                if len(out) >= k:
                    break
        return out

    def totals(self) -> dict:
        with self._lock:
            conns = list(self.conns.values())
            return {
                "live": sum(1 for c in conns if not c["closed"]),
                "gaps": sum(c["replay"].gaps for c in conns),
                "dups": sum(c["replay"].dups for c in conns),
                "desynced": sum(1 for c in conns if c["replay"].desynced),
                "reconnects": sum(c["reconnects"] for c in conns),
                "sheds_seen": sum(
                    1 for c in conns
                    if c["replay"].shed_reason is not None),
                "frames": sum(c["replay"].frames for c in conns),
                "latencies": sorted(
                    lat for c in conns for lat in c["latencies"]),
            }

    def drain_latencies(self) -> None:
        with self._lock:
            for c in self.conns.values():
                c["latencies"] = []

    def stop(self) -> None:
        self._stopping = True
        for w in self._workers:
            try:
                w["wake_w"].send(b"\x00")
            except OSError:
                pass
        for w in self._workers:
            w["thread"].join(timeout=10.0)


def _raise_nofile(need: int) -> None:
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < need <= hard:
            resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except (ImportError, ValueError, OSError):
        pass


def run_dashboard_demo(
    n_targets: int,
    shards: int,
    chips: int,
    subs: int,
    rounds: int,
    replicas: int,
    state_root: str,
    push_p99_budget_s: float = 1.0,
    rss_cap_mb: float = 128.0,
    negative: bool = False,
    kill_replica: bool = True,
) -> dict:
    """The dashboard-storm acceptance drill (``make dashboard-demo``).

    Holds ``subs`` concurrent stream subscriptions against one root +
    ``replicas`` stateless read replicas over a real leaf tier, drives
    caller-ticked rounds, and asserts: bounded per-round push p99, flat
    RSS, zero duplicate/missed rounds per subscriber, delta replay equal
    to the polled answer for every sampled subscriber every round, and a
    replica kill mid-stream degrading ONLY its own subscribers (they
    reconnect to a peer and resync). ``negative=True`` drops one delta
    frame client-side per subscriber — the equality invariant must catch
    it, proving the drill can fail."""
    import os

    from tpu_pod_exporter_torch import utils
    from tpu_pod_exporter_torch.metrics import SnapshotBuilder
    from tpu_pod_exporter_torch.server import MetricsServer
    from tpu_pod_exporter_torch.shard import RootQueryPlane
    from tpu_pod_exporter_torch.stream import (
        QueryShape,
        StreamHub,
        plane_poll_fn,
        rows_map,
    )

    _raise_nofile(2 * subs + 4 * n_targets + 512)
    os.makedirs(state_root, exist_ok=True)
    result: dict = {
        "ok": False, "mode": "dashboard", "targets": n_targets,
        "shards": shards, "subs": subs, "rounds": rounds,
        "replicas": replicas, "negative": negative,
        "failures": [],
    }
    fails: list = result["failures"]
    t_start = time.perf_counter()
    # A dropped delta (negative mode) leaves its subscriber behind the
    # round generation until the next frame — don't ride out the full
    # production wait on a lag the control CREATED.
    gen_wait_s = 5.0 if negative else 30.0
    sim = _ShardSim(n_targets, shards, ha=False, chips=chips,
                    state_root=state_root, timeout_s=10.0,
                    query_plane=True)
    # ~1/4 of the fleet's api series change per round: the delta stream
    # has real sparsity to exploit (and to be measured on).
    sim.farm.api_churn = 4
    storm = _StormSubscribers(drop_one_delta=negative)
    root_plane = RootQueryPlane(
        sim.topology, timeout_s=10.5,
        leaf_breakers=sim.root._breakers,
        generation_fn=lambda: sim.root.rounds,
    )
    per_hub_cap = subs  # admission headroom; shed is exercised explicitly
    root_hub = StreamHub(plane_poll_fn(root_plane),
                         lambda: sim.root.rounds,
                         heartbeat_s=5.0, full_sync_s=20.0,
                         max_subscribers=per_hub_cap)
    root_server = MetricsServer(sim.root_store, host="127.0.0.1", port=0,
                                fleet=root_plane, stream_hub=root_hub)
    root_server.start()
    reps: list[_ReplicaSim] = []
    try:
        for i in range(replicas):
            reps.append(_ReplicaSim(
                f"replica-{i}", sim.topology,
                root_url=f"127.0.0.1:{root_server.port}",
                timeout_s=10.0, max_subscribers=per_hub_cap))
        endpoints = [("root", ("127.0.0.1", root_server.port))] + [
            (rep.name, rep.addr) for rep in reps
        ]
        storm.set_endpoints(endpoints)
        planes = {"root": plane_poll_fn(root_plane)}
        hubs = {"root": root_hub}
        for rep in reps:
            planes[rep.name] = rep.poll_fn
            hubs[rep.name] = rep.hub

        def tick_all() -> dict:
            sim.run_round()
            for rep in reps:
                rep.tick_round()
            t0 = time.perf_counter()
            root_hub.on_round(sim.root.rounds)
            return {"root_push_s": time.perf_counter() - t0}

        # Prime: two rounds before any viewer shows up.
        tick_all()
        tick_all()

        # Dashboard panels: a handful of query shapes shared by thousands
        # of subscribers — per round the plane evaluates each shape ONCE
        # per serving endpoint, not once per viewer.
        shapes = [
            QueryShape(route="window_stats", metric="tpu_hbm_used_bytes",
                       match=(("slice_name", f"slice-{i}"),), window_s=60.0)
            for i in range(4)
        ] + [QueryShape(route="window_stats", metric="tpu_hbm_used_bytes",
                        window_s=60.0)]
        storm.open(subs, shapes)
        if not storm.wait_snapshots(subs, timeout_s=60.0):
            fails.append(
                f"only {storm.live()} of {subs} subscriptions "
                f"reached their snapshot")
        result["connected"] = storm.live()
        # RSS baseline AFTER the subscriptions exist: the flat-RSS
        # invariant hunts leaks DURING the storm (per-round growth), not
        # the one-time footprint of 2×subs in-process sockets this
        # single-process harness deliberately carries on both sides.
        rss_before = utils.process_rss_bytes() or 0

        kill_round = (rounds // 2
                      if (kill_replica and reps and rounds > 0) else -1)
        round_push_p99: list[float] = []
        equality_checked = 0
        equality_failures = 0
        for r in range(rounds):
            storm.drain_latencies()
            tick_all()
            expect = {label: hub.shape_seqs() for label, hub in hubs.items()}
            laggards = storm.wait_caught_up(expect,
                                            timeout_s=gen_wait_s)
            if laggards:
                fails.append(
                    f"round {r}: {laggards} subscribers never caught up "
                    f"to their shape's seq")
            # Replay == polled answer, per sampled subscriber. Same
            # generation + the generation-keyed plane cache ⇒ the polled
            # answer is byte-identical to what the hub diffed from.
            for label, shape, rows, gen in storm.sample(12):
                env = planes[label](shape, gen or 0)
                equality_checked += 1
                if rows != rows_map(shape.route, env):
                    equality_failures += 1
                    fails.append(
                        f"round {r}: replay != polled answer for a "
                        f"{label} subscriber of {shape.metric} "
                        f"{dict(shape.match)}")
            tot = storm.totals()
            lats = tot["latencies"]
            if lats:
                round_push_p99.append(lats[int(0.99 * (len(lats) - 1))])
            if r == kill_round:
                pre_kill = storm.totals()
                victim = reps[0]
                with storm._lock:
                    victim_subs = sum(
                        1 for c in storm.conns.values()
                        if c["label"] == victim.name and not c["closed"])
                storm.mark_dead(victim.name)
                victim.kill()
                result["replica_kill"] = {
                    "victim": victim.name,
                    "subscribers_at_kill": victim_subs,
                    "reconnects_before": pre_kill["reconnects"],
                }
        # Post-kill: every orphaned subscriber must be back on a live
        # peer with a fresh snapshot (degradation contained to the
        # victim's own viewers).
        if kill_round >= 0:
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                tot = storm.totals()
                if tot["live"] >= result["connected"]:
                    break
                time.sleep(0.1)
            tot = storm.totals()
            rk = result["replica_kill"]
            rk["reconnects_after"] = tot["reconnects"]
            rk["live_after"] = tot["live"]
            if tot["live"] < result["connected"]:
                fails.append(
                    f"replica kill: only {tot['live']} of "
                    f"{result['connected']} subscribers live after "
                    f"reconnect window")
            if tot["reconnects"] < rk["subscribers_at_kill"]:
                fails.append(
                    f"replica kill: {rk['subscribers_at_kill']} "
                    f"subscribers orphaned but only {tot['reconnects']} "
                    f"reconnected")
            # Survivors' streams untouched: reconnect count equals the
            # victim's subscriber count (no collateral drops).
            if tot["reconnects"] > rk["subscribers_at_kill"] + max(
                    2, rk["subscribers_at_kill"] // 10):
                fails.append(
                    f"replica kill: {tot['reconnects']} reconnects for "
                    f"{rk['subscribers_at_kill']} orphaned subscribers — "
                    f"survivors were disrupted too")
            # One settle round so reconnected subscribers resync, then
            # re-verify equality across every endpoint.
            tick_all()
            expect = {label: h.shape_seqs() for label, h in hubs.items()
                      if label != reps[0].name}
            storm.wait_caught_up(expect, timeout_s=gen_wait_s)
            for label, shape, rows, gen in storm.sample(12):
                env = planes[label](shape, gen or 0)
                equality_checked += 1
                if rows != rows_map(shape.route, env):
                    equality_failures += 1
                    fails.append(
                        f"post-kill settle: replay != polled answer on "
                        f"{label}")

        # Subscriber-shed semantics: pressure on the root hub sheds the
        # oldest half with a labeled shed frame; the shed viewers
        # reconnect (to any live endpoint) and the counter records it.
        root_subs_before = root_hub.subscribers
        shed_n = root_hub.shed_oldest(0.5, reason="pressure")
        time.sleep(0.5)
        b = SnapshotBuilder()
        root_hub.emit(b)
        snap = b.build(timestamp=time.time())
        shed_counted = snap.value("tpu_stream_sheds_total",
                                  ("pressure",)) or 0.0
        result["shed"] = {"root_subs_before": root_subs_before,
                          "shed": shed_n, "counted": shed_counted}
        if shed_n and shed_counted < shed_n:
            fails.append(
                f"shed {shed_n} subscribers but counter shows "
                f"{shed_counted}")

        # Pull baseline: what the same viewers would cost as polling —
        # one keep-alive client hammering the polled route (generation-
        # cache-hot, the PRE-inversion best case). The storm's per-round
        # cost for comparison: one delta computation per shape plus one
        # small write per subscriber.
        import http.client

        poll_path = ("/api/v1/window_stats?metric=tpu_hbm_used_bytes"
                     "&window=60")
        conn = http.client.HTTPConnection("127.0.0.1", root_server.port,
                                          timeout=10)
        pull_n = min(max(subs // 4, 50), 1000)
        pull_bytes = 0
        t0 = time.perf_counter()
        try:
            for _ in range(pull_n):
                conn.request("GET", poll_path)
                r_ = conn.getresponse()
                pull_bytes += len(r_.read())
        finally:
            conn.close()
        pull_took = time.perf_counter() - t0
        result["pull_baseline"] = {
            "requests": pull_n,
            "qps_one_client": round(pull_n / max(pull_took, 1e-9), 1),
            "bytes_per_answer": pull_bytes // max(pull_n, 1),
            "note": ("full body per viewer per refresh, cache-hot; the "
                     "push plane ships changed rows only, once per round "
                     "per subscriber"),
        }

        tot = storm.totals()
        rss_after = utils.process_rss_bytes() or 0
        result["push_p99_s"] = (max(round_push_p99)
                                if round_push_p99 else None)
        result["push_p99_budget_s"] = push_p99_budget_s
        result["gaps"] = tot["gaps"]
        result["dups"] = tot["dups"]
        result["desynced"] = tot["desynced"]
        result["frames_delivered"] = tot["frames"]
        result["equality_checked"] = equality_checked
        result["equality_failures"] = equality_failures
        result["rss_before_mb"] = round(rss_before / 2**20, 1)
        result["rss_after_mb"] = round(rss_after / 2**20, 1)
        result["rss_delta_mb"] = round((rss_after - rss_before) / 2**20, 1)
        stats = root_hub.stats()
        result["root_hub"] = stats
        if negative:
            # The negative control PASSES only by FAILING: dropped deltas
            # must surface as equality failures (or explicit gaps).
            if equality_failures == 0 and tot["gaps"] == 0:
                fails.append(
                    "NEGATIVE CONTROL: deltas were dropped client-side "
                    "but no invariant caught it")
            else:
                result["ok"] = True
                result["negative_detected"] = equality_failures + tot["gaps"]
                result["took_s"] = round(time.perf_counter() - t_start, 3)
                return result
        if equality_failures:
            pass  # already recorded per round
        if tot["gaps"] or tot["dups"]:
            fails.append(
                f"seq discontinuities: {tot['gaps']} gaps, "
                f"{tot['dups']} dups across subscribers")
        if result["push_p99_s"] is not None and (
                result["push_p99_s"] > push_p99_budget_s):
            fails.append(
                f"per-round push p99 {result['push_p99_s']:.3f}s over "
                f"budget {push_p99_budget_s}s")
        if result["rss_delta_mb"] > rss_cap_mb:
            fails.append(
                f"RSS grew {result['rss_delta_mb']} MiB under the storm "
                f"(cap {rss_cap_mb})")
        result["ok"] = not fails
        result["took_s"] = round(time.perf_counter() - t_start, 3)
        return result
    finally:
        storm.stop()
        root_server.stop()
        root_hub.close()
        root_plane.close()
        for rep in reps:
            rep.close()
        sim.close()
        try:
            with open(os.path.join(state_root, "dashboard-result.json"),
                      "w", encoding="utf-8") as f:
                json.dump(result, f, indent=1, default=str)
        except OSError:
            pass


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="tpu-loadgen-fleet",
        description="Simulated-fleet acceptance harnesses: the federated "
                    "query plane (make fleet-query-demo) and the sharded "
                    "HA aggregation tree (make shard-demo).",
    )
    p.add_argument("--mode", default="query",
                   choices=("query", "shard", "dashboard"),
                   help="query = fleet-query demo (default); shard = "
                        "sharded-tree churn/kill demo; dashboard = "
                        "streaming viewer-storm drill (subscriptions vs "
                        "one root + N read replicas)")
    p.add_argument("--shards", type=int, default=8,
                   help="[shard] consistent-hash shard count")
    p.add_argument("--no-ha", dest="ha", action="store_false", default=True,
                   help="[shard] single leaf per shard (no HA pairs)")
    p.add_argument("--churn", type=int, default=32,
                   help="[shard] churn-wave size (targets removed + added)")
    p.add_argument("--round-budget-s", type=float, default=15.0,
                   help="[shard] max full-round (leaf tier + root) wall time")
    p.add_argument("--stale-budget-s", type=float, default=5.0,
                   help="[shard] max HA-twin staleness after a leaf kill")
    p.add_argument("--state-root", default="shard-demo-state",
                   help="[shard] state dir (breaker/shard-map carryover; "
                        "uploaded as a CI artifact on failure)")
    p.add_argument("--gpu-slices", type=int, default=2,
                   help="[shard] farm slices (of 8) that are GPU node "
                        "pools — the mixed-fleet half of the demo; 0 for "
                        "a homogeneous TPU farm")
    p.add_argument("--targets", type=int, default=64)
    p.add_argument("--chips", type=int, default=4, help="chips per host")
    p.add_argument("--polls", type=int, default=10,
                   help="history-priming polls before aggregation")
    p.add_argument("--interval-s", type=float, default=0.02,
                   help="pause between priming polls")
    p.add_argument("--queries", type=int, default=40,
                   help="latency-measurement queries (cache-busted)")
    p.add_argument("--budget-ms", type=float, default=1500.0,
                   help="fleet query p99 budget")
    p.add_argument("--kill-one", action="store_true", default=True)
    p.add_argument("--no-kill", dest="kill_one", action="store_false",
                   help="skip the mid-run target kill")
    p.add_argument("--no-persist", dest="persist", action="store_false",
                   default=True, help="disable per-target persistence")
    p.add_argument("--subs", type=int, default=5000,
                   help="[dashboard] concurrent stream subscriptions")
    p.add_argument("--replicas", type=int, default=2,
                   help="[dashboard] stateless read replicas beside the "
                        "root")
    p.add_argument("--rounds", type=int, default=10,
                   help="[dashboard] storm rounds to drive")
    p.add_argument("--push-p99-budget-s", type=float, default=1.0,
                   help="[dashboard] per-round push latency p99 budget")
    p.add_argument("--rss-cap-mb", type=float, default=128.0,
                   help="[dashboard] max RSS growth under the storm")
    p.add_argument("--negative", action="store_true",
                   help="[dashboard] NEGATIVE CONTROL: drop one delta "
                        "frame per subscriber client-side; the run "
                        "passes only if the replay-equality invariant "
                        "catches it")
    p.add_argument("--no-replica-kill", dest="replica_kill",
                   action="store_false", default=True,
                   help="[dashboard] skip the mid-storm replica kill")
    ns = p.parse_args(argv)

    if ns.mode == "dashboard":
        result = run_dashboard_demo(
            ns.targets, ns.shards, ns.chips, ns.subs, ns.rounds,
            ns.replicas, ns.state_root,
            push_p99_budget_s=ns.push_p99_budget_s,
            rss_cap_mb=ns.rss_cap_mb, negative=ns.negative,
            kill_replica=ns.replica_kill,
        )
        print(json.dumps({k: v for k, v in result.items()
                          if k != "root_hub"}, indent=1, default=str))
        if not result["ok"]:
            print(f"DASHBOARD DEMO FAILED: {result['failures']}",
                  file=sys.stderr)
            return 1
        mode = "negative control" if ns.negative else "storm"
        print(
            f"dashboard-demo OK ({mode}): {result['connected']} "
            f"subscriptions vs 1 root + {ns.replicas} replica(s) at "
            f"{ns.targets} targets, {result['frames_delivered']} frames, "
            f"push p99 {result['push_p99_s']}s "
            f"(budget {ns.push_p99_budget_s}s), gaps {result['gaps']}, "
            f"dups {result['dups']}, RSS {result['rss_delta_mb']:+} MiB, "
            f"equality {result['equality_checked']} checks / "
            f"{result['equality_failures']} failures"
        )
        return 0

    if ns.mode == "shard":
        result = run_shard_demo(
            ns.targets, ns.shards, ns.ha, ns.chips, ns.churn,
            ns.round_budget_s, ns.stale_budget_s, ns.state_root,
            gpu_slices=ns.gpu_slices,
        )
        print(json.dumps(result, indent=1))
        try:
            # Into the state root: CI uploads the dir on failure, and the
            # executed timeline + per-phase verdicts ARE the forensics.
            with open(f"{ns.state_root}/result.json", "w",
                      encoding="utf-8") as f:
                json.dump(result, f, indent=1)
        except OSError:
            pass
        if not result["ok"]:
            print(f"SHARD DEMO FAILED: {result.get('error')}",
                  file=sys.stderr)
            return 1
        t = result["timings"]
        print(
            f"shard-demo OK: {ns.targets} targets / {ns.shards} shards "
            f"(HA={'on' if ns.ha else 'off'}, families "
            f"{result['baseline']['family_chips']}), mid-round leaf kill → "
            f"0 series lost, churn {ns.churn} → "
            f"{result['churn']['assignment_moves']} moves "
            f"(bound {result['churn']['bound']}), round max "
            f"{t['full_max_s']}s (budget {t['budget_s']}s)"
        )
        return 0

    result = run_demo(
        ns.targets, ns.chips, ns.polls, ns.interval_s,
        ns.queries, ns.budget_ms, ns.kill_one, ns.persist,
    )
    print(json.dumps(result, indent=1))
    if not result["ok"]:
        print(f"FLEET QUERY DEMO FAILED: {result.get('error')}",
              file=sys.stderr)
        return 1
    print(
        f"fleet-query-demo OK: {ns.targets} targets, "
        f"p99 {result['query_p99_ms']}ms (budget {ns.budget_ms:.0f}ms), "
        f"kill→partial asserted" if ns.kill_one else "kill skipped",
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
