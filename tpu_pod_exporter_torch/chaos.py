"""Deterministic fault injection — the chaos harness for source supervision.

Wraps any poll source (device backend, attribution provider, process
scanner) and injects faults on a **seeded, reproducible schedule**:

- ``hang``    — block the call for a duration (exercises the phase
  deadline + abandoned-worker path in ``supervisor.py``);
- ``err``     — raise :class:`ChaosError` (the ordinary error-containment
  path);
- ``slow``    — add latency, then proceed (deadline-adjacent but returning);
- ``garbage`` — return a *well-formed but bogus* value (negative HBM, NaN
  duty cycle, label-hostile pod names) so value-robustness is exercised,
  not just control flow.
- ``kill``    — SIGKILL the whole process mid-call: no drain, no flush, no
  atexit — the crash the persistence layer (``persist.py``) must survive.
  Exercised by ``make restart-demo``.

Spec grammar (``--chaos-spec``, test-only flag)::

    spec  := rule ("," rule)*
    rule  := kind ":" source (":" token)*
    kind  := hang | err | slow | garbage | kill | reject | truncate
    source:= device | attribution | procscan | recv

The ``recv`` source is the **remote-write receiver** (:class:`ChaosReceiver`
— an in-process HTTP receiver the egress shipper posts batches at, used by
``make egress-demo`` and ``tests/test_egress.py``) rather than a wrapped
poll source: ``hang``/``slow`` park the request, ``err`` answers 500,
``reject`` answers 429 (backpressure), and ``truncate`` reads part of the
request body then drops the connection mid-transfer. ``reject``/``truncate``
are receiver-only; ``garbage``/``kill`` are source-only.

Tokens after the source are order-free: a bare float in [0, 1] is the
per-call probability (default 1.0), a duration with a unit ("500ms",
"10s", "0.3s") is the hang/slow length, ``xN`` caps the rule at N
injections total, and ``@N`` arms the rule only from call index N on
(0-based — the knob that places a kill *mid-run*, after state worth
persisting exists). Examples::

    hang:device:0.01                 1% of device reads hang (default 3600s)
    err:attribution:0.05             5% of attribution reads raise
    slow:procscan:500ms              every process scan takes +500ms
    hang:device:1:10s:x3             the first three device reads hang 10s
    kill:device:1:@20:x1             SIGKILL on the 21st device read

Determinism: each source draws from its own ``random.Random`` seeded with
``f"{seed}:{source}"``, and the single poll thread calls sources in a fixed
order — so a given (spec, seed) injects the same faults on the same call
indices on every run, regardless of wall-clock timing. Used by
``tests/test_chaos.py`` and ``make chaos-demo``.
"""

from __future__ import annotations

import logging
import random
import re
import threading
import time
from dataclasses import dataclass, field

from tpu_pod_exporter_torch import trace as trace_mod

log = logging.getLogger("tpu_pod_exporter_torch.chaos")

KINDS = ("hang", "err", "slow", "garbage", "kill", "reject", "truncate")
SOURCES = ("device", "attribution", "procscan", "recv")

# The remote-write receiver target (``recv``) injects wire-level faults
# the wrapped in-process sources have no analog for — and vice versa.
RECEIVER_ONLY_KINDS = ("reject", "truncate")
RECEIVER_INVALID_KINDS = ("garbage", "kill")

DEFAULT_HANG_S = 3600.0   # "forever" at poll-loop scale; the deadline fences it
DEFAULT_SLOW_S = 0.25

_DURATION_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s)$")
_COUNT_RE = re.compile(r"^x(\d+)$")
_OFFSET_RE = re.compile(r"^@(\d+)$")


# --------------------------------------------------------------- seam registry
#
# Every distinct place this toolbox (plus the scenario engine driving it)
# can inject a fault, enumerable at runtime. The fuzzer's coverage ledger
# keys its (seam × invariant) matrix off this registry and cross-checks it
# against the DSL's kind→seam map in BOTH directions, so an injector added
# here without a generator (or a generator naming a ghost seam) fails a
# tier-1 test instead of being silently omitted from coverage.

@dataclass(frozen=True)
class Seam:
    """One injection seam: a named fault surface and the mechanism that
    cuts it (class or engine hook), for the coverage report."""

    name: str
    description: str


SEAM_REGISTRY: dict[str, Seam] = {}


def register_seam(name: str, description: str) -> Seam:
    """Register one seam (module-import time, next to its injector). Loud
    on duplicates: two injectors claiming one seam would make the
    coverage matrix under-count."""
    if name in SEAM_REGISTRY:
        raise ValueError(f"chaos seam {name!r} registered twice")
    seam = Seam(name=name, description=description)
    SEAM_REGISTRY[name] = seam
    return seam


def registered_seams() -> tuple[str, ...]:
    """Sorted seam names — the coverage matrix's row space."""
    return tuple(sorted(SEAM_REGISTRY))


# The wire seams PartitionState/PartitionedFetch/PartitionedSend cut, one
# per tier edge the stack actually crosses (scenario.PARTITION_EDGES).
register_seam("wire:node-leaf",
              "leaf→target scrape fetches (PartitionedFetch at the leaf "
              "poll seam)")
register_seam("wire:leaf-root",
              "root→leaf merge fetches + query fan-out (PartitionedFetch "
              "at the root seam)")
register_seam("wire:root-recv",
              "root→receiver remote-write posts (PartitionedSend at the "
              "egress seam)")
# Host-level injectors.
register_seam("wallclock",
              "NTP-shaped wall-clock steps (ClockStepper — the egress "
              "clock fence's subject)")
register_seam("memory",
              "memory-budget collapse over the byte-accounted caches "
              "(MemoryHog / the governor's squeezed memory budget)")
register_seam("disk",
              "disk-budget collapse under the durable-state dirs (the "
              "governor's squeezed disk budget)")
register_seam("serving",
              "aggressive keep-alive scrape load on the serving tier "
              "(ScrapeStorm vs the admission caps)")
register_seam("receiver",
              "remote-write receiver outage/flap (ChaosReceiver "
              "set_outage — breaker + backlog + exactly-once drain)")
# Process/fleet seams the scenario engine injects through the sim.
register_seam("target-process",
              "target processes dying and returning (farm dead set: "
              "preempt / restart_wave)")
register_seam("root-process",
              "SIGKILL-shaped root death + fresh-instance restart "
              "(_ShardSim.kill_root/restart_root)")
register_seam("workload",
              "workload behavior shifts: hotspot duty/HBM spikes and "
              "pod label churn (farm hot set / pod_gen)")
register_seam("membership",
              "targets-file membership churn (add/remove waves through "
              "the shared targets file)")
register_seam("stream",
              "streaming dashboard subscription load against "
              "/api/v1/stream (_StormSubscribers vs the hub caps)")


class ChaosError(RuntimeError):
    """An injected source failure (the ``err`` fault kind)."""


@dataclass
class ChaosRule:
    kind: str
    source: str
    prob: float = 1.0
    duration_s: float | None = None  # hang/slow length; kind-default if None
    max_count: int | None = None     # total injection cap; None = unlimited
    min_index: int = 0               # rule armed from this call index on (@N)
    # err:device rules may speak exact NVML error shapes
    # (``err:device:1:nvml=gpu_is_lost``): the injected exception is an
    # NvmlError carrying this code, so GPU-path drills exercise the same
    # typed failures the reference dies on (main.go:119-137).
    nvml_code: str = ""
    fired: int = field(default=0, compare=False)

    @property
    def effective_duration_s(self) -> float:
        if self.duration_s is not None:
            return self.duration_s
        return DEFAULT_HANG_S if self.kind == "hang" else DEFAULT_SLOW_S


def parse_chaos_spec(spec: str) -> list[ChaosRule]:
    """``--chaos-spec`` string → rule list. Raises ValueError loudly on any
    malformed rule — a typo'd chaos spec must fail at startup, not silently
    inject nothing during the test it was written for."""
    rules: list[ChaosRule] = []
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        if len(parts) < 2:
            raise ValueError(f"chaos rule {raw!r}: want kind:source[:tokens]")
        kind, source = parts[0].strip().lower(), parts[1].strip().lower()
        if kind not in KINDS:
            raise ValueError(f"chaos rule {raw!r}: unknown kind {kind!r} "
                             f"(want one of {'/'.join(KINDS)})")
        if source not in SOURCES:
            raise ValueError(f"chaos rule {raw!r}: unknown source {source!r} "
                             f"(want one of {'/'.join(SOURCES)})")
        if kind in RECEIVER_ONLY_KINDS and source != "recv":
            raise ValueError(f"chaos rule {raw!r}: kind {kind!r} is only "
                             f"valid for the recv (remote-write receiver) "
                             f"source")
        if source == "recv" and kind in RECEIVER_INVALID_KINDS:
            raise ValueError(f"chaos rule {raw!r}: kind {kind!r} is not "
                             f"valid for the recv source (the receiver "
                             f"answers requests; it has no payload or "
                             f"process to corrupt)")
        rule = ChaosRule(kind=kind, source=source)
        for tok in parts[2:]:
            tok = tok.strip().lower()
            if not tok:
                continue
            m = _DURATION_RE.match(tok)
            if m:
                v = float(m.group(1))
                rule.duration_s = v / 1000.0 if m.group(2) == "ms" else v
                continue
            m = _COUNT_RE.match(tok)
            if m:
                rule.max_count = int(m.group(1))
                continue
            m = _OFFSET_RE.match(tok)
            if m:
                rule.min_index = int(m.group(1))
                continue
            if tok.startswith("nvml="):
                if kind != "err" or source != "device":
                    raise ValueError(
                        f"chaos rule {raw!r}: nvml= codes only apply to "
                        f"err:device rules (the NVML-shaped GPU backend)"
                    )
                from tpu_pod_exporter_torch.backend.nvml import normalize_nvml_code

                try:
                    rule.nvml_code = normalize_nvml_code(tok[5:])[0]
                except ValueError as e:
                    raise ValueError(f"chaos rule {raw!r}: {e}") from None
                continue
            try:
                p = float(tok)
            except ValueError:
                raise ValueError(
                    f"chaos rule {raw!r}: token {tok!r} is neither a "
                    f"probability, a duration (500ms/10s), a count (x3), "
                    f"nor a call offset (@20)"
                ) from None
            if not 0.0 <= p <= 1.0:
                raise ValueError(
                    f"chaos rule {raw!r}: bare number {tok!r} must be a "
                    f"probability in [0, 1]; use units for durations (e.g. "
                    f"{tok}s)"
                )
            rule.prob = p
        rules.append(rule)
    if not rules:
        raise ValueError(f"chaos spec {spec!r} contains no rules")
    return rules


# --- Garbage generators ------------------------------------------------------
# Well-formed-but-bogus values, per wrapped method: they must flow through
# the collector's normal code paths (that is the point — value robustness),
# so the types are real, only the contents are hostile.


def _garbage_sample(rng: random.Random):
    from tpu_pod_exporter_torch.backend import (
        ChipInfo,
        ChipSample,
        HostSample,
        IciLinkSample,
    )

    return HostSample(
        chips=(
            ChipSample(
                info=ChipInfo(chip_id=999, device_path="/dev/chaos999"),
                hbm_used_bytes=-float(rng.randrange(1, 2**40)),
                hbm_total_bytes=0.0,
                tensorcore_duty_cycle_percent=float("nan"),
                # Counter regression: the monotonic fold must clamp it.
                ici_links=(IciLinkSample("0", -1.0),),
            ),
        ),
        partial_errors=("chaos: garbage sample",),
    )


def _garbage_snapshot(rng: random.Random):
    from tpu_pod_exporter_torch.attribution import (
        AttributionSnapshot,
        DeviceAllocation,
    )

    # Label-hostile identity: escaping bugs in the renderer or a consumer
    # would corrupt the exposition framing exactly here.
    return AttributionSnapshot(
        allocations=(
            DeviceAllocation(
                pod='chaos"pod\n\\' + str(rng.randrange(10)),
                namespace="chaos\tns",
                container="c☃",
                device_ids=("0",),
            ),
        ),
    )


def _garbage_scan(rng: random.Random):  # noqa: ARG001 — signature symmetry
    return []


_GARBAGE = {
    "sample": _garbage_sample,
    "snapshot": _garbage_snapshot,
    "scan": _garbage_scan,
}


class ChaosWrapper:
    """Duck-typed chaos proxy for any poll source.

    Exposes ``sample``/``snapshot``/``scan`` (whichever the inner object
    has is the one the collector calls) plus ``close()`` passthrough so the
    supervisor's reconnect hook reaches the real source. Injections happen
    *outside* any inner lock — a hang parks only the caller (or its
    supervised worker), never the source's internal state.
    """

    def __init__(
        self,
        inner,
        source: str,
        rules: list[ChaosRule],
        seed: int = 0,
        sleep=time.sleep,
    ) -> None:
        self._inner = inner
        self.source = source
        self.rules = [r for r in rules if r.source == source]
        self._rng = random.Random(f"{seed}:{source}")
        # Garbage payload contents draw from their OWN stream: the schedule
        # rng must consume exactly one draw per rule per call (the
        # determinism invariant), and payload generation takes a varying
        # number of draws.
        self._garbage_rng = random.Random(f"{seed}:{source}:garbage")
        self._sleep = sleep
        self.calls = 0
        # (call_index, kind) per injection — the deterministic schedule,
        # asserted verbatim by tests.
        self.injected: list[tuple[int, str]] = []

    @property
    def name(self) -> str:
        return f"chaos({getattr(self._inner, 'name', '?')})"

    def _invoke(self, method: str, *args, **kwargs):
        idx = self.calls
        self.calls += 1
        # Every rule consumes exactly one rng draw per call, no matter what
        # earlier rules did: the schedule of one rule can never shift
        # because another rule fired, was capped out, or was removed —
        # determinism is per (rule position, call index), not per hit. The
        # first hitting, non-exhausted rule (spec order) is the one applied.
        triggered: ChaosRule | None = None
        for rule in self.rules:
            draw = self._rng.random()
            if (
                triggered is None
                and draw < rule.prob
                and idx >= rule.min_index
                and (rule.max_count is None or rule.fired < rule.max_count)
            ):
                triggered = rule
        if triggered is not None:
            triggered.fired += 1
            self.injected.append((idx, triggered.kind))
            log.debug("chaos: %s[%d] %s", self.source, idx, triggered.kind)
            # Annotate the active phase span (the supervisor propagates the
            # poll's trace context onto its worker threads, so this lands on
            # the right span even when the injection runs supervised): an
            # injected wedge must read as a *caused* incident in the trace.
            detail = ""
            if triggered.kind in ("hang", "slow"):
                detail = f" {triggered.effective_duration_s:g}s"
            trace_mod.annotate(
                f"chaos: injected {triggered.kind}{detail} "
                f"(call {idx}, rule {triggered.kind}:{triggered.source})"
            )
            if triggered.kind == "kill":
                # The crash persistence must survive: SIGKILL, delivered to
                # ourselves, mid-call — no drain, no Python cleanup, no
                # buffered-write flush. Anything not already fsynced is
                # gone, which is the point (make restart-demo).
                import os
                import signal

                log.critical("chaos: SIGKILL mid-%s-call (call %d)",
                             self.source, idx)
                os.kill(os.getpid(), signal.SIGKILL)
            if triggered.kind in ("hang", "slow"):
                # Sleep OUTSIDE any inner lock, then proceed with the real
                # call — a wedged-then-released source returns real data.
                self._sleep(triggered.effective_duration_s)
            elif triggered.kind == "err":
                if triggered.nvml_code:
                    from tpu_pod_exporter_torch.backend.nvml import NvmlError

                    raise NvmlError(
                        f"chaos: injected {self.source} error (call {idx})",
                        triggered.nvml_code,
                    )
                raise ChaosError(
                    f"chaos: injected {self.source} error (call {idx})"
                )
            elif triggered.kind == "garbage":
                return _GARBAGE[method](self._garbage_rng)
        return getattr(self._inner, method)(*args, **kwargs)

    # The collector calls exactly one of these per source kind.
    def sample(self):
        return self._invoke("sample")

    def snapshot(self):
        return self._invoke("snapshot")

    def scan(self):
        return self._invoke("scan")

    def close(self) -> None:
        close = getattr(self._inner, "close", None)
        if close is not None:
            close()

    def __getattr__(self, item):
        # Introspection passthrough (e.g. FakeBackend.fail_next in tests).
        return getattr(self._inner, item)


def apply_chaos(spec: str, seed: int, backend, attribution, scanner):
    """Wrap the three poll sources per ``spec``. Sources with no matching
    rules are returned unwrapped; returns (backend, attribution, scanner,
    {source: ChaosWrapper}) with the wrapper map for /debug/vars."""
    rules = parse_chaos_spec(spec)
    wrappers: dict[str, ChaosWrapper] = {}
    by_source = {s: [r for r in rules if r.source == s] for s in SOURCES}
    if by_source["device"] and backend is not None:
        backend = wrappers["device"] = ChaosWrapper(
            backend, "device", by_source["device"], seed
        )
    if by_source["attribution"] and attribution is not None:
        attribution = wrappers["attribution"] = ChaosWrapper(
            attribution, "attribution", by_source["attribution"], seed
        )
    if by_source["procscan"] and scanner is not None:
        scanner = wrappers["procscan"] = ChaosWrapper(
            scanner, "procscan", by_source["procscan"], seed
        )
    return backend, attribution, scanner, wrappers


# --- Network partitions (fleet scenario engine) ------------------------------
#
# Partitions are injected at the HTTP *fetch seam*: every tier-to-tier call
# in the stack (leaf → node scrape, root → leaf scrape, fleet-query
# fan-out, egress send) goes through an injectable callable, so ONE wrapper
# composes with every tier. A cut raises the same ConnectionError a real
# unreachable network yields — the wrapped tier cannot tell chaos from an
# actual partition, which is the point.


class PartitionError(ConnectionError):
    """An injected network cut (the fetch never reached the peer)."""


def _sel_matches(selector: str, addr: str) -> bool:
    """``selector`` matches ``addr`` when equal, or when the selector is a
    bare tier and the addr is an instance of it (``leaf`` matches
    ``leaf:1a``; ``leaf:1a`` matches only itself)."""
    return addr == selector or addr.split(":", 1)[0] == selector


@dataclass
class Cut:
    """One directed edge cut. ``src``/``dst`` are tier selectors —
    ``"root"``, ``"leaf"``, ``"leaf:1a"``, ``"node"``, ``"node:17"``,
    ``"recv"`` — a bare tier matches every instance. ``flapping`` cuts
    only on alternating engine rounds (deterministic: seeded phase +
    round parity, no wall clock), so a flapping edge is open and cut on a
    reproducible schedule."""

    src: str
    dst: str
    flapping: bool = False
    since_round: int = 0
    phase: int = 0  # seeded flap phase: cut when (round - phase) is even


class PartitionState:
    """The fault switchboard every :class:`PartitionedFetch` /
    :class:`PartitionedSend` consults. Thread-safe for concurrent fetch
    threads (scrape pools, query fan-out, the egress sender); mutation
    happens from the scenario driver between rounds.

    ``round`` is the engine's logical clock: flapping cuts key their
    open/cut alternation off it so the schedule is deterministic under a
    fixed seed regardless of thread timing."""

    def __init__(self, seed: int = 0) -> None:
        self._lock = threading.Lock()
        self._cuts: list[Cut] = []
        self._rng = random.Random(f"{seed}:partition")
        self.round = 0
        # (round, "cut|heal", src, dst) — the injected history, for traces.
        self.log: list[tuple[int, str, str, str]] = []

    def advance(self, round_idx: int) -> None:
        with self._lock:
            self.round = round_idx

    def cut(self, src: str, dst: str, flapping: bool = False) -> None:
        """Cut the directed edge src→dst (selectors, see :class:`Cut`).
        Symmetric partitions are two cuts; asymmetric ones are one."""
        with self._lock:
            phase = self._rng.randrange(2) if flapping else 0
            self._cuts.append(Cut(src=src, dst=dst, flapping=flapping,
                                  since_round=self.round, phase=phase))
            self.log.append((self.round, "cut", src, dst))

    def heal(self, src: str, dst: str) -> None:
        """Remove every cut matching exactly (src, dst) as given."""
        with self._lock:
            self._cuts = [
                c for c in self._cuts if not (c.src == src and c.dst == dst)
            ]
            self.log.append((self.round, "heal", src, dst))

    def heal_all(self) -> None:
        with self._lock:
            for c in self._cuts:
                self.log.append((self.round, "heal", c.src, c.dst))
            self._cuts = []

    def is_cut(self, src: str, dst: str) -> bool:
        """Is the concrete edge src→dst cut right now (both are instance
        addresses; cuts may be tier-wide selectors)?"""
        with self._lock:
            rnd = self.round
            for c in self._cuts:
                if not (_sel_matches(c.src, src) and _sel_matches(c.dst, dst)):
                    continue
                if c.flapping and (rnd - c.phase) % 2 != 0:
                    continue  # the flap's open half-round
                return True
            return False

    def active(self) -> list[tuple[str, str, bool]]:
        """Currently-effective cuts as (src, dst, flapping) — flapping cuts
        are listed only on their cut half-rounds."""
        with self._lock:
            rnd = self.round
            return [
                (c.src, c.dst, c.flapping)
                for c in self._cuts
                if not (c.flapping and (rnd - c.phase) % 2 != 0)
            ]

    def any_cuts(self) -> bool:
        """Any cut INSTALLED (flapping ones count even on their open
        half-round — the window is still an injected-fault window)."""
        with self._lock:
            return bool(self._cuts)


class PartitionedFetch:
    """Wrap any ``fetch(target, timeout_s[, traceparent])`` seam with a
    partition check: when the (src, dst(target)) edge is cut the call
    raises :class:`PartitionError` without touching the wire — exactly a
    black-holed SYN from the caller's point of view, minus the timeout
    burn (the drills inject hundreds of cut calls per round).

    Deliberately a 2-arg callable: the aggregator tiers auto-detect
    traceparent support by signature, and the wrapper must not promise a
    kwarg it cannot forward to arbitrary inner fetches.
    """

    def __init__(self, net: PartitionState, src: str,
                 dst_of, inner) -> None:
        self._net = net
        self.src = src
        self._dst_of = dst_of  # target/url -> instance addr ("node:17", "leaf:1a")
        self._inner = inner
        self.blocked = 0

    def __call__(self, target: str, timeout_s: float) -> str:
        dst = self._dst_of(target)
        if self._net.is_cut(self.src, dst):
            self.blocked += 1
            raise PartitionError(
                f"partition: {self.src} -> {dst} is cut ({target})"
            )
        return self._inner(target, timeout_s)


class PartitionedSend:
    """The egress half of the seam: wraps an egress ``send(url, body,
    headers, timeout_s)`` callable (``egress.RemoteWriteShipper``'s
    injectable sender) with the same switchboard check."""

    def __init__(self, net: PartitionState, src: str, dst: str,
                 inner) -> None:
        self._net = net
        self.src = src
        self.dst = dst
        self._inner = inner
        self.blocked = 0

    def __call__(self, url: str, body: bytes, headers, timeout_s: float) -> int:
        if self._net.is_cut(self.src, self.dst):
            self.blocked += 1
            raise PartitionError(
                f"partition: {self.src} -> {self.dst} is cut ({url})"
            )
        return self._inner(url, body, headers, timeout_s)


# --- Host-level chaos (resource-pressure drills) -----------------------------
#
# The pressure drills (tpu_pod_exporter_torch.pressure, scenario kinds
# ``disk_full`` / ``mem_pressure`` / ``scrape_storm`` / ``clock_step``)
# need faults no wrapped poll source can model: the MACHINE misbehaving.
# Like LeafKillHook, these are timeline-driven harness classes rather than
# ``--chaos-spec`` rules — the scenario engine and ``make pressure-demo``
# fire them at fixed round coordinates, deterministically.


class ClockStepper:
    """An injectable wall clock with a mutable offset — the ``clock_step``
    fault. Components take it as their ``wallclock=`` callable; the drill
    calls :meth:`step` mid-run and asserts the wall-time seams (egress
    batch gating, backlog ages, staleness gauges) stay fenced: ages never
    go negative, and a backward step never silently stops a pipeline."""

    def __init__(self, base: "float | None" = None,
                 real=time.time) -> None:
        self._real = real
        self._base = base
        self.offset_s = 0.0
        self.steps: list[float] = []

    def step(self, seconds: float) -> None:
        """Apply one NTP-shaped step (positive = forward)."""
        self.offset_s += seconds
        self.steps.append(seconds)
        log.warning("chaos: wall clock stepped %+gs (offset now %+gs)",
                    seconds, self.offset_s)

    def __call__(self) -> float:
        now = self._real() if self._base is None else self._base
        return now + self.offset_s


class MemoryHog:
    """Holds real referenced memory (the ``mem_pressure`` fault's RSS
    half): allocates touch-backed bytearrays so the drill's RSS assertions
    measure genuine pages, not lazily-mapped zeros."""

    def __init__(self) -> None:
        self._blocks: list[bytearray] = []

    def hold(self, n_bytes: int, block: int = 1 << 20) -> None:
        remaining = n_bytes
        while remaining > 0:
            size = min(block, remaining)
            buf = bytearray(size)
            # Touch one byte per page so the kernel actually commits it.
            for i in range(0, size, 4096):
                buf[i] = 1
            self._blocks.append(buf)
            remaining -= size

    def held_bytes(self) -> int:
        return sum(len(b) for b in self._blocks)

    def release(self) -> None:
        self._blocks.clear()


class ScrapeStorm:
    """A misconfigured scrape fleet: N concurrent connections hammering
    one URL in tight keep-alive loops — the admission-control drill's
    storm half. Each worker binds its own loopback SOURCE address
    (127.0.0.N pool) so the per-client-IP cap sees distinct clients from
    the polite scraper sharing the same box."""

    def __init__(self, host: str, port: int, path: str = "/metrics",
                 conns: int = 100, source_ips: int = 8,
                 pause_s: float = 0.0,
                 reject_pause_s: float = 0.25) -> None:
        self.host = host
        self.port = port
        self.path = path
        self.conns = conns
        self.source_ips = max(source_ips, 1)
        # Per-request pause: 0 is a maximally-hostile tight loop; in-process
        # drills pace slightly so the STORM THREADS' own GIL churn does not
        # drown the polite-scraper measurement they run alongside.
        self.pause_s = pause_s
        # Back-off after a reject/reset before reconnecting: a fraction of
        # the Retry-After: 1 the 429 carries (a storm of merely
        # MISCONFIGURED scrapers retries eventually; one that ignores 429s
        # entirely is modeled with 0 — at the cost of the client threads'
        # own reconnect churn dominating an in-process measurement).
        self.reject_pause_s = reject_pause_s
        self.responses: dict[int, int] = {}   # status -> count
        self.errors = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def _worker(self, idx: int) -> None:
        import http.client

        source = f"127.0.0.{2 + idx % self.source_ips}"
        conn: http.client.HTTPConnection | None = None
        while not self._stop.is_set():
            try:
                if conn is None:
                    conn = http.client.HTTPConnection(
                        self.host, self.port, timeout=5,
                        source_address=(source, 0),
                    )
                conn.request("GET", self.path)
                resp = conn.getresponse()
                resp.read()
                status = resp.status
                if resp.headers.get("Connection") == "close":
                    conn.close()
                    conn = None
                with self._lock:
                    self.responses[status] = (
                        self.responses.get(status, 0) + 1
                    )
                if status == 429 and self.reject_pause_s > 0:
                    self._stop.wait(self.reject_pause_s)
                elif self.pause_s > 0:
                    self._stop.wait(self.pause_s)
            except OSError:
                with self._lock:
                    self.errors += 1
                if conn is not None:
                    conn.close()
                    conn = None
                if self.reject_pause_s > 0:
                    self._stop.wait(self.reject_pause_s)
        if conn is not None:
            conn.close()

    def start(self) -> None:
        if self._threads:
            return
        self._stop.clear()
        self._threads = [
            threading.Thread(
                target=self._worker, args=(i,),
                name=f"tpu-chaos-storm-{i}", daemon=True,
            )
            for i in range(self.conns)
        ]
        for t in self._threads:
            t.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads = []

    def stats(self) -> dict:
        with self._lock:
            return {
                "responses": dict(self.responses),
                "errors": self.errors,
                "served": self.responses.get(200, 0),
                "rejected": self.responses.get(429, 0),
            }


# --- Leaf chaos (sharded aggregation tree) -----------------------------------


@dataclass
class LeafEvent:
    """One scripted action against a leaf aggregator in the shard-demo
    timeline: ``kill`` (SIGKILL-shaped: the leaf's HTTP server stops
    serving and its in-flight round never becomes visible) or ``restart``
    (a fresh leaf process on the same state dir — breaker + shard-map
    carryover is exactly what the restart asserts)."""

    action: str              # "kill" | "restart"
    leaf: str                # leaf id as the harness registered it
    round_idx: int           # driver round the event arms at
    at_call: int | None = None  # kill MID-round, after this many scrapes
    fired: bool = field(default=False, compare=False)


LEAF_ACTIONS = ("kill", "restart")

_LEAF_EVENT_RE = re.compile(
    r"^(?P<action>[a-z]+):(?P<leaf>[^@]+)@(?P<round>\d+)(?:#(?P<call>\d+))?$"
)


def parse_leaf_timeline(spec: str) -> list[LeafEvent]:
    """``--leaf-timeline`` grammar, one event per comma::

        event := action ":" leaf "@" round ["#" call]
        action := kill | restart

    ``kill:1a@3#12`` kills leaf ``1a`` in driver round 3 after its 12th
    target scrape of that round (mid-round — the crash shape the HA dedup
    must absorb); ``restart:1a@6`` brings it back in round 6. Malformed
    events raise ValueError loudly, same contract as parse_chaos_spec."""
    events: list[LeafEvent] = []
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        m = _LEAF_EVENT_RE.match(raw)
        if m is None:
            raise ValueError(
                f"leaf timeline event {raw!r}: want action:leaf@round[#call]"
            )
        action = m.group("action")
        if action not in LEAF_ACTIONS:
            raise ValueError(
                f"leaf timeline event {raw!r}: unknown action {action!r} "
                f"(want one of {'/'.join(LEAF_ACTIONS)})"
            )
        call = m.group("call")
        if action == "restart" and call is not None:
            raise ValueError(
                f"leaf timeline event {raw!r}: #call only applies to kill"
            )
        events.append(LeafEvent(
            action=action,
            leaf=m.group("leaf"),
            round_idx=int(m.group("round")),
            at_call=int(call) if call is not None else None,
        ))
    if not events:
        raise ValueError(f"leaf timeline {spec!r} contains no events")
    return events


class LeafKillHook:
    """Executes a :func:`parse_leaf_timeline` schedule against a running
    leaf tier — the shard-demo's kill switch (``loadgen/fleet.py``).

    The harness provides ``kill_fn(leaf)`` / ``restart_fn(leaf)``;
    whole-round events fire from :meth:`begin_round` (driver thread),
    mid-round kills fire from :meth:`on_scrape`, which the victim leaf's
    fetch wrapper calls per target scrape — concurrently from the leaf's
    scrape pool, hence the lock. Deterministic by construction: events
    fire at fixed (round, call) coordinates, no randomness."""

    def __init__(self, events: "list[LeafEvent]", kill_fn, restart_fn) -> None:
        self.events = list(events)
        self._kill_fn = kill_fn
        self._restart_fn = restart_fn
        self._lock = threading.Lock()
        # (round_idx, action, leaf) per fired event — the executed
        # timeline, asserted by the harness.
        self.executed: list[tuple[int, str, str]] = []

    def begin_round(self, round_idx: int) -> None:
        """Fire restarts and whole-round kills armed at this round (called
        once per driver round, before the leaves poll)."""
        for ev in self.events:
            if ev.fired or ev.round_idx != round_idx:
                continue
            if ev.action == "restart":
                ev.fired = True
                self.executed.append((round_idx, "restart", ev.leaf))
                self._restart_fn(ev.leaf)
            elif ev.action == "kill" and ev.at_call is None:
                ev.fired = True
                self.executed.append((round_idx, "kill", ev.leaf))
                self._kill_fn(ev.leaf)

    def on_scrape(self, leaf: str, round_idx: int, call_idx: int) -> bool:
        """Mid-round kill check, called per target scrape from the leaf's
        fetch path; True exactly once, when the leaf just died."""
        with self._lock:
            fire = None
            for ev in self.events:
                if (
                    not ev.fired
                    and ev.action == "kill"
                    and ev.at_call is not None
                    and ev.leaf == leaf
                    and ev.round_idx == round_idx
                    and call_idx >= ev.at_call
                ):
                    fire = ev
                    break
            if fire is None:
                return False
            fire.fired = True
            self.executed.append((round_idx, "kill", leaf))
        self._kill_fn(leaf)
        return True


# --- Chaos remote-write receiver ---------------------------------------------


class ChaosReceiver:
    """In-process Prometheus remote-write receiver with a seeded fault
    schedule — the wire-side twin of :class:`ChaosWrapper`, proving the
    egress breaker + WAL story end to end (``make egress-demo``).

    Applies ``recv``-source rules per request index with the same
    one-rng-draw-per-rule-per-request determinism as the wrapper: ``hang``
    parks the request for its duration then answers 503 (the client has
    long since timed out — answering 200 after the client gave up would
    poison the exactly-once ledger), ``err`` → 500, ``reject`` → 429,
    ``slow`` sleeps then accepts, ``truncate`` reads part of the body and
    drops the connection mid-transfer.

    Accepted batches are decoded (vendored snappy + protobuf decoders from
    ``tpu_pod_exporter_torch.egress``) into a ledger: batch seqs (from the
    shipper's ``X-Tpe-Egress-Seq`` header), per-(series, timestamp) sample
    identity, and duplicate counts — the demo's zero-loss / no-acked-
    re-send assertions read straight off it. A batch is recorded only
    AFTER its 200 response was written successfully: if the client vanished
    mid-response the write raises and the batch stays unaccounted, exactly
    as the sender (which saw a failure and will re-send) believes.

    ``poison_seqs`` (test knob): respond 400 to those batch seqs — the
    shipper must count-and-skip them without wedging the queue.
    """

    def __init__(self, rules: list[ChaosRule], seed: int = 0,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        import http.server

        self.rules = [r for r in rules if r.source == "recv"]
        self._rng = random.Random(f"{seed}:recv")
        self.calls = 0
        self.injected: list[tuple[int, str]] = []
        self.poison_seqs: set[int] = set()
        self._lock = threading.Lock()
        self._accepted_seqs: list[int] = []
        self._accepted_set: set[int] = set()
        self._samples: set[tuple] = set()
        self._accepted_samples = 0
        self._duplicate_seqs: list[int] = []
        self._duplicate_samples = 0
        self._requests = 0
        # Scenario-driven outage switch (set_outage): while True every
        # request answers 503 WITHOUT consuming the seeded rule schedule —
        # the outage is driven by the scenario timeline's rounds, and the
        # probabilistic rules must keep their own deterministic call
        # indices for when it lifts.
        self._outage = False
        self._outage_responses = 0
        # hold_next() choreography: park one request mid-handling and tell
        # the caller it is in flight (the demo SIGKILLs the sender there).
        self._hold_pending: threading.Event | None = None
        self._hold_release = threading.Event()
        self._hold_s = 0.0

        receiver = self

        class _RecvHandler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self) -> None:  # noqa: N802 — stdlib API
                receiver._handle(self)

            def log_message(self, fmt: str, *args) -> None:
                log.debug("chaos-recv: " + fmt, *args)

        class _RecvServer(http.server.ThreadingHTTPServer):
            daemon_threads = True

            def handle_error(self, request, client_address) -> None:
                # A SIGKILLed sender leaves a broken pipe mid-response —
                # expected chaos, not a server fault worth a stack trace.
                log.debug("chaos-recv: handler error from %s",
                          client_address)

        self._httpd = _RecvServer((host, port), _RecvHandler)
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/api/v1/write"

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="tpu-chaos-recv", daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._hold_release.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # ------------------------------------------------------------- schedule

    def _draw(self, idx: int) -> ChaosRule | None:
        """Same determinism contract as ChaosWrapper._invoke: every rule
        consumes exactly one draw per request regardless of what earlier
        rules did; first hitting, armed, non-exhausted rule wins."""
        triggered: ChaosRule | None = None
        for rule in self.rules:
            draw = self._rng.random()
            if (
                triggered is None
                and draw < rule.prob
                and idx >= rule.min_index
                and (rule.max_count is None or rule.fired < rule.max_count)
            ):
                triggered = rule
        if triggered is not None:
            triggered.fired += 1
            self.injected.append((idx, triggered.kind))
        return triggered

    # ------------------------------------------------------------- handling

    def hold_next(self, hold_s: float = 10.0) -> threading.Event:
        """Arm a one-shot hold: the NEXT request parks un-answered for up
        to ``hold_s`` (or until release_hold()). Returns an Event set the
        moment that request is in flight — the demo's SIGKILL-mid-send
        trigger."""
        ev = threading.Event()
        with self._lock:
            self._hold_pending = ev
            self._hold_s = hold_s
            self._hold_release.clear()
        return ev

    def release_hold(self) -> None:
        self._hold_release.set()

    def set_outage(self, down: bool) -> None:
        """Receiver-side outage (the ``recv_outage`` scenario event): every
        request answers 503 while set — the receiver process is "down",
        which is different from a network cut (the client sees an HTTP
        error, not a connection failure)."""
        with self._lock:
            self._outage = down

    def _handle(self, h) -> None:
        with self._lock:
            if self._outage:
                self._outage_responses += 1
                outage = True
            else:
                outage = False
        if outage:
            # Drain the body first: dropping a connection with an unread
            # body reads as a RESET client-side, and an outage must look
            # like a live-but-refusing receiver, not a cut wire.
            length = int(h.headers.get("Content-Length") or 0)
            if length:
                h.rfile.read(length)
            self._respond(h, 503, b"receiver outage\n")
            return
        with self._lock:
            idx = self.calls
            self.calls += 1
            rule = self._draw(idx)
            hold = self._hold_pending
            if hold is not None:
                self._hold_pending = None
        if hold is not None:
            hold.set()
            self._hold_release.wait(self._hold_s)
            self._respond(h, 503, b"held\n")
            return
        length = int(h.headers.get("Content-Length") or 0)
        if rule is not None and rule.kind == "truncate":
            # Read part of the body, then drop the connection mid-transfer
            # — the client sees a reset, nothing was received.
            h.rfile.read(min(length, max(length // 2, 1)))
            try:
                h.connection.close()
            except OSError:
                pass
            return
        body = h.rfile.read(length) if length else b""
        if rule is not None:
            if rule.kind in ("hang", "slow"):
                time.sleep(rule.effective_duration_s)
                if rule.kind == "hang":
                    self._respond(h, 503, b"wedged\n")
                    return
            elif rule.kind == "err":
                self._respond(h, 500, b"injected error\n")
                return
            elif rule.kind == "reject":
                self._respond(h, 429, b"backpressure\n")
                return
        self._accept(h, body)

    def _accept(self, h, body: bytes) -> None:
        from tpu_pod_exporter_torch.egress import (
            SEQ_HEADER,
            parse_write_request,
            snappy_decompress,
        )

        try:
            series = parse_write_request(snappy_decompress(body))
        except ValueError as e:
            self._respond(h, 400, f"bad batch: {e}\n".encode())
            return
        try:
            seq = int(h.headers.get(SEQ_HEADER) or 0)
        except ValueError:
            seq = 0
        if seq in self.poison_seqs:
            self._respond(h, 400, b"poisoned\n")
            return
        # Respond FIRST; ledger only what the client could have seen acked.
        try:
            self._respond(h, 200, b"ok\n")
        except OSError:
            return  # client gone mid-response: it will re-send; no record
        with self._lock:
            self._requests += 1
            if seq:
                if seq in self._accepted_set:
                    self._duplicate_seqs.append(seq)
                else:
                    self._accepted_set.add(seq)
                    self._accepted_seqs.append(seq)
            for labels, samples in series:
                ident = tuple(sorted(labels.items()))
                for _value, ts_ms in samples:
                    key = (ident, ts_ms)
                    if key in self._samples:
                        self._duplicate_samples += 1
                    else:
                        self._samples.add(key)
                        self._accepted_samples += 1

    @staticmethod
    def _respond(h, code: int, body: bytes) -> None:
        h.send_response(code)
        h.send_header("Content-Type", "text/plain")
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)
        h.wfile.flush()

    # ----------------------------------------------------------------- stats

    def accepted_batches(self) -> int:
        with self._lock:
            return len(self._accepted_seqs)

    def stats(self) -> dict:
        with self._lock:
            return {
                "requests": self._requests,
                "calls": self.calls,
                "outage_responses": self._outage_responses,
                "injected": list(self.injected),
                "accepted_seqs": list(self._accepted_seqs),
                "accepted_samples": self._accepted_samples,
                "duplicate_seqs": list(self._duplicate_seqs),
                "duplicate_samples": self._duplicate_samples,
            }


# --- Demo: a wedge, observed end to end --------------------------------------


def main(argv: list[str] | None = None) -> int:
    """``make chaos-demo``: wedge the device backend of a live in-process
    exporter, watch the supervisor abandon the call, the breaker open,
    the backend reconnect, and ``tpu_exporter_up`` return to 1 — while
    /metrics keeps answering from the stale snapshot throughout."""
    import argparse
    import json
    import urllib.request

    from tpu_pod_exporter_torch import utils as _utils
    from tpu_pod_exporter_torch.app import ExporterApp
    from tpu_pod_exporter_torch.config import ExporterConfig

    p = argparse.ArgumentParser(
        prog="tpu-pod-exporter-chaos",
        description="Chaos demo: survive a wedged device backend, visibly.",
    )
    p.add_argument("--hang-s", type=float, default=6.0,
                   help="how long each injected device hang blocks")
    p.add_argument("--hangs", type=int, default=3,
                   help="number of consecutive device reads that hang")
    p.add_argument("--deadline-s", type=float, default=0.5)
    p.add_argument("--interval-s", type=float, default=0.25)
    p.add_argument("--timeout-s", type=float, default=60.0,
                   help="give up if the exporter has not recovered by then")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--trace-out", default="",
                   help="write the incident's poll traces as Chrome "
                        "trace_event JSON to this path on exit (CI uploads "
                        "it as an artifact when the demo fails)")
    ns = p.parse_args(argv)

    _utils.setup_logging("warning")
    cfg = ExporterConfig(
        port=0, host="127.0.0.1", interval_s=ns.interval_s,
        backend="fake", fake_chips=4, attribution="none",
        phase_deadline_s=ns.deadline_s,
        breaker_failures=2, breaker_backoff_s=0.5, breaker_backoff_max_s=2.0,
        chaos_spec=f"hang:device:1:{ns.hang_s:g}s:x{ns.hangs}",
        chaos_seed=ns.seed,
        history_retention_s=0.0,
        # Slow-poll threshold under the deadline, so every wedged poll gets
        # its stacks sampled — the incident trace then names the hung frame
        # (chaos._invoke here), not just the abandoned span.
        trace_slow_poll_s=ns.deadline_s / 2.0,
    )
    app = ExporterApp(cfg)
    app.start()
    base = f"http://127.0.0.1:{app.port}"
    print(f"exporter up on {base}  "
          f"(spec: {cfg.chaos_spec}, deadline {ns.deadline_s:g}s)")
    saw_open = saw_reconnect = False
    t0 = time.monotonic()
    rc = 1
    try:
        while time.monotonic() - t0 < ns.timeout_s:
            ts0 = time.monotonic()
            with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
                body = r.read().decode()
            scrape_ms = (time.monotonic() - ts0) * 1000.0

            def val(name: str, default: float = 0.0) -> float:
                for line in body.splitlines():
                    if line.startswith(name) and " " in line:
                        try:
                            return float(line.rsplit(" ", 1)[1])
                        except ValueError:
                            pass
                return default

            up = val("tpu_exporter_up ")
            sup = app.supervisors["device"].stats()
            print(f"t={time.monotonic() - t0:5.1f}s  up={up:g}  "
                  f"breaker={sup['state']:<9}  abandoned={sup['abandoned']}  "
                  f"reconnects={sup['reconnects']}  "
                  f"skipped={sup['skipped']}  scrape={scrape_ms:.1f}ms")
            saw_open = saw_open or sup["state"] != "closed"
            saw_reconnect = saw_reconnect or sup["reconnects"] > 0
            if saw_open and saw_reconnect and up == 1.0 and sup["state"] == "closed":
                print("recovered: breaker closed, backend reconnected, up=1")
                with urllib.request.urlopen(base + "/readyz", timeout=5) as r:
                    print("readyz:", json.dumps(json.loads(r.read())))
                rc = 0
                break
            time.sleep(max(ns.interval_s, 0.25))
        else:
            print("TIMEOUT: exporter did not recover", flush=True)
    finally:
        if ns.trace_out and app.trace is not None:
            # The abandoned device spans + profiler stacks of the wedge,
            # viewable in chrome://tracing / Perfetto. Written win or lose —
            # CI only uploads it when the demo failed.
            from tpu_pod_exporter_torch.trace import to_chrome_trace

            doc = to_chrome_trace(app.trace.last(app.trace.max_traces),
                                  app.trace.scrapes(256))
            with open(ns.trace_out, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            print(f"incident trace written to {ns.trace_out} "
                  f"({len(doc['traceEvents'])} events)")
        app.stop()
    return rc


if __name__ == "__main__":
    import sys

    sys.exit(main())
