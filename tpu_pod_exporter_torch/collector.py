"""The poll loop: read devices, read attribution, join, publish.

Redesign of the reference's collection loop (``main.go:74-157``) with these
deliberate inversions (SURVEY.md §7):

- **Error containment**: every phase catches its errors, increments an error
  counter, and degrades — the reference instead ``log.Fatalf``s on any NVML
  error mid-loop (``main.go:119,126,131,137``) and ``panic``s on apiserver
  blips (``main.go:79``).
- **Join by device ID**: chip → allocation via the podresources device-ID
  map, O(chips) dict lookups — the reference does an O(devices × procs ×
  pods × pids) nested scan over the wrong join key (``main.go:141-154``).
- **Structural stale-series GC**: each poll builds a complete snapshot and
  swaps it; dead pods' series vanish on the next poll — the reference never
  deletes a series.
- **Bounded attribution staleness**: if the attribution source fails, the
  last good snapshot is reused for up to ``attribution_max_stale_s`` so chip
  metrics keep flowing with slightly stale ownership, then attribution
  labels drop to "" rather than lie indefinitely.
- **Drift-free scheduling**: ticks are scheduled at ``start + n·interval``
  (the reference sleeps a flat 30 s *after* each iteration, ``main.go:156``,
  so its period is interval + iteration time).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Iterable, Sequence

from tpu_pod_exporter_torch.attribution import (
    AttributionError,
    AttributionProvider,
    AttributionSnapshot,
    TPU_RESOURCE_NAME,
)
from tpu_pod_exporter_torch.backend import BackendError, DeviceBackend, HostSample
from tpu_pod_exporter_torch.metrics import (
    CounterStore,
    HistogramStore,
    SnapshotBuilder,
    SnapshotStore,
)
from tpu_pod_exporter_torch import trace as trace_mod
from tpu_pod_exporter_torch import utils
from tpu_pod_exporter_torch.metrics import schema
from tpu_pod_exporter_torch.metrics.registry import PrefixCache
from tpu_pod_exporter_torch.supervisor import SourceSkipped, SourceTimeout
from tpu_pod_exporter_torch.topology import HostTopology
from tpu_pod_exporter_torch.utils import RateLimitedLogger
from tpu_pod_exporter_torch.version import __version__

if TYPE_CHECKING:  # import-cycle-free typing only
    from tpu_pod_exporter_torch.egress import RemoteWriteShipper
    from tpu_pod_exporter_torch.history import HistoryStore
    from tpu_pod_exporter_torch.metrics.registry import Snapshot
    from tpu_pod_exporter_torch.persist import StatePersister
    from tpu_pod_exporter_torch.supervisor import SourceSupervisor
    from tpu_pod_exporter_torch.trace import PollTrace, Tracer

log = logging.getLogger("tpu_pod_exporter_torch.collector")


@dataclass
class PollStats:
    """Per-phase timing + outcome of one poll (SURVEY.md §5 tracing)."""

    device_read_s: float = 0.0
    attribution_s: float = 0.0
    process_scan_s: float = 0.0
    join_s: float = 0.0
    publish_s: float = 0.0
    total_s: float = 0.0
    ok: bool = True
    errors: tuple[str, ...] = ()
    # Phases skipped by an open circuit breaker this poll. A skip degrades
    # the phase exactly like an error (absent/stale data, up=0 for device)
    # but is NOT a failure — it is the quarantine working — so it never
    # counts into tpu_exporter_poll_errors_total (skips have their own
    # counter, tpu_exporter_source_calls_skipped_total); same split the
    # aggregator applies to its per-target scrape-error counter.
    skipped: tuple[str, ...] = ()
    # Trace id of this poll's trace ("" when tracing is off) — the join key
    # between /debug/vars' last_poll, the JSON log stream, and /debug/trace.
    trace_id: str = ""


class Collector:
    def __init__(
        self,
        backend: DeviceBackend,
        attribution: AttributionProvider,
        store: SnapshotStore,
        topology: HostTopology | None = None,
        resource_name: str = TPU_RESOURCE_NAME,
        attribution_max_stale_s: float = 30.0,
        legacy_metrics: bool = False,
        process_scanner: Any = None,
        # () -> {cause: int}, from the HTTP guard
        scrape_rejects_fn: Callable[[], dict[str, int]] | None = None,
        # () -> int, from the CollectorLoop
        loop_overruns_fn: Callable[[], int] | None = None,
        # HistogramStore fed by the HTTP server
        scrape_duration_hist: HistogramStore | None = None,
        # (SnapshotBuilder) -> None, from the HTTP server: its timing
        # families (MetricsServer.emit_timings)
        server_timings_fn: Callable[[Any], None] | None = None,
        # HistoryStore fed after each snapshot swap
        history: "HistoryStore | None" = None,
        # {"device"|"attribution"|"process_scan": SourceSupervisor}
        supervisors: "dict[str, SourceSupervisor] | None" = None,
        # trace.Tracer; None = zero tracing work per poll
        tracer: "Tracer | None" = None,
        # persist.StatePersister; None = no persistence
        persister: "StatePersister | None" = None,
        # egress.RemoteWriteShipper; None = no push egress
        shipper: "RemoteWriteShipper | None" = None,
        # pressure.PressureGovernor; None = no pressure surface. The
        # governor runs its own check thread — the collector only emits
        # its cached stats (never a disk walk on the poll thread).
        governor: Any = None,
        # () -> int, from the HTTP server
        client_write_timeouts_fn: Callable[[], int] | None = None,
        # Incremental splice render (--render-splice); False restores the
        # per-family full re-render at every poll.
        render_splice: bool = True,
        clock: Callable[[], float] = time.monotonic,
        wallclock: Callable[[], float] = time.time,
    ) -> None:
        self._backend = backend
        self._attribution = attribution
        self._process_scanner = process_scanner
        self._scrape_rejects_fn = scrape_rejects_fn
        self._loop_overruns_fn = loop_overruns_fn
        self._store = store
        # Optional supervision layer (tpu_pod_exporter_torch.supervisor): when a
        # source has a supervisor, its phase call runs on a fenced worker
        # with a hard deadline behind a circuit breaker; without one, the
        # call runs in-thread exactly as before (tests/bench construct the
        # Collector bare).
        self._supervisors = supervisors or {}
        # End-to-end poll tracing (tpu_pod_exporter_torch.trace): every poll
        # becomes a trace with one span per phase; None skips every hook.
        self._tracer = tracer
        # Consecutive-failure counts per phase error key, for recovery log
        # lines on the UNsupervised path (supervisors log their own).
        self._phase_failures: dict[str, int] = {}
        self._topology = topology or HostTopology()
        self._resource_name = resource_name
        self._attribution_max_stale_s = attribution_max_stale_s
        self._legacy_metrics = legacy_metrics
        # GPU surface latch: once the backend (or any observed chip) is
        # GPU-family, the gpu_* twins are declared every poll — sticky, so
        # scrapers see a stable surface from the first GPU sighting on
        # (the same conditional-surface rule as TPU_CHIP_PROCESS_INFO).
        self._gpu_surface = getattr(backend, "family", "tpu") == "gpu"
        self._clock = clock
        self._wallclock = wallclock

        self._counters = CounterStore()
        # Distributions of the exporter's own latencies (VERDICT r4: a p99
        # of poll phases must be computable from the exposition). Phase
        # observations land at poll end; the scrape store is fed by the
        # HTTP handler threads and emitted here, one poll behind — fine
        # for a cumulative histogram.
        self._phase_hist = HistogramStore(
            schema.TPU_EXPORTER_POLL_PHASE_DURATION_HIST
        )
        self._scrape_hist = scrape_duration_hist
        self._server_timings_fn = server_timings_fn
        # Flight recorder: fed once per poll AFTER the snapshot swap, so the
        # scrape path never contends on the history lock. The append
        # duration lands in the next snapshot (one poll behind, like
        # publish/total timings).
        self._history = history
        self._history_append_s = 0.0
        # Crash-safe persistence: fed once per poll AFTER the history
        # append, on its own phase — like the history append it is
        # excluded from the publish/total timings it is separately
        # accounted against. The poll-side cost is one queue put; all
        # I/O runs on the persister's writer thread.
        self._persister = persister
        self._persist_s = 0.0
        # Remote-write egress: fed once per poll AFTER persistence, on its
        # own phase — the same excluded-from-publish/total accounting. The
        # poll-side cost is one non-blocking queue put; batch building and
        # every byte of network/disk I/O run on the shipper's own threads.
        self._shipper = shipper
        self._egress_s = 0.0
        self._governor = governor
        self._client_write_timeouts_fn = client_write_timeouts_fn
        # Poll-phase faults repeat every interval (1 s) while a source is
        # down; rate-limit per fault key so logs show the fault, not 86k
        # lines/day. Per-instance: multiple collectors (tests, bench)
        # must not suppress each other.
        self._rlog = RateLimitedLogger(log)
        self._prefix_cache = PrefixCache(splice=render_splice)
        # Topology labels are fixed for the process lifetime; pre-order them
        # once for the tuple fast path (CHIP_LABELS[2:6]).
        t = self._topology.labels()
        self._topo_tuple = (
            t["accelerator"], t["slice_name"], t["host"], t["worker_id"],
        )
        # tpu_host_info label tuple (TOPO_LABELS + multislice membership):
        # static for the process lifetime, published every poll as the
        # cross-slice join key (see HostTopology.host_info_labels).
        hi = self._topology.host_info_labels()
        self._host_info_tuple = self._topo_tuple + (
            hi["multislice_group"], hi["num_slices"],
        )
        self._last_attr: AttributionSnapshot | None = None
        self._last_attr_at: float = 0.0
        # Last good holder set, reused under the same bounded-staleness rule
        # as attribution: a transient scan failure must not flip the legacy
        # series identity from {pid="<holder>"} to {pid=""} for one poll.
        self._last_holders: tuple | None = None
        self._last_holders_at: float = 0.0
        # (chip_id, owner pod/ns/container) -> (chip label tuple,
        # {link id -> link label tuple}, chip-info label tuple or None).
        # Label tuples are invariant between
        # churn events, so rebuilding + re-interning them per chip per poll
        # is the main Python cost of publish at 256 chips; cache and reuse.
        # The cached inner tuples also make the PrefixCache layout comparison
        # hit its pointer-identity fast path. Bounded: wiped wholesale when
        # churn outgrows it (entries for dead owners are unreachable after).
        self._label_cache: dict[tuple, tuple[tuple, dict]] = {}
        # chip_id -> {link id -> [raw_prev, folded, rate_base, last_seq]}:
        # per-link monotonic-fold state, deliberately keyed by chip (not by
        # owner) so counters and rates continue across pod reassignment.
        # Mutable-list slot access instead of tuple-keyed CounterStore
        # lookups, which at 1.5k links × ~5 nested-tuple hashes each were
        # the hottest publish cost. A wiped record re-seeds its counter at
        # the current raw value, which is ≥ the folded value barring a
        # device reset in the same instant, so exported counters stay
        # monotonic.
        self._chip_state: dict[int, dict[str, list]] = {}
        # Same per-link fold state for DCN counters. No flat/numpy fast
        # path: DCN cardinality is a handful of NIC-class links per host
        # (vs 6 ICI links × every chip), so a plain loop is already cheap.
        self._dcn_state: dict[int, dict[str, list]] = {}
        # Monotonic publish sequence for polls that carried a device sample;
        # a link's rate is published only when it was also seen at seq-1
        # (dt measures exactly that window).
        self._publish_seq = 0
        # Flat ICI fold block for the steady state: when the (chip, owner,
        # link-id) layout is identical to the previous sampled poll, all
        # links fold in one numpy pass (delta/clip/rate over flat arrays)
        # instead of ~15 interpreted ops per link — at 256 chips × 6 links
        # that is the single largest publish cost. Any layout change (churn,
        # re-enumeration, link set change) falls back to the per-link loop
        # for that poll, which also (re)builds this block. The per-link recs
        # in _chip_state go stale while the fast path runs and are written
        # back by _export_ici_flat() before any slow-path fold.
        self._ici_flat: dict | None = None
        # monotonic time of the previous published device sample, for rates
        self._prev_ici_at: float | None = None
        self.last_stats = PollStats()

    def render_stats(self) -> dict[str, int] | None:
        """Splice-render counters for /debug/vars, or None when the
        incremental render is disabled (--render-splice false)."""
        tmpl = self._prefix_cache.template
        return tmpl.stats() if tmpl is not None else None

    # ------------------------------------------------------------------ poll

    def poll_once(self) -> PollStats:
        # One trace per poll (tpu_pod_exporter_torch.trace): the root span also
        # arms the slow-poll stack sampler, and setting the thread-local
        # context here is what stamps trace ids onto every log line below.
        tracer = self._tracer
        tr = tracer.start_poll() if tracer is not None else None
        t0 = self._clock()
        errors: list[str] = []
        skips: list[str] = []

        # Phase 1: device read (analog of main.go:116-138, error-contained).
        # Supervised when a "device" supervisor exists: the call runs on a
        # fenced worker with a hard deadline, behind the source's breaker.
        td0 = self._clock()
        sup = self._supervisors.get("device")
        if tr is not None:
            tr.begin("device_read",
                     breaker=sup.breaker.state if sup is not None else "")
        dev_status = "ok"
        host_sample: HostSample | None = None
        read_wall0 = self._wallclock()
        try:
            host_sample = sup.call() if sup is not None else self._backend.sample()
            self._phase_recovered("device_read", supervised=sup is not None)
            for msg in host_sample.partial_errors:
                errors.append("device_partial")
                self._rlog.warning("device_partial", "device partial error: %s", msg)
        except SourceSkipped as e:
            # The breaker quarantine working as designed — the phase
            # degrades like an error (stale/absent data is the truth), but
            # it is neither counted as a poll error nor logged past INFO:
            # the fault already logged when the breaker opened.
            dev_status = "skipped"
            skips.append("device_read")
            self._rlog.info("device_skip", "device read skipped: %s", e)
        except SourceTimeout as e:
            dev_status = "abandoned"
            errors.append("device_read")
            self._rlog.warning("device_timeout", "device read abandoned: %s", e)
        except BackendError as e:
            dev_status = "err"
            errors.append("device_read")
            self._count_phase_failure("device_read", sup)
            self._rlog.warning("device_read", "device read failed: %s", e)
        except Exception as e:  # noqa: BLE001 — never die in the loop
            dev_status = "err"
            errors.append("device_read")
            self._count_phase_failure("device_read", sup)
            self._rlog.error("device_read_unexpected", "device read failed unexpectedly: %s", e, exc_info=True)
        read_wall1 = self._wallclock()
        td1 = self._clock()
        if tr is not None:
            tr.end(dev_status,
                   chips=len(host_sample.chips) if host_sample is not None else 0)

        # Phase 2: attribution (replaces main.go:74-114).
        attr = self._read_attribution(errors, skips, tr)
        ta1 = self._clock()

        # Phase 2b: process scan (the honest analog of the reference's PID
        # harvest, main.go:92-109 — local procfs instead of kubectl exec).
        holders = None
        if self._process_scanner is not None:
            psup = self._supervisors.get("process_scan")
            if tr is not None:
                tr.begin("process_scan",
                         breaker=psup.breaker.state if psup is not None else "")
            scan_status = "ok"
            try:
                holders = (
                    psup.call() if psup is not None
                    else self._process_scanner.scan()
                )
                self._phase_recovered("process_scan", supervised=psup is not None)
                self._last_holders = holders
                self._last_holders_at = self._clock()
            except Exception as e:  # noqa: BLE001 — never die in the loop
                if isinstance(e, SourceSkipped):
                    scan_status = "skipped"
                    skips.append("process_scan")
                    self._rlog.info("process_scan_skip", "process scan skipped: %s", e)
                elif isinstance(e, SourceTimeout):
                    scan_status = "abandoned"
                    errors.append("process_scan")
                    self._rlog.warning("process_scan_timeout", "process scan abandoned: %s", e)
                else:
                    scan_status = "err"
                    errors.append("process_scan")
                    self._count_phase_failure("process_scan", psup)
                    self._rlog.warning("process_scan", "process scan failed: %s", e)
                if (
                    self._last_holders is not None
                    and self._clock() - self._last_holders_at
                    <= self._attribution_max_stale_s
                ):
                    holders = self._last_holders
            if tr is not None:
                tr.end(scan_status,
                       holders=len(holders) if holders is not None else 0)
        tps1 = self._clock()

        # Phase 3: join (replaces main.go:141-154).
        if tr is not None:
            tr.begin("join")
        device_owner = attr.by_device_id(self._resource_name) if attr else {}
        allocatable = attr.allocatable_device_ids if attr else None
        # None ⇒ "source cannot report"; 0 is a real, publishable value on an
        # idle node. A source that reports neither allocations nor inventory
        # (attribution disabled / "none") stays absent rather than claiming 0.
        allocated = (
            len(device_owner)
            if attr is not None
            and (attr.allocations or attr.allocatable_device_ids is not None)
            else None
        )
        tj1 = self._clock()
        if tr is not None:
            tr.end("ok", owned_devices=len(device_owner))

        # Phase 4: publish (snapshot build + swap).
        stats = PollStats(
            device_read_s=td1 - td0,
            attribution_s=ta1 - td1,
            process_scan_s=tps1 - ta1,
            join_s=tj1 - tps1,
            # A skipped device phase degrades up exactly like a failed one:
            # no device data was read either way.
            ok="device_read" not in errors and "device_read" not in skips,
            errors=tuple(errors),
            skipped=tuple(skips),
            trace_id=tr.trace_id if tr is not None else "",
        )
        if tr is not None:
            tr.begin("publish")
        snap = self._publish(host_sample, device_owner, stats, now_mono=tj1,
                             allocatable=allocatable, allocated=allocated,
                             holders=holders,
                             device_read_wall=(read_wall0, read_wall1))
        tp1 = self._clock()
        if tr is not None:
            tr.end("ok", series=snap.series_count)
        stats.publish_s = tp1 - tj1
        stats.total_s = tp1 - t0
        self.last_stats = stats
        # Cumulative distributions; this poll's publish/total are complete
        # here (unlike the point-in-time gauges, which lag them by one poll).
        for phase, dur in (
            ("device_read", stats.device_read_s),
            ("attribution", stats.attribution_s),
            ("process_scan", stats.process_scan_s),
            ("join", stats.join_s),
            ("publish", stats.publish_s),
            ("total", stats.total_s),
        ):
            self._phase_hist.observe(dur, (phase,))
        # History append LAST, outside every phase timing: the snapshot is
        # already swapped (scrapes serve it; the history lock is never on
        # the scrape path) and the append must not inflate the publish/total
        # phase distributions it is separately accounted against
        # (tpu_exporter_history_append_seconds).
        if self._history is not None:
            if tr is not None:
                tr.begin("history_append")
            th0 = self._clock()
            appended = 0
            hist_status = "ok"
            try:
                appended = self._history.append_snapshot(
                    snap, now_mono=th0, now_wall=snap.timestamp
                )
            except Exception as e:  # noqa: BLE001 — recording must not fail a poll
                hist_status = "err"
                self._rlog.error(
                    "history_append", "history append failed: %s", e,
                    exc_info=True,
                )
            self._history_append_s = self._clock() - th0
            if tr is not None:
                tr.end(hist_status, samples=appended)
            # The append IS part of the poll's latency story even though it
            # is excluded from publish/total: give it its own distribution
            # label so the per-phase heatmap shows where post-swap time goes.
            self._phase_hist.observe(self._history_append_s, ("history_append",))
        # Persistence LAST, on its own supervised phase: the snapshot is
        # swapped and the history append has run, so the WAL record covers
        # exactly what a restart would need — and like the history append
        # it never inflates the publish/total distributions (satellite
        # audit: persistence I/O must not read as poll latency).
        if self._persister is not None:
            if tr is not None:
                tr.begin("persist")
            tq0 = self._clock()
            queued = 0
            persist_status = "ok"
            try:
                queued = self._persister.on_poll(snap)
            except Exception as e:  # noqa: BLE001 — persistence must not fail a poll
                persist_status = "err"
                self._rlog.error(
                    "persist", "persistence enqueue failed: %s", e,
                    exc_info=True,
                )
            self._persist_s = self._clock() - tq0
            if tr is not None:
                tr.end(persist_status, queued=queued)
            self._phase_hist.observe(self._persist_s, ("persist",))
        # Egress LAST, on its own phase: the snapshot is swapped, recorded,
        # and persisted, so the batch the shipper's writer extracts covers
        # exactly what every other consumer saw — and like persist, the
        # enqueue must never read as publish/total poll latency (the
        # phase-exclusion is test-asserted in tests/test_egress.py).
        if self._shipper is not None:
            if tr is not None:
                tr.begin("egress")
            te0 = self._clock()
            equeued = 0
            egress_status = "ok"
            try:
                equeued = self._shipper.on_snapshot(snap)
            except Exception as e:  # noqa: BLE001 — egress must not fail a poll
                egress_status = "err"
                self._rlog.error(
                    "egress", "egress enqueue failed: %s", e, exc_info=True,
                )
            self._egress_s = self._clock() - te0
            if tr is not None:
                tr.end(egress_status, queued=equeued)
            self._phase_hist.observe(self._egress_s, ("egress",))
        if tr is not None:
            tracer.finish(tr, status="ok" if stats.ok else "err",
                          errors=len(errors), skips=len(skips))
            if tr.slow:
                # Trace-correlated breadcrumb for the incident timeline; the
                # profile itself lives in /debug/trace, not in the logs.
                # Logs the ROOT SPAN duration — the number the slow
                # classification actually compared (it includes the
                # history append, which stats.total_s deliberately
                # excludes; printing total_s here could contradict the
                # budget the line claims was exceeded).
                self._rlog.warning(
                    "slow_poll",
                    "slow poll: %.3fs > %.3gs budget (trace %s, %d profile "
                    "samples — GET /debug/trace)",
                    tr.root.dur_s, tracer.slow_poll_s, tr.trace_id,
                    tr.profile_samples,
                )
        return stats

    def _read_attribution(self, errors: list[str], skips: list[str],
                          tr: "PollTrace | None" = None) -> AttributionSnapshot | None:
        now = self._clock()
        sup = self._supervisors.get("attribution")
        if tr is not None:
            tr.begin("attribution",
                     breaker=sup.breaker.state if sup is not None else "")
        status = "ok"
        snap = None
        try:
            snap = sup.call() if sup is not None else self._attribution.snapshot()
            self._phase_recovered("attribution", supervised=sup is not None)
            self._last_attr = snap
            self._last_attr_at = now
        except SourceSkipped as e:
            status = "skipped"
            skips.append("attribution")
            self._rlog.info("attribution_skip", "attribution read skipped: %s", e)
        except SourceTimeout as e:
            status = "abandoned"
            errors.append("attribution")
            self._rlog.warning("attribution_timeout", "attribution read abandoned: %s", e)
        except AttributionError as e:
            status = "err"
            errors.append("attribution")
            self._count_phase_failure("attribution", sup)
            self._rlog.warning("attribution", "attribution read failed: %s", e)
        except Exception as e:  # noqa: BLE001
            status = "err"
            errors.append("attribution")
            self._count_phase_failure("attribution", sup)
            self._rlog.error("attribution_unexpected", "attribution failed unexpectedly: %s", e, exc_info=True)
        if snap is None and (
            self._last_attr is not None
            and now - self._last_attr_at <= self._attribution_max_stale_s
        ):
            # Bounded-staleness reuse of the last good snapshot.
            snap = self._last_attr
            if tr is not None:
                trace_mod.annotate(
                    f"reusing attribution snapshot from "
                    f"{now - self._last_attr_at:.1f}s ago (bounded staleness)"
                )
        if tr is not None:
            tr.end(status,
                   allocations=len(snap.allocations) if snap is not None else 0)
        return snap

    # ------------------------------------------------- phase fault tracking

    def _count_phase_failure(self, key: str, sup: "SourceSupervisor | None") -> None:
        """Track consecutive failures for recovery log lines — only on the
        unsupervised path (a SourceSupervisor tracks and logs its own)."""
        if sup is None:
            self._phase_failures[key] = self._phase_failures.get(key, 0) + 1

    def _phase_recovered(self, key: str, supervised: bool) -> None:
        if supervised:
            return
        n = self._phase_failures.get(key, 0)
        if n:
            self._phase_failures[key] = 0
            # Bypasses the rate limit: the end of an incident must always
            # be visible, even inside the fault lines' suppression window.
            self._rlog.recovery(
                key, "source %s healthy again after %d failure(s)", key, n
            )

    # --------------------------------------------------------------- publish

    def _publish(self, host_sample: HostSample | None,
                 device_owner: dict[str, Any], stats: PollStats,
                 now_mono: float, allocatable: Iterable[str] | None = None,
                 allocated: int | None = None,
                 holders: Sequence[Any] | None = None,
                 device_read_wall: tuple[float, float] | None = None) -> "Snapshot":
        b = SnapshotBuilder(prefix_cache=self._prefix_cache)

        # GPU-family detection BEFORE the declares: a recorded/fake mixed
        # host whose first GPU chip appears this poll must declare the
        # gpu_* families in the same snapshot that carries their samples.
        if not self._gpu_surface and host_sample is not None:
            for c in host_sample.chips:
                if c.info.family == "gpu":
                    self._gpu_surface = True
                    break

        # Declare the full schema up front so families are present (and typed)
        # even when sample-less — scrapers see a stable surface from poll #1.
        for spec in schema.ALL_SPECS:
            b.declare(spec)
        self._phase_hist.emit(b)
        if self._scrape_hist is not None:
            self._scrape_hist.emit(b)
        if self._server_timings_fn is not None:
            try:
                self._server_timings_fn(b)
            except Exception:  # noqa: BLE001 — accounting must never fail a poll
                pass
        if self._legacy_metrics:
            b.declare(schema.LEGACY_POD_MEMORY_USAGE)
            b.declare(schema.LEGACY_POD_MEMORY_PERC_USAGE)
        if self._process_scanner is not None:
            b.declare(schema.TPU_CHIP_PROCESS_INFO)
        if self._gpu_surface:
            for spec in schema.GPU_NODE_SPECS:
                b.declare(spec)

        # device_path -> holders, for the per-chip process join. Holder sets
        # are tiny (≈ one workload process per chip), so a plain dict-of-lists
        # rebuilt per poll is cheaper than caching machinery.
        holders_by_path: dict[str, list] = {}
        if holders:
            for h in holders:
                holders_by_path.setdefault(h.device_path, []).append(h)

        # (family, *pod labels) -> [chips, hbm_used, chips_with_readable_hbm]
        # — family-keyed so a mixed host (recorded/fake) rolls each pod up
        # under its own namespace (tpu_pod_* vs gpu_pod_*), never summed
        # across families.
        pod_rollup: dict[tuple[str, ...], list[float]] = {}
        # (pod, pid) -> [hbm_used, hbm_total] for the legacy aliases; pid is
        # "" when no process scanner or no holder was seen for the chip.
        legacy_rollup: dict[tuple[str, str], list[float]] = {}

        if host_sample is not None:
            dt = None
            if self._prev_ici_at is not None:
                dt = max(now_mono - self._prev_ici_at, 1e-9)
            seq = self._publish_seq = self._publish_seq + 1
            # Direct samples-dict handles: one dict store per series instead
            # of a full add() (family lookup + shape checks) — at 256 chips ×
            # ~16 series × 1 s that overhead is the largest publish cost.
            hbm_used_s = b.series(schema.TPU_HBM_USED_BYTES)
            hbm_total_s = b.series(schema.TPU_HBM_TOTAL_BYTES)
            hbm_pct_s = b.series(schema.TPU_HBM_USED_PERCENT)
            hbm_peak_s = b.series(schema.TPU_HBM_PEAK_BYTES)
            chip_info_s = b.series(schema.TPU_CHIP_INFO)
            duty_s = b.series(schema.TPU_TENSORCORE_DUTY_CYCLE_PERCENT)
            if self._gpu_surface:
                # The gpu_* twins; the per-chip loop below selects handles
                # by ChipInfo.family (one compare per chip — free next to
                # the dict stores it gates).
                g_used_s = b.series(schema.GPU_HBM_USED_BYTES)
                g_total_s = b.series(schema.GPU_HBM_TOTAL_BYTES)
                g_pct_s = b.series(schema.GPU_HBM_USED_PERCENT)
                g_util_s = b.series(schema.GPU_UTILIZATION_PERCENT)
                g_info_s = b.series(schema.GPU_CHIP_INFO)
            ici_total_s = b.series(schema.TPU_ICI_TRANSFERRED_BYTES_TOTAL)
            ici_bw_s = b.series(schema.TPU_ICI_LINK_BANDWIDTH_BYTES_PER_SECOND)
            dcn_total_s = b.series(schema.TPU_DCN_TRANSFERRED_BYTES_TOTAL)
            dcn_bw_s = b.series(schema.TPU_DCN_LINK_BANDWIDTH_BYTES_PER_SECOND)
            label_cache = self._label_cache
            if len(label_cache) > 4 * len(host_sample.chips) + 64:
                label_cache.clear()
            chip_state = self._chip_state
            if len(chip_state) > 2 * len(host_sample.chips) + 64:
                # Prune only vanished chips — never live ones. A wholesale
                # clear would re-seed surviving links' counters at the raw
                # reading, which regresses the exported counter whenever a
                # device reset ever happened (folded > raw from then on).
                live = {c.info.chip_id for c in host_sample.chips}
                for cid in [cid for cid in chip_state if cid not in live]:
                    del chip_state[cid]
                for cid in [c for c in self._dcn_state if c not in live]:
                    del self._dcn_state[cid]
            chips = host_sample.chips
            flat = self._ici_flat
            # Steady-state fast path precondition; per-chip identity is
            # verified inside the loop and any mismatch drops to slow.
            fast = (
                flat is not None
                and dt is not None
                and len(chips) == len(flat["chips"])
            )
            raw_buf = flat["raw_buf"] if fast else None
            chip_cached: list = []  # (chip, cached) for the link fold pass
            for ci, chip in enumerate(chips):
                owner = None
                for did in chip.info.device_ids:
                    owner = device_owner.get(did)
                    if owner is not None:
                        break
                info = chip.info
                cache_key = (
                    info.chip_id,
                    info.device_path,  # re-enumeration can move a chip_id
                    owner.pod if owner else "",
                    owner.namespace if owner else "",
                    owner.container if owner else "",
                )
                cached = label_cache.get(cache_key)
                if cached is None:
                    # Pre-ordered to CHIP_LABELS.
                    chip_tuple = (
                        str(info.chip_id),
                        info.device_path,
                        *self._topo_tuple,
                        *cache_key[2:],
                    )
                    # device_kind/coords are static per chip: build the
                    # tpu_chip_info label tuple once here, not per poll.
                    # ALWAYS published (empty kind/coords stay empty labels):
                    # since round 4 a chip with unreadable HBM emits no
                    # tpu_hbm_* series, so chip_info is the one guaranteed
                    # per-chip presence series — the aggregator counts
                    # chips/hosts_reporting from it.
                    info_tuple = chip_tuple + (info.device_kind, info.coords)
                    cached = (chip_tuple, {}, info_tuple)
                    label_cache[cache_key] = cached
                chip_tuple, link_tuples, info_tuple = cached
                # Family dispatch: one string compare per chip selects the
                # tpu_* or gpu_* series handles — the label schema is
                # shared, only the namespace differs.
                fam = info.family
                if fam == "gpu":
                    used_sel, total_sel = g_used_s, g_total_s
                    pct_sel, duty_sel, info_sel = g_pct_s, g_util_s, g_info_s
                else:
                    used_sel, total_sel = hbm_used_s, hbm_total_s
                    pct_sel, duty_sel, info_sel = hbm_pct_s, duty_s, chip_info_s
                # None = backend couldn't read HBM (tunnel with empty
                # memory_stats): publish no series — absent beats fake-zero
                # (main.go:129-132 never publishes an unread value).
                used = chip.hbm_used_bytes
                total_b = chip.hbm_total_bytes
                if used is not None:
                    used_sel[chip_tuple] = used
                if total_b is not None:
                    total_sel[chip_tuple] = total_b
                if used is not None and total_b is not None and total_b > 0:
                    # hbm_used_percent inlined (analog of main.go:149-150).
                    # total==0 ⇒ omit the series: a percent of a zero/unread
                    # total is undefined, and 0.0 would read as "idle".
                    pct_sel[chip_tuple] = used / total_b * 100.0
                if chip.hbm_peak_bytes is not None and fam == "tpu":
                    # No gpu twin: NVML serves no allocator high-water mark.
                    hbm_peak_s[chip_tuple] = chip.hbm_peak_bytes
                if chip.tensorcore_duty_cycle_percent is not None:
                    # For GPU chips this slot carries the NVML utilization
                    # rate (GetUtilizationRates.gpu) — see ChipSample.
                    duty_sel[chip_tuple] = chip.tensorcore_duty_cycle_percent
                info_sel[info_tuple] = 1.0
                if fam == "gpu" and chip.processes:
                    # The runtime's own per-process table
                    # (GetComputeRunningProcesses, main.go:134-155): honest
                    # host PIDs straight from the driver, pod attribution
                    # from the same device-ID join as every chip series.
                    for pr in chip.processes:
                        b.add(
                            schema.GPU_PROCESS_MEMORY_USED_BYTES,
                            pr.used_bytes,
                            chip_tuple + (str(pr.pid), pr.comm),
                        )

                # Link work is deferred to the fold pass below; here the fast
                # path only verifies layout identity and extracts raw totals.
                links = chip.ici_links
                if fast:
                    ent = flat["chips"][ci]
                    if ent[0] is cached and len(links) == len(ent[1]):
                        ids = ent[1]
                        base = ent[2]
                        # Index access (IciLinkSample is a NamedTuple:
                        # [0]=link, [1]=transferred_bytes_total) skips two
                        # descriptor lookups per link on the hottest loop.
                        for j, l in enumerate(links):
                            lid = l[0]
                            if lid is ids[j] or lid == ids[j]:
                                raw_buf[base + j] = l[1]
                            else:
                                fast = False
                                break
                    else:
                        fast = False
                chip_cached.append((chip, cached))

                chip_holders = (
                    holders_by_path.get(info.device_path)
                    if holders_by_path
                    else None
                )
                if chip_holders:
                    for h in chip_holders:
                        b.add(
                            schema.TPU_CHIP_PROCESS_INFO,
                            1.0,
                            chip_tuple + (str(h.pid), h.comm, h.pod_uid),
                        )

                if owner is not None:
                    rk = (fam, owner.pod, owner.namespace) + self._topo_tuple
                    # [chips, hbm_used, chips_with_readable_hbm]
                    agg = pod_rollup.setdefault(rk, [0.0, 0.0, 0])
                    agg[0] += 1.0
                    # Unreadable (None) HBM contributes nothing — and if NO
                    # chip of the pod was readable, the pod HBM series is
                    # omitted below, same absent-beats-fake-zero rule as the
                    # per-chip series.
                    if used is not None:
                        agg[1] += used
                        agg[2] += 1
                    if (
                        self._legacy_metrics
                        and used is not None
                        and total_b is not None
                    ):
                        # The legacy shape has no namespace label (the
                        # reference collided on pod name, main.go:113); sum
                        # across namespaces rather than last-write-wins. With
                        # the process scanner on, the pid label carries the
                        # chip's primary (lowest-pid) holder so each chip's
                        # HBM is counted exactly once even under forked
                        # workers; "" otherwise. A chip missing EITHER HBM
                        # number is skipped entirely: half-folding would
                        # publish a fake-zero usage row or skew the percent
                        # denominator (used without total → pct inflation).
                        pid = str(chip_holders[0].pid) if chip_holders else ""
                        lagg = legacy_rollup.setdefault((owner.pod, pid), [0.0, 0.0])
                        lagg[0] += used
                        lagg[1] += total_b

            if fast:
                self._fold_ici_fast(ici_total_s, ici_bw_s, dt, seq)
            else:
                self._fold_ici_slow(chip_cached, ici_total_s, ici_bw_s, dt, seq)
            self._fold_dcn(chip_cached, dcn_total_s, dcn_bw_s, dt, seq)
            self._prev_ici_at = now_mono

        for rk, (nchips, hbm, readable) in pod_rollup.items():
            # rk[0] is the family key; the published labels are rk[1:].
            if rk[0] == "gpu":
                count_spec = schema.GPU_POD_CHIP_COUNT
                mem_spec = schema.GPU_POD_MEMORY_USED_BYTES
            else:
                count_spec = schema.TPU_POD_CHIP_COUNT
                mem_spec = schema.TPU_POD_HBM_USED_BYTES
            b.add(count_spec, nchips, rk[1:])
            if readable:
                b.add(mem_spec, hbm, rk[1:])
        for (pod, pid), (hbm, hbm_total) in legacy_rollup.items():
            # Reference-name aliases (main.go:24,31), label shape {pid, pod}.
            b.add(schema.LEGACY_POD_MEMORY_USAGE, hbm, (pid, pod))
            b.add(
                schema.LEGACY_POD_MEMORY_PERC_USAGE,
                schema.hbm_used_percent(hbm, hbm_total),
                (pid, pod),
            )

        # Host identity incl. multi-slice membership — the cross-slice
        # rollup join key (always published; empty labels off multi-slice).
        b.add(schema.TPU_HOST_INFO, 1.0, self._host_info_tuple)

        # Kubelet inventory (absent when the source cannot report it; an
        # allocated count of 0 on an idle node is real data, not absence).
        if allocatable is not None:
            b.add(schema.TPU_KUBELET_ALLOCATABLE_CHIPS, len(allocatable),
                  self._topo_tuple)
        if allocated is not None:
            b.add(schema.TPU_KUBELET_ALLOCATED_CHIPS, allocated,
                  self._topo_tuple)

        # Self-metrics (SURVEY.md §5).
        b.add(schema.TPU_EXPORTER_UP, 1.0 if stats.ok else 0.0)
        if self._gpu_surface:
            # Per-backend up for the GPU family: tracks the device half of
            # the poll (a GPU-node wedge drops this exactly the way a TPU
            # node drops tpu_exporter_up — the mixed-wedge drill's parity).
            b.add(schema.GPU_BACKEND_UP, 1.0 if stats.ok else 0.0)
        # Warm-start markers: every LIVE poll publishes 0 — a restored
        # exposition (persist.RestoredSnapshot) patches these two values to
        # 1 / the measured staleness, which only works because the series
        # are unconditionally present.
        b.add(schema.TPU_EXPORTER_WARM_START, 0.0)
        b.add(schema.TPU_EXPORTER_SNAPSHOT_STALE_SECONDS, 0.0)
        # This poll's read/join timings; publish/total are not known until
        # after the swap, so the previous poll's values stand in for them.
        for phase, dur in (
            ("device_read", stats.device_read_s),
            ("attribution", stats.attribution_s),
            ("process_scan", stats.process_scan_s),
            ("join", stats.join_s),
            ("publish", self.last_stats.publish_s),
            ("total", self.last_stats.total_s),
        ):
            b.add(schema.TPU_EXPORTER_POLL_DURATION_SECONDS, dur, {"phase": phase})
        for source in stats.errors:
            self._counters.inc(schema.TPU_EXPORTER_POLL_ERRORS_TOTAL.name, (source,))
        for lv, v in self._counters.items_for(schema.TPU_EXPORTER_POLL_ERRORS_TOTAL.name):
            b.add(schema.TPU_EXPORTER_POLL_ERRORS_TOTAL, v, lv)
        # Side-channel error counters a provider tracks itself (e.g. the
        # checkpoint path's uid-map fetch failures, which degrade to
        # last-good data without raising into a poll phase).
        attr_errors = getattr(self._attribution, "error_counters", None)
        if callable(attr_errors):
            for source, v in attr_errors().items():
                # Namespaced: a provider-chosen source name must never
                # collide with (b.add overwrites, not sums) a poll-phase
                # counter series like source="attribution".
                b.add(
                    schema.TPU_EXPORTER_POLL_ERRORS_TOTAL,
                    float(v),
                    (f"attribution.{source}",),
                )
        # Source-supervision surface (tpu_pod_exporter_torch.supervisor): breaker
        # state + transition/abandon/skip/reconnect counters per source.
        # Families are declared via ALL_SPECS either way; samples exist only
        # when supervision is on.
        for source, sup in self._supervisors.items():
            st = sup.stats()
            b.add(schema.TPU_EXPORTER_SOURCE_BREAKER_STATE,
                  st["state_value"], (source,))
            for state, n in st["transitions"].items():
                b.add(schema.TPU_EXPORTER_SOURCE_BREAKER_TRANSITIONS_TOTAL,
                      float(n), (source, state))
            b.add(schema.TPU_EXPORTER_SOURCE_CALLS_ABANDONED_TOTAL,
                  float(st["abandoned"]), (source,))
            b.add(schema.TPU_EXPORTER_SOURCE_CALLS_SKIPPED_TOTAL,
                  float(st["skipped"]), (source,))
            b.add(schema.TPU_EXPORTER_SOURCE_RECONNECTS_TOTAL,
                  float(st["reconnects"]), (source,))

        # Tracing surface: slow-poll count + ring occupancy. Read one poll
        # behind (this publish runs before the current trace finishes) —
        # the same lag every other point-in-time self-metric carries.
        if self._tracer is not None:
            slow, traces, spans = self._tracer.store.counts()
            b.add(schema.TPU_EXPORTER_SLOW_POLLS_TOTAL, float(slow))
            b.add(schema.TPU_EXPORTER_TRACES, float(traces))
            b.add(schema.TPU_EXPORTER_TRACE_SPANS, float(spans))

        polls = self._counters.inc(schema.TPU_EXPORTER_POLLS_TOTAL.name, ())
        b.add(schema.TPU_EXPORTER_POLLS_TOTAL, polls)
        b.add(
            schema.TPU_EXPORTER_INFO,
            1.0,
            {
                "version": __version__,
                "backend": getattr(self._backend, "name", "?"),
                "attribution": getattr(self._attribution, "name", "?"),
            },
        )
        b.add(schema.TPU_EXPORTER_LAST_POLL_TIMESTAMP_SECONDS, self._wallclock())
        if device_read_wall is not None:
            b.add(schema.TPU_EXPORTER_LAST_DEVICE_READ_TIMESTAMP_SECONDS,
                  device_read_wall[0], ("start",))
            b.add(schema.TPU_EXPORTER_LAST_DEVICE_READ_TIMESTAMP_SECONDS,
                  device_read_wall[1], ("end",))

        # Self-resource accounting (<1% CPU budget, auditable in production).
        cpu_s = utils.process_cpu_seconds()
        if cpu_s is not None:
            b.add(schema.TPU_EXPORTER_CPU_SECONDS_TOTAL, cpu_s)
        rss = utils.process_rss_bytes()
        if rss is not None:
            b.add(schema.TPU_EXPORTER_RSS_BYTES, rss)
        if self._scrape_rejects_fn is not None:
            try:
                for cause, n in self._scrape_rejects_fn().items():
                    b.add(
                        schema.TPU_EXPORTER_SCRAPE_REJECTS_TOTAL,
                        float(n),
                        (cause,),
                    )
            except Exception:  # noqa: BLE001 — accounting must never fail a poll
                pass
        if self._loop_overruns_fn is not None:
            try:
                b.add(
                    schema.TPU_EXPORTER_POLL_OVERRUNS_TOTAL,
                    float(self._loop_overruns_fn()),
                )
            except Exception:  # noqa: BLE001 — accounting must never fail a poll
                pass
        if self._client_write_timeouts_fn is not None:
            try:
                b.add(
                    schema.TPU_EXPORTER_CLIENT_WRITE_TIMEOUTS_TOTAL,
                    float(self._client_write_timeouts_fn()),
                )
            except Exception:  # noqa: BLE001 — accounting must never fail a poll
                pass

        # ICI counter state lives in self._chip_state (pruned above when it
        # outgrows its bound: vanished chips only, never live ones).
        # CounterStore now holds only the node-lifetime self-metric
        # counters, so there is nothing to prune per poll.

        if self._history is not None:
            # Point-in-time history accounting; reflects the append that ran
            # after the PREVIOUS swap (this poll's append happens below).
            hs = self._history.stats()
            b.add(schema.TPU_EXPORTER_HISTORY_SERIES, float(hs["series"]))
            b.add(schema.TPU_EXPORTER_HISTORY_SAMPLES, float(hs["samples"]))
            b.add(
                schema.TPU_EXPORTER_HISTORY_MEMORY_BYTES,
                float(hs["memory_bytes"]),
            )
            for reason, n in hs["evicted"].items():
                b.add(
                    schema.TPU_EXPORTER_HISTORY_EVICTED_SERIES_TOTAL,
                    float(n),
                    (reason,),
                )
            b.add(
                schema.TPU_EXPORTER_HISTORY_APPEND_SECONDS,
                self._history_append_s,
            )
            for tier in hs.get("tiers", ()):
                lbl = (f"{tier['step_s']:g}",)
                b.add(
                    schema.TPU_EXPORTER_HISTORY_TIER_BUCKETS,
                    float(tier["buckets"]), lbl,
                )
                b.add(
                    schema.TPU_EXPORTER_HISTORY_TIER_SPAN_SECONDS,
                    tier["span_s"], lbl,
                )

        if self._persister is not None:
            # Point-in-time persistence accounting (one poll behind, like
            # every other self-stat read mid-publish).
            try:
                ps = self._persister.stats()
                b.add(schema.TPU_EXPORTER_PERSIST_WAL_BYTES,
                      float(ps["wal_bytes"]))
                b.add(schema.TPU_EXPORTER_PERSIST_WAL_RECORDS_TOTAL,
                      float(ps["wal_records"]))
                b.add(schema.TPU_EXPORTER_PERSIST_SNAPSHOTS_TOTAL,
                      float(ps["snapshots"]))
                # Reason-split error/drop counters: a full disk
                # (reason="disk_full") and a flaky one (reason="io") page
                # different playbooks — see the DiskPressure alert.
                for reason, n in ps["errors_by_reason"].items():
                    b.add(schema.TPU_EXPORTER_PERSIST_ERRORS_TOTAL,
                          float(n), (reason,))
                for reason, n in ps["dropped_by_reason"].items():
                    b.add(schema.TPU_EXPORTER_PERSIST_DROPPED_TOTAL,
                          float(n), (reason,))
                b.add(schema.TPU_EXPORTER_PERSIST_FSYNC_SECONDS,
                      ps["last_fsync_s"])
                if ps["last_snapshot_wall"] > 0:
                    b.add(
                        schema.TPU_EXPORTER_PERSIST_SNAPSHOT_AGE_SECONDS,
                        max(self._wallclock() - ps["last_snapshot_wall"], 0.0),
                    )
            except Exception:  # noqa: BLE001 — accounting must never fail a poll
                pass

        if self._shipper is not None:
            # Conditional egress surface (EGRESS_SPECS), same rule as the
            # history/persist stats: declared + sampled only when a shipper
            # is attached, read one poll behind like every other self-stat.
            try:
                self._shipper.emit(b)
            except Exception:  # noqa: BLE001 — accounting must never fail a poll
                pass

        if self._governor is not None:
            # Conditional pressure surface (PRESSURE_SPECS): the ladder
            # rung, bytes-vs-budget pair, and every shed/recover
            # transition — the governor's cached numbers, no disk walk.
            try:
                self._governor.emit(b)
            except Exception:  # noqa: BLE001 — accounting must never fail a poll
                pass

        # +1 accounts for the series-count series itself.
        b.add(schema.TPU_EXPORTER_SERIES, float(b.series_count + 1))
        snap = b.build(timestamp=self._wallclock(), transfer=True)
        self._store.swap(snap)
        return snap

    # ------------------------------------------------------------- ICI fold

    def _fold_ici_fast(self, ici_total_s: dict[tuple[str, ...], float],
                       ici_bw_s: dict[tuple[str, ...], float],
                       dt: float, seq: int) -> None:
        """Steady-state fold: raw totals were extracted into flat['raw_buf']
        by the chip loop (layout verified); delta/clip/accumulate/rate happen
        as four numpy ops over all links at once, and the series dicts fill
        via C-speed dict.update. Valid because every link in the block was
        seen at the previous sampled publish (flat['seq'] == seq-1 by
        construction), which is exactly the slow path's bw-eligibility rule.
        """
        import numpy as np

        flat = self._ici_flat
        raw = np.array(flat["raw_buf"], dtype=np.float64)
        delta = raw - flat["raw_prev"]
        np.maximum(delta, 0.0, out=delta)  # device reset ⇒ counter holds
        folded = flat["folded"]
        folded += delta
        keys = flat["keys"]
        ici_total_s.update(zip(keys, folded.tolist()))
        # Same whole-bytes/s rounding as the slow path (renderer fast path).
        bw = np.rint(delta * (1.0 / dt))
        ici_bw_s.update(zip(keys, bw.tolist()))
        flat["raw_prev"] = raw
        flat["seq"] = seq

    def _export_ici_flat(self) -> None:
        """Write the flat arrays back into the per-link recs in _chip_state —
        they went stale while the fast path ran — then drop the block."""
        flat = self._ici_flat
        if flat is None:
            return
        raw_prev = flat["raw_prev"]
        folded = flat["folded"]
        seq = flat["seq"]
        for i, rec in enumerate(flat["recs"]):
            f = float(folded[i])
            rec[0] = float(raw_prev[i])
            rec[1] = f
            rec[2] = f
            rec[3] = seq
        self._ici_flat = None

    def _fold_ici_slow(self, chip_cached: list[tuple[Any, tuple]],
                       ici_total_s: dict[tuple[str, ...], float],
                       ici_bw_s: dict[tuple[str, ...], float],
                       dt: float | None, seq: int) -> None:
        """Per-link fold (first poll, churn, layout change): the reference
        semantics — monotonic fold with reset tolerance, rate only for links
        also seen at seq-1 — and the builder of the flat block the fast path
        uses on subsequent polls."""
        self._export_ici_flat()
        chip_state = self._chip_state
        flat_chips: list = []
        keys: list = []
        flat_recs: list = []
        base = 0
        for chip, cached in chip_cached:
            chip_tuple, link_tuples, _ = cached
            info = chip.info
            link_recs = chip_state.get(info.chip_id)
            if link_recs is None:
                link_recs = chip_state[info.chip_id] = {}
            ids: list = []
            for link in chip.ici_links:
                raw = link.transferred_bytes_total
                lv = link_tuples.get(link.link)
                if lv is None:
                    lv = link_tuples[link.link] = chip_tuple + (link.link,)  # ICI_LABELS ordering
                rec = link_recs.get(link.link)
                if rec is None:
                    # First sighting of this chip+link: seed the monotonic
                    # fold at the current raw reading
                    # (CounterStore.observe_total semantics).
                    folded = raw if raw >= 0 else 0.0
                    rec = link_recs[link.link] = [raw, folded, folded, seq]
                    ici_total_s[lv] = folded
                else:
                    raw_prev, folded, rate_base, last_seq = rec
                    delta = raw - raw_prev
                    if delta > 0:
                        folded = rec[1] = folded + delta
                    rec[0] = raw
                    ici_total_s[lv] = folded
                    if dt is not None and last_seq == seq - 1:
                        # Rounded to whole bytes/s: sub-byte rate precision
                        # is noise, and integral values take the renderer's
                        # fast integer path.
                        bw = (folded - rate_base) / dt
                        ici_bw_s[lv] = round(bw) if bw > 0.0 else 0.0
                    rec[2] = folded
                    rec[3] = seq
                ids.append(link.link)
                keys.append(lv)
                flat_recs.append(rec)
            flat_chips.append((cached, tuple(ids), base))
            base += len(ids)

        try:
            import numpy as np
        except ImportError:
            # No numpy (minimal image): stay on the per-link fold every poll
            # — correct, just without the steady-state speedup.
            return

        self._ici_flat = {
            "chips": flat_chips,
            "keys": keys,
            "recs": flat_recs,
            "raw_buf": [0.0] * len(keys),
            "raw_prev": np.array([r[0] for r in flat_recs], dtype=np.float64),
            "folded": np.array([r[1] for r in flat_recs], dtype=np.float64),
            "seq": seq,
        }

    def _fold_dcn(self, chip_cached: list[tuple[Any, tuple]],
                  dcn_total_s: dict[tuple[str, ...], float],
                  dcn_bw_s: dict[tuple[str, ...], float],
                  dt: float | None, seq: int) -> None:
        """Per-link DCN fold: identical semantics to the slow ICI fold
        (monotonic with reset tolerance; rate only for links also seen at
        seq-1). Shares each chip's cached link-label-tuple dict with ICI —
        a given link id renders to the same label tuple either way, and
        the two counter families never collide (different metric names)."""
        dcn_state = self._dcn_state
        for chip, cached in chip_cached:
            links = chip.dcn_links
            if not links:
                continue
            chip_tuple, link_tuples, _ = cached
            link_recs = dcn_state.get(chip.info.chip_id)
            if link_recs is None:
                link_recs = dcn_state[chip.info.chip_id] = {}
            for link in links:
                raw = link.transferred_bytes_total
                lv = link_tuples.get(link.link)
                if lv is None:
                    lv = link_tuples[link.link] = chip_tuple + (link.link,)
                rec = link_recs.get(link.link)
                if rec is None:
                    folded = raw if raw >= 0 else 0.0
                    link_recs[link.link] = [raw, folded, folded, seq]
                    dcn_total_s[lv] = folded
                    continue
                raw_prev, folded, rate_base, last_seq = rec
                delta = raw - raw_prev
                if delta > 0:
                    folded = rec[1] = folded + delta
                rec[0] = raw
                dcn_total_s[lv] = folded
                if dt is not None and last_seq == seq - 1:
                    bw = (folded - rate_base) / dt
                    dcn_bw_s[lv] = round(bw) if bw > 0.0 else 0.0
                rec[2] = folded
                rec[3] = seq

    def close(self) -> None:
        for sup in self._supervisors.values():
            sup.shutdown()
        self._backend.close()
        self._attribution.close()


class CollectorLoop:
    """Background thread driving Collector.poll_once on a fixed schedule.

    Ticks at ``start + n·interval`` (no drift), skips ticks it cannot meet
    (logs + counts overruns rather than queueing), and exits promptly on
    ``stop()`` — real SIGTERM drain for DaemonSet rolling updates, which the
    reference lacks entirely (SURVEY.md §3.4).

    Thread-death supervision: per-iteration containment catches ``Exception``,
    but a ``BaseException`` escaping ``poll_once`` (SystemExit from a
    misbehaving dependency, MemoryError, a bug in the containment itself)
    would silently kill the thread — snapshots stop swapping and only the
    slow ``health_max_age_s`` staleness trip would notice. Instead the loop
    is restarted ONCE; a second death marks it ``dead``, which the app's
    ``/healthz`` hook reports as an immediate 503 so kubelet restarts the
    pod promptly.

    Boot is the exception to restart-once: a crash BEFORE the first
    iteration ever completed is usually a transient boot-time wedge (the
    device runtime still initializing while kubelet races the DaemonSet
    up), and declaring ``dead`` after one retry turns a 2-second wedge
    into a pod restart loop. First-poll crash loops therefore retry up to
    ``boot_max_restarts`` times with a small exponential delay
    (``boot_restart_backoff_s`` · 2^n) before staying down; once any
    iteration has completed, the steady-state restart-once contract is
    unchanged.
    """

    MAX_RESTARTS = 1
    BOOT_MAX_RESTARTS = 3

    def __init__(self, collector: Collector, interval_s: float = 1.0,
                 boot_max_restarts: int = BOOT_MAX_RESTARTS,
                 boot_restart_backoff_s: float = 0.25) -> None:
        if interval_s <= 0:
            raise ValueError("interval must be positive")
        self._collector = collector
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._restart_lock = threading.Lock()
        self.overruns = 0
        self.restarts = 0
        self.dead = False
        self.boot_max_restarts = boot_max_restarts
        self.boot_restart_backoff_s = boot_restart_backoff_s
        # Flipped after the first completed iteration (crash or not inside
        # poll_once's own containment — "completed" means the thread
        # survived it); selects the boot vs steady-state restart budget.
        self.first_iteration_done = False

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("already started")
        self._thread = self._spawn()

    def _spawn(self) -> threading.Thread:
        t = threading.Thread(
            target=self._run_guarded, name="tpu-exporter-poll", daemon=True
        )
        t.start()
        return t

    def _run_guarded(self) -> None:
        try:
            self._run()
        except BaseException:  # noqa: BLE001  # lint: disable=bare-except(thread-death supervision: the ONE sanctioned poll-restart path — see class docstring)
            # Decide + mutate under the lock; log AFTER release (lock-io
            # discipline — log handlers do stream I/O, and stop() takes
            # this lock on the SIGTERM drain path).
            with self._restart_lock:
                if self._stop.is_set():
                    return
                boot = not self.first_iteration_done
                budget = self.boot_max_restarts if boot else self.MAX_RESTARTS
                respawn = self.restarts < budget
                delay = 0.0
                if respawn:
                    self.restarts += 1
                    if boot:
                        # Exponential boot backoff: a transient device
                        # wedge gets a beat to clear before the retry; a
                        # deterministic crash burns the budget in ~2 s
                        # instead of hot-looping.
                        delay = self.boot_restart_backoff_s * (
                            2.0 ** (self.restarts - 1)
                        )
                    else:
                        self._thread = self._spawn()
                else:
                    self.dead = True
            if respawn:
                log.critical(
                    "poll loop thread died unexpectedly%s; restarting "
                    "(%d/%d)%s",
                    " during boot (first poll never completed)" if boot
                    else "",
                    self.restarts, budget,
                    f" in {delay:g}s" if delay > 0 else "",
                    exc_info=True,
                )
                if delay > 0:
                    # Outside the lock: stop() must never wait on this.
                    if self._stop.wait(delay):
                        return
                    with self._restart_lock:
                        if self._stop.is_set():
                            return
                        self._thread = self._spawn()
            else:
                log.critical(
                    "poll loop died again (%d restart(s) used); staying "
                    "down — /healthz reports 503", self.restarts,
                    exc_info=True,
                )

    def _run(self) -> None:
        start = time.monotonic()
        n = 0
        while not self._stop.is_set():
            try:
                self._collector.poll_once()
            except Exception:  # noqa: BLE001 — the loop must survive anything
                log.exception("poll iteration failed")
            if not self.first_iteration_done:
                self.first_iteration_done = True
                if self.restarts:
                    # The boot-time wedge cleared: the steady-state budget
                    # starts fresh (a restart used booting must not spend
                    # the one steady-state restart).
                    self.restarts = 0
            n += 1
            next_tick = start + n * self.interval_s
            now = time.monotonic()
            if next_tick <= now:
                missed = int((now - start) / self.interval_s) - n + 1
                if missed > 0:
                    self.overruns += missed
                    n += missed
                    next_tick = start + n * self.interval_s
            self._stop.wait(max(next_tick - time.monotonic(), 0.0))

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        with self._restart_lock:  # the thread may have been restart-swapped
            t = self._thread
            self._thread = None
        if t is not None:
            t.join(timeout=timeout)
