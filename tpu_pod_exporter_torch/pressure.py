"""Resource-pressure governor — degradation by policy, not by exception.

Every durable-state layer assumes a healthy machine: the
checkpoint + WAL (``persist.py``) assume the disk accepts writes, the
egress send buffer assumes it can grow, every ring and cache (history
tiers, trace ring, fleet query cache, root stale-serve views) assumes
memory is free, and the thread-per-connection server assumes scrapers are
polite. When the node itself misbehaves — ENOSPC, RSS pressure, FD
exhaustion, an NTP clock step — the exporter previously degraded by
*whatever exception surfaced first*. A production DaemonSet must degrade
by **explicit, documented policy** instead.

:class:`PressureGovernor` owns two degradation ladders, each a fixed
ordered list of rungs that shed the least valuable capability first and
recover rung by rung with hysteresis when the pressure lifts:

**Disk** (``--state-max-disk-mb`` across ``--state-dir`` + ``--egress-dir``,
plus immediate reaction to reported ENOSPC/EDQUOT):

1. ``wal_coarse``     — WAL sample coverage thinned (every Nth poll; the
   coarsest history tiers still rebuild from the checkpoint, so the cut
   costs raw-resolution restore fidelity, nothing else);
2. ``egress_compact`` — the egress send buffer rotates tiny segments so
   acked-but-unrotated bytes reclaim promptly, and the pending-backlog
   cap tightens (sheds via the existing ``WalBuffer.trim_to_bytes`` — a
   bounded, counted loss only while the receiver is down);
3. ``checkpoint_halved`` — checkpoint frequency halves (the worst-case
   restore staleness doubles — still bounded, still serving);
4. ``wal_off``        — the WAL stops entirely; the exporter keeps
   serving and checkpointing at the reduced cadence (restart loses the
   tail since the last checkpoint — the documented floor).

**Memory** (``--memory-budget-mb`` over the byte-accounted components —
coarse tiers shed LAST, because they are the cheapest bytes per second of
answerable history):

1. ``fleet_cache``  — the fleet query result cache is cleared and
   disabled (dashboard refreshes re-fan-out; correctness unchanged);
2. ``trace_halved`` — the trace ring halves (shorter incident lookback);
3. ``history_cut``  — the raw history rings rebuild at half capacity
   (retention cut: the downsample tiers keep answering the long windows).

Shedding decisions and the exposition read the SAME numbers: the
accounted usage, the budget, the ladder rung and every transition are
published (``tpu_exporter_pressure_state{resource}`` et al.,
:data:`~tpu_pod_exporter_torch.metrics.schema.PRESSURE_SPECS`) and mirrored to
a ``pressure-status.json`` sidecar for the ``status`` footer.

The governor runs on its own thread (the poll thread never touches the
disk-usage walk — same discipline as persistence and egress); component
hooks it calls are cheap attribute flips or bounded rebuilds on the
owning component's lock.

``python -m tpu_pod_exporter_torch.pressure --demo`` (``make pressure-demo``)
drills the ladders end to end: a disk drill against a real exporter on a
tiny budget (ladder climbs, WAL growth stops, the egress exactly-once
ledger stays intact, scraping keeps serving), a memory drill (sheds in
order until the accounted bytes fit), and a scrape-storm drill (admission
control keeps a polite scraper's p99 flat while hundreds of connections
are refused). ``--negative-control`` reruns a drill WITHOUT the governor
and passes only when the invariant visibly breaks — proving the drills
can fail.
"""

from __future__ import annotations

import errno
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from tpu_pod_exporter_torch.metrics import schema
from tpu_pod_exporter_torch.utils import RateLimitedLogger

log = logging.getLogger("tpu_pod_exporter_torch.pressure")

# errnos that mean "the disk is FULL", as opposed to flaky/unreachable —
# the distinction the persist `reason="disk_full"` counter split exists for.
_DISK_FULL_ERRNOS = frozenset({errno.ENOSPC, errno.EDQUOT})

# How long one reported ENOSPC keeps the disk ladder under pressure even
# when the byte budget (if any) is not breached: the write just failed, so
# the filesystem is full regardless of what our own directories measure.
FAULT_WINDOW_S = 30.0

SIDE_CAR_NAME = "pressure-status.json"


def is_disk_full_error(exc: BaseException) -> bool:
    """ENOSPC/EDQUOT detection shared by persist/egress error accounting."""
    return isinstance(exc, OSError) and exc.errno in _DISK_FULL_ERRNOS


def reclaim_tmp_files(dirs: list[str], min_age_s: float = 60.0,
                      now: float | None = None) -> int:
    """Unlink orphaned ``*.tmp`` files left by failed atomic writes
    (``persist.atomic_write`` interrupted by ENOSPC or a crash between
    write and rename). The age guard keeps a CONCURRENT atomic write's
    live temp file safe — pass ``min_age_s=0`` only at boot, before any
    writer thread exists. Returns the number of files reclaimed."""
    reclaimed = 0
    now = time.time() if now is None else now
    for d in dirs:
        if not d:
            continue
        try:
            names = os.listdir(d)
        except OSError:
            continue
        for name in names:
            if not name.endswith(".tmp"):
                continue
            path = os.path.join(d, name)
            try:
                if min_age_s > 0 and now - os.stat(path).st_mtime < min_age_s:
                    continue
                os.unlink(path)
                reclaimed += 1
            except OSError:
                continue
    if reclaimed:
        log.warning("reclaimed %d orphaned .tmp file(s) from failed atomic "
                    "writes", reclaimed)
    return reclaimed


def dir_usage_bytes(path: str) -> int:
    """Total bytes of regular files directly under ``path`` (the state and
    egress dirs are flat by construction — no recursion needed)."""
    total = 0
    try:
        with os.scandir(path) as it:
            for entry in it:
                try:
                    if entry.is_file(follow_symlinks=False):
                        total += entry.stat(follow_symlinks=False).st_size
                except OSError:
                    continue
    except OSError:
        return 0
    return total


@dataclass
class Rung:
    """One ladder rung: ``apply`` sheds, ``release`` restores. Both must be
    idempotent and cheap (attribute flips / bounded rebuilds) — they run on
    the governor thread while the component keeps serving."""

    name: str
    apply: Callable[[], None]
    release: Callable[[], None]


@dataclass
class _Ladder:
    resource: str
    usage_fn: Callable[[], int]
    budget_bytes: int = 0          # 0 = no byte budget (fault-driven only)
    recover_frac: float = 0.85     # hysteresis: recover below this fraction
    rungs: list[Rung] = field(default_factory=list)
    level: int = 0
    sheds: int = 0
    recovers: int = 0
    last_usage: int = 0
    last_shed_wall: float = 0.0
    last_recover_wall: float = 0.0
    fault_until_mono: float = 0.0  # ENOSPC window (disk ladder only)
    quiet_since_mono: float | None = None

    def under_pressure(self, now_mono: float) -> bool:
        if now_mono < self.fault_until_mono:
            return True
        return bool(self.budget_bytes) and self.last_usage > self.budget_bytes

    def can_recover(self, now_mono: float) -> bool:
        if now_mono < self.fault_until_mono:
            return False
        if not self.budget_bytes:
            return True  # fault window expired — the only pressure source
        return self.last_usage <= self.recover_frac * self.budget_bytes


class PressureGovernor:
    """The two-ladder resource governor. Construction wires budgets; the
    component rungs are registered by ``app.py`` (exporter shape) or a
    harness; ``start()`` spawns the check thread. Every method is safe to
    call from any thread; rung callbacks run on the governor thread only.
    """

    def __init__(
        self,
        disk_budget_bytes: int = 0,
        memory_budget_bytes: int = 0,
        check_interval_s: float = 2.0,
        hysteresis_s: float = 30.0,
        sidecar_dir: str = "",
        clock: Callable[[], float] = time.monotonic,
        wallclock: Callable[[], float] = time.time,
    ) -> None:
        self.check_interval_s = check_interval_s
        self.hysteresis_s = hysteresis_s
        self.sidecar_dir = sidecar_dir
        self._clock = clock
        self._wallclock = wallclock
        self._rlog = RateLimitedLogger(log)
        self._lock = threading.Lock()
        self._disk = _Ladder("disk", self._disk_usage, disk_budget_bytes)
        self._memory = _Ladder("memory", self._memory_usage,
                               memory_budget_bytes)
        self._disk_paths: list[str] = []
        # name -> () -> int; the byte-accounted memory components. The
        # shed decision and the published tpu_exporter_pressure_bytes read
        # the SAME sum — no second accounting.
        self._memory_components: dict[str, Callable[[], int]] = {}
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._thread: threading.Thread | None = None
        self._disk_full_errors = 0
        self._last_sidecar_wall = 0.0

    # -------------------------------------------------------------- wiring

    def add_disk_path(self, path: str) -> None:
        if path and path not in self._disk_paths:
            self._disk_paths.append(path)

    def add_disk_rung(self, name: str, apply: Callable[[], None],
                      release: Callable[[], None]) -> None:
        self._disk.rungs.append(Rung(name, apply, release))

    def add_memory_rung(self, name: str, apply: Callable[[], None],
                        release: Callable[[], None]) -> None:
        self._memory.rungs.append(Rung(name, apply, release))

    def register_memory_component(self, name: str,
                                  bytes_fn: Callable[[], int]) -> None:
        self._memory_components[name] = bytes_fn

    def set_disk_budget_bytes(self, n: int) -> None:
        with self._lock:
            self._disk.budget_bytes = n
        self._kick.set()

    def set_memory_budget_bytes(self, n: int) -> None:
        with self._lock:
            self._memory.budget_bytes = n
        self._kick.set()

    @property
    def disk_budget_bytes(self) -> int:
        return self._disk.budget_bytes

    @property
    def memory_budget_bytes(self) -> int:
        return self._memory.budget_bytes

    # ------------------------------------------------------------- signals

    def report_io_error(self, exc: BaseException) -> bool:
        """Component hook for write failures: an ENOSPC/EDQUOT arms the
        disk ladder's fault window and triggers an immediate check (called
        from the persist writer / egress threads — never blocks). Returns
        True when the error was disk-full-shaped."""
        if not is_disk_full_error(exc):
            return False
        with self._lock:
            self._disk_full_errors += 1
            self._disk.fault_until_mono = self._clock() + FAULT_WINDOW_S
        self._kick.set()
        return True

    # ----------------------------------------------------------- the check

    def _disk_usage(self) -> int:
        return sum(dir_usage_bytes(p) for p in self._disk_paths)

    def _memory_usage(self) -> int:
        total = 0
        for fn in self._memory_components.values():
            try:
                total += int(fn())
            except Exception:  # noqa: BLE001 — accounting must not kill the governor
                continue
        return total

    def tick(self) -> bool:
        """One evaluation of both ladders (normally driven by the governor
        thread; public so tests and drills can step deterministically).
        Returns True when any rung moved."""
        changed = False
        for ladder in (self._disk, self._memory):
            changed = self._tick_ladder(ladder) or changed
        if changed or self._wallclock() - self._last_sidecar_wall >= 30.0:
            self._write_sidecar()
        return changed

    def _tick_ladder(self, ladder: _Ladder) -> bool:
        usage = ladder.usage_fn()
        now_mono = self._clock()
        with self._lock:
            ladder.last_usage = usage
            pressured = ladder.under_pressure(now_mono)
            shed_rung: Rung | None = None
            release_rung: Rung | None = None
            if pressured:
                ladder.quiet_since_mono = None
                if ladder.level < len(ladder.rungs):
                    shed_rung = ladder.rungs[ladder.level]
                    ladder.level += 1
                    ladder.sheds += 1
                    ladder.last_shed_wall = self._wallclock()
            elif ladder.level > 0 and ladder.can_recover(now_mono):
                if ladder.quiet_since_mono is None:
                    ladder.quiet_since_mono = now_mono
                elif now_mono - ladder.quiet_since_mono >= self.hysteresis_s:
                    release_rung = ladder.rungs[ladder.level - 1]
                    ladder.level -= 1
                    ladder.recovers += 1
                    ladder.last_recover_wall = self._wallclock()
                    # Each further recovery needs its own quiet window —
                    # rung-by-rung, never a cliff back to full throughput.
                    ladder.quiet_since_mono = now_mono
            else:
                ladder.quiet_since_mono = None
        # Callbacks OUTSIDE the governor lock: they take component locks.
        if shed_rung is not None:
            self._rlog.warning(
                f"shed:{ladder.resource}",
                "%s pressure: usage %d bytes vs budget %d — shedding rung "
                "%d (%s)", ladder.resource, usage, ladder.budget_bytes,
                ladder.level, shed_rung.name,
            )
            self._run_rung(shed_rung.apply, ladder, shed_rung.name, "apply")
            if ladder.resource == "disk":
                # A full disk is exactly when orphaned temp files matter.
                reclaim_tmp_files(self._disk_paths)
            return True
        if release_rung is not None:
            self._rlog.recovery(
                f"shed:{ladder.resource}",
                "%s pressure lifted: usage %d bytes vs budget %d — "
                "recovering rung %s (level now %d)", ladder.resource,
                usage, ladder.budget_bytes, release_rung.name, ladder.level,
            )
            self._run_rung(release_rung.release, ladder, release_rung.name,
                          "release")
            return True
        return False

    def _run_rung(self, fn: Callable[[], None], ladder: _Ladder,
                  name: str, what: str) -> None:
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — a broken rung must not kill the governor
            self._rlog.warning(
                f"rung:{ladder.resource}:{name}",
                "pressure rung %s/%s %s failed: %s", ladder.resource, name,
                what, e,
            )

    # ------------------------------------------------------------- thread

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="tpu-exporter-pressure", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._kick.clear()
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the governor must survive anything
                log.exception("pressure check failed")
            # Either the interval elapses or a reported ENOSPC / budget
            # change kicks an immediate re-check.
            self._kick.wait(self.check_interval_s)

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._kick.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            self._thread = None

    # -------------------------------------------------------- introspection

    def _ladder_stats(self, ladder: _Ladder) -> dict[str, Any]:
        rungs = [r.name for r in ladder.rungs]
        return {
            "level": ladder.level,
            "rung": rungs[ladder.level - 1] if ladder.level else "",
            "rungs": rungs,
            "usage_bytes": ladder.last_usage,
            "budget_bytes": ladder.budget_bytes,
            "sheds": ladder.sheds,
            "recovers": ladder.recovers,
            "last_shed_wall": ladder.last_shed_wall,
            "last_recover_wall": ladder.last_recover_wall,
        }

    def stats(self) -> dict[str, Any]:
        """Cached-usage snapshot (no disk walk — safe on the poll thread;
        usage numbers are as of the governor thread's last tick)."""
        with self._lock:
            out: dict[str, Any] = {
                "disk": self._ladder_stats(self._disk),
                "memory": self._ladder_stats(self._memory),
                "disk_full_errors": self._disk_full_errors,
            }
        out["disk"]["paths"] = list(self._disk_paths)
        out["memory"]["components"] = sorted(self._memory_components)
        return out

    def emit(self, b: Any) -> None:
        """Publish the pressure surface into a SnapshotBuilder (collector
        publish hook — conditional surface, PRESSURE_SPECS)."""
        for spec in schema.PRESSURE_SPECS:
            b.declare(spec)
        with self._lock:
            rows = [
                (ladder.resource, ladder.level, ladder.last_usage,
                 ladder.budget_bytes, ladder.sheds, ladder.recovers)
                for ladder in (self._disk, self._memory)
            ]
        for resource, level, usage, budget, sheds, recovers in rows:
            b.add(schema.TPU_EXPORTER_PRESSURE_STATE, float(level),
                  (resource,))
            b.add(schema.TPU_EXPORTER_PRESSURE_BYTES, float(usage),
                  (resource,))
            b.add(schema.TPU_EXPORTER_PRESSURE_BUDGET_BYTES, float(budget),
                  (resource,))
            b.add(schema.TPU_EXPORTER_PRESSURE_TRANSITIONS_TOTAL,
                  float(sheds), (resource, "shed"))
            b.add(schema.TPU_EXPORTER_PRESSURE_TRANSITIONS_TOTAL,
                  float(recovers), (resource, "recover"))

    def memory_component_bytes(self) -> dict[str, int]:
        """Per-component byte breakdown (/debug/vars — the same callables
        the shed decision sums)."""
        out: dict[str, int] = {}
        for name, fn in self._memory_components.items():
            try:
                out[name] = int(fn())
            except Exception:  # noqa: BLE001
                out[name] = -1
        return out

    def _write_sidecar(self) -> None:
        """Operator-facing sidecar for the ``status`` pressure footer.
        Best-effort by design: on a genuinely full disk this write fails —
        the footer then shows the last state that fit, which is still
        truer than nothing."""
        if not self.sidecar_dir:
            return
        self._last_sidecar_wall = self._wallclock()
        doc = {"wall": self._last_sidecar_wall, **self.stats()}
        from tpu_pod_exporter_torch.persist import atomic_write

        try:
            atomic_write(
                os.path.join(self.sidecar_dir, SIDE_CAR_NAME),
                json.dumps(doc).encode(),
            )
        except OSError:
            pass


def pressure_status_summary(sidecar_dir: str) -> dict[str, Any] | None:
    """Read the governor's on-disk sidecar for the out-of-process
    ``status`` footer (None when absent/unreadable — no governor ran
    here, or nothing was writable)."""
    try:
        with open(os.path.join(sidecar_dir, SIDE_CAR_NAME),
                  encoding="utf-8") as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


# ------------------------------------------------------- exporter-shape wiring


def build_exporter_governor(
    cfg: Any,
    persister: Any = None,
    shipper: Any = None,
    history: Any = None,
    trace_store: Any = None,
) -> PressureGovernor | None:
    """Wire the exporter-shaped ladders from an ExporterConfig and the
    components app.py built. Returns None when nothing is governable
    (no budgets configured and no durable-state layer to protect)."""
    disk_budget = int(cfg.state_max_disk_mb * (1 << 20))
    memory_budget = int(cfg.memory_budget_mb * (1 << 20))
    has_disk = bool(cfg.state_dir) or shipper is not None
    if not has_disk and memory_budget <= 0:
        return None
    gov = PressureGovernor(
        disk_budget_bytes=disk_budget if has_disk else 0,
        memory_budget_bytes=memory_budget,
        sidecar_dir=cfg.state_dir,
    )
    if cfg.state_dir:
        gov.add_disk_path(cfg.state_dir)
    if shipper is not None:
        gov.add_disk_path(shipper.egress_dir)
    # --- disk ladder, shallowest shed first -----------------------------
    if persister is not None:
        gov.add_disk_rung(
            "wal_coarse",
            lambda: persister.set_wal_stride(4),
            lambda: persister.set_wal_stride(1),
        )
    if shipper is not None:
        gov.add_disk_rung(
            "egress_compact",
            lambda: shipper.set_disk_pressure(True),
            lambda: shipper.set_disk_pressure(False),
        )
    if persister is not None:
        gov.add_disk_rung(
            "checkpoint_halved",
            lambda: persister.set_snapshot_interval_factor(2.0),
            lambda: persister.set_snapshot_interval_factor(1.0),
        )
        gov.add_disk_rung(
            "wal_off",
            lambda: persister.set_wal_enabled(False),
            lambda: persister.set_wal_enabled(True),
        )
        persister.set_pressure_hook(gov.report_io_error)
    if shipper is not None:
        shipper.set_pressure_hook(gov.report_io_error)
    # --- memory ladder, coarse tiers last -------------------------------
    if memory_budget > 0:
        # The exporter has no fleet cache; the rung exists on aggregator
        # shapes (the harness registers it). Trace then history.
        if trace_store is not None:
            gov.register_memory_component(
                "trace", trace_store.memory_bytes)
            gov.add_memory_rung(
                "trace_halved",
                lambda: trace_store.set_max_traces(
                    max(trace_store.max_traces // 2, 8)),
                lambda: trace_store.set_max_traces(cfg.trace_max_traces),
            )
        if history is not None:
            gov.register_memory_component(
                "history", lambda: int(history.stats()["memory_bytes"]))
            base_capacity = history.capacity
            gov.add_memory_rung(
                "history_cut",
                lambda: history.set_capacity(
                    max(history.capacity // 2, 16)),
                lambda: history.set_capacity(base_capacity),
            )
    return gov


# ------------------------------------------------------- root-store wiring


def register_store_rungs(
    gov: PressureGovernor, store: Any,
    store_fn: Callable[[], Any] | None = None,
) -> None:
    """Wire a root-side FleetStore (tpu_pod_exporter_torch.store) into the
    governor: the disk ladder gains the ``store_thin`` rung — the store
    drops its FINEST tier first (coarse tiers last: they are the cheapest
    bytes per second of answerable history), with the dropped records
    counted as ``reason="shed"`` — and the store's in-memory tier bytes
    register with the memory ladder's component accounting (the shed
    decision and ``tpu_root_store_memory_bytes`` read the same number).
    The store's WAL appends also report ENOSPC through the same fault
    window the persist/egress writers use.

    ``store_fn``: harnesses that SWAP store instances mid-run (the
    scenario engine's root_restart, the retention demo's kill/replay)
    pass a getter so the rungs and accounting follow the live instance;
    the swapping caller must re-apply ``set_pressure_hook`` (and any held
    thin state) to each fresh instance — hooks live on the instance. The
    disk paths are registered once: they derive from the tier config,
    which an instance swap on the same dir preserves."""
    get = store_fn if store_fn is not None else (lambda: store)
    for path in store.disk_paths():
        gov.add_disk_path(path)
    gov.add_disk_rung(
        "store_thin",
        lambda: get().set_thin(True),
        lambda: get().set_thin(False),
    )
    gov.register_memory_component("store", lambda: int(get().memory_bytes()))
    store.set_pressure_hook(gov.report_io_error)


# ----------------------------------------------------- stream-hub wiring


def register_stream_rung(
    gov: PressureGovernor, hub: Any,
    hub_fn: Callable[[], Any] | None = None,
) -> None:
    """Wire a streaming dashboard hub (tpu_pod_exporter_torch.stream.StreamHub)
    into the memory ladder: the ``stream_shed`` rung sheds the OLDEST
    half of the live subscriptions (each gets a final ``shed`` frame and
    a counted ``tpu_stream_sheds_total{reason="pressure"}``) and halves
    the effective subscriber cap so a storm cannot instantly refill what
    was shed; recovery restores the configured cap. Ordered after the
    fleet-cache rung by registration order in the harnesses: dropping a
    cache is cheaper than dropping viewers, so viewers shed last among
    the cheap rungs but before history cuts. The hub's retained bytes
    (last answers + catch-up rings) register as a memory component — the
    shed decision and /debug/vars read the same number."""
    get = hub_fn if hub_fn is not None else (lambda: hub)
    gov.register_memory_component("stream",
                                  lambda: int(get().memory_bytes()))
    gov.add_memory_rung(
        "stream_shed",
        lambda: get().apply_pressure(),
        lambda: get().release_pressure(),
    )


def build_serving_governor(
    memory_budget_bytes: int,
    sidecar_dir: str = "",
    cache_plane: Any = None,
    hub: Any = None,
    governor: "PressureGovernor | None" = None,
) -> "PressureGovernor | None":
    """The serving-tier memory ladder the CLIs share (flat aggregator,
    root, replica — ``--memory-budget-mb``): the query-plane result
    cache sheds FIRST (queries re-fan-out; pure speed, zero viewers
    lost), live stream subscriptions LAST via :func:`register_stream_rung`
    (dropping viewers costs reconnects). Extends ``governor`` when the
    tier already built one (the root's store disk budget) — one governor
    per process — else builds and STARTS a fresh one. Returns the
    governor (unchanged when no budget is configured)."""
    if memory_budget_bytes <= 0:
        return governor
    gov = governor if governor is not None else PressureGovernor(
        sidecar_dir=sidecar_dir)
    gov.set_memory_budget_bytes(memory_budget_bytes)
    if cache_plane is not None and hasattr(cache_plane, "cache_bytes"):
        gov.register_memory_component(
            "fleet_cache", lambda: int(cache_plane.cache_bytes()))
        gov.add_memory_rung(
            "fleet_cache",
            lambda: cache_plane.set_cache_enabled(False),
            lambda: cache_plane.set_cache_enabled(True),
        )
    if hub is not None:
        register_stream_rung(gov, hub)
    if governor is None:
        gov.start()
    return gov


# --------------------------------------------------------------------- demo


def main(argv: list[str] | None = None) -> int:
    import argparse

    from tpu_pod_exporter_torch.pressure_demo import (
        run_disk_drill,
        run_memory_drill,
        run_storm_drill,
    )

    p = argparse.ArgumentParser(
        prog="tpu-pod-exporter-pressure",
        description="Resource-pressure governor drills: disk-full ladder, "
                    "memory-budget shedding, scrape-storm admission "
                    "control (make pressure-demo).",
    )
    p.add_argument("--demo", action="store_true",
                   help="run the three pressure drills against real "
                        "components and fail on any broken invariant")
    p.add_argument("--drill", default="all",
                   help="disk | memory | storm | all")
    p.add_argument("--negative-control", action="store_true",
                   help="re-run the disk drill WITHOUT the governor and "
                        "succeed only if the budget invariant visibly "
                        "breaks (proves the drill can fail)")
    p.add_argument("--storm-conns", type=int, default=500,
                   help="concurrent storm connections for the scrape-storm "
                        "drill (CI uses a reduced count)")
    p.add_argument("--p99-slack-frac", type=float, default=0.05,
                   help="allowed fractional p99 regression for the polite "
                        "scraper during the storm")
    p.add_argument("--p99-slack-ms", type=float, default=5.0,
                   help="absolute p99 noise floor added to the budget")
    p.add_argument("--state-dir", default="",
                   help="disk-drill state dir (default: temp, removed on "
                        "success)")
    ns = p.parse_args(argv)

    if ns.negative_control:
        return run_disk_drill(ns.state_dir, governor=False)
    if not ns.demo:
        p.error("need --demo or --negative-control")
    rc = 0
    if ns.drill in ("all", "disk"):
        rc = rc or run_disk_drill(ns.state_dir, governor=True)
    if ns.drill in ("all", "memory"):
        rc = rc or run_memory_drill()
    if ns.drill in ("all", "storm"):
        rc = rc or run_storm_drill(ns.storm_conns, ns.p99_slack_frac,
                                   ns.p99_slack_ms / 1e3)
    if rc == 0:
        print("pressure-demo OK: ladder sheds by policy, recovers with "
              "hysteresis, and every rung is attributable from the "
              "exposition")
    return rc


if __name__ == "__main__":
    import sys

    sys.exit(main())
