"""Slice-level aggregator — cross-host rollups without a Prometheus.

On a multi-host slice (e.g. v5p-64: 8 hosts × 4 chips) each host runs one
exporter and cross-host aggregation is a *label join*, normally done by
Prometheus recording rules (SURVEY.md §2.8: exporters never talk to each
other; ICI/DCN are measured quantities, not transports). This optional
component computes the same joins for setups without a Prometheus: it
scrapes every per-host ``/metrics``, sums per-slice and per-workload, and
re-exports the rollups on its own ``/metrics``.

Deliberately an *observer of exporters*, not a peer: it consumes the public
exposition format over HTTP — the same bytes Prometheus would — so it works
against any mix of exporter versions and needs no new protocol. A target
that fails to scrape is reported down (``tpu_aggregator_target_up 0``) and
its chips simply drop out of the sums for that round; partial slices stay
honest via ``tpu_slice_hosts_reporting``.

The aggregator also serves the **federated query plane**
(``tpu_pod_exporter_torch.fleet``, ``--fleet-query``): its own ``/api/v1/*``
routes fan ``query_range``/``window_stats``/``series`` out to every
non-quarantined target and merge per-series answers with partial-result
semantics — one query shows a duty-cycle cliff across all 64 hosts of a
slice, riding each node's history tiers hours back.

Run: ``python -m tpu_pod_exporter_torch.aggregate --targets h0:8000,h1:8000``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import logging
import os
import signal
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Sequence

from tpu_pod_exporter_torch.collector import CollectorLoop
from tpu_pod_exporter_torch.metrics import (
    CounterStore,
    HistogramStore,
    PrefixCache,
    SnapshotBuilder,
    SnapshotStore,
)
from tpu_pod_exporter_torch.metrics import schema
from tpu_pod_exporter_torch.metrics.parse import (
    LayoutCache,
    ParseError,
    parse_exposition_layout,
)

from tpu_pod_exporter_torch.server import MetricsServer
from tpu_pod_exporter_torch.supervisor import CLOSED, STATE_VALUES, CircuitBreaker
from tpu_pod_exporter_torch.trace import format_traceparent
from tpu_pod_exporter_torch import utils
from tpu_pod_exporter_torch.utils import RateLimitedLogger

# The only sample names _consume folds. Passed to parse_exposition as a
# pre-parse filter: a 256-chip body is ~4k lines of which roughly half
# (per-link counters, percents, info/self series) are irrelevant here —
# skipping them before label parsing nearly halves round latency at
# 64-host scale (bench_aggregate.py).
CONSUMED_NAMES = frozenset({
    "tpu_chip_info",
    "tpu_hbm_used_bytes",
    "tpu_hbm_total_bytes",
    "tpu_tensorcore_duty_cycle_percent",
    "tpu_ici_link_bandwidth_bytes_per_second",
    "tpu_dcn_link_bandwidth_bytes_per_second",
    "tpu_host_info",
    "tpu_pod_chip_count",
    "tpu_pod_hbm_used_bytes",
    # The GPU device family's node surface (backend/nvml.py): same fold
    # slots, family-keyed slice accumulators — a mixed fleet's sums never
    # cross families.
    "gpu_chip_info",
    "gpu_hbm_used_bytes",
    "gpu_hbm_total_bytes",
    "gpu_utilization_percent",
    "gpu_pod_chip_count",
    "gpu_pod_memory_used_bytes",
})

log = logging.getLogger("tpu_pod_exporter_torch.aggregate")


def target_base_url(target: str) -> str:
    """``host:port`` (or a full /metrics URL) → the exporter's URL root,
    for the ``/api/v1/*`` history endpoints."""
    if target.startswith(("http://", "https://")):
        return target[: -len("/metrics")] if target.endswith("/metrics") else target
    return f"http://{target}"


def default_history_fetch(url: str, timeout_s: float) -> dict:
    """GET one history-API URL, parsed JSON. Raises on HTTP/parse failure
    (the caller treats any raise as 'no history answer from this target')."""
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:  # noqa: S310 — operator-supplied targets
        return json.loads(resp.read().decode("utf-8", errors="replace"))


# ``stages``: the seconds of FETCH_STAGES of the calling thread's last
# successful default_fetch. The round's scrape clears it before a fetch and
# reads it after, so the stages reach the round through any wrapper of
# default_fetch (one fetch's stages stay on the thread that made it).
_FETCH_STAGES = threading.local()
FETCH_STAGES = ("headers", "body", "gunzip", "decode")


def default_fetch(target: str, timeout_s: float,
                  traceparent: str | None = None) -> str:
    """``host:port`` (or full URL) → exposition text.

    Asks for gzip: the exporters serve a lazily-cached compressed body
    (~20× smaller than the ~900 KB plain text at 256 chips), which matters
    when the aggregator scrapes every host of a slice over DCN each round.

    ``traceparent`` (W3C Trace Context) carries the aggregator's round
    trace + scrape span onto the exporter, which records its serve time as
    a scrape span under that remote context — the cross-tier join asserted
    in tests/test_trace.py.

    A successful fetch leaves its stages on the thread (``_FETCH_STAGES``):
    headers (``urlopen`` up to the response's headers: connect, send, the
    target's serve and the first byte), body, gunzip (0 for an identity
    body) and decode.
    """
    url = target if target.startswith(("http://", "https://")) else f"http://{target}/metrics"
    headers = {"Accept-Encoding": "gzip"}
    if traceparent:
        headers["traceparent"] = traceparent
    req = urllib.request.Request(url, headers=headers)
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:  # noqa: S310 — operator-supplied targets
        t1 = time.monotonic()
        body = resp.read()
        t2 = time.monotonic()
        if (resp.headers.get("Content-Encoding") or "").lower() == "gzip":
            import gzip

            body = gzip.decompress(body)
        t3 = time.monotonic()
        text = body.decode("utf-8", errors="replace")
        t4 = time.monotonic()
    _FETCH_STAGES.stages = (t1 - t0, t2 - t1, t3 - t2, t4 - t3)
    return text


class _SliceAgg:
    """Mutable per-(slice, accelerator, family) accumulator for one round."""

    __slots__ = ("hosts", "chip_series_hosts", "chips", "hbm_used",
                 "hbm_total", "used_chips", "total_chips", "duty_sum",
                 "duty_n", "ici_bw", "ici_n", "dcn_bw", "dcn_n")

    def __init__(self) -> None:
        self.hosts: set[str] = set()
        # Hosts seen via ANY per-chip series but (possibly) not via
        # chip_info — only for the mixed-fleet diagnostic, never for counts.
        self.chip_series_hosts: set[str] = set()
        self.chips = 0
        self.hbm_used = 0.0
        self.hbm_total = 0.0
        # (host, chip_id) identity sets, not bare counts: a slice whose
        # chips published NO hbm series (HBM unreadable — collector round 4)
        # must omit the slice HBM rollups, and the percent is honest only
        # when used and total cover the SAME chips — equal counts over
        # disjoint sets (chip A used-only + chip B total-only) could read
        # >100% (code-review r5).
        self.used_chips: set[tuple[str, str]] = set()
        self.total_chips: set[tuple[str, str]] = set()
        self.duty_sum = 0.0
        self.duty_n = 0
        self.ici_bw = 0.0
        # Same rule as duty/HBM: a slice with NO ICI samples (runtime
        # without ICI counters) omits the rollup — 0.0 would read as
        # "interconnect idle", not "unmeasured". Ditto DCN.
        self.ici_n = 0
        self.dcn_bw = 0.0
        self.dcn_n = 0

    # Count/flag surface consumed by emit_rollups — the same attribute
    # names tpu_pod_exporter_torch.shard's SliceStats (rebuilt at the root tier
    # from tpu_leaf_slice_component series) exposes, so one emit path
    # serves both the flat aggregator and the sharded tree's root.
    @property
    def hosts_n(self) -> int:
        return len(self.hosts)

    @property
    def used_n(self) -> int:
        return len(self.used_chips)

    @property
    def total_n(self) -> int:
        return len(self.total_chips)

    @property
    def coverage_eq(self) -> bool:
        """Used and total HBM samples cover the SAME chip set — the slice
        percent is emitted only then (see emit_rollups)."""
        return self.used_chips == self.total_chips

    def orphan_hosts(self) -> set[str]:
        """Hosts contributing per-chip series but no tpu_chip_info rows
        (mixed-fleet diagnostic; empty at the root tier, where the leaf
        already warned)."""
        return self.chip_series_hosts - self.hosts


class _GroupAgg:
    """Mutable per-multislice-group accumulator for one round."""

    __slots__ = ("slices", "hosts_n", "chips", "hbm_used", "hbm_used_n",
                 "ici_bw", "ici_n", "dcn_bw", "dcn_n", "expected_slices")

    def __init__(self) -> None:
        self.slices: set[tuple[str, str, str]] = set()
        # Count, not a set: slice hosts are disjoint (one host belongs to
        # one slice), so summing per-slice counts equals the union size —
        # and the root tier only has counts to sum.
        self.hosts_n = 0
        self.chips = 0
        self.hbm_used = 0.0
        self.hbm_used_n = 0
        self.ici_bw = 0.0
        self.ici_n = 0
        self.dcn_bw = 0.0
        self.dcn_n = 0
        self.expected_slices = 0


class _WorkloadAgg:
    __slots__ = ("chips", "hbm_used", "hbm_used_n", "hosts")

    def __init__(self) -> None:
        self.chips = 0.0
        self.hbm_used = 0.0
        # Same absent-beats-fake-zero rule as _SliceAgg: a workload whose
        # pods emitted chip_count but no hbm series must omit workload HBM.
        self.hbm_used_n = 0
        self.hosts: set[str] = set()

    @property
    def hosts_n(self) -> int:
        return len(self.hosts)


def emit_rollups(b: SnapshotBuilder, slices: dict, workloads: dict,
                 slice_groups: dict,
                 rlog: RateLimitedLogger | None = None) -> None:
    """Fold the round accumulators into rollup series on ``b`` — the ONE
    emit path for ``tpu_slice_*`` / ``tpu_multislice_*`` / ``tpu_workload_*``.

    Shared between :class:`SliceAggregator` (accumulators fresh from
    ``_consume``) and the sharded tree's root tier
    (:class:`tpu_pod_exporter_torch.shard.RootAggregator`, accumulators rebuilt
    by summing per-shard ``tpu_leaf_*`` components), so the root's fleet
    rollups cannot drift from what a flat aggregator over the same scrape
    set would publish — the shard-demo asserts them equal against exactly
    that oracle. Consumes only the count/flag surface (``hosts_n``,
    ``used_n``, ``coverage_eq``, …), never the identity sets, because the
    root only has counts."""
    for key, agg in slices.items():
        # Mixed-fleet diagnostic (advisor r4): an exporter older than the
        # unconditional-chip_info change contributes HBM sums while its
        # chips/hosts_reporting read 0 — a silent undercount during
        # rolling upgrades. Not supported, but loudly not silently.
        orphan_hosts = agg.orphan_hosts()
        if orphan_hosts and rlog is not None:
            rlog.warning(
                f"orphan-hbm:{key[0]}",
                "slice %s: host(s) %s contribute per-chip series but "
                "zero tpu_chip_info rows — exporter too old? chips/"
                "hosts_reporting will undercount",
                key[0], sorted(orphan_hosts),
            )
        b.add(schema.TPU_SLICE_HOSTS_REPORTING, float(agg.hosts_n), key)
        b.add(schema.TPU_SLICE_CHIP_COUNT, float(agg.chips), key)
        # Emitted only when at least one chip actually reported HBM —
        # absent beats fake-zero, same rule the exporter applies to
        # per-chip and per-pod series.
        if agg.used_n:
            b.add(schema.TPU_SLICE_HBM_USED_BYTES, agg.hbm_used, key)
        if agg.total_n:
            b.add(schema.TPU_SLICE_HBM_TOTAL_BYTES, agg.hbm_total, key)
        # Percent only when used and total cover the SAME chip set —
        # mismatched coverage (e.g. a runtime serving bytes_in_use but
        # no bytes_limit on some chips) would yield a misleading or
        # >100% ratio (advisor r4) — and only over a positive capacity:
        # a percent of zero total is undefined, and 0.0 would read as
        # "idle" (same rule as the per-chip series).
        if agg.used_n and agg.coverage_eq and agg.hbm_total > 0:
            b.add(
                schema.TPU_SLICE_HBM_USED_PERCENT,
                schema.hbm_used_percent(agg.hbm_used, agg.hbm_total),
                key,
            )
        if agg.duty_n:
            b.add(
                schema.TPU_SLICE_DUTY_CYCLE_AVG_PERCENT,
                agg.duty_sum / agg.duty_n,
                key,
            )
        if agg.ici_n:
            b.add(schema.TPU_SLICE_ICI_BYTES_PER_SECOND, agg.ici_bw, key)
        if agg.dcn_n:
            b.add(schema.TPU_SLICE_DCN_BYTES_PER_SECOND, agg.dcn_bw, key)

    # Per-family fleet rollups: the slice sums grouped by the accelerator
    # family key (key[2]) — published rather than derived so mixed-fleet
    # dashboards and the store's `by (family)` rules never sum across
    # families by accident. Same absent-beats-fake-zero guards.
    fam_hosts: dict[str, float] = {}
    fam_chips: dict[str, float] = {}
    fam_used: dict[str, list[float]] = {}   # [sum, n]
    fam_total: dict[str, list[float]] = {}  # [sum, n]
    for key, agg in slices.items():
        fam = key[2] if len(key) > 2 else "tpu"
        fam_hosts[fam] = fam_hosts.get(fam, 0.0) + agg.hosts_n
        fam_chips[fam] = fam_chips.get(fam, 0.0) + agg.chips
        u = fam_used.setdefault(fam, [0.0, 0.0])
        u[0] += agg.hbm_used
        u[1] += agg.used_n
        t = fam_total.setdefault(fam, [0.0, 0.0])
        t[0] += agg.hbm_total
        t[1] += agg.total_n
    for fam in fam_chips:
        fkey = (fam,)
        b.add(schema.TPU_FLEET_FAMILY_HOSTS_REPORTING, fam_hosts[fam], fkey)
        b.add(schema.TPU_FLEET_FAMILY_CHIP_COUNT, fam_chips[fam], fkey)
        if fam_used[fam][1]:
            b.add(schema.TPU_FLEET_FAMILY_HBM_USED_BYTES,
                  fam_used[fam][0], fkey)
        if fam_total[fam][1]:
            b.add(schema.TPU_FLEET_FAMILY_HBM_TOTAL_BYTES,
                  fam_total[fam][0], fkey)

    # Multi-slice group rollups: join slices to groups via the
    # tpu_host_info membership map (BASELINE config 5). A slice without
    # a group (single-slice deployment) contributes to no group series,
    # and every sum keeps the absent-beats-fake-zero sample-count guards.
    # Membership is keyed (slice_name, accelerator) — tpu_host_info
    # carries no family — so the slice key's family element is dropped
    # for the lookup.
    groups: dict[str, _GroupAgg] = {}
    for skey, agg in slices.items():
        membership = slice_groups.get(tuple(skey)[:2])
        if membership is None:
            continue
        group, nslices_str = membership
        g = groups.get(group)
        if g is None:
            g = groups[group] = _GroupAgg()
        g.slices.add(skey)
        g.hosts_n += agg.hosts_n
        g.chips += agg.chips
        g.hbm_used += agg.hbm_used
        g.hbm_used_n += agg.used_n
        g.ici_bw += agg.ici_bw
        g.ici_n += agg.ici_n
        g.dcn_bw += agg.dcn_bw
        g.dcn_n += agg.dcn_n
        try:
            g.expected_slices = max(g.expected_slices, int(nslices_str))
        except ValueError:
            pass
    for group, g in groups.items():
        gkey = (group,)
        b.add(schema.TPU_MULTISLICE_SLICES_REPORTING, float(len(g.slices)), gkey)
        if g.expected_slices > 0:
            b.add(
                schema.TPU_MULTISLICE_EXPECTED_SLICES,
                float(g.expected_slices), gkey,
            )
        b.add(schema.TPU_MULTISLICE_HOSTS_REPORTING, float(g.hosts_n), gkey)
        b.add(schema.TPU_MULTISLICE_CHIP_COUNT, float(g.chips), gkey)
        if g.hbm_used_n:
            b.add(schema.TPU_MULTISLICE_HBM_USED_BYTES, g.hbm_used, gkey)
        if g.ici_n:
            b.add(schema.TPU_MULTISLICE_ICI_BYTES_PER_SECOND, g.ici_bw, gkey)
        if g.dcn_n:
            b.add(schema.TPU_MULTISLICE_DCN_BYTES_PER_SECOND, g.dcn_bw, gkey)

    for key, w in workloads.items():
        b.add(schema.TPU_WORKLOAD_CHIP_COUNT, w.chips, key)
        if w.hbm_used_n:  # absent beats fake-zero (advisor r4, medium)
            b.add(schema.TPU_WORKLOAD_HBM_USED_BYTES, w.hbm_used, key)
        b.add(schema.TPU_WORKLOAD_HOSTS, float(w.hosts_n), key)


def read_targets_file(path: str) -> tuple[str, ...]:
    """Parse a targets file: one ``host:port`` (or URL) per line, commas
    also accepted, ``#`` comments and blanks ignored. Deduped in order,
    same as ``--targets``. Raises OSError on an unreadable file — the
    caller decides whether that is fatal (boot) or a keep-last-known
    (reload)."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    out: list[str] = []
    for line in text.split("\n"):
        line = line.split("#", 1)[0]
        for part in line.split(","):
            part = part.strip()
            if part:
                out.append(part)
    return tuple(dict.fromkeys(out))


class TargetSet:
    """Dynamic scrape-target membership plus everything keyed per target —
    circuit breakers (with optional ``persist.BreakerStateFile`` carryover)
    and parse-layout caches.

    Extracted from :class:`SliceAggregator` (which used to rebuild its
    target tuple from argv once, at construction) so that target add/remove
    no longer requires a restart, and so the sharded leaf tier
    (:class:`tpu_pod_exporter_torch.shard.LeafAggregator`) can share it: a leaf's
    membership is ``filter_fn`` (its consistent-hash shard) applied to the
    same targets file every other leaf reads.

    Sources of membership, in precedence order:

    - ``targets_file``: one target per line (see :func:`read_targets_file`),
      re-read on :meth:`refresh` whenever its mtime changes — the live
      resharding path. An unreadable or vanished file keeps the last known
      membership (a fat-fingered ``mv`` must not empty the fleet view).
    - the static ``targets`` tuple: the classic ``--targets`` flag, used as
      the whole membership when no file is given, and as the boot fallback
      while the file is unreadable.

    Thread model: all mutation happens on the aggregator's round thread
    (``refresh()`` at round start). Concurrent readers (fleet query plane
    HTTP threads) do per-key ``get`` on the breakers dict — mutated in
    place, one GIL-atomic op at a time, never re-bound — and read the
    targets tuple, which is swapped atomically.
    """

    def __init__(
        self,
        targets: Sequence[str] = (),
        targets_file: str = "",
        filter_fn: Callable[[tuple[str, ...]], Iterable[str]] | None = None,
        breaker_failures: int = 0,
        breaker_backoff_s: float = 10.0,
        breaker_backoff_max_s: float = 120.0,
        breaker_store: Any = None,
        wallclock: Callable[[], float] = time.time,
    ) -> None:
        self._file = targets_file
        self._file_mtime: float | None = None
        self._filter = filter_fn
        self._wallclock = wallclock
        self._breaker_failures = breaker_failures
        self._breaker_backoff_s = breaker_backoff_s
        self._breaker_backoff_max_s = breaker_backoff_max_s
        self._breaker_store = breaker_store
        # Saved breaker docs from a previous process: consumed lazily as
        # targets (re)appear, so a target that reshards INTO this leaf
        # after a restart still inherits its quarantine.
        self._saved_breakers: dict[str, dict] = (
            breaker_store.load() if breaker_store is not None else {}
        )
        self._rlog = RateLimitedLogger(log)
        self._breaker_sigs: dict[str, tuple] = {}
        self.breakers: dict[str, CircuitBreaker] | None = (
            {} if breaker_failures > 0 else None
        )
        self.layouts: dict[str, LayoutCache] = {}
        self.targets: tuple[str, ...] = ()
        # Cumulative membership changes (adds + removes) — the leaf-side
        # reshard counter (tpu_leaf_reshard_moves_total).
        self.moves = 0
        base = tuple(dict.fromkeys(t.strip() for t in targets if t.strip()))
        if targets_file:
            try:
                # mtime BEFORE contents: if the file is replaced between
                # the two calls we record the OLD file's mtime against
                # its own contents and the next refresh re-reads — the
                # reverse order could pin stale membership forever (new
                # mtime recorded against old contents).
                self._file_mtime = os.path.getmtime(targets_file)
                base = read_targets_file(targets_file)
            except OSError as e:
                self._file_mtime = None
                log.warning(
                    "targets file %s unreadable at boot (%s); starting "
                    "from --targets (%d entries) until it appears",
                    targets_file, e, len(base),
                )
        self.set_targets(base)
        self.moves = 0  # boot population is not churn

    def set_targets(self, targets: Sequence[str]) -> tuple[int, int]:
        """Replace membership; returns (added, removed) counts. Per-target
        state is created for newcomers (breakers restored from the saved
        store when present) and dropped for leavers."""
        new = tuple(dict.fromkeys(t.strip() for t in targets if t.strip()))
        if self._filter is not None:
            new = tuple(self._filter(new))
        old = self.targets
        if new == old:
            return 0, 0
        old_set, new_set = set(old), set(new)
        added = [t for t in new if t not in old_set]
        removed = [t for t in old if t not in new_set]
        for t in added:
            self.layouts[t] = LayoutCache()
            if self.breakers is not None:
                br = CircuitBreaker(
                    failure_threshold=self._breaker_failures,
                    backoff_base_s=self._breaker_backoff_s,
                    backoff_max_s=self._breaker_backoff_max_s,
                )
                # pop, not get: the doc is a snapshot of a PAST state.
                # Consumed once, it must not re-quarantine this target on
                # a later remove/re-add bounce after it has RECOVERED —
                # the removal path below stashes current state for the
                # genuine bounce case.
                doc = self._saved_breakers.pop(t, None)
                if doc:
                    try:
                        br.restore_state(doc, wallclock=self._wallclock)
                    except Exception as e:  # noqa: BLE001 — never refuse to start
                        log.warning("breaker restore for %s failed: %s", t, e)
                if br.state != CLOSED:
                    log.warning(
                        "target %s restored %s (reopens=%d, next probe "
                        "in %.1fs) — quarantine carried across restart",
                        t, br.state, br.reopens, br.seconds_until_probe,
                    )
                self._breaker_sigs[t] = (br.state, br.reopens)
                self.breakers[t] = br
        for t in removed:
            self.layouts.pop(t, None)
            if self.breakers is not None:
                br = self.breakers.pop(t, None)
                if br is not None and br.state != CLOSED:
                    # Stash the live quarantine: a target that bounces out
                    # and back (partial file read, flapping inventory)
                    # must restore its backoff, not re-learn a black hole
                    # from closed. Memory-bounded by churned-target count;
                    # the on-disk file only ever holds CURRENT targets.
                    try:
                        self._saved_breakers[t] = br.export_state(
                            wallclock=self._wallclock)
                    except Exception:  # noqa: BLE001 — stash is best-effort
                        pass
            self._breaker_sigs.pop(t, None)
        self.targets = new
        self.moves += len(added) + len(removed)
        return len(added), len(removed)

    def refresh(self) -> tuple[int, int]:
        """Re-read the targets file when its mtime moved; returns (added,
        removed). Called at round start on the round thread. No file =
        static membership, always (0, 0) here."""
        if not self._file:
            return 0, 0
        try:
            mtime = os.path.getmtime(self._file)
        except OSError:
            # Vanished mid-flight: keep last known membership; it will be
            # re-read when the file reappears with a fresh mtime.
            return 0, 0
        if self._file_mtime is not None and mtime == self._file_mtime:
            return 0, 0
        try:
            targets = read_targets_file(self._file)
        except OSError as e:
            log.warning("targets file %s unreadable on reload (%s); "
                        "keeping current %d targets",
                        self._file, e, len(self.targets))
            return 0, 0
        self._file_mtime = mtime
        if not targets and self.targets:
            # A readable-but-EMPTY file on reload is overwhelmingly a torn
            # in-place write (shell `>` truncate-then-write) — not an
            # operator deleting the whole fleet. Applying it would drop
            # every breaker and empty the fleet view for a round; keep
            # the membership and wait for the next mtime bump (a genuine
            # full teardown restarts the process instead).
            log.warning(
                "targets file %s read EMPTY on reload; keeping current %d "
                "targets (truncated mid-write? restart to force empty)",
                self._file, len(self.targets),
            )
            return 0, 0
        added, removed = self.set_targets(targets)
        if added or removed:
            log.info("targets file %s reloaded: +%d/-%d targets (now %d)",
                     self._file, added, removed, len(self.targets))
        return added, removed

    def maybe_save_breakers(self, force: bool = False) -> None:
        """Persist breaker state after rounds where any breaker changed
        state/reopen count (transitions, not per-round churn — the file is
        rewritten a handful of times per incident, not 1 Hz)."""
        if self._breaker_store is None or self.breakers is None:
            return
        changed = force
        for t, br in self.breakers.items():
            sig = (br.state, br.reopens)
            if self._breaker_sigs.get(t) != sig:
                self._breaker_sigs[t] = sig
                changed = True
        if changed:
            try:
                self._breaker_store.save({
                    t: br.export_state(wallclock=self._wallclock)
                    for t, br in self.breakers.items()
                })
            except Exception as e:  # noqa: BLE001 — persistence must not fail rounds
                # Rate-limited: a full disk plus a flapping breaker would
                # otherwise emit one line per round for the whole incident.
                self._rlog.warning("breaker_save",
                                   "breaker state save failed: %s", e)


class RoundRecorder:
    """Append every round's fetched bodies to a JSONL file — the
    aggregator-side twin of the exporter's record/replay backend
    (``backend/recorded.py``): capture a live incident (a slice-wide
    rollup anomaly, a flapping target) once, replay it deterministically
    offline with :class:`ReplayFetch`. One line per round:
    ``{"t": epoch, "bodies": {target: text-or-null}, "durations": {...}}``
    — null marks a target that was down that round, so the replay
    reproduces outages too. Size note: a 256-chip body is ~950 KB, so an
    N-target capture grows ~N MB/round; record incidents, not weeks."""

    def __init__(self, path: str,
                 wallclock: Callable[[], float] = time.time) -> None:
        self._f = open(path, "a", encoding="utf-8")
        self._wallclock = wallclock

    def record(
        self, results: Iterable[tuple[str, str | None, float]],
    ) -> None:
        rec = {
            "t": self._wallclock(),
            "bodies": {t: text for t, text, _d in results},
            "durations": {t: d for t, _text, d in results},
        }
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()  # an incident capture must survive a crash/kill

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:  # noqa: BLE001
            pass


class ReplayFetch:
    """Serve recorded bodies in round order — inject as ``fetch``.

    Thread-safe for the aggregator's one-call-per-target-per-round pool:
    a second request for an already-served target advances to the next
    round. A target recorded as null raises (the round's outage replays
    as an outage); past the last round, ``loop=True`` (the
    RecordedBackend convention) starts over, else every fetch raises."""

    def __init__(self, path: str, loop: bool = True) -> None:
        self._rounds: list[dict] = []
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                    bodies = rec["bodies"]
                    if not isinstance(bodies, dict):
                        raise TypeError(
                            f"bodies must be an object, got {type(bodies).__name__}"
                        )
                except (ValueError, KeyError, TypeError) as e:
                    raise ValueError(f"{path}:{i}: bad round record: {e}") from e
                self._rounds.append(bodies)
        if not self._rounds:
            raise ValueError(f"{path}: no rounds recorded")
        self._loop = loop
        self._idx = 0
        self._served: set[str] = set()
        self._lock = threading.Lock()

    @property
    def targets(self) -> tuple[str, ...]:
        """Target set of the first round (JSON preserves recording order)."""
        return tuple(self._rounds[0])

    def __call__(self, target: str, timeout_s: float) -> str:
        with self._lock:
            if target in self._served:
                self._idx += 1
                self._served = set()
            if self._idx >= len(self._rounds):
                if not self._loop:
                    raise ConnectionError("replay exhausted")
                self._idx = 0
            bodies = self._rounds[self._idx]
            self._served.add(target)
        body = bodies.get(target)
        if body is None:
            raise ConnectionError(f"{target} recorded as down this round")
        return body


class SliceAggregator:
    """Scrape N per-host exporters, publish slice/workload rollups.

    Exposes ``poll_once`` so :class:`~tpu_pod_exporter_torch.collector.CollectorLoop`
    can drive it on the same drift-free schedule as the exporter's own loop.
    ``fetch`` is injectable for tests (no sockets needed).
    """

    def __init__(
        self,
        targets: tuple[str, ...],
        store: SnapshotStore,
        timeout_s: float = 2.0,
        fetch: Callable[..., Any] = default_fetch,
        wallclock: Callable[[], float] = time.time,
        recorder: "RoundRecorder | None" = None,
        loop_overruns_fn: Callable[[], int] | None = None,  # CollectorLoop's
        history_fallback_window_s: float = 0.0,
        history_fetch: Callable[..., Any] = default_history_fetch,
        breaker_failures: int = 3,
        breaker_backoff_s: float = 10.0,
        breaker_backoff_max_s: float = 120.0,
        tracer: Any = None,
        breaker_store: Any = None,  # persist.BreakerStateFile; None = none
        fleet: Any = None,  # fleet.FleetQueryPlane; self-metrics land here
        shipper: Any = None,  # egress.RemoteWriteShipper; None = no egress
        targets_file: str = "",  # live membership: re-read on mtime change
        target_filter: Callable[[tuple[str, ...]], Iterable[str]] | None = None,  # leaf tier's shard cut
        render_splice: bool = True,  # --render-splice; the RUNBOOK kill switch
    ) -> None:
        if not targets and not targets_file:
            raise ValueError("aggregator needs at least one target")
        # Federated /api/v1 query plane (tpu_pod_exporter_torch.fleet): attached
        # after construction (it shares this aggregator's breakers), it
        # serves fan-out queries on HTTP handler threads; the round loop's
        # only involvement is publishing its self-metrics and bumping
        # `rounds` — the result cache's generation, so cached envelopes
        # live exactly one round.
        self._fleet = fleet
        # Attachment seams for conditional planes that ride this tier's
        # rounds and exposition without the aggregator knowing them by
        # name (the streaming dashboard hub is the first user):
        # emit_hooks run inside _publish on the round's SnapshotBuilder;
        # round_hooks run at the very end of poll_once with the new round
        # number (poll-side cost must stay trivial — the stream hub's is
        # one Event.set on its pump).
        self.emit_hooks: list[Callable[[SnapshotBuilder], None]] = []
        self.round_hooks: list[Callable[[int], None]] = []
        # Remote-write egress (tpu_pod_exporter_torch.egress): the aggregator
        # ships its slice/workload rollups the same WAL-buffered way the
        # exporter ships chip series — the round loop's only involvement
        # is one non-blocking enqueue after each snapshot swap plus the
        # self-metric emission (same discipline as persist/fleet).
        self._shipper = shipper
        self.rounds = 0
        # Round tracing (tpu_pod_exporter_torch.trace): one trace per round, one
        # span per target scrape / fallback / publish. The trace context
        # propagates onto the fan-out via a traceparent header — only when
        # the injected fetch accepts one (tests inject plain 2-arg fetches;
        # ReplayFetch has no wire to stamp headers on).
        self._tracer = tracer
        self._fetch_traceparent = False
        try:
            self._fetch_traceparent = (
                "traceparent" in inspect.signature(fetch).parameters
            )
        except (TypeError, ValueError):
            pass
        self._recorder = recorder
        self._loop_overruns_fn = loop_overruns_fn
        self._store = store
        # Splice render across rounds (same machinery as the exporter
        # tier): rollup label sets are stable between target churn events,
        # so each round splices changed cells instead of re-rendering the
        # whole aggregate exposition. Same kill switch as the exporter
        # (--render-splice false), so the RUNBOOK bisection step applies
        # on every tier.
        self._prefix_cache = PrefixCache(splice=render_splice)
        self._timeout_s = timeout_s
        self._fetch = fetch
        # Missed-round continuity (0 disables): when a target's full scrape
        # fails, query its history flight recorder (/api/v1/window_stats)
        # for last-known chip data over this trailing window, so one dropped
        # round doesn't read as "half the slice vanished". The target still
        # reports down (target_up=0) — continuity is labeled, not hidden —
        # and the substitution is counted per target in
        # tpu_aggregator_history_fallbacks_total.
        self._history_window_s = history_fallback_window_s
        self._history_fetch = history_fetch
        # Per-target state lives in a TargetSet: circuit breakers
        # (tpu_pod_exporter_torch.supervisor — a persistently-down target is
        # QUARANTINED with exponential backoff+jitter instead of costing a
        # full timeout_s in the scrape pool every round; while quarantined
        # its history fallback is skipped too; breaker_failures=0
        # disables), quarantine carryover across restarts
        # (tpu_pod_exporter_torch.persist via breaker_store), parse-layout
        # caches (value-only re-parse between churn events — the
        # parse-side twin of the exporter's PrefixCache), and LIVE
        # membership: a --targets-file is re-read at round start whenever
        # its mtime changes, so target add/remove no longer requires a
        # restart, and the sharded leaf tier applies its consistent-hash
        # cut via target_filter.
        self._tset = TargetSet(
            targets,
            targets_file=targets_file,
            filter_fn=target_filter,
            breaker_failures=breaker_failures,
            breaker_backoff_s=breaker_backoff_s,
            breaker_backoff_max_s=breaker_backoff_max_s,
            breaker_store=breaker_store,
            wallclock=wallclock,
        )
        self._wallclock = wallclock
        self._counters = CounterStore()
        # Targets that have ever served a gpu_* family (the aggregator-side
        # twin of the collector's _gpu_surface latch): the history fallback
        # probes GPU metrics only for these, so a missed round on a
        # homogeneous TPU fleet costs zero can-only-404 requests.
        self._gpu_targets: set[str] = set()
        self._rlog = RateLimitedLogger(log)
        # Latency distributions (same contract as the exporter's: p99
        # computable from the exposition). Round durations observe after
        # the swap, so they land one round behind — fine for cumulative
        # histograms.
        self._round_hist = HistogramStore(schema.TPU_AGG_ROUND_HIST)
        self._scrape_hist = HistogramStore(schema.TPU_AGG_TARGET_SCRAPE_HIST)
        # A round's phases (fetch, parse, fold, publish; observed after the
        # swap with the round) and each successful default_fetch's stages.
        self._phase_hist = HistogramStore(schema.TPU_AGG_ROUND_PHASE_HIST)
        self._fetch_stage_hist = HistogramStore(schema.TPU_AGG_FETCH_STAGE_HIST)
        # Last round's scrape-plane health (ok, quarantined, total), read
        # by ready_detail() from HTTP threads — swapped atomically.
        self._health: tuple[int, int, int] = (0, 0, 0)
        # Cap, not current membership: ThreadPoolExecutor spawns workers
        # lazily (one per pending task up to the cap), so a 2-target
        # aggregator never creates 16 threads — while a targets-file
        # deployment that boots before the file exists still gets full
        # parallelism when the file appears (membership is LIVE; a pool
        # sized at boot would serialize the grown fleet forever).
        self._pool = ThreadPoolExecutor(
            max_workers=16,
            thread_name_prefix="tpu-agg-scrape",
        )

    # Delegating views over the TargetSet: membership and per-target state
    # are owned there; everything below reads the live view.
    @property
    def _targets(self) -> tuple[str, ...]:
        return self._tset.targets

    @property
    def _breakers(self) -> "dict[str, CircuitBreaker] | None":
        return self._tset.breakers

    @property
    def _parse_layouts(self) -> dict[str, LayoutCache]:
        return self._tset.layouts

    @property
    def targets(self) -> tuple[str, ...]:
        """Current membership (live view — changes on targets-file reload)."""
        return self._tset.targets

    @property
    def breakers(self) -> "dict[str, CircuitBreaker] | None":
        """Per-target breaker map (None when disabled) — shared read-only
        with the fleet query plane for its quarantine-aware skip. The dict
        object is stable across resharding (mutated in place), so holders
        of this reference always see current membership."""
        return self._tset.breakers

    def set_fleet(self, fleet: Any) -> None:
        """Attach the federated query plane (constructed after the
        aggregator because it borrows the breaker map built here)."""
        self._fleet = fleet

    # ------------------------------------------------------------------ round

    def poll_once(self) -> None:
        t0 = time.monotonic()
        self.rounds += 1
        # Live membership: apply a changed targets file BEFORE the round
        # snapshot, so this round already scrapes the new set. The tuple
        # read below is the round's frozen view — per-target state for
        # everything in it exists until at least the next refresh.
        _added, removed = self._tset.refresh()
        if removed:
            # Per-target counter state follows membership out: without
            # this, every target that ever errored keeps its series in
            # the exposition (and its entry in RSS) forever on a
            # churning fleet — same prune discipline as the exporter's
            # chip state.
            keep = {
                (name, (t,))
                for name in (schema.TPU_AGG_SCRAPE_ERRORS_TOTAL.name,
                             schema.TPU_AGG_HISTORY_FALLBACKS_TOTAL.name)
                for t in self._tset.targets
            }
            self._counters.prune(keep)
            self._gpu_targets &= set(self._tset.targets)
        round_targets = self._tset.targets
        tr = self._tracer.start_poll() if self._tracer is not None else None
        # Round-local quarantine set: targets whose breaker skipped the
        # scrape entirely this round (set.add is GIL-atomic; each pool
        # worker touches a distinct target exactly once).
        quarantined: set[str] = set()

        def scrape(target: str) -> tuple[str, str | None, float]:
            br = self._breakers.get(target) if self._breakers else None
            # Explicit span API (not the TLS begin/end): pool workers run
            # concurrently, and PollTrace.span/end_span are safe from any
            # thread (list.append is GIL-atomic).
            span = (
                tr.span("scrape", breaker=br.state if br is not None else "")
                if tr is not None else None
            )
            if br is not None and br.decide() == "skip":
                quarantined.add(target)
                if span is not None:
                    span.add_event(
                        f"quarantined: next probe in "
                        f"{br.seconds_until_probe:.1f}s"
                    )
                    tr.end_span(span, "skipped", target=target)
                return target, None, 0.0
            traceparent = (
                format_traceparent(tr.trace_id, span.span_id)
                if span is not None and self._fetch_traceparent
                else None
            )
            out = self._scrape_one(target, traceparent)
            if span is not None:
                stages = _FETCH_STAGES.stages
                tr.end_span(
                    span, "ok" if out[1] is not None else "err",
                    target=target,
                    bytes=len(out[1]) if out[1] is not None else 0,
                    **({} if stages is None else {
                        f"{stage}_s": v for stage, v in zip(FETCH_STAGES, stages)
                    }),
                )
            if br is not None:
                if out[1] is None:
                    br.record_failure()
                elif br.consecutive_failures or br.state != CLOSED:
                    # Recovery bypasses the rate limit: the scrape-failure
                    # lines for this target were suppressed to one per
                    # window, and the incident's END must never be.
                    self._rlog.recovery(
                        f"scrape:{target}",
                        "target %s healthy again after %d failed scrape(s)",
                        target, br.consecutive_failures,
                    )
                    br.record_success()
                else:
                    br.record_success()
            return out

        tf0 = time.monotonic()
        results = list(
            self._pool.map(scrape, round_targets)
        )  # [(target, text|None, duration_s)]
        fetch_s = time.monotonic() - tf0
        if self._recorder is not None:
            try:
                self._recorder.record(results)
            except Exception as e:  # noqa: BLE001 — capture must not kill rounds
                self._rlog.warning("recorder", "round record failed: %s", e)
        fallbacks: dict[str, list] = {}
        if self._history_window_s > 0:
            # Quarantined targets are excluded: their scrape was skipped
            # BECAUSE the endpoint is persistently dead, and the history
            # API lives on the same dead port — probing it would burn the
            # very timeout the breaker exists to save.
            failed = [
                t for t, text, _d in results
                if text is None and t not in quarantined
            ]
            if failed:

                def fallback(target: str) -> list | None:
                    span = (
                        tr.span("history_fallback") if tr is not None else None
                    )
                    samples = self._history_fallback(target)
                    if span is not None:
                        tr.end_span(
                            span, "ok" if samples else "err", target=target,
                            samples=len(samples) if samples else 0,
                        )
                    return samples

                for target, samples in zip(
                    failed, self._pool.map(fallback, failed)
                ):
                    if samples:
                        fallbacks[target] = samples
        pspan = tr.span("publish") if tr is not None else None
        self._health = (
            sum(1 for _t, text, _d in results if text is not None),
            len(quarantined),
            len(round_targets),
        )
        self._publish(results, fallbacks=fallbacks, round_started=t0,
                      quarantined=quarantined, fetch_s=fetch_s, span=pspan)
        if tr is not None:
            ok_n = sum(1 for _t, text, _d in results if text is not None)
            tr.end_span(pspan, "ok")
            self._tracer.finish(
                tr,
                status="ok" if ok_n else "err",
                targets=len(round_targets), ok=ok_n,
                quarantined=len(quarantined), fallbacks=len(fallbacks),
            )
        # AFTER the round's spans close: the save fsyncs twice, and disk
        # latency during an incident must not read as publish/round time —
        # the same persist-outside-the-timings discipline the exporter's
        # poll applies.
        self._maybe_save_breakers()
        for hook in self.round_hooks:
            try:
                hook(self.rounds)
            except Exception as e:  # noqa: BLE001 — a hook must never fail a round
                self._rlog.warning("round_hook",
                                   "round hook failed: %s", e)

    def _history_fallback(self, target: str) -> list | None:
        """Last-known chip data from a down target's flight recorder, as
        synthesized ``(name, labels, value)`` samples `_consume` understands.

        Gauges contribute their window-``last`` value; the ICI/DCN byte
        counters contribute their counter-aware window ``rate`` under the
        corresponding bandwidth-gauge name — the same quantity a live round
        would have folded. Any endpoint failure (exporter fully down, no
        history, pre-history version) returns None and the round proceeds
        exactly as before the fallback existed."""
        base = target_base_url(target)
        window = self._history_window_s
        samples: list[tuple[str, dict, float]] = []
        probes = [
            ("tpu_chip_info", "tpu_chip_info", False),
            ("tpu_hbm_used_bytes", "tpu_hbm_used_bytes", False),
            ("tpu_hbm_total_bytes", "tpu_hbm_total_bytes", False),
            ("tpu_tensorcore_duty_cycle_percent",
             "tpu_tensorcore_duty_cycle_percent", False),
            # Pod rollups ride along so workload continuity matches slice
            # continuity — a missed round must not read as "the workload
            # shrank" while the slice sums hold steady.
            ("tpu_pod_chip_count", "tpu_pod_chip_count", False),
            ("tpu_pod_hbm_used_bytes", "tpu_pod_hbm_used_bytes", False),
            ("tpu_ici_transferred_bytes_total",
             "tpu_ici_link_bandwidth_bytes_per_second", True),
            ("tpu_dcn_transferred_bytes_total",
             "tpu_dcn_link_bandwidth_bytes_per_second", True),
        ]
        if target in self._gpu_targets:
            # GPU-family twins, only for targets that have ever served a
            # gpu_* family: a homogeneous TPU fleet's missed rounds never
            # pay six can-only-404 probes inside the degraded window.
            probes += [
                ("gpu_chip_info", "gpu_chip_info", False),
                ("gpu_hbm_used_bytes", "gpu_hbm_used_bytes", False),
                ("gpu_hbm_total_bytes", "gpu_hbm_total_bytes", False),
                ("gpu_utilization_percent", "gpu_utilization_percent",
                 False),
                ("gpu_pod_chip_count", "gpu_pod_chip_count", False),
                ("gpu_pod_memory_used_bytes", "gpu_pod_memory_used_bytes",
                 False),
            ]
        for metric, synth_name, use_rate in probes:
            url = f"{base}/api/v1/window_stats?metric={metric}&window={window:g}"
            try:
                doc = self._history_fetch(url, self._timeout_s)
                rows = doc["data"]["result"]
            except urllib.error.HTTPError as e:
                # The endpoint ANSWERED: 404 here just means that family
                # has no samples (or a pre-history exporter) — cheap, keep
                # trying the remaining metrics; partial history beats none.
                self._rlog.info(
                    f"history:{target}:{metric}",
                    "history fallback for %s/%s unavailable: %s",
                    target, metric, e,
                )
                continue
            except Exception as e:  # noqa: BLE001
                # Connection-level failure (refused, black-holed, timeout):
                # the remaining metrics would each burn another timeout_s
                # in the scrape pool — against a black-holed target that is
                # 6x timeout per round, exactly in the outage the fallback
                # serves. One strike and out.
                self._rlog.info(
                    f"history:{target}",
                    "history fallback for %s aborted: %s", target, e,
                )
                break
            for row in rows:
                try:
                    labels = row["labels"]
                    value = row["stats"]["rate"] if use_rate else row["stats"]["last"]
                    if value is None:
                        continue
                    samples.append((synth_name, labels, float(value)))
                except (KeyError, TypeError, ValueError):
                    continue
        return samples or None

    def _scrape_one(self, target: str,
                    traceparent: str | None = None) -> tuple[str, str | None, float]:
        _FETCH_STAGES.stages = None
        t0 = time.monotonic()
        try:
            if traceparent is not None:
                text = self._fetch(target, self._timeout_s,
                                   traceparent=traceparent)
            else:
                text = self._fetch(target, self._timeout_s)
        except Exception as e:  # noqa: BLE001 — a down host is data, not death
            self._rlog.warning(f"scrape:{target}", "scrape of %s failed: %s", target, e)
            return target, None, time.monotonic() - t0
        dur = time.monotonic() - t0
        stages = _FETCH_STAGES.stages
        if stages is not None:
            for stage, v in zip(FETCH_STAGES, stages):
                self._fetch_stage_hist.observe(v, (stage,))
        return target, text, dur

    # ---------------------------------------------------------------- publish

    def _publish(self, results: Sequence[tuple[str, str | None, float]],
                 fallbacks: dict[str, list] | None = None,
                 round_started: float | None = None,
                 quarantined: set | None = None,
                 fetch_s: float | None = None,
                 span: Any = None) -> None:
        """Fold a round's results into a snapshot and swap it in. With the
        fan-out's ``fetch_s``, observe the round's phases once the swap is
        done; ``span`` (the round's publish span, ended by the caller) gains
        the parse, fold and build seconds as attributes."""
        parse_s = fold_s = 0.0
        b = SnapshotBuilder(prefix_cache=self._prefix_cache)
        for spec in schema.AGGREGATE_SPECS:
            b.declare(spec)
        fallbacks = fallbacks or {}
        quarantined = quarantined or set()

        # (slice_name, accelerator, family) -> accumulator
        slices: dict[tuple[str, str, str], _SliceAgg] = {}
        workloads: dict[tuple[str, str, str], _WorkloadAgg] = {}
        # (slice_name, accelerator) -> (multislice_group, num_slices str)
        slice_groups: dict[tuple[str, str], tuple[str, str]] = {}

        for target, text, duration_s in results:
            ok = text is not None
            if ok:
                # Parse fully before folding: a mid-body ParseError must not
                # leave a half-consumed host in the sums while the target is
                # reported down. Layout-cached: steady-state bodies re-parse
                # values only (labels dicts are shared with the cache;
                # _consume reads them, never mutates).
                tp0 = time.monotonic()
                try:
                    samples = parse_exposition_layout(
                        text, CONSUMED_NAMES, self._parse_layouts[target]
                    )
                except ParseError as e:
                    parse_s += time.monotonic() - tp0
                    ok = False
                    self._rlog.warning(
                        f"parse:{target}", "bad exposition from %s: %s", target, e
                    )
                else:
                    tp1 = time.monotonic()
                    parse_s += tp1 - tp0
                    if target not in self._gpu_targets and any(
                        s[0].startswith("gpu_") for s in samples
                    ):
                        # Cheap: samples are already filtered to
                        # CONSUMED_NAMES (a handful of rows per chip).
                        self._gpu_targets.add(target)
                    self._consume(samples, slices, workloads, slice_groups)
                    fold_s += time.monotonic() - tp1
            if not ok:
                # A quarantined round was SKIPPED, not attempted — the
                # error counter keeps meaning "failed scrapes", so the
                # breaker must not inflate it while saving timeouts.
                if target not in quarantined:
                    self._counters.inc(
                        schema.TPU_AGG_SCRAPE_ERRORS_TOTAL.name, (target,)
                    )
                fb = fallbacks.get(target)
                if fb:
                    # Missed-round continuity: the target's flight recorder
                    # answered even though its full scrape didn't; fold its
                    # last-known samples so slice chips/hosts/HBM stay
                    # continuous. target_up stays 0 — the round WAS missed.
                    tc0 = time.monotonic()
                    self._consume(fb, slices, workloads, slice_groups)
                    fold_s += time.monotonic() - tc0
                    self._counters.inc(
                        schema.TPU_AGG_HISTORY_FALLBACKS_TOTAL.name, (target,)
                    )
            b.add(schema.TPU_AGG_TARGET_UP, 1.0 if ok else 0.0, (target,))
            if self._breakers is not None:
                # .get: a refresh between this round's snapshot and publish
                # cannot happen (same thread), but a target REMOVED by the
                # refresh at the top of this very round still has its round
                # result here only if it was in the snapshot — guard anyway.
                br = self._breakers.get(target)
                if br is not None:
                    b.add(
                        schema.TPU_AGG_TARGET_BREAKER_STATE,
                        STATE_VALUES[br.state],
                        (target,),
                    )
            b.add(schema.TPU_AGG_SCRAPE_DURATION_SECONDS, duration_s, (target,))
            if text is not None:
                # Successful fetches only: a down target's timeout (~2 s
                # every round) would pin the pooled p99 at the top bucket
                # and mask regressions on healthy targets; failures are
                # visible via target_up / scrape_errors instead.
                self._scrape_hist.observe(duration_s)

        # One emit path for every tier: the same function the sharded
        # tree's root uses over accumulators rebuilt from leaf components,
        # so flat and sharded rollups cannot drift (shard-demo oracle).
        tc0 = time.monotonic()
        emit_rollups(b, slices, workloads, slice_groups, rlog=self._rlog)
        # Subclass hook (the leaf tier emits its tpu_leaf_* component
        # series here); the base aggregator adds nothing.
        self._emit_extra(b, slices, workloads, slice_groups)

        if self._fleet is not None:
            try:
                self._fleet.emit(b)
            except Exception:  # noqa: BLE001 — accounting must never fail a round
                pass
        for emit_hook in self.emit_hooks:
            try:
                emit_hook(b)
            except Exception:  # noqa: BLE001 — accounting must never fail a round
                pass
        fold_s += time.monotonic() - tc0
        if self._shipper is not None:
            try:
                self._shipper.emit(b)
            except Exception:  # noqa: BLE001 — accounting must never fail a round
                pass
        for lv, v in self._counters.items_for(schema.TPU_AGG_SCRAPE_ERRORS_TOTAL.name):
            b.add(schema.TPU_AGG_SCRAPE_ERRORS_TOTAL, v, lv)
        for lv, v in self._counters.items_for(
            schema.TPU_AGG_HISTORY_FALLBACKS_TOTAL.name
        ):
            b.add(schema.TPU_AGG_HISTORY_FALLBACKS_TOTAL, v, lv)
        b.add(schema.TPU_AGG_LAST_ROUND_TIMESTAMP_SECONDS, self._wallclock())
        if self._loop_overruns_fn is not None:
            try:
                b.add(
                    schema.TPU_AGG_POLL_OVERRUNS_TOTAL,
                    float(self._loop_overruns_fn()),
                )
            except Exception:  # noqa: BLE001 — accounting must never fail a round
                pass
        # Self-resource accounting, same contract as the exporter's series:
        # absent beats fake-zero when the platform can't report a value.
        cpu_s = utils.process_cpu_seconds()
        if cpu_s is not None:
            b.add(schema.TPU_AGG_CPU_SECONDS_TOTAL, cpu_s)
        rss = utils.process_rss_bytes()
        if rss is not None:
            b.add(schema.TPU_AGG_RSS_BYTES, rss)
        self._round_hist.emit(b)
        self._phase_hist.emit(b)
        self._scrape_hist.emit(b)
        self._fetch_stage_hist.emit(b)
        if round_started is not None:
            # One measurement for both the gauge and the histogram, so
            # histogram_quantile cross-checks against the gauge instead of
            # mysteriously exceeding it by the build+swap span.
            round_dur = time.monotonic() - round_started
            b.add(schema.TPU_AGG_ROUND_DURATION_SECONDS, round_dur)
        tb0 = time.monotonic()
        snap = b.build(timestamp=self._wallclock(), transfer=True)
        self._store.swap(snap)
        build_s = time.monotonic() - tb0
        if self._shipper is not None:
            # AFTER the swap (the batch covers exactly what scrapers see);
            # one non-blocking queue put — a wedged receiver can never
            # stretch a round.
            try:
                self._shipper.on_snapshot(snap)
            except Exception:  # noqa: BLE001 — egress must never fail a round
                pass
        if round_started is not None:
            self._round_hist.observe(round_dur)
        if fetch_s is not None:
            for phase, dur in (("fetch", fetch_s), ("parse", parse_s),
                               ("fold", fold_s), ("publish", build_s)):
                self._phase_hist.observe(dur, (phase,))
        if span is not None:
            span.attrs = {"parse_s": parse_s, "fold_s": fold_s,
                          "build_s": build_s}

    @staticmethod
    def _consume(samples: Iterable[tuple[str, dict[str, str], float]],
                 slices: dict, workloads: dict,
                 slice_groups: dict) -> None:
        """Fold one host's parsed ``(name, labels, value)`` tuples into the
        round accumulators. The name dispatch is ordered by sample
        frequency — per-link ICI rows are ~60% of a 256-chip body's
        consumed lines (6 links/chip), so they test first. GPU-family
        names (``gpu_*``, backend/nvml.py) fold into the same accumulator
        slots under ``family="gpu"`` slice keys: the node's metric
        namespace IS the family marker, so one fold path serves both
        device families without ever summing across them."""
        for name, labels, value in samples:
            if name == "tpu_ici_link_bandwidth_bytes_per_second":
                agg = SliceAggregator._slice(slices, labels, "tpu")
                agg.ici_bw += value
                agg.ici_n += 1
                host = labels.get("host")
                if host:
                    agg.chip_series_hosts.add(host)
            elif name == "tpu_chip_info" or name == "gpu_chip_info":
                # The one guaranteed per-chip series (round 4: a chip whose
                # HBM is unreadable publishes NO tpu_hbm_* series, so chip
                # presence and hosts_reporting must not key off those).
                # Presence intentionally keys on chip_info ALONE: exporters
                # have published it unconditionally since the same change,
                # and a dual-source count (chip_info OR hbm series) would
                # risk double-counting; mixed fleets older than that are
                # not supported.
                agg = SliceAggregator._slice(slices, labels, name[:3])
                agg.chips += 1
                # A missing host label must not count as host "" — mixed
                # with exporters that omit the label, all such hosts would
                # collapse into one and undercount hosts_reporting. The
                # sample still contributes to the chip count above.
                host = labels.get("host")
                if host:
                    agg.hosts.add(host)
            elif name == "tpu_hbm_used_bytes" or name == "gpu_hbm_used_bytes":
                agg = SliceAggregator._slice(slices, labels, name[:3])
                agg.hbm_used += value
                agg.used_chips.add(SliceAggregator._chip_key(labels))
                host = labels.get("host")
                if host:
                    agg.chip_series_hosts.add(host)
            elif name == "tpu_hbm_total_bytes" or name == "gpu_hbm_total_bytes":
                agg = SliceAggregator._slice(slices, labels, name[:3])
                agg.hbm_total += value
                agg.total_chips.add(SliceAggregator._chip_key(labels))
                host = labels.get("host")
                if host:
                    agg.chip_series_hosts.add(host)
            elif name in ("tpu_tensorcore_duty_cycle_percent",
                          "gpu_utilization_percent"):
                agg = SliceAggregator._slice(slices, labels, name[:3])
                agg.duty_sum += value
                agg.duty_n += 1
                host = labels.get("host")
                if host:
                    agg.chip_series_hosts.add(host)
            elif name == "tpu_dcn_link_bandwidth_bytes_per_second":
                agg = SliceAggregator._slice(slices, labels, "tpu")
                agg.dcn_bw += value
                agg.dcn_n += 1
                host = labels.get("host")
                if host:
                    agg.chip_series_hosts.add(host)
            elif name == "tpu_host_info":
                # Multi-slice membership join key: slice -> (group,
                # expected slice count). Hosts of one slice agree on both
                # (same MEGASCALE env); last writer wins harmlessly.
                group = labels.get("multislice_group", "")
                if group:
                    key = (
                        labels.get("slice_name", ""),
                        labels.get("accelerator", ""),
                    )
                    slice_groups[key] = (group, labels.get("num_slices", ""))
            elif name in ("tpu_pod_chip_count", "tpu_pod_hbm_used_bytes",
                          "gpu_pod_chip_count", "gpu_pod_memory_used_bytes"):
                pod = labels.get("pod", "")
                if not pod:
                    continue
                # Workload rollups stay family-agnostic (a pod's chips are
                # one family — slices are homogeneous node pools), so both
                # namespaces fold into the same tpu_workload_* keys.
                key = (pod, labels.get("namespace", ""), labels.get("slice_name", ""))
                w = workloads.get(key)
                if w is None:
                    w = workloads[key] = _WorkloadAgg()
                if name.endswith("_pod_chip_count"):
                    w.chips += value
                    host = labels.get("host")
                    if host:  # same missing-label rule as hosts_reporting
                        w.hosts.add(host)
                else:
                    w.hbm_used += value
                    w.hbm_used_n += 1

    @staticmethod
    def _chip_key(labels: dict[str, str]) -> tuple[str, str]:
        """Chip identity within a slice, for used/total coverage matching."""
        return labels.get("host", ""), labels.get("chip_id", "")

    @staticmethod
    def _slice(slices: dict, labels: dict[str, str],
               family: str = "tpu") -> _SliceAgg:
        key = (labels.get("slice_name", ""), labels.get("accelerator", ""),
               family)
        agg = slices.get(key)
        if agg is None:
            agg = slices[key] = _SliceAgg()
        return agg

    def ready_detail(self) -> dict:
        """/readyz detail hook (``server.MetricsServer ready_detail_fn``):
        an aggregator (or sharded leaf) whose ENTIRE scrape plane went
        dark keeps serving its last snapshot over HTTP 200 — stale data
        is still data — but flips ``state`` to ``degraded`` so operators
        and rollouts can tell "healthy view" from "partition-suspected
        view". Per-round detail is included either way."""
        ok, quarantined, total = self._health
        out: dict = {
            "scrape_plane": {
                "targets_ok": ok,
                "quarantined": quarantined,
                "targets": total,
            },
        }
        if total and ok == 0 and self.rounds > 0:
            out["degraded_sources"] = [
                f"scrape-plane: 0/{total} targets reachable "
                f"({quarantined} quarantined) — serving the last "
                f"snapshot; node-side network partition suspected"
            ]
        return out

    def debug_vars(self) -> dict:
        """Introspection payload for /debug/vars — the aggregator twin of
        ExporterApp._debug_vars. Reads are cross-thread but safe: layout
        lists are swapped atomically by the publish thread."""
        tmpl = self._prefix_cache.template
        return {
            "targets": list(self._targets),
            "timeout_s": self._timeout_s,
            "rounds": self.rounds,
            # Splice-render counters (None = --render-splice false); the
            # RUNBOOK's render triage reads the same shape on every tier.
            "render": tmpl.stats() if tmpl is not None else None,
            # Cumulative membership changes (targets-file reloads / leaf
            # resharding); 0 forever on a static --targets deployment.
            "target_moves": self._tset.moves,
            # Federated query plane occupancy (None = fleet queries off).
            "fleet_query": (
                self._fleet.stats() if self._fleet is not None else None
            ),
            # Remote-write egress occupancy (None = egress off).
            "egress": (
                self._shipper.stats() if self._shipper is not None else None
            ),
            # Round-trace ring occupancy (None = tracing off); the traces
            # themselves are at GET /debug/trace.
            "trace": (
                self._tracer.store.stats() if self._tracer is not None
                else None
            ),
            # Per-target parsed-layout sizes: 0 = never parsed (target down
            # since start) OR deliberately uncached (oversize body — see
            # layout_oversize below); steady state ≈ body line count.
            "layout_entries": {
                t: len(layout.entries)
                for t, layout in self._parse_layouts.items()
            },
            # True while a target's body exceeds the layout-cache cap: it
            # parses uncached every round (healthy, just slower); cleared
            # when the body shrinks back under the cap. Without this an
            # operator reading layout_entries=0 would misdiagnose an
            # oversize target as down after the WARNING scrolled away.
            "layout_oversize": {
                t: layout.oversize_logged
                for t, layout in self._parse_layouts.items()
            },
            # Per-target breaker view (None = breakers disabled): state plus
            # how long until a quarantined target's next probe.
            "target_breakers": (
                {
                    t: {
                        "state": br.state,
                        "consecutive_failures": br.consecutive_failures,
                        "reopens": br.reopens,
                        "next_probe_in_s": round(br.seconds_until_probe, 3),
                    }
                    for t, br in self._breakers.items()
                }
                if self._breakers is not None
                else None
            ),
        }

    def _emit_extra(self, b: SnapshotBuilder, slices: dict,
                    workloads: dict, slice_groups: dict) -> None:
        """Subclass hook, called once per round after the rollups landed on
        the builder and before the self-metrics: the sharded leaf tier
        (tpu_pod_exporter_torch.shard.LeafAggregator) emits its accumulator
        component series here. Base aggregator: nothing."""

    def _maybe_save_breakers(self, force: bool = False) -> None:
        """Persist target breaker state on transitions (owned by the
        TargetSet, which also restores it for targets that reshard in)."""
        self._tset.maybe_save_breakers(force=force)

    def close(self) -> None:
        self._maybe_save_breakers(force=True)
        self._pool.shutdown(wait=False)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="tpu-pod-exporter-aggregate",
        description="Scrape per-host TPU exporters; serve slice-level rollups.",
    )
    p.add_argument("--targets", default="",
                   help="comma-separated host:port (or URL) exporter targets")
    p.add_argument("--targets-file", default="",
                   help="file with one target per line (# comments ok), "
                        "re-read at round start whenever its mtime changes "
                        "— target add/remove without a restart. Takes "
                        "precedence over --targets, which then only seeds "
                        "membership while the file is unreadable")
    p.add_argument("--port", type=int, default=9100)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--interval-s", type=float, default=5.0)
    p.add_argument("--timeout-s", type=float, default=2.0)
    p.add_argument("--max-scrapes-per-s", type=float, default=100.0,
                   help="rate-cap own /metrics (token bucket; 0 disables)")
    p.add_argument("--debug-addr", default="127.0.0.1",
                   help="/debug/* exposure: loopback clients only by "
                        "default; 0.0.0.0 serves them to any client "
                        "(same policy as the exporter's --debug-addr)")
    p.add_argument("--breaker-failures", type=int, default=3,
                   help="consecutive scrape failures before a target is "
                        "quarantined with backoff instead of burning "
                        "--timeout-s every round (0 disables the breaker)")
    p.add_argument("--breaker-backoff-s", type=float, default=0.0,
                   help="first quarantine window; doubles per reopen "
                        "(default 0 = auto: max(2x --interval-s, "
                        "--timeout-s))")
    p.add_argument("--breaker-backoff-max-s", type=float, default=120.0)
    p.add_argument("--state-dir", default="",
                   help="persist per-target breaker state here (atomic "
                        "JSON) so a restarted aggregator keeps its "
                        "quarantines instead of re-learning every dead "
                        "target from closed; empty disables")
    p.add_argument("--render-splice", default="on", choices=("on", "off"),
                   help="incremental exposition render (splice changed "
                        "cells into a pre-rendered body template per "
                        "round); off restores the per-family full "
                        "re-render — the RUNBOOK's bisection step, same "
                        "switch as the exporter tier")
    p.add_argument("--trace", default="on", choices=("on", "off"),
                   help="round tracing: one trace per aggregation round "
                        "with per-target scrape spans, exported at "
                        "/debug/trace; the trace context propagates to "
                        "each exporter via a traceparent header")
    p.add_argument("--trace-max-traces", type=int, default=256)
    p.add_argument("--history-fallback-window", type=float, default=0.0,
                   help="when a target's scrape fails, query its history "
                        "flight recorder (/api/v1/window_stats) over this "
                        "trailing window and fold the last-known chip data "
                        "into the rollups (0 disables; try 3x --interval-s)")
    p.add_argument("--fleet-query", default="on", choices=("on", "off"),
                   help="federated /api/v1 on this aggregator: "
                        "query_range/window_stats/series fan out to every "
                        "non-quarantined target, merge per series, and "
                        "answer with partial-result semantics (a dead "
                        "target degrades the answer, never fails it)")
    p.add_argument("--fleet-query-timeout-s", type=float, default=0.0,
                   help="per-target deadline for fleet query fan-out "
                        "(default 0 = use --timeout-s)")
    p.add_argument("--fleet-query-cache", type=int, default=128,
                   help="fleet query result cache entries, keyed by "
                        "(query, grid, round generation) — absorbs "
                        "dashboard-refresh traffic (0 disables)")
    p.add_argument("--stream", default="on", choices=("on", "off"),
                   help="/api/v1/stream subscriptions over the fleet "
                        "query plane: viewers register a query once and "
                        "receive per-round deltas (SSE + long-poll "
                        "fallback) instead of re-polling; requires "
                        "--fleet-query on")
    p.add_argument("--stream-max-subscribers", type=int, default=10000,
                   help="admission cap on live stream subscriptions "
                        "(past it: 429, retry against a read replica)")
    p.add_argument("--stream-heartbeat-s", type=float, default=10.0,
                   help="stream heartbeat cadence while rounds are "
                        "quiet; 0 disables")
    p.add_argument("--stream-full-sync-s", type=float, default=60.0,
                   help="periodic full-answer frames on every stream "
                        "(delta-only streams rot); 0 disables")
    p.add_argument("--memory-budget-mb", type=float, default=0.0,
                   help="memory budget over the serving components "
                        "(fleet query result cache, stream hub retained "
                        "answers): past it the pressure ladder sheds "
                        "the cache first, then the oldest stream "
                        "subscriptions (counted). 0 = no budget")
    p.add_argument("--egress-url", default="",
                   help="Prometheus remote-write receiver: push the slice/"
                        "workload rollups there, WAL-buffered (empty "
                        "disables — same contract as the exporter's "
                        "--egress-url)")
    p.add_argument("--egress-dir", default="aggregator-egress",
                   help="durable send-buffer directory for --egress-url")
    p.add_argument("--egress-interval-s", type=float, default=0.0,
                   help="min seconds between egress batches (0 = every "
                        "round)")
    p.add_argument("--egress-max-backlog-mb", type=float, default=64.0)
    p.add_argument("--egress-max-backlog-age-s", type=float, default=3600.0)
    p.add_argument("--egress-timeout-s", type=float, default=5.0)
    p.add_argument("--egress-breaker-failures", type=int, default=3)
    p.add_argument("--egress-breaker-backoff-s", type=float, default=1.0)
    p.add_argument("--egress-breaker-backoff-max-s", type=float, default=60.0)
    p.add_argument("--log-level", default="info")
    p.add_argument("--log-format", default="text", choices=("text", "json"),
                   help="json = one Cloud-Logging-shaped object per line")
    p.add_argument("--record-to", default="",
                   help="append every round's fetched bodies to this JSONL "
                        "file (incident capture; ~1 MB/target/round)")
    p.add_argument("--replay-from", default="",
                   help="serve recorded rounds instead of scraping HTTP "
                        "(loops at end); with --targets '-', targets come "
                        "from the recording")
    ns = p.parse_args(argv)
    utils.setup_logging(ns.log_level, ns.log_format)

    fetch = default_fetch
    if ns.replay_from:
        fetch = ReplayFetch(ns.replay_from)
    elif ns.targets.strip() == "-":
        p.error("--targets - (targets from recording) requires --replay-from")
    recorder = RoundRecorder(ns.record_to) if ns.record_to else None
    # Dedup, order-preserved: a doubled target would fold its chips into
    # the rollups twice on the live path and corrupt ReplayFetch's
    # advance-on-repeat round tracking on the replay path.
    targets = tuple(dict.fromkeys(
        t.strip() for t in ns.targets.split(",") if t.strip()
    ))
    if ns.replay_from and targets == ("-",):
        targets = fetch.targets
    if not targets and not ns.targets_file:
        p.error("one of --targets / --targets-file is required")
    store = SnapshotStore()
    trace_store = tracer = None
    if ns.trace == "on":
        from tpu_pod_exporter_torch.trace import Tracer, TraceStore

        # No slow-poll sampler on the aggregator: a slow round is already
        # attributed by its per-target scrape spans (the scrape pool, not
        # the round thread, is where the time goes).
        trace_store = TraceStore(max_traces=ns.trace_max_traces)
        tracer = Tracer(trace_store, slow_poll_s=0.0, root_name="round")
    breaker_backoff_s = (
        ns.breaker_backoff_s if ns.breaker_backoff_s > 0
        else max(2.0 * ns.interval_s, ns.timeout_s)
    )
    breaker_store = None
    if ns.state_dir:
        import os

        from tpu_pod_exporter_torch.persist import BreakerStateFile

        breaker_store = BreakerStateFile(
            os.path.join(ns.state_dir, "aggregator-breakers.json")
        )
    shipper = None
    if ns.egress_url:
        from tpu_pod_exporter_torch.egress import (
            RemoteWriteShipper,
            aggregator_egress_metrics,
            build_breaker,
        )

        shipper = RemoteWriteShipper(
            ns.egress_url,
            ns.egress_dir,
            metrics=aggregator_egress_metrics(),
            interval_s=ns.egress_interval_s,
            timeout_s=ns.egress_timeout_s,
            max_backlog_mb=ns.egress_max_backlog_mb,
            max_backlog_age_s=ns.egress_max_backlog_age_s,
            breaker=build_breaker(
                ns.egress_breaker_failures,
                ns.egress_breaker_backoff_s,
                ns.egress_breaker_backoff_max_s,
            ),
        )
        shipper.load()
        shipper.start()
    agg = SliceAggregator(
        targets, store, timeout_s=ns.timeout_s, fetch=fetch, recorder=recorder,
        # Late-bound closure (the loop is constructed just below; the
        # exporter wires its collector the same way, app.py): overruns
        # surface as tpu_aggregator_poll_overruns_total.
        loop_overruns_fn=lambda: loop.overruns,
        history_fallback_window_s=ns.history_fallback_window,
        breaker_failures=ns.breaker_failures,
        # Auto backoff tracks the round cadence: the first quarantine skips
        # about one round, growing from there; never below the scrape
        # timeout (probing faster than a timeout resolves is pointless).
        breaker_backoff_s=breaker_backoff_s,
        # The ceiling must admit the base (huge --interval-s setups).
        breaker_backoff_max_s=max(ns.breaker_backoff_max_s, breaker_backoff_s),
        tracer=tracer,
        breaker_store=breaker_store,
        shipper=shipper,
        targets_file=ns.targets_file,
        render_splice=ns.render_splice == "on",
    )
    fleet = None
    if ns.fleet_query == "on":
        from tpu_pod_exporter_torch.fleet import FleetQueryPlane

        # Fleet query traces share the round-trace ring under their own
        # root name, so /debug/trace shows rounds and queries side by side.
        query_tracer = None
        if trace_store is not None:
            from tpu_pod_exporter_torch.trace import Tracer

            query_tracer = Tracer(trace_store, slow_poll_s=0.0,
                                  root_name="query")
        fleet = FleetQueryPlane(
            agg.targets,
            timeout_s=(ns.fleet_query_timeout_s
                       if ns.fleet_query_timeout_s > 0 else ns.timeout_s),
            breakers=agg.breakers,
            tracer=query_tracer,
            cache_entries=ns.fleet_query_cache,
            # Cache generation = round counter: one fan-out per query per
            # round, however many dashboard panels refresh.
            generation_fn=lambda: agg.rounds,
            # Live membership: a --targets-file reload changes agg.targets
            # between rounds; each query snapshots the current view.
            targets_fn=lambda: agg.targets,
        )
        agg.set_fleet(fleet)
    hub = pump = None
    if ns.stream == "on" and fleet is not None:
        from tpu_pod_exporter_torch.stream import attach_stream

        hub, pump = attach_stream(
            agg, fleet,
            heartbeat_s=ns.stream_heartbeat_s,
            full_sync_s=ns.stream_full_sync_s,
            max_subscribers=ns.stream_max_subscribers,
        )
    governor = None
    if ns.memory_budget_mb > 0:
        from tpu_pod_exporter_torch.pressure import build_serving_governor

        # Serving-tier memory ladder: result cache sheds first, oldest
        # stream subscriptions last (stream_shed rung, counted).
        governor = build_serving_governor(
            int(ns.memory_budget_mb * (1 << 20)),
            sidecar_dir=ns.state_dir,
            cache_plane=fleet, hub=hub,
        )
    loop = CollectorLoop(agg, interval_s=ns.interval_s)
    server = MetricsServer(
        store, host=ns.host, port=ns.port,
        health_max_age_s=max(10.0 * ns.interval_s, 10.0),
        max_scrapes_per_s=ns.max_scrapes_per_s,
        debug_vars=agg.debug_vars,
        debug_addr=ns.debug_addr,
        trace=trace_store,
        fleet=fleet,
        # Partition-aware readiness: all-targets-dark flips /readyz to
        # state=degraded (still HTTP 200 — the stale view keeps serving).
        ready_detail_fn=agg.ready_detail,
        stream_hub=hub,
    )

    stop = threading.Event()

    def _on_signal(signum: int, frame: object) -> None:  # noqa: ARG001
        log.info("signal %d: draining", signum)
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    agg.poll_once()  # synchronous first round so /readyz flips immediately
    loop.start()
    server.start()
    log.info("aggregating %d targets on :%d every %.1fs",
             len(targets), server.port, ns.interval_s)
    stop.wait()
    loop.stop()
    server.stop()
    if pump is not None:
        pump.close()
    if hub is not None:
        hub.close()
    if governor is not None:
        governor.close()
    if fleet is not None:
        fleet.close()
    if shipper is not None:
        shipper.close()
    agg.close()
    if recorder is not None:
        recorder.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
