"""Node-local telemetry flight recorder — bounded in-memory history.

The exporter's snapshot model deliberately keeps only the *latest* poll:
stale series are structurally impossible, but so is looking backwards. When
a pod OOMs or a duty-cycle cliff lands between Prometheus scrapes (or on a
cluster with no Prometheus at all — the gap ``aggregate.py`` exists to
fill), the evidence is gone by the next scrape. The reference exporter has
the same blindness — it overwrites two gauges every 30 s and keeps nothing
(``main.go:74-157``).

:class:`HistoryStore` turns each node into its own short-horizon TSDB: a
fixed set of per-series ring buffers (float64 value + monotonic and wall
timestamps, preallocated ``array('d')`` storage, O(1) append) that the
collector feeds once per poll *after* the snapshot swap — the scrape path
never touches the history lock. Memory is hard-bounded twice:

- per series: ``capacity`` samples × 24 bytes (three float64 arrays),
  allocated once at series creation, never grown;
- across series: at most ``max_series`` rings; creating one more evicts the
  least-recently-appended series (churned-away pods age out first) and
  counts it in ``evicted()['capacity']``. Series idle longer than
  ``retention_s`` are dropped wholesale (``evicted()['retention']``).

Worst case: ``max_series × capacity × 24`` bytes plus per-series
bookkeeping, allocated only for series actually present (~32 MB at the
256-chip shape; the exporter defaults cap at 8192 × 301 × 24 ≈ 59 MB).

Behind the raw ring sit **multi-resolution downsample tiers** (default
10 s and 60 s buckets — :data:`DEFAULT_TIER_SPEC`): each bucket folds
min/max/sum/count/first/last plus the within-bucket positive-delta sum, so
both gauge statistics and counter-reset-tolerant rates recompute exactly
from buckets. ``query_range`` transparently serves the coarsest tier that
satisfies the requested step (escalating to a coarser tier when the
requested start predates what the finer ring still holds), stretching
answerable retention from minutes to hours inside the same
``max_series`` hard bound; tier rings ride their series and evict with it.

Query surface (served by ``server.py`` as ``/api/v1/*`` JSON):

- ``series_list()`` — stored series and their label sets;
- ``query_range(metric, match, start, end, step)`` — samples by wall-clock
  range, optionally aligned to a step grid;
- ``window_stats(metric, match, window_s)`` — min/max/mean/first/last over
  a trailing window plus a counter-aware ``rate`` using the same monotonic
  fold-with-reset-tolerance semantics as the collector's ICI/DCN rates
  (negative deltas — device reset — contribute nothing).

Consumers in-tree: ``status.py --watch`` (per-chip deltas and trend arrows
instead of discarding prior samples) and ``aggregate.py`` (window-stats
fallback when a scrape round is missed, so slice continuity survives a
dropped round).

``python -m tpu_pod_exporter_torch.history --replay trace.jsonl`` replays a
recorded backend trace through a real collector into a history store and
prints what the flight recorder would answer — the offline forensics demo
(``make history-demo``).
"""

from __future__ import annotations

import threading
import time
from array import array
from typing import TYPE_CHECKING, Callable, Mapping, Sequence

from tpu_pod_exporter_torch.metrics import schema

if TYPE_CHECKING:  # typing only — no runtime import cost
    from tpu_pod_exporter_torch.metrics.registry import Snapshot

# Metric families the collector feeds into history each poll. Info series
# (tpu_host_info, tpu_exporter_info) and self-metrics are excluded — their
# history is either constant or recoverable from counters — EXCEPT
# tpu_chip_info, tpu_exporter_up and tpu_exporter_slow_polls_total:
# chip_info is the guaranteed per-chip presence series (HBM may be
# unreadable), so "which chips existed at time T" must come from it;
# exporter_up is the first question of any incident timeline — and slow
# polls are the second ("was the exporter itself struggling?"), so the
# tracing counter rides along and window_stats' counter-aware rate answers
# "slow polls in the last N minutes" without a Prometheus.
HISTORY_TRACKED_METRICS: frozenset[str] = frozenset({
    "tpu_hbm_used_bytes",
    "tpu_hbm_total_bytes",
    "tpu_hbm_used_percent",
    "tpu_hbm_peak_bytes",
    "tpu_chip_info",
    "tpu_tensorcore_duty_cycle_percent",
    "tpu_ici_transferred_bytes_total",
    "tpu_ici_link_bandwidth_bytes_per_second",
    "tpu_dcn_transferred_bytes_total",
    "tpu_dcn_link_bandwidth_bytes_per_second",
    "tpu_pod_chip_count",
    "tpu_pod_hbm_used_bytes",
    "tpu_kubelet_allocatable_chips",
    "tpu_kubelet_allocated_chips",
    "tpu_exporter_up",
    "tpu_exporter_slow_polls_total",
    # The GPU device family's node surface (backend/nvml.py): same
    # forensics contract as the TPU twins — "what did GPU 0's memory do
    # over the last five minutes" must answer node-locally, and the
    # aggregator's missed-round history fallback probes these names. On
    # TPU-only exporters the families carry no samples, so tracking them
    # costs nothing (series are created per sample, not per name).
    "gpu_hbm_used_bytes",
    "gpu_hbm_total_bytes",
    "gpu_hbm_used_percent",
    "gpu_utilization_percent",
    "gpu_chip_info",
    "gpu_pod_chip_count",
    "gpu_pod_memory_used_bytes",
    "gpu_backend_up",
})

_SPEC_BY_NAME = {
    spec.name: spec
    for spec in schema.ALL_SPECS + schema.GPU_NODE_SPECS
}
_COUNTER_METRICS = frozenset(
    name for name, spec in _SPEC_BY_NAME.items() if spec.type == schema.COUNTER
)


def is_counter_metric(name: str) -> bool:
    """Counter-aware rate eligibility: schema type wins; unknown names fall
    back to the Prometheus naming convention."""
    if name in _SPEC_BY_NAME:
        return name in _COUNTER_METRICS
    return name.endswith("_total")


# Multi-resolution downsample tiers behind the raw ring: ``step:capacity``
# pairs, finest first. Defaults stretch query_range's answerable retention
# from 5 min of raw (301 × 1 s polls) to 4 h (240 × 60 s buckets) — 48×, at
# the same ``--history-max-series`` series bound. Each bucket keeps
# min/max/sum/count/first/last plus the within-bucket positive-delta sum,
# so gauge stats AND counter-reset-tolerant rates recompute exactly from
# tier buckets (asserted by tests/test_tiers.py property tests).
DEFAULT_TIER_SPEC = "10:60,60:240"

# Per finalized bucket: 11 float64 cells (4 timestamps + 7 value stats).
_TIER_BUCKET_BYTES = 11 * 8


def parse_tier_spec(spec: str) -> tuple[tuple[float, int], ...]:
    """``"10:60,60:240"`` → ``((10.0, 60), (60.0, 240))``, sorted finest
    first. Empty / ``"off"`` / ``"none"`` disables tiering entirely."""
    s = spec.strip().lower()
    if s in ("", "off", "none", "0"):
        return ()
    tiers: list[tuple[float, int]] = []
    for entry in s.split(","):
        entry = entry.strip()
        if not entry:
            continue
        step_s, _, cap_s = entry.partition(":")
        try:
            step = float(step_s)
            cap = int(cap_s) if cap_s else 0
        except ValueError as e:
            raise ValueError(f"bad tier entry {entry!r}: {e}") from e
        if step <= 0 or cap < 2:
            raise ValueError(
                f"bad tier entry {entry!r}: need step > 0 and capacity >= 2"
            )
        tiers.append((step, cap))
    tiers.sort()
    if len({step for step, _cap in tiers}) != len(tiers):
        raise ValueError(f"duplicate tier step in {spec!r}")
    return tuple(tiers)


class _TierRing:
    """One series' downsample ring for one tier: a fixed-capacity ring of
    finalized buckets plus one open accumulator bucket.

    Buckets are keyed by wall time (``t_wall // step``) so bucket edges
    line up with the wall-clock grids queries ask for. Per finalized
    bucket the ring stores first/last mono+wall timestamps and
    min/max/sum/count/first/last values, plus ``dpos`` — the sum of
    positive deltas between consecutive samples *within* the bucket. The
    cross-bucket boundary delta is recomputed at query time from
    ``vfirst[k] − vlast[k−1]``, so a window rate over whole buckets equals
    the raw-sample computation exactly (reset tolerance included) without
    the ring needing to know its neighbours at append time."""

    __slots__ = ("step", "cap", "n", "head",
                 "tmf", "tml", "twf", "twl",
                 "vmin", "vmax", "vsum", "vcnt", "vfirst", "vlast", "dpos",
                 "bucket", "a_tmf", "a_tml", "a_twf", "a_twl", "a_min",
                 "a_max", "a_sum", "a_cnt", "a_first", "a_last", "a_dpos")

    def __init__(self, step: float, cap: int) -> None:
        zeros = bytes(8 * cap)
        self.step = step
        self.cap = cap
        self.n = 0
        self.head = 0
        self.tmf = array("d", zeros)
        self.tml = array("d", zeros)
        self.twf = array("d", zeros)
        self.twl = array("d", zeros)
        self.vmin = array("d", zeros)
        self.vmax = array("d", zeros)
        self.vsum = array("d", zeros)
        self.vcnt = array("d", zeros)
        self.vfirst = array("d", zeros)
        self.vlast = array("d", zeros)
        self.dpos = array("d", zeros)
        self.bucket = -1  # open-bucket id; -1 = nothing accumulated yet
        self.a_tmf = 0.0
        self.a_tml = 0.0
        self.a_twf = 0.0
        self.a_twl = 0.0
        self.a_min = 0.0
        self.a_max = 0.0
        self.a_sum = 0.0
        self.a_cnt = 0
        self.a_first = 0.0
        self.a_last = 0.0
        self.a_dpos = 0.0

    def add(self, t_mono: float, t_wall: float, v: float, dpos: float) -> None:
        b = int(t_wall // self.step)
        if b != self.bucket:
            if self.bucket >= 0:
                self._flush()
            self.bucket = b
            self.a_tmf = t_mono
            self.a_twf = t_wall
            self.a_min = v
            self.a_max = v
            self.a_sum = v
            self.a_cnt = 1
            self.a_first = v
            # The boundary delta (previous bucket's last → this sample) is
            # deliberately NOT accumulated: queries rebuild it from the
            # stored first/last values of adjacent buckets, keeping window
            # rates exact from any bucket onward.
            self.a_dpos = 0.0
        else:
            if v < self.a_min:
                self.a_min = v
            if v > self.a_max:
                self.a_max = v
            self.a_sum += v
            self.a_cnt += 1
            self.a_dpos += dpos
        self.a_tml = t_mono
        self.a_twl = t_wall
        self.a_last = v

    def _flush(self) -> None:
        i = self.head
        self.tmf[i] = self.a_tmf
        self.tml[i] = self.a_tml
        self.twf[i] = self.a_twf
        self.twl[i] = self.a_twl
        self.vmin[i] = self.a_min
        self.vmax[i] = self.a_max
        self.vsum[i] = self.a_sum
        self.vcnt[i] = float(self.a_cnt)
        self.vfirst[i] = self.a_first
        self.vlast[i] = self.a_last
        self.dpos[i] = self.a_dpos
        self.head = (i + 1) % self.cap
        if self.n < self.cap:
            self.n += 1

    def open_bucket(self) -> tuple | None:
        """The open accumulator as one bucket tuple (None while empty) —
        the same 11-field shape :func:`tier_items` yields. The fleet store
        (``tpu_pod_exporter_torch.store``) captures it just before a boundary
        crossing finalizes it, which is exactly the record it persists."""
        if self.bucket >= 0 and self.a_cnt > 0:
            return (self.a_tmf, self.a_tml, self.a_twf, self.a_twl,
                    self.a_min, self.a_max, self.a_sum,
                    float(self.a_cnt), self.a_first, self.a_last,
                    self.a_dpos)
        return None

    # ------------------------------------------------ disk-backed restore
    # The wall-bucketed generalization (tpu_pod_exporter_torch.store): a ring is
    # rebuilt at boot from persisted finalized-bucket records, then keeps
    # accumulating live — push() inserts a finalized bucket directly,
    # replacing the newest retained bucket when both cover the SAME wall
    # bucket (a re-finalization record written after a restart merged new
    # samples into a restored accumulator supersedes the pre-crash record,
    # so replay is idempotent and never yields duplicate buckets), and
    # pop_to_accumulator() re-opens the newest restored bucket so the
    # first post-restart samples of the same wall bucket MERGE exactly
    # (every accumulator field is present in the stored bucket) instead of
    # forking a twin bucket.

    def _store_at(self, i: int, b: tuple) -> None:
        (self.tmf[i], self.tml[i], self.twf[i], self.twl[i],
         self.vmin[i], self.vmax[i], self.vsum[i], self.vcnt[i],
         self.vfirst[i], self.vlast[i], self.dpos[i]) = b

    def push(self, b: tuple) -> None:
        """Insert one FINALIZED bucket (oldest-first replay order); a
        bucket covering the same wall bucket as the newest retained one
        REPLACES it (see the restore notes above)."""
        bid = int(b[2] // self.step)
        if self.n:
            j = (self.head - 1) % self.cap
            if int(self.twf[j] // self.step) == bid:
                self._store_at(j, b)
                return
        self._store_at(self.head, b)
        self.head = (self.head + 1) % self.cap
        if self.n < self.cap:
            self.n += 1

    def pop_to_accumulator(self) -> None:
        """Move the NEWEST finalized bucket back into the open accumulator
        (boot-time restore tail): post-restart samples landing in the same
        wall bucket then merge into it exactly."""
        if not self.n:
            return
        i = (self.head - 1) % self.cap
        self.head = i
        self.n -= 1
        (self.a_tmf, self.a_tml, self.a_twf, self.a_twl,
         self.a_min, self.a_max, self.a_sum, cnt,
         self.a_first, self.a_last, self.a_dpos) = (
            self.tmf[i], self.tml[i], self.twf[i], self.twl[i],
            self.vmin[i], self.vmax[i], self.vsum[i], self.vcnt[i],
            self.vfirst[i], self.vlast[i], self.dpos[i])
        self.a_cnt = int(cnt)
        self.bucket = int(self.a_twf // self.step)

    # Query-side copy, called UNDER the store lock (same raw-slice
    # discipline as HistoryStore._rows_for): finalized buckets as array
    # slices plus the open accumulator as one tuple; per-bucket Python
    # tuples are built outside the lock by _tier_items.
    def copy(self) -> tuple:
        open_bucket = self.open_bucket()
        return (self.step, self.cap, self.n, self.head,
                self.tmf[:], self.tml[:], self.twf[:], self.twl[:],
                self.vmin[:], self.vmax[:], self.vsum[:], self.vcnt[:],
                self.vfirst[:], self.vlast[:], self.dpos[:], open_bucket)

    def oldest_mono(self) -> float:
        """Earliest t_mono this ring can answer for; -inf when the ring has
        not wrapped yet (it then holds everything since series creation)."""
        if self.n < self.cap:
            return float("-inf")
        return self.tmf[(self.head - self.n) % self.cap]

    def oldest_wall(self) -> float:
        if self.n < self.cap:
            return float("-inf")
        return self.twf[(self.head - self.n) % self.cap]

    def newest_wall(self) -> float:
        if self.bucket >= 0 and self.a_cnt > 0:
            return self.a_twl
        if self.n:
            return self.twl[(self.head - 1) % self.cap]
        return float("-inf")

    def first_wall(self) -> float:
        """Wall time of the oldest retained bucket's first sample (+inf when
        empty) — the occupancy/span read, not the coverage read."""
        if self.n:
            return self.twf[(self.head - self.n) % self.cap]
        if self.bucket >= 0 and self.a_cnt > 0:
            return self.a_twf
        return float("inf")


def _tier_items(copy: tuple) -> list[tuple]:
    """One copied tier ring's buckets, oldest first (open bucket last), as
    (tmf, tml, twf, twl, vmin, vmax, vsum, vcnt, vfirst, vlast, dpos)."""
    (_step, cap, n, head, tmf, tml, twf, twl,
     vmin, vmax, vsum, vcnt, vfirst, vlast, dpos, open_bucket) = copy
    start = (head - n) % cap
    items = [
        (tmf[i], tml[i], twf[i], twl[i], vmin[i], vmax[i], vsum[i],
         vcnt[i], vfirst[i], vlast[i], dpos[i])
        for i in ((start + k) % cap for k in range(n))
    ]
    if open_bucket is not None:
        items.append(open_bucket)
    return items


# Public names for the wall-bucketed tier machinery the root-side fleet
# store (tpu_pod_exporter_torch.store) builds on: the ring itself, the copied-
# ring walker, and the two query folds extracted below. One implementation
# of bucket semantics — the store must answer exactly like a node ring.
TierRing = _TierRing
tier_items = _tier_items


def align_grid(
    points: Sequence[tuple[float, float]],
    start: float,
    end: float,
    step: float,
    lookback: float,
) -> list[list[float]]:
    """Align time-ordered ``(t_wall, value)`` points to the grid ``start,
    start+step, …, end``: each grid point carries the most recent sample at
    or before it, within ``lookback`` seconds (so a long-dead series does
    not project forward forever). Samples just BEFORE ``start`` are still
    eligible for the left-edge grid points — filtering them out would fake
    a gap at the start of an incident window. One forward pointer walk."""
    raw = [(tw, v) for (tw, v) in points if tw <= end]
    aligned: list[list[float]] = []
    i = -1
    t = start
    while t <= end + 1e-9:
        while i + 1 < len(raw) and raw[i + 1][0] <= t:
            i += 1
        if i >= 0 and t - raw[i][0] <= lookback:
            aligned.append([t, raw[i][1]])
        t += step
    return aligned


def fold_tier_window(
    buckets: Sequence[tuple], counter: bool
) -> dict[str, float | int | None]:
    """Window statistics recomputed EXACTLY from tier buckets (oldest
    first): min/max/first/last direct, mean via sum/count (weighted —
    bucket sample counts differ), and the counter rate from within-bucket
    positive-delta sums plus cross-bucket boundary deltas rebuilt from
    adjacent buckets' first/last values, so reset tolerance survives
    downsampling. The shared fold behind HistoryStore.window_stats and the
    fleet store's window queries."""
    nsamples = int(sum(b[7] for b in buckets))
    stats: dict[str, float | int | None] = {
        "min": min(b[4] for b in buckets),
        "max": max(b[5] for b in buckets),
        "mean": sum(b[6] for b in buckets) / nsamples,
        "first": buckets[0][8],
        "last": buckets[-1][9],
        "first_t": buckets[0][2],
        "last_t": buckets[-1][3],
        "samples": nsamples,
        "rate": None,
    }
    if counter and nsamples >= 2:
        dt = buckets[-1][1] - buckets[0][0]
        if dt > 0:
            gained = sum(b[10] for b in buckets)
            for prev, cur in zip(buckets, buckets[1:]):
                d = cur[8] - prev[9]  # boundary: first - prev last
                if d > 0:
                    gained += d
            stats["rate"] = gained / dt
    return stats


class _Series:
    """One series' identity plus its fixed-capacity ring of
    (t_mono, t_wall, value) float64 triples.

    Three parallel ``array('d')`` buffers, preallocated at construction —
    an append is three C-level stores plus index arithmetic, no Python
    object allocation. Ring state lives directly on the series (no nested
    ring object): the steady-state append loop in ``append_snapshot`` is
    the store's hot path at 256-chip scale (~4.4k series/poll) and a
    per-sample method call there is the dominant cost (measured)."""

    __slots__ = ("name", "labels", "cap", "n", "head", "tm", "tw", "vals",
                 "last_mono", "tiers", "pv")

    def __init__(self, name: str, labels: dict[str, str], cap: int,
                 tier_spec: tuple[tuple[float, int], ...] = ()) -> None:
        zeros = bytes(8 * cap)
        self.name = name
        self.labels = labels
        self.cap = cap
        self.n = 0
        self.head = 0  # next write slot
        self.tm = array("d", zeros)
        self.tw = array("d", zeros)
        self.vals = array("d", zeros)
        self.last_mono = 0.0
        # Downsample rings (finest first) + the previous raw value, from
        # which each sample's positive delta (the counter-rate unit) is
        # derived once and fed to every tier. NaN start: `v - nan > 0` is
        # False, so the first sample contributes dpos 0 with no branch.
        self.tiers = tuple(_TierRing(step, tcap) for step, tcap in tier_spec)
        self.pv = float("nan")

    def append(self, t_mono: float, t_wall: float, value: float) -> None:
        i = self.head
        self.tm[i] = t_mono
        self.tw[i] = t_wall
        self.vals[i] = value
        self.head = (i + 1) % self.cap
        if self.n < self.cap:
            self.n += 1
        self.last_mono = t_mono

    def tier_add(self, t_mono: float, t_wall: float, value: float) -> None:
        d = value - self.pv
        dpos = d if d > 0.0 else 0.0
        self.pv = value
        for t in self.tiers:
            t.add(t_mono, t_wall, value, dpos)

class HistoryStore:
    """Bounded multi-series ring-buffer store with a query API.

    Tier occupancy in :meth:`stats` refreshes at most every
    ``_TIER_STATS_INTERVAL_S`` (spans move one bucket per tier step, so a
    staler read is indistinguishable almost always).

    Thread contract: ``append*`` is called by the poll thread (one lock
    acquisition per poll, after the snapshot swap — never on the scrape
    path); queries come from HTTP handler threads and copy results out
    under the same lock.
    """

    def __init__(
        self,
        capacity: int = 301,
        max_series: int = 4096,
        retention_s: float = 300.0,
        clock: Callable[[], float] = time.monotonic,
        wallclock: Callable[[], float] = time.time,
        tiers: Sequence[tuple[float, int]] | str | None = None,
    ) -> None:
        if capacity < 2:
            raise ValueError("history capacity must be >= 2")
        if max_series < 1:
            raise ValueError("history max_series must be >= 1")
        self.capacity = capacity
        self.max_series = max_series
        self.retention_s = retention_s
        # Downsample tiers (None = the default 10 s/60 s pair; () or "off"
        # disables). Tier rings ride each series and are evicted with it;
        # they stretch query_range's answerable retention ~48× at the cost
        # of ~4× per-series memory (see DEFAULT_TIER_SPEC), still
        # hard-bounded by max_series.
        if tiers is None:
            self.tier_spec = parse_tier_spec(DEFAULT_TIER_SPEC)
        elif isinstance(tiers, str):
            self.tier_spec = parse_tier_spec(tiers)
        else:
            self.tier_spec = tuple(sorted(tiers))
        self._tiering = bool(self.tier_spec)
        self._clock = clock
        self._wallclock = wallclock
        self._lock = threading.Lock()
        # (metric, label values tuple) -> _Series. Eviction picks the
        # minimum last_mono by scan — O(series) per eviction, but evictions
        # only happen past max_series, which is sized above the worst
        # supported host shape.
        self._series: dict[tuple, _Series] = {}
        # Steady-state fast path, the history twin of the renderer's
        # FamilyLayout: when a tracked family's key tuple is identical to
        # the previous poll (no churn), its _Series objects are replayed
        # from this cache and appends run as one tight zip loop — no
        # per-sample dict lookups or method calls. Any eviction clears the
        # cache wholesale (an entry could otherwise keep feeding a series
        # that no longer exists in the store).
        self._layouts: dict[str, tuple[tuple, list[_Series]]] = {}
        self._samples = 0  # retained samples across all rings
        self._evicted = {"capacity": 0, "retention": 0}
        # Bumped on every eviction. The slow path snapshots it before
        # walking a family and refuses to cache the family's layout if it
        # changed mid-walk: an eviction can claim a series created earlier
        # in the same walk, and caching that ghost would let the fast path
        # feed a series no longer in the store — silently losing samples
        # while the eviction counter sits still.
        self._evict_gen = 0
        # Retention GC is a full-store scan; at one poll per second that
        # would cost more than the appends it polices. Amortized: scans run
        # at most every retention/32 (min 1 s), so an idle series lives at
        # most ~3% past its retention — invisible at query granularity.
        self._gc_interval_s = max(1.0, retention_s / 32.0)
        self._last_gc = 0.0
        # Tier occupancy stats are a full scan too (see _tier_stats_locked)
        # — same amortization discipline.
        self._tier_stats_cache: list[dict] | None = None
        self._tier_stats_at = 0.0

    # ---------------------------------------------------------------- append

    def append(
        self,
        metric: str,
        labels: Mapping[str, str],
        value: float,
        t_mono: float | None = None,
        t_wall: float | None = None,
    ) -> None:
        """Record one sample (public single-series entry point — used by
        ``status --watch``; the collector batches via append_snapshot)."""
        tm = self._clock() if t_mono is None else t_mono
        tw = self._wallclock() if t_wall is None else t_wall
        key = (metric, tuple(sorted(labels.items())))
        with self._lock:
            self._append_locked(key, metric, dict(labels), float(value), tm, tw)
            self._gc_locked(tm)

    def append_snapshot(
        self, snapshot: "Snapshot", now_mono: float, now_wall: float
    ) -> int:
        """Feed every tracked family of one collector snapshot; returns the
        number of samples appended. One lock acquisition for the whole poll.

        Steady state (identical family layout to the previous poll) runs
        the inlined zip loop over cached _Series objects; any churn falls
        back to the keyed path for that family and rebuilds its layout."""
        appended = 0
        tiering = self._tiering
        with self._lock:
            layouts = self._layouts
            for name in HISTORY_TRACKED_METRICS:
                spec = _SPEC_BY_NAME.get(name)
                if spec is None:
                    continue
                fam = snapshot.samples(name)
                if not fam:
                    continue
                keys = tuple(fam)
                cached = layouts.get(name)
                if cached is not None and cached[0] == keys:
                    new_samples = 0
                    for s, v in zip(cached[1], fam.values()):
                        i = s.head
                        s.tm[i] = now_mono
                        s.tw[i] = now_wall
                        s.vals[i] = v
                        i += 1
                        s.head = 0 if i == s.cap else i
                        if s.n != s.cap:
                            s.n += 1
                            new_samples += 1
                        s.last_mono = now_mono
                        if tiering:
                            s.tier_add(now_mono, now_wall, v)
                    self._samples += new_samples
                    appended += len(keys)
                    continue
                # Slow path: churn or first sighting — keyed appends, then
                # freeze this poll's series list as the next poll's layout.
                label_names = spec.label_names
                series_list: list[_Series] = []
                gen0 = self._evict_gen
                for lvs, value in fam.items():
                    key = (name, lvs)
                    s = self._series.get(key)
                    if s is None:
                        s = self._create_locked(
                            key, name, dict(zip(label_names, lvs))
                        )
                    if s.n != s.cap:
                        self._samples += 1
                    s.append(now_mono, now_wall, value)
                    if tiering:
                        s.tier_add(now_mono, now_wall, value)
                    series_list.append(s)
                    appended += 1
                if self._evict_gen == gen0:
                    layouts[name] = (keys, series_list)
                # else: an eviction landed mid-walk and series_list may hold
                # a ghost — leave the family uncached (next poll re-keys).
            self._gc_locked(now_mono)
        return appended

    def _append_locked(
        self, key: tuple, metric: str, labels: dict[str, str],
        value: float, tm: float, tw: float,
    ) -> None:
        s = self._series.get(key)
        if s is None:
            s = self._create_locked(key, metric, labels)
        if s.n != s.cap:
            self._samples += 1
        s.append(tm, tw, value)
        if self._tiering:
            s.tier_add(tm, tw, value)

    def _create_locked(self, key: tuple, metric: str,
                       labels: dict[str, str]) -> _Series:
        while len(self._series) >= self.max_series:
            victim_key = min(self._series, key=lambda k: self._series[k].last_mono)
            victim = self._series.pop(victim_key)
            self._samples -= victim.n
            self._evicted["capacity"] += 1
            self._evict_gen += 1
            self._layouts.clear()  # a layout may still reference the victim
        s = self._series[key] = _Series(metric, labels, self.capacity,
                                        self.tier_spec)
        return s

    def _gc_locked(self, now_mono: float) -> None:
        """Drop series idle past retention (amortized full scan)."""
        if self.retention_s <= 0:
            return
        if now_mono - self._last_gc < self._gc_interval_s:
            return
        self._last_gc = now_mono
        horizon = now_mono - self.retention_s
        stale = [k for k, s in self._series.items() if s.last_mono < horizon]
        for k in stale:
            s = self._series.pop(k)
            self._samples -= s.n
            self._evicted["retention"] += 1
        if stale:
            self._evict_gen += 1
            self._layouts.clear()

    # ------------------------------------------------- pressure shed hook

    def set_capacity(self, new_cap: int) -> None:
        """Rebuild every raw ring at ``new_cap``, keeping each series'
        NEWEST samples — the memory-pressure ladder's ``history_cut`` rung
        (tpu_pod_exporter_torch.pressure). The downsample tiers are untouched
        (coarse tiers shed LAST: they are the cheapest bytes per second of
        answerable history), so long-window queries keep answering while
        raw-resolution retention halves. Reversible: a larger ``new_cap``
        re-grows the rings (existing samples preserved)."""
        new_cap = max(int(new_cap), 2)
        with self._lock:
            if new_cap == self.capacity:
                return
            zeros = bytes(8 * new_cap)
            for s in self._series.values():
                keep = min(s.n, new_cap)
                start = (s.head - keep) % s.cap
                tm = array("d", zeros)
                tw = array("d", zeros)
                vals = array("d", zeros)
                for k in range(keep):
                    i = (start + k) % s.cap
                    tm[k] = s.tm[i]
                    tw[k] = s.tw[i]
                    vals[k] = s.vals[i]
                self._samples -= s.n - keep
                s.tm, s.tw, s.vals = tm, tw, vals
                s.cap = new_cap
                s.n = keep
                s.head = keep % new_cap
            self.capacity = new_cap
            # The cached layouts hold the same _Series objects (still
            # valid — identity unchanged), so the steady-state append
            # fast path keeps working across the rebuild.

    # ----------------------------------------------- persistence (persist.py)

    def export_series(self) -> list[tuple[str, dict, list[tuple[float, float]]]]:
        """Every series' full ring as ``(metric, labels, [(t_wall, value),
        …])`` oldest-first — the checkpoint payload for crash-safe
        persistence. Raw ``array('d')`` slices are copied under the lock
        (same discipline as :meth:`_rows_for`); the per-sample tuples are
        built outside it."""
        with self._lock:
            rows = [
                (s.name, dict(s.labels), s.cap, s.n, s.head, s.tw[:], s.vals[:])
                for s in self._series.values()
            ]
        out = []
        for name, labels, cap, n, head, tw, vals in rows:
            start = (head - n) % cap
            samples = [
                (tw[i], vals[i])
                for i in ((start + k) % cap for k in range(n))
            ]
            out.append((name, labels, samples))
        return out

    def restore_series(
        self, metric: str, labels: Mapping[str, str],
        samples: list[tuple[float, float]],
        wall_to_mono: Callable[[float], float],
    ) -> int:
        """Bulk-append persisted samples (oldest first) at boot. Monotonic
        timestamps are reconstructed from wall time via ``wall_to_mono``
        (the restart reset the monotonic clock); appending past capacity
        simply wraps the ring, keeping the newest samples. Returns the
        number of samples appended.

        Key discipline: the restored series MUST land under the exact key
        the collector's ``append_snapshot`` will use on the first live
        poll — ``(metric, label-VALUE tuple in spec order)`` — or restored
        and live samples fork into two series with identical labels and
        the continuity the restore exists for is silently lost. Metrics
        outside the schema fall back to the sorted-items key that the
        generic :meth:`append` path uses, for the same reason."""
        spec = _SPEC_BY_NAME.get(metric)
        if spec is not None:
            key = (metric, tuple(str(labels.get(ln, ""))
                                 for ln in spec.label_names))
        else:
            key = (metric, tuple(sorted(labels.items())))
        lbl = dict(labels)
        with self._lock:
            for t_wall, value in samples:
                self._append_locked(
                    key, metric, lbl, float(value),
                    wall_to_mono(t_wall), t_wall,
                )
        return len(samples)

    # ----------------------------------------------------------------- query

    @staticmethod
    def _matches(labels: dict[str, str], match: Mapping[str, str]) -> bool:
        return all(labels.get(k) == v for k, v in match.items())

    @staticmethod
    def _choose_ring(s: _Series, step: float, start: float,
                     wall_axis: bool, escalate: bool = True) -> int:
        """Tier selection for one series: index into ``s.tiers`` or -1 for
        the raw ring.

        Two rules, in order: (1) the COARSEST ring whose resolution still
        satisfies the requested step (raw when ``step`` is 0 or finer than
        every tier) — the transparent-downsample contract; (2) coverage
        escalation (``escalate``; off for raw-sample queries, whose
        contract is "the raw ring, whatever it still holds"): if the
        chosen ring has already evicted ``start``, prefer the finest
        coarser ring that still reaches it, else whichever ring reaches
        furthest back — answering an old incident window at 60 s
        resolution beats answering nothing. A ring that has not wrapped
        yet holds everything since series creation and always covers."""
        choice = -1
        if step > 0:
            for i, t in enumerate(s.tiers):
                if t.step <= step:
                    choice = i

        def oldest(idx: int) -> float:
            if idx < 0:
                if s.n < s.cap:
                    return float("-inf")
                j = (s.head - s.n) % s.cap
                return s.tw[j] if wall_axis else s.tm[j]
            t = s.tiers[idx]
            return t.oldest_wall() if wall_axis else t.oldest_mono()

        if not escalate or oldest(choice) <= start:
            return choice
        best, best_oldest = choice, oldest(choice)
        for i in range(choice + 1, len(s.tiers)):
            ow = oldest(i)
            if ow <= start:
                return i
            if ow < best_oldest:
                best, best_oldest = i, ow
        return best

    def _rows_for(self, metric: str, match: Mapping[str, str]) -> list[tuple]:
        """Matching series' ring contents, copied out under the lock as raw
        ``array('d')`` slices — C-speed memcpy, ~7 KB per series. The
        per-sample Python tuples are built OUTSIDE the lock by
        ``_row_items``: a match-less query on a 256-chip store materializes
        ~1.3M tuples, and doing that under the lock would let any client of
        the (unauthenticated) /api/v1 endpoints starve the poll thread's
        append and stall polling."""
        with self._lock:
            return [
                (s.labels, s.cap, s.n, s.head, s.tm[:], s.tw[:], s.vals[:])
                for s in self._series.values()
                if s.name == metric and self._matches(s.labels, match)
            ]

    def _query_rows(self, metric: str, match: Mapping[str, str],
                    step: float, start: float, wall_axis: bool,
                    escalate: bool = True) -> list[tuple]:
        """Tier-aware row copies for one query: per matching series, pick
        the ring :meth:`_choose_ring` selects and copy ONLY that ring
        (copying every tier of every series would multiply the under-lock
        memcpy ~4×, paid by raw-only queries that never read it). Each row
        is ``(labels, tier_step, payload, last_wall)`` where tier_step is
        0.0 for the raw ring and payload is the matching ring copy;
        last_wall is the series' newest raw sample wall time — the
        staleness stamp every query answer now carries."""
        with self._lock:
            rows: list[tuple] = []
            for s in self._series.values():
                if s.name != metric or not self._matches(s.labels, match):
                    continue
                last_wall = (
                    s.tw[(s.head - 1) % s.cap] if s.n else None
                )
                idx = (
                    self._choose_ring(s, step, start, wall_axis, escalate)
                    if s.tiers else -1
                )
                if idx < 0:
                    payload: tuple = (
                        s.labels, s.cap, s.n, s.head,
                        s.tm[:], s.tw[:], s.vals[:],
                    )
                    rows.append((s.labels, 0.0, payload, last_wall))
                else:
                    t = s.tiers[idx]
                    rows.append((s.labels, t.step, t.copy(), last_wall))
            return rows

    @staticmethod
    def _row_items(row: tuple) -> list[tuple[float, float, float]]:
        """One copied row's samples, oldest first, as (t_mono, t_wall, v)."""
        _labels, cap, n, head, tm, tw, vals = row
        start = (head - n) % cap
        return [
            (tm[i], tw[i], vals[i])
            for i in ((start + k) % cap for k in range(n))
        ]

    def series_list(self) -> list[dict]:
        with self._lock:
            return [
                {"metric": s.name, "labels": dict(s.labels),
                 "samples": s.n}
                for s in self._series.values()
            ]

    # Per-bucket value picks for tier-backed query_range grids. A bucket
    # tuple is (tmf, tml, twf, twl, vmin, vmax, vsum, vcnt, vfirst, vlast,
    # dpos) — see _tier_items.
    QUERY_AGGS: tuple[str, ...] = ("last", "min", "max", "mean")

    @staticmethod
    def _bucket_value(b: tuple, agg: str) -> float:
        if agg == "min":
            return b[4]
        if agg == "max":
            return b[5]
        if agg == "mean":
            return b[6] / b[7] if b[7] else b[9]
        return b[9]  # last

    def query_range(
        self,
        metric: str,
        match: Mapping[str, str] | None = None,
        start: float | None = None,
        end: float | None = None,
        step: float = 0.0,
        agg: str = "last",
    ) -> list[dict]:
        """Samples of every matching series with wall time in [start, end].

        ``step == 0`` returns raw samples; ``step > 0`` aligns to the grid
        ``start, start+step, …, end``, each point carrying the most recent
        sample at or before it (within a ``max(2*step, 10 s)`` staleness
        lookback, so a long-dead series doesn't project forward forever).

        The backing ring is chosen per series (:meth:`_choose_ring`): the
        coarsest downsample tier whose resolution satisfies ``step``, with
        coverage escalation when the requested ``start`` predates what the
        finer ring still holds — one query spans hours without the caller
        knowing tiers exist. Tier-backed answers expose per-bucket ``agg``
        (last/min/max/mean; a duty-cycle cliff hunts with ``agg=min``);
        each result row carries ``tier`` (the bucket width served, 0 =
        raw) and ``last_sample_wall_ts`` (the series' newest sample — the
        staleness stamp federation merges key on).
        """
        if end is None:
            end = self._wallclock()
        if start is None:
            start = end - 300.0
        out: list[dict] = []
        for labels, tier_step, payload, last_wall in self._query_rows(
            metric, match or {}, step, start, True, escalate=step > 0
        ):
            if tier_step == 0.0:
                items = self._row_items(payload)
                points = [(tw, v) for (_tm, tw, v) in items]
            else:
                points = [
                    (b[3], self._bucket_value(b, agg))
                    for b in _tier_items(payload)
                ]
            if step > 0:
                # Lookback floor tracks the bucket width on tier-backed
                # answers: a 60 s bucket's single point must carry grid
                # points across its whole bucket, not just 10 s of it.
                lookback = max(2.0 * step, 2.0 * tier_step, 10.0)
                values = align_grid(points, start, end, step, lookback)
            else:
                values = [
                    [tw, v] for (tw, v) in points if start <= tw <= end
                ]
            if values:
                out.append({
                    "metric": metric, "labels": dict(labels),
                    "values": values, "tier": tier_step,
                    "last_sample_wall_ts": last_wall,
                })
        return out

    def window_stats(
        self,
        metric: str,
        match: Mapping[str, str] | None = None,
        window_s: float = 60.0,
        now_mono: float | None = None,
    ) -> list[dict]:
        """min/max/mean/first/last over the trailing window, plus a
        counter-aware ``rate`` (sum of positive deltas / elapsed — the
        ICI/DCN monotonic-fold semantics: a device reset holds, it never
        goes negative). ``rate`` is null for gauges and for windows with
        fewer than two samples.

        Windows reaching past raw retention fold downsample-tier buckets
        instead: min/mean/max/first/last and sample counts recompute
        exactly from per-bucket stats, and the counter rate rebuilds
        cross-bucket boundary deltas from adjacent buckets' first/last
        values, so reset tolerance survives downsampling (a window edge
        mid-bucket includes that whole bucket — bucket-width granularity,
        not sample loss). Rows carry ``tier`` and ``last_sample_wall_ts``
        like :meth:`query_range`."""
        now = self._clock() if now_mono is None else now_mono
        lo = now - window_s
        counter = is_counter_metric(metric)
        out: list[dict] = []
        for labels, tier_step, payload, last_wall in self._query_rows(
            metric, match or {}, 0.0, lo, False
        ):
            stats: dict[str, float | int | None]
            if tier_step == 0.0:
                items = self._row_items(payload)
                win = [(tm, tw, v) for (tm, tw, v) in items if tm >= lo]
                if not win:
                    continue
                vals = [v for (_tm, _tw, v) in win]
                stats = {
                    "min": min(vals),
                    "max": max(vals),
                    "mean": sum(vals) / len(vals),
                    "first": vals[0],
                    "last": vals[-1],
                    "first_t": win[0][1],
                    "last_t": win[-1][1],
                    "samples": len(vals),
                    "rate": None,
                }
                if counter and len(win) >= 2:
                    dt = win[-1][0] - win[0][0]
                    if dt > 0:
                        gained = sum(
                            d for d in
                            (b - a for a, b in zip(vals, vals[1:]))
                            if d > 0
                        )
                        stats["rate"] = gained / dt
            else:
                buckets = [
                    b for b in _tier_items(payload) if b[1] >= lo
                ]  # bucket's last sample inside the window
                if not buckets:
                    continue
                stats = fold_tier_window(buckets, counter)
            out.append({
                "metric": metric, "labels": dict(labels), "stats": stats,
                "tier": tier_step, "last_sample_wall_ts": last_wall,
            })
        return out

    # ----------------------------------------------------------- introspection

    _TIER_STATS_INTERVAL_S = 10.0

    def _tier_stats_locked(self) -> list[dict]:
        """Per-tier occupancy/span, amortized: the full O(series × tiers)
        scan runs at most once per _TIER_STATS_INTERVAL_S and is cached —
        the collector reads stats() EVERY poll, and spans move one bucket
        per tier-step anyway, so a freshly scanned answer would be
        identical almost every time while holding the append lock longer."""
        now = self._clock()
        if (self._tier_stats_cache is not None
                and now - self._tier_stats_at < self._TIER_STATS_INTERVAL_S):
            return self._tier_stats_cache
        tiers: list[dict] = []
        for i, (step, cap) in enumerate(self.tier_spec):
            buckets = 0
            oldest = float("inf")
            newest = float("-inf")
            for s in self._series.values():
                t = s.tiers[i]
                buckets += t.n + (1 if t.bucket >= 0 and t.a_cnt else 0)
                fw = t.first_wall()
                if fw < oldest:
                    oldest = fw
                nw = t.newest_wall()
                if nw > newest:
                    newest = nw
            tiers.append({
                "step_s": step,
                "capacity": cap,
                "buckets": buckets,
                # Answerable span: how far back this tier can currently
                # reach — the occupancy read the Grafana row plots.
                "span_s": max(newest - oldest, 0.0) if buckets else 0.0,
            })
        self._tier_stats_cache = tiers
        self._tier_stats_at = now
        return tiers

    def stats(self) -> dict:
        with self._lock:
            nseries = len(self._series)
            # Three float64 arrays per raw ring plus 11 per tier bucket,
            # all preallocated at full capacity per series present.
            per_series = self.capacity * 24 + sum(
                cap * _TIER_BUCKET_BYTES for _step, cap in self.tier_spec
            )
            tiers = self._tier_stats_locked()
            return {
                "series": nseries,
                "samples": self._samples,
                "evicted": dict(self._evicted),
                "capacity": self.capacity,
                "max_series": self.max_series,
                "retention_s": self.retention_s,
                "memory_bytes": nseries * per_series,
                "tiers": tiers,
            }


# --------------------------------------------------------------------- demo


def main(argv: list[str] | None = None) -> int:
    """Replay a recorded backend trace through a real collector into a
    HistoryStore and print the flight recorder's answers — offline incident
    forensics with zero hardware (``make history-demo``)."""
    import argparse

    from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
    from tpu_pod_exporter_torch.backend.recorded import RecordedBackend
    from tpu_pod_exporter_torch.collector import Collector
    from tpu_pod_exporter_torch.metrics import SnapshotStore

    p = argparse.ArgumentParser(
        prog="tpu-pod-exporter-history",
        description="Replay a recorded trace into the telemetry flight "
                    "recorder and print window stats.",
    )
    p.add_argument("--replay", required=True,
                   help="JSONL trace recorded with --record-to")
    p.add_argument("--polls", type=int, default=0,
                   help="polls to replay (default: one pass over the trace)")
    p.add_argument("--interval-s", type=float, default=1.0,
                   help="simulated seconds between replayed polls")
    p.add_argument("--window-s", type=float, default=0.0,
                   help="window for stats (default: the whole replay)")
    ns = p.parse_args(argv)

    backend = RecordedBackend(ns.replay, loop=True)
    polls = ns.polls or len(backend)
    window = ns.window_s or polls * ns.interval_s + 1.0

    # Simulated clocks: the replay runs at memory speed but history sees
    # evenly spaced poll timestamps, so rates/windows mean what they say.
    sim = {"t": 0.0}
    base_wall = 1_700_000_000.0
    history = HistoryStore(
        capacity=max(2, min(polls + 1, 4096)),
        retention_s=0.0,  # forensics replay: never age anything out
        clock=lambda: sim["t"],
        wallclock=lambda: base_wall + sim["t"],
    )
    collector = Collector(
        backend, FakeAttribution(), SnapshotStore(), history=history,
        clock=lambda: sim["t"], wallclock=lambda: base_wall + sim["t"],
    )
    for i in range(polls):
        sim["t"] = i * ns.interval_s
        collector.poll_once()

    st = history.stats()
    print(f"replayed {polls} polls from {ns.replay}")
    print(f"history: {st['series']} series, {st['samples']} samples, "
          f"~{st['memory_bytes'] / 1024:.0f} KiB, evicted={st['evicted']}")
    metrics = sorted({s["metric"] for s in history.series_list()})
    if not metrics:
        print("no tracked series in this trace")
        return 0
    for metric in metrics:
        print(f"\n{metric} (window={window:g}s):")
        for row in history.window_stats(metric, window_s=window,
                                        now_mono=sim["t"] + 1e-9):
            s = row["stats"]
            ident = ",".join(
                f"{k}={v}" for k, v in sorted(row["labels"].items()) if v
            )
            rate = "" if s["rate"] is None else f" rate={s['rate']:.1f}/s"
            print(f"  {{{ident}}} n={s['samples']} min={s['min']:g} "
                  f"max={s['max']:g} mean={s['mean']:g} last={s['last']:g}"
                  f"{rate}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
