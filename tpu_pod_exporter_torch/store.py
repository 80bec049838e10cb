"""Fleet TSDB-lite — durable, queryable fleet history at the root.

Every history layer so far dies with its process or its node: the node
rings vanish when a host is drained, the leaf tier holds no
history at all, and the root's federated ``/api/v1`` can only
fan out to whatever is *currently* alive — which means fleet-wide history
**ends** exactly when incident forensics need it most: when a node dies,
a leaf reshards, or the root itself restarts. The common incident path
("what did the fleet look like over the last N hours/days?") therefore
still needs an external Prometheus.

:class:`FleetStore` closes that gap by turning the aggregation tree into a
self-contained small TSDB. After each root merge round it appends the
merged rollups plus the per-target series (``STORE_TRACKED_METRICS`` —
the same "what is the fleet doing" set the remote-write egress ships)
into **multi-resolution downsample tiers**: the wall-bucketed
:class:`~tpu_pod_exporter_torch.history.TierRing` machinery generalized to be
disk-backed. Each tier persists its finalized buckets through its own
:class:`~tpu_pod_exporter_torch.persist.WalBuffer` segment directory (CRC
framing, torn-write-tolerant clean-prefix replay, cursor-advance trim —
the exact machinery the egress send buffer proved), so retention is
measured in **days** (``--store-tiers``, default 4 h at 1 min plus 7 days
at 10 min) and survives root restarts, leaf death, and resharding:

- a restart replays every tier's pending records back into its rings,
  re-opens the newest bucket as the live accumulator (post-restart samples
  of the same wall bucket MERGE exactly — every accumulator field rides
  the record) and resumes counter-delta tracking from the restored last
  value, so rates stay continuous across the boundary;
- replay is idempotent: a re-finalized bucket's record REPLACES its
  pre-crash twin (``TierRing.push``), never duplicates it.

**Recording rules** (``--store-rules``): a small declarative file of
per-slice/per-workload aggregates — ``name = agg(metric{match}) by
(labels)`` — evaluated each round against the root's published snapshot
and appended as their own stored series, so dashboard queries hit
precomputed rollups instead of fan-outs.

**Serving**: :class:`StoreQueryPlane` wraps the root's live two-level
query plane and serves the same ``/api/v1/query_range|window_stats|
series`` shapes with a ``source: live|store|merged`` field — the store
fills where the live fan-out has no coverage (dead nodes, pre-restart
windows, rule series), and ``?source=store`` answers from the store
alone. Every row carries its own ``source`` so attribution is honest
per series, not per envelope.

**Pressure integration** (``tpu_pod_exporter_torch.pressure``): the disk ladder
gains a ``store_thin`` rung — the store drops its FINEST tier first
(coarse tiers last: they are the cheapest bytes per second of answerable
history), counted as ``reason="shed"`` — and the store's in-memory tier
bytes register with the memory ladder's component accounting.

``python -m tpu_pod_exporter_torch.store --demo`` (``make store-demo``) drills
both acceptance gates: a 7-day synthetic-retention run at 1000 targets on
a compressed timescale inside a governor-enforced disk budget (the ladder
must exercise ``store_thin`` and the 7-day span must survive it), and a
query-latency comparison proving a stored-rollup query beats the cold
two-level fan-out at 200 real-HTTP targets.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Iterable, Mapping, Sequence

from tpu_pod_exporter_torch.fleet import (
    data_shape as _data_shape,
    rows_of as _rows_of,
)
from tpu_pod_exporter_torch.history import (
    TierRing,
    align_grid,
    fold_tier_window,
    is_counter_metric,
    parse_tier_spec,
    tier_items,
)
from tpu_pod_exporter_torch.metrics import schema
from tpu_pod_exporter_torch.persist import WalBuffer, atomic_write
from tpu_pod_exporter_torch.utils import RateLimitedLogger

if TYPE_CHECKING:  # typing only — no runtime import cost
    from tpu_pod_exporter_torch.metrics.registry import Snapshot, SnapshotBuilder

log = logging.getLogger("tpu_pod_exporter_torch.store")

# What the root folds into the store each round: the merged rollups + the
# per-target series — the same "what is the fleet doing" set the egress
# ships to an external TSDB, plus per-leaf liveness (the first question of
# any incident timeline is "which leaves were up at T?").
STORE_TRACKED_METRICS: frozenset[str] = frozenset(
    spec.name for spec in schema.AGGREGATE_EGRESS_SPECS
) | {schema.TPU_ROOT_LEAF_UP.name}

# Default tiers: 4 h at 1-minute buckets for the incident close-up, 7 days
# at 10-minute buckets for the forensics horizon (600 × 1008 = exactly
# 7 d). Memory per series ≈ (240 + 1008) × 88 B ≈ 107 KiB, hard-bounded by
# max_series; disk per tier ≈ one WAL record per bucket boundary.
DEFAULT_STORE_TIERS = "60:240,600:1008"

SIDECAR_NAME = "store-status.json"

# Per retained bucket: 11 float64 cells (see history._TIER_BUCKET_BYTES).
_BUCKET_BYTES = 11 * 8
# Rough per-series bookkeeping (labels dict, key tuple, slots).
_SERIES_OVERHEAD_BYTES = 512

_SPEC_BY_NAME = {
    spec.name: spec
    for group in (schema.ALL_SPECS, schema.AGGREGATE_SPECS,
                  schema.LEAF_SPECS, schema.ROOT_SPECS)
    for spec in group
}

# Extra records a tier buffer may hold past its ring capacity before the
# retention trim advances the cursor (slack absorbs re-finalization
# records without trimming every round).
_RETENTION_SLACK_RECORDS = 16


# ------------------------------------------------------------ recording rules


RULE_AGGS: tuple[str, ...] = ("sum", "avg", "min", "max", "count")

_RULE_RE = re.compile(
    r"^(?P<name>[A-Za-z_][A-Za-z0-9_:]*)\s*=\s*"
    r"(?P<agg>[a-z]+)\s*\(\s*(?P<metric>[A-Za-z_][A-Za-z0-9_]*)\s*"
    r"(?P<match>\{[^}]*\})?\s*\)\s*"
    r"(?:by\s*\(\s*(?P<by>[^)]*)\)\s*)?$"
)
_MATCHER_RE = re.compile(
    r"""^\s*(?P<label>[A-Za-z_][A-Za-z0-9_]*)\s*=\s*"(?P<value>[^"]*)"\s*$"""
)


@dataclass(frozen=True)
class RecordingRule:
    """One parsed rule: ``name = agg(metric{label="v"}) by (l1, l2)``.
    Evaluated per root round over the published snapshot; the output lands
    in the store as metric ``name`` labeled by the ``by`` labels."""

    name: str
    agg: str
    metric: str
    by: tuple[str, ...]
    match: tuple[tuple[str, str], ...]
    line_no: int


def _rule_err(line_no: int, line: str, msg: str) -> ValueError:
    return ValueError(f"store rule line {line_no} ({line!r}): {msg}")


def parse_rules(text: str) -> tuple[RecordingRule, ...]:
    """Parse a rule file body; raises ValueError naming the offending line
    and what would be accepted — a typo'd rule file must fail at startup,
    never silently store nothing (the parse_chaos_spec contract)."""
    rules: list[RecordingRule] = []
    seen: dict[str, int] = {}
    for line_no, raw in enumerate(text.splitlines(), start=1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        m = _RULE_RE.match(line)
        if m is None:
            raise _rule_err(
                line_no, raw.strip(),
                'want name = agg(metric[{label="value", ...}]) '
                "[by (label, ...)] with agg one of " + "/".join(RULE_AGGS),
            )
        name = m.group("name")
        agg = m.group("agg")
        metric = m.group("metric")
        if agg not in RULE_AGGS:
            raise _rule_err(line_no, raw.strip(),
                            f"unknown aggregation {agg!r} "
                            f"(want one of {'/'.join(RULE_AGGS)})")
        if name in _SPEC_BY_NAME:
            raise _rule_err(line_no, raw.strip(),
                            f"rule name {name!r} shadows a schema-registered "
                            f"metric; pick a distinct name "
                            f"(convention: level:metric:operation)")
        if name in seen:
            raise _rule_err(line_no, raw.strip(),
                            f"duplicate rule name {name!r} "
                            f"(first defined on line {seen[name]})")
        spec = _SPEC_BY_NAME.get(metric)
        if spec is None:
            raise _rule_err(line_no, raw.strip(),
                            f"unknown metric {metric!r}: rules evaluate over "
                            f"the root's published families "
                            f"(schema-registered names)")
        by: list[str] = []
        if m.group("by") is not None:
            for part in m.group("by").split(","):
                lbl = part.strip()
                if not lbl:
                    continue
                if lbl not in spec.label_names:
                    raise _rule_err(
                        line_no, raw.strip(),
                        f"by-label {lbl!r} is not a label of {metric} "
                        f"(has: {', '.join(spec.label_names) or 'none'})")
                by.append(lbl)
        matchers: list[tuple[str, str]] = []
        if m.group("match"):
            inner = m.group("match")[1:-1].strip()
            if inner:
                for part in inner.split(","):
                    mm = _MATCHER_RE.match(part)
                    if mm is None:
                        raise _rule_err(
                            line_no, raw.strip(),
                            f'bad matcher {part.strip()!r}: want '
                            f'label="value"')
                    lbl = mm.group("label")
                    if lbl not in spec.label_names:
                        raise _rule_err(
                            line_no, raw.strip(),
                            f"matcher label {lbl!r} is not a label of "
                            f"{metric} "
                            f"(has: {', '.join(spec.label_names) or 'none'})")
                    matchers.append((lbl, mm.group("value")))
        seen[name] = line_no
        rules.append(RecordingRule(
            name=name, agg=agg, metric=metric,
            by=tuple(by), match=tuple(matchers), line_no=line_no,
        ))
    return tuple(rules)


def load_rules_file(path: str) -> tuple[RecordingRule, ...]:
    """Read + parse a rule file; OSError/ValueError propagate (a missing
    or malformed rule file is a startup error, not a silent no-op)."""
    with open(path, encoding="utf-8") as f:
        return parse_rules(f.read())


def evaluate_rule(
    rule: RecordingRule, snapshot: "Snapshot"
) -> list[tuple[dict[str, str], float]]:
    """One rule against one published snapshot → ``[(labels, value), …]``
    grouped by the rule's ``by`` labels (one unlabeled output when ``by``
    is empty). Absent families produce no output (not an error: a fleet
    with no DCN simply has no DCN rollups)."""
    spec = _SPEC_BY_NAME[rule.metric]
    view = snapshot.samples_view(rule.metric)
    if not view:
        return []
    label_names = spec.label_names
    idx_of = {ln: i for i, ln in enumerate(label_names)}
    match_idx = [(idx_of[lbl], val) for lbl, val in rule.match]
    by_idx = [idx_of[lbl] for lbl in rule.by]
    groups: dict[tuple[str, ...], list[float]] = {}
    for lvs, value in view.items():
        if any(lvs[i] != val for i, val in match_idx):
            continue
        groups.setdefault(tuple(lvs[i] for i in by_idx), []).append(value)
    out: list[tuple[dict[str, str], float]] = []
    for gkey, values in groups.items():
        if rule.agg == "sum":
            v = sum(values)
        elif rule.agg == "avg":
            v = sum(values) / len(values)
        elif rule.agg == "min":
            v = min(values)
        elif rule.agg == "max":
            v = max(values)
        else:  # count
            v = float(len(values))
        out.append((dict(zip(rule.by, gkey)), v))
    return out


# ----------------------------------------------------------------- the store


class _StoreSeries:
    """One stored series: identity plus its per-tier downsample rings.
    No raw ring — the store's inputs are already once-per-round merged
    samples; the finest tier IS the raw resolution it keeps."""

    __slots__ = ("name", "labels", "tiers", "pv", "last_wall")

    def __init__(self, name: str, labels: dict[str, str],
                 tier_spec: Sequence[tuple[float, int]]) -> None:
        self.name = name
        self.labels = labels
        self.tiers = tuple(TierRing(step, cap) for step, cap in tier_spec)
        self.pv = float("nan")
        self.last_wall = 0.0


class FleetStore:
    """Durable multi-tier downsample store for the root's merged series.

    Thread contract: ``append_snapshot``/``append_samples`` are called by
    ONE thread (the root's round loop); queries come from HTTP handler
    threads and copy ring contents out under the store lock (the
    HistoryStore discipline — per-bucket Python tuples are built outside
    it). ``set_thin`` may be called from the pressure governor's thread:
    ring state flips under the store lock, and the tier buffer's cursor
    trim uses the WalBuffer consumer side, which is concurrency-safe
    against the appender by the same contract the egress sender relies on.

    Timestamps: tier rings are wall-bucketed and the store feeds the wall
    time into BOTH ring time axes — monotonic time is meaningless across
    the restarts this store exists to survive."""

    def __init__(
        self,
        path: str,
        tiers: str | Sequence[tuple[float, int]] = DEFAULT_STORE_TIERS,
        rules: Sequence[RecordingRule] = (),
        max_series: int = 8192,
        tracked: frozenset[str] = STORE_TRACKED_METRICS,
        segment_max_bytes: int = 4 << 20,
        fsync: bool = False,
        wallclock: Callable[[], float] = time.time,
        sidecar_interval_s: float = 30.0,
    ) -> None:
        spec = (parse_tier_spec(tiers) if isinstance(tiers, str)
                else tuple(sorted(tiers)))
        if not spec:
            raise ValueError("the fleet store needs at least one tier "
                             "(--store-tiers cannot be 'off')")
        self.dir = path
        self.tier_spec = spec
        self.rules = tuple(rules)
        self.max_series = max_series
        self._tracked = tuple(sorted(tracked))
        self._segment_max_bytes = segment_max_bytes
        self._fsync = fsync
        self._wallclock = wallclock
        self._sidecar_interval_s = sidecar_interval_s
        self._rlog = RateLimitedLogger(log)
        self._lock = threading.Lock()
        self._series: dict[tuple, _StoreSeries] = {}
        self._buffers: tuple[WalBuffer, ...] = ()
        self._thinned = False
        self._samples_total = 0
        self._append_failures = 0
        self._dropped = {"shed": 0, "retention": 0, "corrupt": 0}
        self._rules_evaluated = 0
        self._rule_failures = 0
        # Last DURABLE round (every WAL frame landed) — the published
        # last-append timestamp and the AppendFailing alert's age arm.
        self._last_append_wall = 0.0
        # Last ingestion wall (in-memory fold) — the backward-step fence.
        self._last_ingest_wall = 0.0
        # Armed by set_thin: the shed tier's pending WAL records are
        # dropped by the APPENDER thread on its next pass — WalBuffer has
        # exactly one cursor-mover (the egress sender-thread lesson); a
        # governor-thread drop racing the appender's retention trim could
        # regress the on-disk cursor and resurrect shed records at boot.
        self._thin_drop_pending = False
        self._last_sidecar_wall = 0.0
        self._restored_buckets = 0
        # (tiers, span, occupancy generation) — see _occupancy_locked.
        # The generation bumps once per append BATCH / thin flip /
        # replay, so the scan runs at most once per round however many
        # queries land between rounds, and is never stale after a
        # mutation (a wall-time TTL would serve a pre-thin view).
        self._occ_cache: tuple[list[dict], float, int] | None = None
        self._occ_gen = 0
        # Budget hint for the sidecar/footer (the governor owns the actual
        # enforcement; mirroring it here keeps `status` honest about what
        # the disk number is measured AGAINST).
        self.disk_budget_bytes = 0
        # ENOSPC hook (pressure.PressureGovernor.report_io_error).
        self._pressure_hook: Callable[[BaseException], bool] | None = None

    # ------------------------------------------------------------------ boot

    def _tier_dir(self, step: float) -> str:
        return os.path.join(self.dir, f"tier-{step:g}")

    def open(self) -> dict:
        """Create the directory tree, open every tier's WAL buffer, and
        replay pending records back into the rings. Corruption keeps the
        clean prefix (WalBuffer semantics) and is counted, never raised;
        only an uncreatable directory raises OSError."""
        os.makedirs(self.dir, exist_ok=True)
        buffers: list[WalBuffer] = []
        errors: list[str] = []
        for step, _cap in self.tier_spec:
            buf = WalBuffer(self._tier_dir(step),
                            segment_max_bytes=self._segment_max_bytes,
                            fsync=self._fsync)
            info = buf.open()
            if info["corrupt_segments"]:
                self._dropped["corrupt"] += info["corrupt_segments"]
            errors.extend(info["errors"])
            buffers.append(buf)
        self._buffers = tuple(buffers)
        restored = 0
        with self._lock:
            for ti, buf in enumerate(self._buffers):
                step = self.tier_spec[ti][0]
                for payload in buf.iter_payloads():  # lint: disable=lock-io-chain(boot replay: open() runs before the round thread or HTTP queries exist, and holding the store lock keeps the restore atomic against an early query; no contention is possible here)
                    restored += self._replay_record_locked(ti, step, payload)
            # Re-open every series' newest restored bucket as the live
            # accumulator and resume counter-delta tracking from its last
            # value — post-restart samples merge instead of forking, and
            # window rates stay continuous across the boundary.
            for s in self._series.values():
                for t in s.tiers:
                    t.pop_to_accumulator()
                for t in s.tiers:
                    if t.bucket >= 0 and t.a_cnt > 0:
                        s.pv = t.a_last
                        s.last_wall = max(s.last_wall, t.a_twl)
                        break
        self._restored_buckets = restored
        self._occ_gen += 1
        return {
            "series": len(self._series),
            "buckets": restored,
            "corrupt_records": self._dropped["corrupt"],
            "errors": errors,
        }

    def _replay_record_locked(self, tier_idx: int, step: float,
                              payload: bytes) -> int:
        try:
            doc = json.loads(payload)
            rows = doc["rows"]
            if not isinstance(rows, list):
                raise TypeError("rows is not a list")
        except (ValueError, KeyError, TypeError):
            self._dropped["corrupt"] += 1
            return 0
        restored = 0
        for row in rows:
            try:
                name, labels, bucket = row
                if not (isinstance(name, str) and isinstance(labels, dict)
                        and isinstance(bucket, list) and len(bucket) == 11):
                    raise TypeError("bad row shape")
                b = tuple(float(x) for x in bucket)
            except (ValueError, TypeError):
                self._dropped["corrupt"] += 1
                continue
            lbl = {str(k): str(v) for k, v in labels.items()}
            key = series_key(name, lbl)
            s = self._series.get(key)
            if s is None:
                s = self._create_locked(key, name, lbl)
            s.tiers[tier_idx].push(b)
            s.last_wall = max(s.last_wall, b[3])
            restored += 1
        return restored

    # ---------------------------------------------------------------- append

    def _create_locked(self, key: tuple, name: str,
                       labels: dict[str, str]) -> _StoreSeries:
        while len(self._series) >= self.max_series:
            victim = min(self._series,
                         key=lambda k: self._series[k].last_wall)
            del self._series[victim]
        s = self._series[key] = _StoreSeries(name, labels, self.tier_spec)
        return s

    def _enabled(self, tier_idx: int) -> bool:
        # store_thin sheds the FINEST tier (index 0); coarse tiers are the
        # cheapest bytes per second of answerable history and shed never.
        return not (self._thinned and tier_idx == 0 and len(self.tier_spec) > 1)

    def _append_one_locked(
        self, s: _StoreSeries, value: float, now_wall: float,
        finalized: list[list[tuple[dict[str, str], str, tuple]]],
    ) -> None:
        d = value - s.pv
        dpos = d if d > 0.0 else 0.0
        s.pv = value
        s.last_wall = now_wall
        for i, t in enumerate(s.tiers):
            if not self._enabled(i):
                continue
            if t.bucket >= 0 and int(now_wall // t.step) != t.bucket:
                ob = t.open_bucket()
                if ob is not None:
                    finalized[i].append((s.labels, s.name, ob))
            t.add(now_wall, now_wall, value, dpos)

    def _fence_wall_locked(self, now_wall: float) -> float:
        """Backward-clock-step fence (the egress discipline, applied
        to this new wall-time consumer): bucket ids must stay monotone —
        TierRing.push's replace-only-newest replay dedup and align_grid's
        forward walk both require time-ordered buckets. A backward NTP
        step therefore clamps ingestion time to the last append's wall
        (samples keep folding into the current bucket until the clock
        catches back up); forward steps pass through untouched."""
        return max(now_wall, self._last_ingest_wall)

    def append_snapshot(self, snapshot: "Snapshot",
                        now_wall: float | None = None) -> int:
        """Fold one root round into the tiers: every tracked family of the
        published snapshot plus the recording-rule outputs evaluated over
        the same snapshot. Returns the number of samples appended. Ring
        mutation happens under the store lock; WAL framing and file I/O
        happen OUTSIDE it (single-appender contract)."""
        now = self._wallclock() if now_wall is None else now_wall
        rule_rows: list[tuple[str, dict[str, str], float]] = []
        for rule in self.rules:
            try:
                for labels, value in evaluate_rule(rule, snapshot):
                    rule_rows.append((rule.name, labels, value))
                self._rules_evaluated += 1
            except Exception as e:  # noqa: BLE001 — one bad rule must not stop the round
                self._rule_failures += 1
                self._rlog.warning(f"rule:{rule.name}",
                                   "store rule %s failed: %s", rule.name, e)
        appended = 0
        finalized: list[list[tuple[dict[str, str], str, tuple]]] = [
            [] for _ in self.tier_spec
        ]
        with self._lock:
            now = self._fence_wall_locked(now)
            for name in self._tracked:
                spec = _SPEC_BY_NAME.get(name)
                if spec is None:
                    continue
                view = snapshot.samples_view(name)
                if not view:
                    continue
                label_names = spec.label_names
                for lvs, value in view.items():
                    key = (name, lvs)
                    s = self._series.get(key)
                    if s is None:
                        s = self._create_locked(
                            key, name, dict(zip(label_names, lvs)))
                    self._append_one_locked(s, float(value), now, finalized)
                    appended += 1
            for rname, labels, value in rule_rows:
                key = series_key(rname, labels)
                s = self._series.get(key)
                if s is None:
                    s = self._create_locked(key, rname, dict(labels))
                self._append_one_locked(s, value, now, finalized)
                appended += 1
            self._samples_total += appended
            self._last_ingest_wall = now
            self._occ_gen += 1
        self._persist_finalized(finalized, now)
        self._maybe_write_sidecar(now)
        return appended

    def append_samples(
        self,
        samples: Iterable[tuple[str, Mapping[str, str], float]],
        now_wall: float | None = None,
    ) -> int:
        """Labeled-sample entry point (tests, harnesses): ``(metric,
        labels, value)`` triples, one wall instant. Same locking split as
        :meth:`append_snapshot`."""
        now = self._wallclock() if now_wall is None else now_wall
        appended = 0
        finalized: list[list[tuple[dict[str, str], str, tuple]]] = [
            [] for _ in self.tier_spec
        ]
        with self._lock:
            now = self._fence_wall_locked(now)
            for name, labels, value in samples:
                key = series_key(name, labels)
                s = self._series.get(key)
                if s is None:
                    s = self._create_locked(key, name, dict(labels))
                self._append_one_locked(s, float(value), now, finalized)
                appended += 1
            self._samples_total += appended
            self._last_ingest_wall = now
            self._occ_gen += 1
        self._persist_finalized(finalized, now)
        self._maybe_write_sidecar(now)
        return appended

    def _persist_finalized(
        self, finalized: list[list[tuple[dict[str, str], str, tuple]]],
        now_wall: float,
    ) -> None:
        """Frame one WAL record per tier carrying every bucket finalized
        this append, then trim each buffer to its tier's own retention.
        Runs on the appender thread, outside the store lock — including
        the deferred store_thin drop: this thread is each buffer's ONE
        cursor-mover (append + retention trim + shed), so the cursor can
        never regress under a racing writer."""
        with self._lock:
            thin_drop = self._thin_drop_pending
            self._thin_drop_pending = False
        if thin_drop and self._buffers:
            buf0 = self._buffers[0]
            n = buf0.drop_oldest(buf0.pending())
            if n:
                with self._lock:
                    self._dropped["shed"] += n
                log.warning("store_thin: shed %d pending WAL record(s) of "
                            "the %gs tier", n, self.tier_spec[0][0])
        ok = True
        for ti, rows in enumerate(finalized):
            if not rows:
                continue
            step, cap = self.tier_spec[ti]
            payload = json.dumps(
                {"t": step,
                 "rows": [[name, labels, list(bucket)]
                          for labels, name, bucket in rows]},
                separators=(",", ":"),
            ).encode()
            buf = self._buffers[ti]
            try:
                buf.append(payload)
            except OSError as e:
                ok = False
                with self._lock:
                    self._append_failures += 1
                hook = self._pressure_hook
                if hook is not None:
                    try:
                        hook(e)
                    except Exception:  # noqa: BLE001 — a broken hook must not fail appends
                        pass
                self._rlog.warning(
                    f"append:{step:g}",
                    "store tier %gs WAL append failed (%s); tiers keep "
                    "serving, durability of this round's buckets is lost",
                    step, e,
                )
                continue
            # Retention: the buffer only needs to replay what the ring can
            # hold — records per tier ≈ one per bucket boundary, so the
            # cap (plus re-finalization slack) IS the retention horizon.
            excess = buf.pending() - (cap + _RETENTION_SLACK_RECORDS)
            if excess > 0:
                n = buf.drop_oldest(excess)
                if n:
                    with self._lock:
                        self._dropped["retention"] += n
        if ok and now_wall > 0:
            # Advances ONLY on fully-durable rounds: a store whose disk
            # refuses writes must age this stamp (the AppendFailing
            # alert's age arm and the footer read it), not report fresh
            # in-memory folds as durable history.
            with self._lock:
                self._last_append_wall = max(self._last_append_wall,
                                             now_wall)

    def set_pressure_hook(
        self, hook: Callable[[BaseException], bool]
    ) -> None:
        """Wire the governor's ``report_io_error`` so a store-side ENOSPC
        arms the disk ladder's fault window immediately."""
        self._pressure_hook = hook

    # ------------------------------------------------- pressure shed hooks

    def set_thin(self, thin: bool) -> None:
        """The disk ladder's ``store_thin`` rung: drop the FINEST tier —
        its rings empty, its WAL records are shed (counted, never silent)
        and appends to it stop — while every coarser tier keeps ingesting
        and answering. Reversible: release re-enables the tier, which
        refills from live appends. A single-tier store refuses (coarse
        tiers shed LAST means the last tier never sheds)."""
        if len(self.tier_spec) < 2:
            if thin:
                self._rlog.warning(
                    "thin", "store_thin requested but only one tier is "
                    "configured — refusing to drop the store's only tier")
            return
        buckets = 0
        with self._lock:
            if thin == self._thinned:
                return
            self._thinned = thin
            self._occ_gen += 1
            if thin:
                for s in self._series.values():
                    t = s.tiers[0]
                    buckets += t.n + (1 if t.bucket >= 0 and t.a_cnt else 0)
                    t.n = 0
                    t.head = 0
                    t.bucket = -1
                    t.a_cnt = 0
                # The tier's pending WAL records are shed by the APPENDER
                # on its next pass — this method may run on the governor
                # thread, and a buffer must have exactly one cursor-mover
                # (see _persist_finalized).
                self._thin_drop_pending = True
            else:
                # A release before the drop executed cancels it: the
                # records' replay would simply restore coverage into the
                # re-enabled tier.
                self._thin_drop_pending = False
        if thin:
            log.warning(
                "disk pressure: store_thin shed the %gs tier (%d buckets; "
                "its WAL records drop on the next round) — coarser tiers "
                "keep the long windows",
                self.tier_spec[0][0], buckets,
            )
        else:
            log.info("disk pressure lifted: store %gs tier re-enabled "
                     "(refills from live rounds)", self.tier_spec[0][0])

    def memory_bytes(self) -> int:
        """In-memory tier-ring bytes — registered with the memory ladder;
        the shed decision and the published gauge read this same number.
        Counts EVERY tier, thinned or not: TierRing preallocates its
        arrays at full capacity and ``store_thin`` only resets counters
        (it frees DISK, not ring memory) — excluding the thinned tier
        would feed the memory ladder phantom headroom and let it skip
        shedding components that actually would free bytes."""
        with self._lock:
            per_series = _SERIES_OVERHEAD_BYTES + sum(
                cap * _BUCKET_BYTES for _step, cap in self.tier_spec
            )
            return len(self._series) * per_series

    def disk_bytes(self) -> int:
        """Pending WAL bytes across tier buffers (cheap: in-memory
        counters, no directory walk — safe from the round thread)."""
        return sum(buf.pending_bytes() for buf in self._buffers)

    def disk_paths(self) -> list[str]:
        """Directories the disk ladder should budget over: the store root
        (sidecar) plus every per-tier segment dir — dir_usage_bytes is
        non-recursive by design, so each tier dir registers itself."""
        return [self.dir] + [self._tier_dir(step)
                             for step, _cap in self.tier_spec]

    # ----------------------------------------------------------------- query

    @staticmethod
    def _matches(labels: dict[str, str], match: Mapping[str, str]) -> bool:
        return all(labels.get(k) == v for k, v in match.items())

    def _choose_tier(self, s: _StoreSeries, step: float,
                     start: float) -> int | None:
        """Tier selection: the COARSEST enabled tier whose resolution
        satisfies the requested step (the finest enabled one when step is
        0 or finer than everything), escalating to a coarser tier when the
        choice no longer covers ``start`` — the HistoryStore rules, minus
        the raw ring the store deliberately does not have.

        Coverage reads ``first_wall()`` (the occupancy read: the oldest
        bucket actually retained), NOT ``oldest_wall()``: that method's
        not-wrapped-means-holds-everything convention is FALSE here — a
        just-released ``store_thin`` tier refills from empty and must not
        claim infinite coverage while the coarse tier still holds the
        days-long span (a long-range query would silently answer minutes
        of post-release data)."""
        enabled = [i for i in range(len(s.tiers)) if self._enabled(i)]
        if not enabled:
            return None
        choice = enabled[0]
        if step > 0:
            for i in enabled:
                if s.tiers[i].step <= step:
                    choice = i
        if s.tiers[choice].first_wall() <= start:
            return choice
        best, best_first = choice, s.tiers[choice].first_wall()
        for i in enabled:
            if i <= choice:
                continue
            fw = s.tiers[i].first_wall()
            if fw <= start:
                return i
            if fw < best_first:
                best, best_first = i, fw
        return best

    def _query_rows(self, metric: str, match: Mapping[str, str],
                    step: float, start: float) -> list[tuple]:
        with self._lock:
            rows: list[tuple] = []
            for s in self._series.values():
                if s.name != metric or not self._matches(s.labels, match):
                    continue
                idx = self._choose_tier(s, step, start)
                if idx is None:
                    continue
                t = s.tiers[idx]
                rows.append((dict(s.labels), t.step, t.copy(),
                             s.last_wall or None))
            return rows

    def query_range(
        self,
        metric: str,
        match: Mapping[str, str] | None = None,
        start: float | None = None,
        end: float | None = None,
        step: float = 0.0,
        agg: str = "last",
    ) -> list[dict]:
        """Node-shape ``query_range`` rows served from the tiers, each
        carrying ``source: "store"`` plus the usual ``tier`` and
        ``last_sample_wall_ts``. ``step == 0`` returns the finalized
        bucket samples themselves (at their last-sample wall time) —
        the honest continuity view, no grid carry-forward."""
        if end is None:
            end = self._wallclock()
        if start is None:
            start = end - 300.0
        out: list[dict] = []
        for labels, tier_step, payload, last_wall in self._query_rows(
            metric, match or {}, step, start
        ):
            buckets = tier_items(payload)
            points = [
                (b[3], _bucket_value(b, agg)) for b in buckets
            ]
            if step > 0:
                lookback = max(2.0 * step, 2.0 * tier_step, 10.0)
                values = align_grid(points, start, end, step, lookback)
            else:
                values = [[tw, v] for (tw, v) in points
                          if start <= tw <= end]
            if values:
                out.append({
                    "metric": metric, "labels": labels,
                    "values": values, "tier": tier_step,
                    "last_sample_wall_ts": last_wall,
                    "source": "store",
                })
        return out

    def window_stats(
        self,
        metric: str,
        match: Mapping[str, str] | None = None,
        window_s: float = 60.0,
        now_wall: float | None = None,
    ) -> list[dict]:
        """Trailing-window stats folded exactly from tier buckets
        (history.fold_tier_window — weighted mean, reset-tolerant counter
        rate from within-bucket dpos + rebuilt boundary deltas)."""
        now = self._wallclock() if now_wall is None else now_wall
        lo = now - window_s
        counter = is_counter_metric(metric)
        out: list[dict] = []
        for labels, tier_step, payload, last_wall in self._query_rows(
            metric, match or {}, 0.0, lo
        ):
            buckets = [b for b in tier_items(payload) if b[1] >= lo]
            if not buckets:
                continue
            out.append({
                "metric": metric, "labels": labels,
                "stats": fold_tier_window(buckets, counter),
                "tier": tier_step,
                "last_sample_wall_ts": last_wall,
                "source": "store",
            })
        return out

    def series_list(self) -> list[dict]:
        with self._lock:
            out = []
            for s in self._series.values():
                buckets = 0
                for i, t in enumerate(s.tiers):
                    if self._enabled(i):
                        buckets += t.n + (1 if t.bucket >= 0 and t.a_cnt
                                          else 0)
                out.append({
                    "metric": s.name, "labels": dict(s.labels),
                    "samples": buckets, "source": "store",
                })
            return out

    # ---------------------------------------------------------- introspection

    # Tier occupancy is a full series × tiers scan under the store lock;
    # it backs both the per-round emit AND the per-query envelope
    # summary, so it is amortized generation-keyed (the HistoryStore
    # tier-stats discipline, minus the staleness: a mutation bumps the
    # generation, so readers never see a pre-thin or pre-append view
    # twice the scan just runs at most once per mutation).

    def _occupancy_locked(self) -> tuple[list[dict], float]:
        cached = self._occ_cache
        if cached is not None and cached[2] == self._occ_gen:
            return cached[0], cached[1]
        tiers: list[dict] = []
        span = 0.0
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
            tspan = max(newest - oldest, 0.0) if buckets else 0.0
            span = max(span, tspan)
            tiers.append({
                "step_s": step, "capacity": cap, "buckets": buckets,
                "span_s": tspan, "enabled": self._enabled(i),
            })
        self._occ_cache = (tiers, span, self._occ_gen)
        return tiers, span

    def summary(self) -> dict:
        """The 4-field envelope summary (StoreQueryPlane) — O(1) between
        occupancy refreshes."""
        with self._lock:
            tiers, span = self._occupancy_locked()
            return {
                "span_s": span,
                "series": len(self._series),
                "thinned": self._thinned,
                "rules": len(self.rules),
            }

    def stats(self) -> dict:
        with self._lock:
            tiers, span = self._occupancy_locked()
            doc = {
                "dir": self.dir,
                "series": len(self._series),
                "samples_appended": self._samples_total,
                "append_failures": self._append_failures,
                "dropped": dict(self._dropped),
                "restored_buckets": self._restored_buckets,
                "rules": len(self.rules),
                "rules_evaluated_total": self._rules_evaluated,
                "rule_failures": self._rule_failures,
                "last_append_wall": self._last_append_wall,
                "thinned": self._thinned,
                "span_s": span,
                "tiers": tiers,
                "disk_budget_bytes": self.disk_budget_bytes,
            }
        doc["disk_bytes"] = self.disk_bytes()
        doc["memory_bytes"] = self.memory_bytes()
        return doc

    def emit(self, b: "SnapshotBuilder") -> None:
        """Publish the ``tpu_root_store_*`` surface into one root snapshot
        (conditional surface — present only while a store is attached)."""
        st = self.stats()
        for spec in schema.STORE_SPECS:
            b.declare(spec)
        b.add(schema.TPU_ROOT_STORE_APPENDED_SAMPLES_TOTAL,
              float(st["samples_appended"]))
        b.add(schema.TPU_ROOT_STORE_APPEND_FAILURES_TOTAL,
              float(st["append_failures"]))
        b.add(schema.TPU_ROOT_STORE_SERIES, float(st["series"]))
        for tier in st["tiers"]:
            b.add(schema.TPU_ROOT_STORE_TIER_BUCKETS,
                  float(tier["buckets"]), (f"{tier['step_s']:g}",))
        b.add(schema.TPU_ROOT_STORE_SPAN_SECONDS, float(st["span_s"]))
        b.add(schema.TPU_ROOT_STORE_DISK_BYTES, float(st["disk_bytes"]))
        b.add(schema.TPU_ROOT_STORE_MEMORY_BYTES, float(st["memory_bytes"]))
        for reason in ("shed", "retention", "corrupt"):
            b.add(schema.TPU_ROOT_STORE_DROPPED_RECORDS_TOTAL,
                  float(st["dropped"][reason]), (reason,))
        b.add(schema.TPU_ROOT_STORE_RULES, float(st["rules"]))
        b.add(schema.TPU_ROOT_STORE_RULE_FAILURES_TOTAL,
              float(st["rule_failures"]))
        b.add(schema.TPU_ROOT_STORE_LAST_APPEND_TIMESTAMP_SECONDS,
              float(st["last_append_wall"]))
        b.add(schema.TPU_ROOT_STORE_THINNED,
              1.0 if st["thinned"] else 0.0)

    def _maybe_write_sidecar(self, now_wall: float) -> None:
        if now_wall - self._last_sidecar_wall < self._sidecar_interval_s:
            return
        self.write_sidecar(now_wall)

    def write_sidecar(self, now_wall: float | None = None) -> None:
        """Operator-facing sidecar for the ``status --tree`` store footer.
        Best-effort by design (the pressure sidecar's contract): on a full
        disk the footer shows the last state that fit."""
        now = self._wallclock() if now_wall is None else now_wall
        self._last_sidecar_wall = now
        doc = {"wall": now, **self.stats()}
        try:
            atomic_write(os.path.join(self.dir, SIDECAR_NAME),
                         json.dumps(doc).encode())
        except OSError:
            pass

    def close(self) -> None:
        """Graceful shutdown: the still-open accumulator buckets flush as
        records first, so a clean restart loses NOTHING (replay re-opens
        them via pop_to_accumulator and a later re-finalization record
        replaces, never duplicates). A SIGKILL skips this by definition —
        the documented floor is one open bucket per tier of tail loss."""
        finalized: list[list[tuple[dict[str, str], str, tuple]]] = [
            [] for _ in self.tier_spec
        ]
        with self._lock:
            last_ingest = self._last_ingest_wall
            for s in self._series.values():
                for i, t in enumerate(s.tiers):
                    if not self._enabled(i):
                        continue
                    ob = t.open_bucket()
                    if ob is not None:
                        finalized[i].append((s.labels, s.name, ob))
        self._persist_finalized(finalized, last_ingest)
        self.write_sidecar()
        for buf in self._buffers:
            buf.close()


def series_key(name: str, labels: Mapping[str, str]) -> tuple:
    """The store's series identity. Schema-known metrics key by label
    VALUES in spec order — the exact key ``append_snapshot`` builds from
    ``samples_view`` tuples, so restored and live samples can never fork
    into twins (the restore_series lesson). Rule outputs (not in
    the schema) key by sorted label items."""
    spec = _SPEC_BY_NAME.get(name)
    if spec is not None:
        return (name, tuple(str(labels.get(ln, ""))
                            for ln in spec.label_names))
    return (name, tuple(sorted(labels.items())))


def _bucket_value(b: tuple, agg: str) -> float:
    if agg == "min":
        return b[4]
    if agg == "max":
        return b[5]
    if agg == "mean":
        return b[6] / b[7] if b[7] else b[9]
    return b[9]  # last


def store_status_summary(path: str) -> dict | None:
    """Read the store's on-disk sidecar for the out-of-process ``status
    --tree`` footer (None when absent/unreadable — no store runs here)."""
    try:
        with open(os.path.join(path, SIDECAR_NAME), encoding="utf-8") as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


# --------------------------------------------------------- source-aware plane


SOURCES: tuple[str, ...] = ("merged", "live", "store")


class StoreQueryPlane:
    """Source-aware ``/api/v1`` front: the live two-level fan-out plus the
    store, merged per series. The live fan-out answers for what is
    reachable NOW; the store fills every series key the live merge has no
    coverage for (dead nodes, pre-restart windows, recording-rule series)
    — and ``source=store`` answers from the store alone. Every row
    carries its own ``source`` (live rows are tagged on copies — cached
    envelopes are shared and must never be mutated)."""

    # server.py passes the ?source= parameter only to planes that declare
    # this — the node tier and store-less aggregators 400 it instead.
    handles_source = True

    def __init__(self, live: Any, store: FleetStore,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._live = live
        self._store = store
        self._clock = clock

    # ------------------------------------------------------------- public API

    def series(self, source: str = "merged") -> dict:
        source = self._resolve(source)
        if source == "live":
            return self._tag_live(self._live.series(), "series")
        t0 = self._clock()
        srows = self._store.series_list()
        if source == "store":
            return self._store_env("series", srows, t0)
        env = self._tag_live(self._live.series(), "series")
        live_rows = _rows_of("series", env)
        keys = {_row_key(r) for r in live_rows}
        fills = [r for r in srows if _row_key(r) not in keys]
        return self._merge_env(env, "series", live_rows, fills)

    def query_range(
        self,
        metric: str,
        match: Mapping[str, str] | None = None,
        start: float | None = None,
        end: float | None = None,
        step: float = 0.0,
        agg: str = "last",
        source: str = "merged",
    ) -> dict:
        source = self._resolve(source)
        if source == "live":
            return self._tag_live(
                self._live.query_range(metric, match, start, end, step,
                                       agg=agg),
                "query_range")
        if source == "store":
            t0 = self._clock()
            rows = self._store.query_range(metric, match, start, end, step,
                                           agg=agg)
            return self._store_env("query_range", rows, t0)
        env = self._tag_live(
            self._live.query_range(metric, match, start, end, step, agg=agg),
            "query_range")
        live_rows = _rows_of("query_range", env)
        # The live plane may have grid-aligned start/end; reuse ITS
        # effective range when it says so, so live and store rows share
        # one grid.
        eff_start = env.get("start", start)
        eff_end = env.get("end", end)
        srows = self._store.query_range(
            metric, match,
            eff_start if isinstance(eff_start, (int, float)) else start,
            eff_end if isinstance(eff_end, (int, float)) else end,
            step, agg=agg)
        keys = {_row_key(r) for r in live_rows}
        fills = [r for r in srows if _row_key(r) not in keys]
        return self._merge_env(env, "query_range", live_rows, fills)

    def window_stats(
        self,
        metric: str,
        match: Mapping[str, str] | None = None,
        window_s: float = 60.0,
        source: str = "merged",
    ) -> dict:
        source = self._resolve(source)
        if source == "live":
            return self._tag_live(
                self._live.window_stats(metric, match, window_s=window_s),
                "window_stats")
        if source == "store":
            t0 = self._clock()
            rows = self._store.window_stats(metric, match, window_s=window_s)
            return self._store_env("window_stats", rows, t0)
        env = self._tag_live(
            self._live.window_stats(metric, match, window_s=window_s),
            "window_stats")
        live_rows = _rows_of("window_stats", env)
        srows = self._store.window_stats(metric, match, window_s=window_s)
        keys = {_row_key(r) for r in live_rows}
        fills = [r for r in srows if _row_key(r) not in keys]
        return self._merge_env(env, "window_stats", live_rows, fills)

    # --------------------------------------------------------------- internals

    def _resolve(self, source: str) -> str:
        source = source or "merged"
        if source not in SOURCES:
            raise ValueError(
                f"source must be one of {'/'.join(SOURCES)} (got {source!r})")
        if self._live is None:
            if source == "live":
                raise ValueError(
                    "source=live: no live query plane attached "
                    "(--fleet-query off) — this root serves store only")
            return "store"
        return source

    def _tag_live(self, env: Mapping[str, Any], route: str) -> dict:
        """Top-level copy of a live envelope with every row tagged
        ``source: live`` (row copies — cached envelopes stay pristine)."""
        out = dict(env)
        rows = [{**row, "source": row.get("source", "live")}
                if isinstance(row, dict) else row
                for row in _rows_of(route, env)]
        out["data"] = _data_shape(route, rows)
        out.setdefault("source", "live")
        return out

    def _store_summary(self) -> dict:
        # summary() is O(1) between occupancy refreshes — this runs per
        # query, and a full series × tiers scan per query would contend
        # the store lock against the round thread's append.
        return self._store.summary()

    def _store_env(self, route: str, rows: list[dict], t0: float) -> dict:
        """``t0`` is captured by the caller BEFORE the store query runs —
        took_s must bracket the ring walk, not this dict build."""
        return {
            "status": "ok",
            "partial": False,
            "route": route,
            "data": _data_shape(route, rows),
            "source": "store",
            "store": self._store_summary(),
            "took_s": round(self._clock() - t0, 6),
        }

    def _merge_env(self, env: dict, route: str, live_rows: list,
                   fills: list[dict]) -> dict:
        env["data"] = _data_shape(route, list(live_rows) + fills)
        env["source"] = "merged" if fills else "live"
        env["store"] = {"filled_series": len(fills), **self._store_summary()}
        return env

    def close(self) -> None:
        if self._live is not None:
            self._live.close()


def _row_key(row: Mapping[str, Any]) -> tuple:
    try:
        return (row.get("metric", ""),
                tuple(sorted((row.get("labels") or {}).items())))
    except TypeError:
        return ("", ())


# ---------------------------------------------------------------------- demo


def run_retention_demo(
    state_dir: str,
    targets: int = 1000,
    days: float = 7.0,
    sim_round_s: float = 600.0,
    budget_frac: float = 0.7,
    verbose: bool = True,
) -> int:
    """7-day synthetic retention at fleet scale, compressed to a simulated
    wall clock, inside a governor-enforced disk budget (the acceptance
    drill). Tiers are scaled so the coarsest alone spans the full window:
    mid-run the budget is squeezed below current usage, the disk ladder
    must shed ``store_thin`` (finest tier dropped, counted), usage must
    come back under budget, and the full span must STILL answer from the
    coarse tier — including across a kill/replay restart."""
    from tpu_pod_exporter_torch.metrics import SnapshotBuilder
    from tpu_pod_exporter_torch.pressure import (
        PressureGovernor,
        register_store_rungs,
    )

    total_s = days * 86400.0
    # Finest: ~20 h of 10-min buckets; coarsest: the full window in 1-h
    # buckets — the tier the thin rung must leave standing.
    coarse_cap = int(total_s // 3600.0) + 2
    tiers = f"600:120,3600:{coarse_cap}"
    sim = {"wall": 1_700_000_000.0}
    rules = parse_rules(
        "demo:hbm:by_slice = sum(" + schema.TPU_SLICE_HBM_USED_BYTES.name
        + ") by (slice_name)\n"
        "demo:targets:up = sum(" + schema.TPU_AGG_TARGET_UP.name + ")\n"
    )
    store = FleetStore(state_dir, tiers=tiers, rules=rules,
                       wallclock=lambda: sim["wall"])
    store.open()
    # The governor outlives the mid-run store restart, so the rungs are
    # registered with a getter (register_store_rungs store_fn contract);
    # the restart below re-applies the hook + held thin state.
    holder: dict[str, FleetStore] = {"store": store}
    gov = PressureGovernor()
    register_store_rungs(gov, store, store_fn=lambda: holder["store"])

    up_name = schema.TPU_AGG_TARGET_UP.name
    hbm_name = schema.TPU_SLICE_HBM_USED_BYTES.name

    def round_snapshot(r: int) -> "Snapshot":
        b = SnapshotBuilder()
        b.declare(schema.TPU_AGG_TARGET_UP)
        b.declare(schema.TPU_SLICE_HBM_USED_BYTES)
        for i in range(targets):
            b.add(schema.TPU_AGG_TARGET_UP,
                  0.0 if (i + r) % 97 == 0 else 1.0, (f"t{i:04d}",))
        for sl in range(8):
            b.add(schema.TPU_SLICE_HBM_USED_BYTES,
                  float((sl + 1) * 2**30 + r * 4096),
                  (f"slice-{sl}", "v5p", "tpu"))
        return b.build(timestamp=sim["wall"])

    rounds = int(total_s // sim_round_s)
    squeeze_at = rounds // 2
    budget = 0
    sheds_seen = 0
    restarted = False
    problems: list[str] = []
    for r in range(rounds):
        sim["wall"] += sim_round_s
        store.append_snapshot(round_snapshot(r), now_wall=sim["wall"])
        if r == squeeze_at:
            usage = store.disk_bytes()
            budget = max(int(usage * budget_frac), 64 << 10)
            store.disk_budget_bytes = budget
            gov.set_disk_budget_bytes(budget)
            if verbose:
                print(f"  r{r}: squeezing disk budget to {budget}B "
                      f"(usage {usage}B)")
        if r >= squeeze_at:
            gov.tick()
            sheds_seen = max(sheds_seen, gov.stats()["disk"]["sheds"])
        if not restarted and r == squeeze_at + rounds // 8:
            # Kill/replay mid-retention: the restarted store must answer
            # the same span from replayed records alone. The governor
            # survives the swap; its held rung is re-applied to the fresh
            # instance (a real root restart restarts governor and store
            # together — this drill deliberately splits them to prove the
            # replay path under pressure).
            store.close()
            store = FleetStore(state_dir, tiers=tiers, rules=rules,
                               wallclock=lambda: sim["wall"])
            info = store.open()
            store.disk_budget_bytes = budget
            holder["store"] = store
            store.set_pressure_hook(gov.report_io_error)
            if gov.stats()["disk"]["level"] >= 1:
                store.set_thin(True)
            restarted = True
            if verbose:
                print(f"  r{r}: restarted store — replayed "
                      f"{info['buckets']} buckets / {info['series']} series")

    st = store.stats()
    usage = store.disk_bytes()
    # Floor: the coarse tier's own records are unmeetable by ANY policy
    # that keeps the 7-day span (the pressure-demo floor discipline).
    coarse_buf_bytes = store._buffers[-1].pending_bytes()
    floor = coarse_buf_bytes + (64 << 10)
    if sheds_seen < 1:
        problems.append("disk ladder never shed store_thin "
                        "(governor inert under the squeezed budget)")
    if not st["thinned"]:
        problems.append("store not thinned after the squeeze")
    if usage > max(budget, floor):
        problems.append(f"disk usage {usage}B over max(budget {budget}B, "
                        f"coarse floor {floor}B)")
    want_span = total_s * 0.9
    if st["span_s"] < want_span:
        problems.append(f"answerable span {st['span_s']:.0f}s < "
                        f"{want_span:.0f}s — the 7-day window did not "
                        f"survive thinning")
    rows = store.query_range(
        "demo:hbm:by_slice", {"slice_name": "slice-3"},
        start=sim["wall"] - total_s, end=sim["wall"], step=3600.0)
    if not rows or len(rows[0]["values"]) < int(total_s / 3600.0 * 0.8):
        got = len(rows[0]["values"]) if rows else 0
        problems.append(f"rule-backed 7-day query answered {got} grid "
                        f"points (want most of {int(total_s / 3600.0)})")
    up_rows = store.window_stats(
        up_name, {"target": f"t{min(42, targets - 1):04d}"},
        window_s=total_s)
    if not up_rows:
        problems.append("per-target series not answerable over the window")
    if verbose:
        print(f"  {targets} targets · {rounds} rounds over {days:g} "
              f"simulated days · span {st['span_s'] / 86400.0:.1f}d · "
              f"disk {usage}B vs budget {budget}B · sheds {sheds_seen} · "
              f"restart replay {'ok' if restarted else 'SKIPPED'}")
    store.close()
    if problems:
        for p in problems:
            print(f"  FAIL: {p}")
        return 1
    if verbose:
        print("  retention drill OK")
    return 0


def run_query_budget_demo(
    state_dir: str, targets: int = 200, shards: int = 4,
    iterations: int = 25, verbose: bool = True,
) -> int:
    """Stored-rollup query vs the cold two-level fan-out at fleet shape
    (the CI p99 budget): a real farm + leaf tier + root over HTTP, a
    store fed from the root's rounds, then p99 of (a) ``source=store``
    rule-series queries against (b) cache-busted live fan-outs. The
    stored path must win — that is the whole point of recording rules."""
    from tpu_pod_exporter_torch.loadgen.fleet import _ShardSim
    from tpu_pod_exporter_torch.shard import RootQueryPlane

    rules = parse_rules(
        "demo:hbm:by_slice = sum(" + schema.TPU_SLICE_HBM_USED_BYTES.name
        + ") by (slice_name)\n")
    store_holder: dict[str, FleetStore] = {}

    def factory() -> FleetStore:
        s = FleetStore(os.path.join(state_dir, "store"),
                       tiers="0.5:600,5:600", rules=rules)
        s.open()
        store_holder["store"] = s
        return s

    sim = _ShardSim(targets, shards, False, 1, state_dir,
                    timeout_s=5.0, query_plane=True, store_factory=factory)
    try:
        for _ in range(6):
            sim.run_round()
        store = store_holder["store"]
        live = RootQueryPlane(sim.topology, timeout_s=5.0)
        plane = StoreQueryPlane(live, store)
        hbm = schema.TPU_HBM_USED_BYTES.name

        def p99(samples: list[float]) -> float:
            samples = sorted(samples)
            return samples[min(int(len(samples) * 0.99), len(samples) - 1)]

        cold: list[float] = []
        for i in range(iterations):
            t0 = time.perf_counter()
            # Distinct window per iteration busts every generation-keyed
            # leaf cache: this IS the cold fan-out path a dashboard pays
            # without recording rules.
            env = plane.query_range(hbm, start=time.time() - 60.0 - i,
                                    end=time.time(), step=0.0,
                                    source="live")
            cold.append(time.perf_counter() - t0)
            if not _rows_of("query_range", env):
                print("  FAIL: cold fan-out returned no rows")
                return 1
        stored: list[float] = []
        for i in range(iterations):
            t0 = time.perf_counter()
            env = plane.query_range("demo:hbm:by_slice",
                                    start=time.time() - 60.0 - i,
                                    end=time.time(), step=0.5,
                                    source="store")
            stored.append(time.perf_counter() - t0)
            if not _rows_of("query_range", env):
                print("  FAIL: stored-rule query returned no rows")
                return 1
        cold_p99, store_p99 = p99(cold), p99(stored)
        if verbose:
            print(f"  {targets} targets / {shards} shards: stored-rollup "
                  f"p99 {store_p99 * 1e3:.2f}ms vs cold fan-out p99 "
                  f"{cold_p99 * 1e3:.2f}ms")
        if store_p99 >= cold_p99:
            print(f"  FAIL: stored query p99 {store_p99 * 1e3:.2f}ms did "
                  f"not beat the cold fan-out {cold_p99 * 1e3:.2f}ms")
            return 1
        if verbose:
            print("  query-budget drill OK")
        return 0
    finally:
        plane_obj = locals().get("plane")
        if plane_obj is not None:
            plane_obj.close()
        sim.close()


def main(argv: list[str] | None = None) -> int:
    import argparse
    import tempfile

    p = argparse.ArgumentParser(
        prog="tpu-pod-exporter-store",
        description="Fleet TSDB-lite drills: 7-day synthetic retention "
                    "inside a governor-enforced disk budget (store_thin "
                    "exercised), and the stored-rollup-vs-cold-fan-out "
                    "query budget (make store-demo).",
    )
    p.add_argument("--demo", action="store_true",
                   help="run the store drills and fail on any broken "
                        "invariant")
    p.add_argument("--drill", default="all",
                   help="retention | query | all")
    p.add_argument("--targets", type=int, default=1000,
                   help="synthetic targets for the retention drill")
    p.add_argument("--days", type=float, default=7.0,
                   help="simulated retention window, days")
    p.add_argument("--query-targets", type=int, default=200,
                   help="real-HTTP targets for the query-budget drill")
    p.add_argument("--state-dir", default="",
                   help="drill state dir (default: temp)")
    ns = p.parse_args(argv)
    if not ns.demo:
        p.error("need --demo")
    state_dir = ns.state_dir or tempfile.mkdtemp(prefix="store-demo-")
    os.makedirs(state_dir, exist_ok=True)
    rc = 0
    if ns.drill in ("all", "retention"):
        print(f"retention drill: {ns.targets} targets, {ns.days:g} days "
              f"simulated")
        rc = rc or run_retention_demo(
            os.path.join(state_dir, "retention"),
            targets=ns.targets, days=ns.days)
    if ns.drill in ("all", "query"):
        print(f"query-budget drill: {ns.query_targets} targets")
        rc = rc or run_query_budget_demo(
            os.path.join(state_dir, "query"), targets=ns.query_targets)
    if rc == 0:
        print("store-demo OK: days of fleet history inside the disk "
              "budget, store_thin sheds by policy, and stored rollups "
              "beat the cold fan-out")
    return rc


if __name__ == "__main__":
    import sys

    sys.exit(main())
