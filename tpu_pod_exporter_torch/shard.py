"""Sharded HA aggregation tree — leaves own consistent-hash shards, a root
merges them into one fleet-wide ``/metrics``.

Every fleet-facing layer so far (aggregator, fleet query plane, egress)
funnels through a single ``SliceAggregator`` process: one SIGKILL away from
losing the whole fleet view, and one flat target list away from a round
time that grows with the fleet. This module splits the tier in two:

- **Leaf aggregators** (:class:`LeafAggregator`) are today's
  ``SliceAggregator`` owning only one **consistent-hash shard** of the node
  targets (:class:`ShardMap`): a target join/leave moves ~1/n of
  assignments (property-tested in tests/test_shard.py), so a churn wave
  reshuffles a bounded slice of the fleet, never all of it. Per-shard
  breaker/quarantine state and the shard map itself carry across restarts
  via ``persist.py`` (``BreakerStateFile`` / :class:`~tpu_pod_exporter_torch.\
persist.ShardMapFile`). Each leaf additionally publishes its raw rollup
  **accumulator components** (``tpu_leaf_*``, schema.LEAF_SPECS) — the
  sums/counts/coverage-flags a mean or a used-vs-total guard cannot be
  rebuilt from rolled-up numbers alone.

- **A root tier** (:class:`RootAggregator`) scrapes every leaf's
  exposition, rebuilds the fleet accumulators by summing per-shard
  components, and emits slice → pod → fleet rollups through the SAME
  ``aggregate.emit_rollups`` path the flat aggregator uses — so the root's
  fleet view cannot drift from what one flat aggregator over the same
  scrape set would publish (the shard-demo asserts them equal against
  exactly that oracle).

- **HA pair mode**: two leaves scrape the same shard; the root dedups per
  series group by **freshest poll wall timestamp** (the leaf's
  ``tpu_aggregator_last_round_timestamp_seconds``). One leaf's death loses
  zero series and at most one round of freshness; taking a STALER leaf's
  value because the freshest lacked the series is counted in
  ``tpu_root_dedup_stale_wins_total``.

- **Two-level queries**: the root's ``/api/v1`` (:class:`RootQueryPlane`)
  fans out to every leaf's federated query plane (``fleet.py``) and merges
  the envelopes — per-LEAF state surfaced alongside the per-target state
  each leaf already reports, same partial-result semantics (a dead leaf
  whose HA twin answers degrades nothing).

Run::

    python -m tpu_pod_exporter_torch.shard --role leaf --shard-index 2 \\
        --num-shards 8 --leaf-id 2a --targets-file /etc/tpe/targets
    python -m tpu_pod_exporter_torch.shard --role root \\
        --leaves 'shard-0=leaf0a:9100|leaf0b:9100,shard-1=leaf1a:9100'
"""

from __future__ import annotations

import argparse
import bisect
import hashlib
import logging
import os
import signal
import threading
import time
import urllib.error
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Iterable, Mapping, Sequence

from tpu_pod_exporter_torch import utils
from tpu_pod_exporter_torch.aggregate import (
    SliceAggregator,
    TargetSet,
    default_fetch,
    emit_rollups,
    read_targets_file,
)
from tpu_pod_exporter_torch.fleet import (
    QueryCache,
    data_shape as fleet_data_shape,
    default_api_fetch,
    rows_of as fleet_rows_of,
    target_query_url,
)
from tpu_pod_exporter_torch.metrics import (
    CounterStore,
    HistogramStore,
    PrefixCache,
    SnapshotBuilder,
    SnapshotStore,
    schema,
)
from tpu_pod_exporter_torch.metrics.parse import (
    LayoutCache,
    ParseError,
    parse_exposition_layout,
)
from tpu_pod_exporter_torch.supervisor import CLOSED, CircuitBreaker
from tpu_pod_exporter_torch.utils import RateLimitedLogger

log = logging.getLogger("tpu_pod_exporter_torch.shard")


# --------------------------------------------------------------------- hashing


def stable_hash64(key: str) -> int:
    """Deterministic 64-bit hash. NOT ``hash()``: that is salted per
    process (PYTHONHASHSEED), and every leaf, the root, and a restarted
    process must all place the same key at the same ring position."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


def default_shards(n: int) -> tuple[str, ...]:
    """Canonical shard ids for an n-shard tree: ``shard-0`` … ``shard-n-1``.
    Every tier derives them from ``--num-shards`` alone, so leaves and root
    agree on the ring without exchanging configuration."""
    if n <= 0:
        raise ValueError("need at least one shard")
    return tuple(f"shard-{i}" for i in range(n))


class ShardMap:
    """Consistent-hash ring assigning node targets to shards.

    Each shard owns ``vnodes`` pseudo-random ring positions; a target maps
    to the first shard clockwise from its own hash. Properties (tested):

    - **stability** — same (shards, vnodes, target) → same assignment, in
      every process, on every run;
    - **target churn is local** — a target joining or leaving moves ONLY
      its own assignment (targets hash independently), so a k-target churn
      wave costs exactly k moves;
    - **shard churn is bounded** — adding/removing one shard of n moves
      about targets/n assignments (the removed shard's arcs), never a full
      reshuffle.
    """

    def __init__(self, shards: Sequence[str], vnodes: int = 64) -> None:
        uniq = tuple(dict.fromkeys(s for s in shards if s))
        if not uniq:
            raise ValueError("shard map needs at least one shard")
        if vnodes <= 0:
            raise ValueError("vnodes must be positive")
        self.shards = uniq
        self.vnodes = vnodes
        ring: list[tuple[int, str]] = []
        for shard in uniq:
            for v in range(vnodes):
                ring.append((stable_hash64(f"{shard}#{v}"), shard))
        ring.sort()
        self._ring_keys = [h for h, _ in ring]
        self._ring_shards = [s for _, s in ring]

    def assign(self, target: str) -> str:
        i = bisect.bisect_right(self._ring_keys, stable_hash64(target))
        if i == len(self._ring_keys):
            i = 0
        return self._ring_shards[i]

    def assignments(self, targets: Iterable[str]) -> dict[str, str]:
        return {t: self.assign(t) for t in targets}

    def to_doc(self) -> dict[str, object]:
        return {"shards": list(self.shards), "vnodes": self.vnodes}

    @classmethod
    def from_doc(cls, doc: Mapping[str, object]) -> "ShardMap":
        shards = doc.get("shards")
        vnodes = doc.get("vnodes", 64)
        if not isinstance(shards, list) or not isinstance(vnodes, int):
            raise ValueError("bad shard map document")
        return cls([str(s) for s in shards], vnodes=vnodes)


def count_moves(old: Mapping[str, str], new: Mapping[str, str]) -> int:
    """Assignment delta between two target→shard maps: targets added,
    removed, or moved to a different shard — the ``reshard_moves``
    quantity the churn budget bounds."""
    moves = 0
    for t, s in new.items():
        prev = old.get(t)
        if prev is None or prev != s:
            moves += 1
    for t in old:
        if t not in new:
            moves += 1
    return moves


# -------------------------------------------------------------- leaf tier


def _slice_fields(agg: Any) -> dict[str, float]:
    """One slice accumulator → the field map ``tpu_leaf_slice_component``
    carries (ordering/naming contract: schema.LEAF_SLICE_FIELDS)."""
    return {
        "hosts": float(agg.hosts_n),
        "chips": float(agg.chips),
        "hbm_used": float(agg.hbm_used),
        "hbm_total": float(agg.hbm_total),
        "used_n": float(agg.used_n),
        "total_n": float(agg.total_n),
        "coverage_eq": 1.0 if agg.coverage_eq else 0.0,
        "duty_sum": float(agg.duty_sum),
        "duty_n": float(agg.duty_n),
        "ici_bw": float(agg.ici_bw),
        "ici_n": float(agg.ici_n),
        "dcn_bw": float(agg.dcn_bw),
        "dcn_n": float(agg.dcn_n),
    }


def _workload_fields(w: Any) -> dict[str, float]:
    return {
        "chips": float(w.chips),
        "hbm_used": float(w.hbm_used),
        "hbm_used_n": float(w.hbm_used_n),
        "hosts": float(w.hosts_n),
    }


class LeafAggregator(SliceAggregator):
    """A :class:`SliceAggregator` owning one consistent-hash shard.

    Everything the flat aggregator does — scrape pool, per-target
    breakers/quarantine, history fallback, tracing, breaker persistence,
    fleet query plane — works unchanged; this subclass only (1) cuts
    membership to its shard via the TargetSet's ``target_filter`` (live:
    a targets-file reload re-applies the hash cut, so targets reshard in
    and out without a restart), (2) publishes the ``tpu_leaf_*``
    component surface the root merges, and (3) persists the shard map +
    assignment view so a restart counts real reshard moves instead of
    re-learning the world as churn.
    """

    def __init__(
        self,
        shard_id: str,
        leaf_id: str,
        shard_map: ShardMap,
        shard_map_store: Any = None,  # persist.ShardMapFile | None
        **kwargs: Any,
    ) -> None:
        if shard_id not in shard_map.shards:
            raise ValueError(
                f"shard {shard_id!r} not in shard map {shard_map.shards}"
            )
        self.shard_id = shard_id
        self.leaf_id = leaf_id
        self._shard_map = shard_map
        self._shard_map_store = shard_map_store
        kwargs["target_filter"] = self._shard_filter
        kwargs.setdefault("targets", ())
        super().__init__(**kwargs)
        if shard_map_store is not None:
            saved = shard_map_store.load()
            self._restore_shard_state(saved)
        self._saved_moves = self._tset.moves
        self._persist_shard_map()

    def _shard_filter(self, targets: Sequence[str]) -> tuple[str, ...]:
        """The consistent-hash cut: of the global target list, keep what
        hashes to this leaf's shard (order preserved)."""
        return tuple(
            t for t in targets if self._shard_map.assign(t) == self.shard_id
        )

    def _restore_shard_state(self, saved: Mapping[str, object]) -> None:
        """Boot-time carryover: restore the cumulative reshard counter and
        count the restart's real assignment delta (targets that joined or
        left the shard while we were down) as moves, not as a cold start.
        A changed ring (different shard set/vnodes) is logged loudly —
        everything is expected to move then."""
        ring = saved.get("ring")
        if isinstance(ring, dict) and ring != self._shard_map.to_doc():
            log.warning(
                "shard ring changed across restart (%s -> %s): assignment "
                "moves below reflect a topology change, not target churn",
                ring, self._shard_map.to_doc(),
            )
        # Restore the cumulative counter; the boot population itself is
        # never counted as churn (mirrors TargetSet's own boot behaviour).
        moves = saved.get("moves")
        if isinstance(moves, (int, float)):
            self._tset.moves = int(moves)
        else:
            self._tset.moves = 0
        prev = saved.get("assigned")
        if isinstance(prev, list):
            prev_set = {str(t) for t in prev}
            cur_set = set(self._tset.targets)
            delta = len(prev_set - cur_set) + len(cur_set - prev_set)
            self._tset.moves += delta
            if delta:
                log.info(
                    "shard %s membership moved %d target(s) across the "
                    "restart (now %d)", self.shard_id, delta, len(cur_set),
                )

    def _persist_shard_map(self) -> None:
        if self._shard_map_store is None:
            return
        self._shard_map_store.save({
            "ring": self._shard_map.to_doc(),
            "shard": self.shard_id,
            "leaf": self.leaf_id,
            "assigned": list(self._tset.targets),
            "moves": self._tset.moves,
        })

    def poll_once(self) -> None:
        super().poll_once()
        # Persist the assignment view only when it changed (a reshard is
        # a handful of saves per churn event, not one per round).
        if self._tset.moves != self._saved_moves:
            self._saved_moves = self._tset.moves
            self._persist_shard_map()

    def _emit_extra(self, b: SnapshotBuilder, slices: Mapping[Any, Any],
                    workloads: Mapping[Any, Any],
                    slice_groups: Mapping[Any, Any]) -> None:
        """The tier-to-tier contract: raw accumulator components + shard
        identity, appended to the same exposition the public rollups ride
        (a leaf stays directly scrapeable as an ordinary aggregator)."""
        for spec in schema.LEAF_SPECS:
            b.declare(spec)
        b.add(schema.TPU_LEAF_SHARD_INFO, 1.0,
              (self.shard_id, self.leaf_id,
               str(len(self._shard_map.shards)),
               str(self._shard_map.vnodes)))
        b.add(schema.TPU_LEAF_TARGETS, float(len(self._tset.targets)),
              (self.shard_id,))
        b.add(schema.TPU_LEAF_RESHARD_MOVES_TOTAL, float(self._tset.moves))
        for key, agg in slices.items():
            for fname, value in _slice_fields(agg).items():
                b.add(schema.TPU_LEAF_SLICE_COMPONENT, value,
                      tuple(key) + (fname,))
        for wkey, w in workloads.items():
            for fname, value in _workload_fields(w).items():
                b.add(schema.TPU_LEAF_WORKLOAD_COMPONENT, value,
                      tuple(wkey) + (fname,))
        for skey, membership in slice_groups.items():
            group, nslices = membership
            b.add(schema.TPU_LEAF_SLICE_GROUP_INFO, 1.0,
                  tuple(skey) + (group, nslices))

    def debug_vars(self) -> dict:
        out = super().debug_vars()
        out["shard"] = {
            "shard_id": self.shard_id,
            "leaf_id": self.leaf_id,
            "ring": self._shard_map.to_doc(),
            "reshard_moves": self._tset.moves,
        }
        return out


# -------------------------------------------------------------- root tier


# What the root folds out of a leaf body — everything else in the leaf's
# exposition (its public rollups included) is skipped before label parsing,
# same fast-path reasoning as aggregate.CONSUMED_NAMES.
ROOT_CONSUMED: frozenset[str] = frozenset({
    schema.TPU_LEAF_SLICE_COMPONENT.name,
    schema.TPU_LEAF_WORKLOAD_COMPONENT.name,
    schema.TPU_LEAF_SLICE_GROUP_INFO.name,
    schema.TPU_LEAF_SHARD_INFO.name,
    schema.TPU_LEAF_TARGETS.name,
    schema.TPU_AGG_TARGET_UP.name,
    schema.TPU_AGG_TARGET_BREAKER_STATE.name,
    schema.TPU_AGG_LAST_ROUND_TIMESTAMP_SECONDS.name,
})


@dataclass
class SliceStats:
    """Additive slice accumulator rebuilt from ``tpu_leaf_slice_component``
    series. Exposes the same count/flag surface ``aggregate._SliceAgg``
    does, so ``aggregate.emit_rollups`` treats both identically."""

    hosts_n: int = 0
    chips: float = 0.0
    hbm_used: float = 0.0
    hbm_total: float = 0.0
    used_n: int = 0
    total_n: int = 0
    coverage_eq: bool = True
    duty_sum: float = 0.0
    duty_n: int = 0
    ici_bw: float = 0.0
    ici_n: int = 0
    dcn_bw: float = 0.0
    dcn_n: int = 0

    def orphan_hosts(self) -> set[str]:
        """Always empty at the root: the leaf that saw the orphan warned."""
        return set()

    @classmethod
    def from_fields(cls, fields: Mapping[str, float]) -> "SliceStats":
        return cls(
            hosts_n=int(fields.get("hosts", 0.0)),
            chips=fields.get("chips", 0.0),
            hbm_used=fields.get("hbm_used", 0.0),
            hbm_total=fields.get("hbm_total", 0.0),
            used_n=int(fields.get("used_n", 0.0)),
            total_n=int(fields.get("total_n", 0.0)),
            coverage_eq=fields.get("coverage_eq", 1.0) != 0.0,
            duty_sum=fields.get("duty_sum", 0.0),
            duty_n=int(fields.get("duty_n", 0.0)),
            ici_bw=fields.get("ici_bw", 0.0),
            ici_n=int(fields.get("ici_n", 0.0)),
            dcn_bw=fields.get("dcn_bw", 0.0),
            dcn_n=int(fields.get("dcn_n", 0.0)),
        )

    def merge(self, other: "SliceStats") -> None:
        """Fold another shard's partial accumulator in. Sums everywhere;
        coverage is the AND over shards — hosts partition by shard, so
        per-shard used==total (as sets) implies the union equality the
        flat aggregator's percent guard checks."""
        self.hosts_n += other.hosts_n
        self.chips += other.chips
        self.hbm_used += other.hbm_used
        self.hbm_total += other.hbm_total
        self.used_n += other.used_n
        self.total_n += other.total_n
        self.coverage_eq = self.coverage_eq and other.coverage_eq
        self.duty_sum += other.duty_sum
        self.duty_n += other.duty_n
        self.ici_bw += other.ici_bw
        self.ici_n += other.ici_n
        self.dcn_bw += other.dcn_bw
        self.dcn_n += other.dcn_n


@dataclass
class WorkloadStats:
    """Additive workload accumulator (root-side twin of ``_WorkloadAgg``)."""

    chips: float = 0.0
    hbm_used: float = 0.0
    hbm_used_n: int = 0
    hosts_n: int = 0

    @classmethod
    def from_fields(cls, fields: Mapping[str, float]) -> "WorkloadStats":
        return cls(
            chips=fields.get("chips", 0.0),
            hbm_used=fields.get("hbm_used", 0.0),
            hbm_used_n=int(fields.get("hbm_used_n", 0.0)),
            hosts_n=int(fields.get("hosts", 0.0)),
        )

    def merge(self, other: "WorkloadStats") -> None:
        self.chips += other.chips
        self.hbm_used += other.hbm_used
        self.hbm_used_n += other.hbm_used_n
        self.hosts_n += other.hosts_n


@dataclass
class LeafView:
    """One leaf body, folded: everything the root merges, plus the round
    wall timestamp the freshest-wins dedup keys on."""

    leaf: str
    round_ts: float = 0.0
    # (slice_name, accelerator, family) -> field map
    slice_fields: dict[tuple[str, str, str], dict[str, float]] = field(
        default_factory=dict)
    workload_fields: dict[tuple[str, str, str], dict[str, float]] = field(
        default_factory=dict)
    group_info: dict[tuple[str, str], tuple[str, str]] = field(
        default_factory=dict)
    target_up: dict[str, float] = field(default_factory=dict)
    target_breaker: dict[str, float] = field(default_factory=dict)
    targets_gauge: float | None = None
    shard_claim: tuple[str, str] | None = None  # (shard, leaf) from the body
    ring_claim: tuple[str, str] | None = None   # (num_shards, vnodes)


def fold_leaf_body(leaf: str, samples: Iterable[tuple]) -> LeafView:
    """Parsed ``(name, labels, value)`` tuples → :class:`LeafView`."""
    view = LeafView(leaf=leaf)
    for name, labels, value in samples:
        if name == schema.TPU_LEAF_SLICE_COMPONENT.name:
            fname = labels.get("field", "")
            if fname not in schema.LEAF_SLICE_FIELDS:
                continue  # newer leaf: unknown components are ignored
            # family defaults to "tpu" so a pre-GPU leaf's components
            # merge unchanged (missing label = the only family there was).
            key = (labels.get("slice_name", ""), labels.get("accelerator", ""),
                   labels.get("family", "tpu"))
            view.slice_fields.setdefault(key, {})[fname] = value
        elif name == schema.TPU_LEAF_WORKLOAD_COMPONENT.name:
            fname = labels.get("field", "")
            if fname not in schema.LEAF_WORKLOAD_FIELDS:
                continue
            wkey = (labels.get("pod", ""), labels.get("namespace", ""),
                    labels.get("slice_name", ""))
            view.workload_fields.setdefault(wkey, {})[fname] = value
        elif name == schema.TPU_AGG_TARGET_UP.name:
            target = labels.get("target", "")
            if target:
                view.target_up[target] = value
        elif name == schema.TPU_AGG_TARGET_BREAKER_STATE.name:
            target = labels.get("target", "")
            if target:
                view.target_breaker[target] = value
        elif name == schema.TPU_LEAF_SLICE_GROUP_INFO.name:
            key = (labels.get("slice_name", ""), labels.get("accelerator", ""))
            view.group_info[key] = (
                labels.get("multislice_group", ""),
                labels.get("num_slices", ""),
            )
        elif name == schema.TPU_AGG_LAST_ROUND_TIMESTAMP_SECONDS.name:
            view.round_ts = value
        elif name == schema.TPU_LEAF_TARGETS.name:
            view.targets_gauge = value
        elif name == schema.TPU_LEAF_SHARD_INFO.name:
            view.shard_claim = (labels.get("shard", ""),
                                labels.get("leaf", ""))
            if "num_shards" in labels:
                view.ring_claim = (labels.get("num_shards", ""),
                                   labels.get("vnodes", ""))
    return view


@dataclass
class ShardMerged:
    """One shard after HA dedup: per-series-group winners plus dedup
    bookkeeping."""

    slices: dict[tuple[str, str, str], SliceStats] = field(
        default_factory=dict)
    workloads: dict[tuple[str, str, str], WorkloadStats] = field(
        default_factory=dict)
    group_info: dict[tuple[str, str], tuple[str, str]] = field(
        default_factory=dict)
    # target -> (value, source round_ts): the ts rides along so a target
    # briefly visible from two shards mid-reshard resolves freshest-wins
    # at the fleet fold too.
    target_up: dict[str, tuple[float, float]] = field(default_factory=dict)
    target_breaker: dict[str, tuple[float, float]] = field(
        default_factory=dict)
    targets_gauge: float | None = None
    stale_wins: int = 0


def merge_shard_views(views: Sequence[LeafView]) -> ShardMerged:
    """HA dedup for one shard: for every series group (a slice's component
    set, a workload's, one target's up/breaker…) take the value from the
    FRESHEST answering leaf that carries it — per series, by poll wall
    timestamp, exactly the freshest-wins contract. A group served only by
    a staler leaf (the freshest is mid-warmup after a restart) still
    lands — that is the zero-series-loss half — and is counted as a stale
    win."""
    out = ShardMerged()
    if not views:
        return out
    ordered = sorted(views, key=lambda v: v.round_ts, reverse=True)

    def pick(present: Callable[[LeafView], bool]) -> LeafView | None:
        for i, v in enumerate(ordered):
            if present(v):
                if i > 0:
                    out.stale_wins += 1
                return v
        return None

    skeys = {k for v in ordered for k in v.slice_fields}
    for key in skeys:
        win = pick(lambda v, k=key: k in v.slice_fields)
        if win is not None:
            out.slices[key] = SliceStats.from_fields(win.slice_fields[key])
    wkeys = {k for v in ordered for k in v.workload_fields}
    for wkey in wkeys:
        win = pick(lambda v, k=wkey: k in v.workload_fields)
        if win is not None:
            out.workloads[wkey] = WorkloadStats.from_fields(
                win.workload_fields[wkey])
    gkeys = {k for v in ordered for k in v.group_info}
    for gkey in gkeys:
        win = pick(lambda v, k=gkey: k in v.group_info)
        if win is not None:
            out.group_info[gkey] = win.group_info[gkey]
    tkeys = {t for v in ordered for t in v.target_up}
    for t in tkeys:
        win = pick(lambda v, k=t: k in v.target_up)
        if win is not None:
            out.target_up[t] = (win.target_up[t], win.round_ts)
    bkeys = {t for v in ordered for t in v.target_breaker}
    for t in bkeys:
        win = pick(lambda v, k=t: k in v.target_breaker)
        if win is not None:
            out.target_breaker[t] = (win.target_breaker[t], win.round_ts)
    for v in ordered:
        if v.targets_gauge is not None:
            out.targets_gauge = v.targets_gauge
            break
    return out


def parse_leaf_topology(spec: str) -> dict[str, tuple[str, ...]]:
    """``--leaves`` grammar: ``shard-0=addrA|addrB,shard-1=addrC`` →
    {shard: (leaf addrs…)}. Two addrs = an HA pair. Raises ValueError
    loudly on malformed entries — a typo'd topology must fail at startup,
    not silently drop a shard from the fleet view."""
    topo: dict[str, tuple[str, ...]] = {}
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        shard, sep, addrs = raw.partition("=")
        shard = shard.strip()
        if not sep or not shard:
            raise ValueError(
                f"leaf topology entry {raw!r}: want shard=addr[|addr]"
            )
        leaf_addrs = tuple(
            dict.fromkeys(a.strip() for a in addrs.split("|") if a.strip())
        )
        if not leaf_addrs:
            raise ValueError(f"leaf topology entry {raw!r}: no leaf address")
        if shard in topo:
            raise ValueError(f"leaf topology: duplicate shard {shard!r}")
        topo[shard] = leaf_addrs
    if not topo:
        raise ValueError(f"leaf topology {spec!r} contains no shards")
    return topo


class RootAggregator:
    """Scrape every leaf, dedup HA pairs freshest-wins, publish the
    fleet-wide rollups plus the per-target series the leaves own.

    An observer of leaves exactly the way the leaves observe exporters:
    public exposition over HTTP, per-leaf circuit breakers quarantining a
    persistently-dead leaf (its HA twin keeps the shard covered), layout
    caches for value-only re-parse. Drives on the same
    ``CollectorLoop``/``poll_once`` contract as every other tier.
    """

    def __init__(
        self,
        topology: Mapping[str, Sequence[str]],
        store: SnapshotStore,
        timeout_s: float = 2.0,
        fetch: Callable[..., str] = default_fetch,
        wallclock: Callable[[], float] = time.time,
        breaker_failures: int = 3,
        breaker_backoff_s: float = 10.0,
        breaker_backoff_max_s: float = 120.0,
        loop_overruns_fn: Callable[[], int] | None = None,
        targets_file: str = "",
        shard_map: ShardMap | None = None,
        shard_map_store: Any = None,  # persist.ShardMapFile | None
        breaker_store: Any = None,  # persist.BreakerStateFile | None
        stale_serve_s: float = 0.0,
        fleet_store: Any = None,  # store.FleetStore | None
        alert_evaluator: Any = None,  # alerting.AlertEvaluator | None
        render_splice: bool = True,  # --render-splice; RUNBOOK kill switch
    ) -> None:
        if not topology:
            raise ValueError("root needs at least one shard of leaves")
        self.topology = {s: tuple(ls) for s, ls in topology.items()}
        self._leaves = tuple(
            leaf for leaves in self.topology.values() for leaf in leaves
        )
        if len(set(self._leaves)) != len(self._leaves):
            raise ValueError("a leaf address appears in two shards")
        self._shard_of = {
            leaf: shard
            for shard, leaves in self.topology.items()
            for leaf in leaves
        }
        self.rounds = 0
        self._store = store
        self._timeout_s = timeout_s
        self._fetch = fetch
        self._wallclock = wallclock
        # Splice render across rounds (see SliceAggregator): the root's
        # merged exposition re-renders only changed cells per round. Same
        # kill switch as the other tiers (--render-splice false).
        self._prefix_cache = PrefixCache(splice=render_splice)
        self._rlog = RateLimitedLogger(log)
        self._counters = CounterStore()
        # Stable conditional surface: both counters exist from round 1.
        self._counters.inc(schema.TPU_ROOT_DEDUP_STALE_WINS_TOTAL.name, (),
                           0.0)
        self._counters.inc(schema.TPU_ROOT_RESHARD_MOVES_TOTAL.name, (), 0.0)
        self._round_hist = HistogramStore(schema.TPU_ROOT_ROUND_HIST)
        self._loop_overruns_fn = loop_overruns_fn
        # Per-LEAF state rides the same TargetSet the leaf tier uses for
        # its node targets (static membership here): one construction
        # path for breakers + layout caches, not a hand-rolled twin.
        self._leaf_set = TargetSet(
            self._leaves,
            breaker_failures=breaker_failures,
            breaker_backoff_s=breaker_backoff_s,
            breaker_backoff_max_s=breaker_backoff_max_s,
            breaker_store=breaker_store,
            wallclock=wallclock,
        )
        self._layouts: dict[str, LayoutCache] = self._leaf_set.layouts
        self._breakers: dict[str, CircuitBreaker] | None = (
            self._leaf_set.breakers
        )
        # Last seen round ts per leaf: a dead leaf's staleness keeps
        # GROWING (published from here), instead of vanishing with its body.
        self._leaf_ts: dict[str, float] = {}
        # Partition tolerance (the scenario drills' hardening): keep each
        # leaf's last successfully-folded view for up to stale_serve_s and
        # MERGE it while the leaf is unreachable — the fleet view degrades
        # to stale-but-labeled (leaf_up=0, staleness growing,
        # tpu_root_leaf_stale_served=1) instead of vanishing, and because
        # the cached view's round_ts is frozen, the HA freshest-wins
        # winner cannot flap while a flapping cut strobes reachability.
        # 0 disables (a vanished leaf's series drop out immediately, the
        # pre-hardening behavior the both-leaves-dead tests pin for the
        # disabled case).
        self._stale_serve_s = stale_serve_s
        # Fleet TSDB-lite (tpu_pod_exporter_torch.store): after each round's
        # publish, the merged rollups + per-target series append into the
        # store's downsample tiers, and the tpu_root_store_* surface rides
        # this root's exposition. Owned here for lifecycle (close()).
        self._fleet_store = fleet_store
        # Native alerting plane (tpu_pod_exporter_torch.alerting): evaluated
        # each round against the just-published snapshot, AFTER the store
        # append (alerts may reference recording-rule outputs the same
        # round computed). Owned here for lifecycle (close()).
        self.alert_evaluator = alert_evaluator
        self._last_views: dict[str, tuple[LeafView, float]] = {}
        # Last round's health summary, read by ready_detail() from HTTP
        # threads (swapped atomically as a tuple).
        self._health: tuple[int, int, int, tuple[str, ...]] = (
            0, len(self._leaves), 0, ())
        # Reshard accounting: the root re-derives the global assignment
        # map from the same targets file the leaves read and counts the
        # delta per reload — the fleet-level churn signal
        # (tpu_root_reshard_moves_total) alerts key off.
        self._targets_file = targets_file
        self._targets_file_mtime: float | None = None
        self._shard_map = shard_map
        self._shard_map_store = shard_map_store
        self._assignments: dict[str, str] = {}
        if shard_map_store is not None:
            saved = shard_map_store.load()
            assigned = saved.get("assignments")
            if isinstance(assigned, dict):
                self._assignments = {
                    str(k): str(v) for k, v in assigned.items()
                }
            moves = saved.get("moves")
            if isinstance(moves, (int, float)) and moves > 0:
                self._counters.inc(
                    schema.TPU_ROOT_RESHARD_MOVES_TOTAL.name, (),
                    float(moves),
                )
        self._pool = ThreadPoolExecutor(
            max_workers=min(max(len(self._leaves), 1), 16),
            thread_name_prefix="tpu-root-scrape",
        )
        # Attachment seams (same contract as SliceAggregator's): emit
        # hooks ride _publish's SnapshotBuilder (stream-hub/replica
        # surfaces), round hooks fire at the end of poll_once with the
        # new round number (poll-side cost must stay trivial).
        self.emit_hooks: list[Callable[[SnapshotBuilder], None]] = []
        self.round_hooks: list[Callable[[int], None]] = []

    # ------------------------------------------------------------------ round

    def _refresh_assignments(self) -> None:
        """Recompute target→shard assignments when the targets file moved;
        count the delta as reshard moves and persist the view."""
        if not self._targets_file or self._shard_map is None:
            return
        try:
            mtime = os.path.getmtime(self._targets_file)
        except OSError:
            return
        if self._targets_file_mtime == mtime:
            return
        try:
            targets = read_targets_file(self._targets_file)
        except OSError as e:
            self._rlog.warning("targets_file",
                               "targets file unreadable on reload: %s", e)
            return
        self._targets_file_mtime = mtime
        if not targets and self._assignments:
            # Same torn-write guard as TargetSet.refresh: a readable-but-
            # empty file is overwhelmingly a truncate-then-write edit in
            # flight. Applying it would count the whole fleet as moves
            # (firing TpuRootReshardStorm on a non-event) and persist an
            # empty assignment view; keep the last one instead.
            self._rlog.warning(
                "targets_file",
                "targets file read EMPTY on reload; keeping the last "
                "%d assignments (truncated mid-write?)",
                len(self._assignments),
            )
            return
        new = self._shard_map.assignments(targets)
        if self._assignments:
            moves = count_moves(self._assignments, new)
        else:
            moves = 0  # first read is a boot population, not churn
        if moves:
            self._counters.inc(schema.TPU_ROOT_RESHARD_MOVES_TOTAL.name, (),
                               float(moves))
            log.info("reshard: %d assignment move(s) across %d target(s)",
                     moves, len(new))
        changed = new != self._assignments
        self._assignments = new
        if changed and self._shard_map_store is not None:
            try:
                self._shard_map_store.save({
                    "ring": self._shard_map.to_doc(),
                    "assignments": self._assignments,
                    "moves": self._counters.inc(
                        schema.TPU_ROOT_RESHARD_MOVES_TOTAL.name, (), 0.0),
                })
            except Exception as e:  # noqa: BLE001 — persistence must not fail rounds
                self._rlog.warning("shard_map_save",
                                   "shard map save failed: %s", e)

    def _scrape_leaf(self, leaf: str) -> tuple[str, LeafView | None, float]:
        t0 = time.monotonic()
        br = self._breakers.get(leaf) if self._breakers else None
        if br is not None and br.decide() == "skip":
            return leaf, None, 0.0
        try:
            text = self._fetch(leaf, self._timeout_s)
        except Exception as e:  # noqa: BLE001 — a down leaf is data, not death
            self._rlog.warning(f"leaf:{leaf}", "leaf scrape of %s failed: %s",
                               leaf, e)
            if br is not None:
                br.record_failure()
            return leaf, None, time.monotonic() - t0
        try:
            samples = parse_exposition_layout(
                text, ROOT_CONSUMED, self._layouts[leaf]
            )
        except ParseError as e:
            self._rlog.warning(f"parse:{leaf}",
                               "bad exposition from leaf %s: %s", leaf, e)
            if br is not None:
                br.record_failure()
            return leaf, None, time.monotonic() - t0
        if br is not None:
            if br.consecutive_failures or br.state != CLOSED:
                self._rlog.recovery(
                    f"leaf:{leaf}",
                    "leaf %s healthy again after %d failed scrape(s)",
                    leaf, br.consecutive_failures,
                )
            br.record_success()
        view = fold_leaf_body(leaf, samples)
        expect = self._shard_of[leaf]
        if view.shard_claim is not None and view.shard_claim[0] != expect:
            # Mis-wired topology: a leaf serving a different shard than
            # the root expects would silently double one shard and drop
            # another. Refuse its data, keep the round.
            self._rlog.warning(
                f"claim:{leaf}",
                "leaf %s claims shard %s but topology says %s — ignoring "
                "its body (fix --leaves or the leaf's --shard-index)",
                leaf, view.shard_claim[0], expect,
            )
            return leaf, None, time.monotonic() - t0
        if (
            self._shard_map is not None
            and view.ring_claim is not None
            and view.ring_claim != (str(len(self._shard_map.shards)),
                                    str(self._shard_map.vnodes))
        ):
            # Same shard id, DIFFERENT ring (mid-resize skew: one leaf
            # restarted with a new --num-shards): its hash cut covers a
            # different target subset, and summing it would double-count
            # targets its true owners also scrape while dropping others.
            self._rlog.warning(
                f"ring:{leaf}",
                "leaf %s hashes with ring %s but the root uses %s/%s — "
                "ignoring its body until the tier agrees on --num-shards",
                leaf, view.ring_claim, len(self._shard_map.shards),
                self._shard_map.vnodes,
            )
            return leaf, None, time.monotonic() - t0
        return leaf, view, time.monotonic() - t0

    def poll_once(self) -> None:
        t0 = time.monotonic()
        self.rounds += 1
        self._refresh_assignments()
        results = list(self._pool.map(self._scrape_leaf, self._leaves))
        views: dict[str, LeafView] = {
            leaf: view for leaf, view, _d in results if view is not None
        }
        reachable = frozenset(views)
        now_wall = self._wallclock()
        for leaf, view in views.items():
            self._leaf_ts[leaf] = view.round_ts
            self._last_views[leaf] = (view, now_wall)
        # Stale-serve: an unreachable leaf's last-known view keeps its
        # shard populated for up to stale_serve_s. The cached view joins
        # the merge with its ORIGINAL round_ts, so a reachable twin (being
        # fresher) wins every shared group and the cache only fills what
        # nothing fresher carries — zero series lost, no winner flap.
        stale_served: set[str] = set()
        if self._stale_serve_s > 0:
            for leaf in self._leaves:
                if leaf in views:
                    continue
                cached = self._last_views.get(leaf)
                if cached is not None and (
                        now_wall - cached[1] <= self._stale_serve_s):
                    views[leaf] = cached[0]
                    stale_served.add(leaf)
        # Partition suspicion: one-sided unreachability — the leaf was
        # healthy moments ago (we are stale-serving its view) while its
        # HA twin still answers. A DEAD leaf trips its own liveness probe
        # and restarts; persistent one-sided cut is a partition shape.
        suspected: set[str] = set()
        for shard, leaves in self.topology.items():
            if any(leaf in reachable for leaf in leaves):
                suspected.update(
                    leaf for leaf in leaves if leaf in stale_served
                )
        merged: dict[str, ShardMerged] = {}
        stale_wins = 0
        for shard, leaves in self.topology.items():
            sm = merge_shard_views(
                [views[leaf] for leaf in leaves if leaf in views]
            )
            stale_wins += sm.stale_wins
            merged[shard] = sm
        if stale_wins:
            self._counters.inc(schema.TPU_ROOT_DEDUP_STALE_WINS_TOTAL.name,
                               (), float(stale_wins))
        self._health = (
            len(reachable), len(self._leaves), len(stale_served),
            tuple(sorted(suspected)),
        )
        self._publish(results, views, merged, now_wall, t0,
                      stale_served=stale_served, suspected=suspected)
        # AFTER publish, same discipline as the leaf tier: disk latency
        # during a leaf incident must not read as round time.
        self._leaf_set.maybe_save_breakers()
        if self._fleet_store is not None:
            # Also after publish: the store folds the just-published
            # snapshot (tracked rollups + per-target series + recording
            # rules) into its tiers; its WAL write rides the round thread
            # but never the published round duration, and a store failure
            # can never fail a round.
            try:
                self._fleet_store.append_snapshot(
                    self._store.current(), now_wall=now_wall)
            except Exception as e:  # noqa: BLE001 — history must not break merging
                self._rlog.warning("fleet_store",
                                   "fleet store append failed: %s", e)
        if self.alert_evaluator is not None:
            # Same seat, same rule: rides the round thread (the
            # evaluator's single-caller contract) but never fails a
            # round — a broken rule degrades /readyz detail, not merging.
            try:
                self.alert_evaluator.evaluate_round(
                    self._store.current(), now_wall=now_wall)
            except Exception as e:  # noqa: BLE001 — alerting must not break merging
                self._rlog.warning("alerting",
                                   "alert evaluation failed: %s", e)
        for hook in self.round_hooks:
            try:
                hook(self.rounds)
            except Exception as e:  # noqa: BLE001 — a hook must never fail a round
                self._rlog.warning("round_hook",
                                   "round hook failed: %s", e)

    def _publish(
        self,
        results: Sequence[tuple[str, LeafView | None, float]],
        views: Mapping[str, LeafView],
        merged: Mapping[str, ShardMerged],
        now_wall: float,
        round_started: float,
        stale_served: set[str] | None = None,
        suspected: set[str] | None = None,
    ) -> None:
        stale_served = stale_served or set()
        suspected = suspected or set()
        b = SnapshotBuilder(prefix_cache=self._prefix_cache)
        # Stable surface: fleet rollups + per-target passthrough + root
        # self-metrics, declared every round whether or not sampled.
        for spec in schema.AGGREGATE_SPECS:
            b.declare(spec)
        for spec in schema.ROOT_SPECS:
            b.declare(spec)

        # Fleet fold: sum per-shard accumulators, then the ONE emit path.
        fleet_slices: dict[tuple[str, str, str], SliceStats] = {}
        fleet_workloads: dict[tuple[str, str, str], WorkloadStats] = {}
        fleet_groups: dict[tuple[str, str], tuple[str, str]] = {}
        target_up: dict[str, tuple[float, float]] = {}
        target_breaker: dict[str, tuple[float, float]] = {}
        for shard, sm in merged.items():
            for key, stats in sm.slices.items():
                cur = fleet_slices.get(key)
                if cur is None:
                    # A copy, not the shard's object: merge() mutates in
                    # place, and aliasing the fleet fold to a ShardMerged
                    # view would corrupt that view for any later reader.
                    fleet_slices[key] = replace(stats)
                else:
                    cur.merge(stats)
            for wkey, wstats in sm.workloads.items():
                wcur = fleet_workloads.get(wkey)
                if wcur is None:
                    fleet_workloads[wkey] = replace(wstats)
                else:
                    wcur.merge(wstats)
            fleet_groups.update(sm.group_info)
            # Mid-reshard a target can transiently appear under two
            # shards: freshest source wins, same contract as HA dedup.
            for t, (v, ts) in sm.target_up.items():
                if t not in target_up or ts > target_up[t][1]:
                    target_up[t] = (v, ts)
            for t, (v, ts) in sm.target_breaker.items():
                if t not in target_breaker or ts > target_breaker[t][1]:
                    target_breaker[t] = (v, ts)
        emit_rollups(b, fleet_slices, fleet_workloads, fleet_groups,
                     rlog=self._rlog)
        for t in sorted(target_up):
            b.add(schema.TPU_AGG_TARGET_UP, target_up[t][0], (t,))
        for t in sorted(target_breaker):
            b.add(schema.TPU_AGG_TARGET_BREAKER_STATE,
                  target_breaker[t][0], (t,))

        # Root self-surface: per-leaf health + per-shard occupancy.
        for leaf, view, _dur in results:
            shard = self._shard_of[leaf]
            # up reflects REACHABILITY this round — a stale-served leaf is
            # still down (stale-serve is labeled continuity, not health).
            b.add(schema.TPU_ROOT_LEAF_UP,
                  1.0 if view is not None else 0.0, (shard, leaf))
            b.add(schema.TPU_ROOT_LEAF_STALE_SERVED,
                  1.0 if leaf in stale_served else 0.0, (shard, leaf))
            b.add(schema.TPU_ROOT_LEAF_PARTITION_SUSPECTED,
                  1.0 if leaf in suspected else 0.0, (shard, leaf))
            ts = self._leaf_ts.get(leaf)
            if ts:
                b.add(schema.TPU_ROOT_LEAF_STALENESS_SECONDS,
                      max(now_wall - ts, 0.0), (shard, leaf))
        for shard, sm in merged.items():
            if sm.targets_gauge is not None:
                b.add(schema.TPU_ROOT_SHARD_TARGETS, sm.targets_gauge,
                      (shard,))
            quarantined = sum(
                1 for v, _ts in sm.target_breaker.values() if v != 0.0
            )
            b.add(schema.TPU_ROOT_SHARD_QUARANTINED_TARGETS,
                  float(quarantined), (shard,))
            # Per-shard accelerator-family split (status --tree's family
            # column): consistent hashing mixes node pools across shards,
            # so which families a shard carries is data, not topology.
            shard_fams: dict[str, float] = {}
            for key, stats in sm.slices.items():
                fam = key[2] if len(key) > 2 else "tpu"
                shard_fams[fam] = shard_fams.get(fam, 0.0) + stats.chips
            for fam, chips in sorted(shard_fams.items()):
                b.add(schema.TPU_ROOT_SHARD_FAMILY_CHIPS, chips,
                      (shard, fam))
        for spec in (schema.TPU_ROOT_DEDUP_STALE_WINS_TOTAL,
                     schema.TPU_ROOT_RESHARD_MOVES_TOTAL):
            for lv, v in self._counters.items_for(spec.name):
                b.add(spec, v, lv)
        b.add(schema.TPU_ROOT_LAST_ROUND_TIMESTAMP_SECONDS, now_wall)
        if self._loop_overruns_fn is not None:
            try:
                b.add(schema.TPU_AGG_POLL_OVERRUNS_TOTAL,
                      float(self._loop_overruns_fn()))
            except Exception:  # noqa: BLE001 — accounting must never fail a round
                pass
        if self._fleet_store is not None:
            try:
                self._fleet_store.emit(b)
            except Exception:  # noqa: BLE001 — store surface must not fail publish
                pass
        for emit_hook in self.emit_hooks:
            try:
                emit_hook(b)
            except Exception:  # noqa: BLE001 — hook surface must not fail publish
                pass
        cpu_s = utils.process_cpu_seconds()
        if cpu_s is not None:
            b.add(schema.TPU_AGG_CPU_SECONDS_TOTAL, cpu_s)
        rss = utils.process_rss_bytes()
        if rss is not None:
            b.add(schema.TPU_AGG_RSS_BYTES, rss)
        self._round_hist.emit(b)
        round_dur = time.monotonic() - round_started
        b.add(schema.TPU_ROOT_ROUND_DURATION_SECONDS, round_dur)
        snap = b.build(timestamp=now_wall, transfer=True)
        self._store.swap(snap)
        self._round_hist.observe(round_dur)

    # Rough per-entry retained cost of a stale-serve cache slot: dict
    # entries + key tuples + float cells. Same estimate the memory budget
    # sums and /debug/vars shows (the shared-numbers contract of
    # tpu_pod_exporter_torch.pressure).
    _VIEW_ENTRY_EST_BYTES = 160

    def stale_view_bytes(self) -> int:
        """Estimated retained bytes of the stale-serve view cache
        (``_last_views``) for the memory budget's component accounting."""
        total = 0
        for view, _wall in self._last_views.values():
            total += self._VIEW_ENTRY_EST_BYTES * (
                1
                + len(view.slice_fields) + len(view.workload_fields)
                + len(view.group_info) + len(view.target_up)
                + len(view.target_breaker)
            )
        return total

    def shed_stale_views(self) -> int:
        """Memory-ladder hook: drop every cached stale-serve view (an
        unreachable leaf's shard then degrades honestly instead of being
        carried — memory pressure trumps continuity at this rung).
        Returns the number of views dropped."""
        n = len(self._last_views)
        self._last_views.clear()
        return n

    def ready_detail(self) -> dict:
        """/readyz detail hook (``server.MetricsServer ready_detail_fn``):
        the root keeps answering HTTP 200 through a partition — last-known
        data IS being served — but flips ``state`` to ``degraded`` with an
        operator-readable reason once NO leaf is reachable, and surfaces
        per-leaf stale-serve/suspicion either way."""
        reachable, total, stale_served, suspected = self._health
        out: dict = {
            "leaf_tier": {
                "reachable": reachable,
                "total": total,
                "stale_served": stale_served,
                "partition_suspected": list(suspected),
            },
        }
        if total and reachable == 0 and self.rounds > 0:
            out["degraded_sources"] = [
                f"leaf-tier: 0/{total} leaves reachable — serving "
                f"last-known shard data"
                + (f" ({stale_served} leaf view(s) stale-served)"
                   if stale_served else "")
                + "; root-side network partition suspected"
            ]
        if self.alert_evaluator is not None:
            # `alerting: ok|degraded` — detail only, NEVER the HTTP code:
            # a down webhook receiver must not pull the root from scrape
            # rotation.
            out["alerting"] = self.alert_evaluator.ready_detail()
        return out

    def debug_vars(self) -> dict:
        tmpl = self._prefix_cache.template
        return {
            "topology": {s: list(ls) for s, ls in self.topology.items()},
            "timeout_s": self._timeout_s,
            "rounds": self.rounds,
            # Splice-render counters (None = --render-splice false); the
            # RUNBOOK's render triage reads the same shape on every tier.
            "render": tmpl.stats() if tmpl is not None else None,
            "store": (self._fleet_store.stats()
                      if self._fleet_store is not None else None),
            "alerting": (self.alert_evaluator.stats()
                         if self.alert_evaluator is not None else None),
            "stale_serve_s": self._stale_serve_s,
            "stale_view_bytes": self.stale_view_bytes(),
            "stale_served_leaves": self._health[2],
            "partition_suspected": list(self._health[3]),
            "leaf_round_ts": dict(self._leaf_ts),
            "assignments": len(self._assignments),
            "leaf_breakers": (
                {
                    leaf: {
                        "state": br.state,
                        "consecutive_failures": br.consecutive_failures,
                        "reopens": br.reopens,
                        "next_probe_in_s": round(br.seconds_until_probe, 3),
                    }
                    for leaf, br in self._breakers.items()
                }
                if self._breakers is not None else None
            ),
        }

    def close(self) -> None:
        self._leaf_set.maybe_save_breakers(force=True)
        self._pool.shutdown(wait=False)
        if self.alert_evaluator is not None:
            try:
                self.alert_evaluator.close()
            except Exception:  # noqa: BLE001 — draining must finish
                pass
        if self._fleet_store is not None:
            try:
                self._fleet_store.close()
            except Exception:  # noqa: BLE001 — draining must finish
                pass


# ---------------------------------------------------------- two-level queries


# Per-target state ranking for the union merge: when two leaves of an HA
# pair disagree about one target, the better state stands (the other leaf's
# failure was leaf-local).
_STATE_RANK = {"ok": 0, "no_data": 1, "quarantined": 2, "timeout": 3,
               "error": 4}


class RootQueryPlane:
    """Two-level ``/api/v1`` fan-out: the root fans a query out to every
    leaf's federated query plane (``fleet.py``) and merges the envelopes.

    Same partial-result contract as one level down, one tier up: a dead
    leaf whose HA twin answers degrades nothing; a shard with NO answering
    leaf marks the result partial. The merged envelope carries per-LEAF
    state (``leaves``) alongside the per-target state (``targets``) the
    leaves already report — ``status --tree`` and dashboards read both.

    Serves the same three methods ``server.MetricsServer`` dispatches to,
    so the root's HTTP surface is identical to an aggregator's.
    """

    def __init__(
        self,
        topology: Mapping[str, Sequence[str]],
        timeout_s: float = 2.5,
        fetch: Callable[..., dict] = default_api_fetch,
        leaf_breakers: Mapping[str, CircuitBreaker] | None = None,
        wallclock: Callable[[], float] = time.time,
        max_workers: int = 16,
        generation_fn: Callable[[], int] | None = None,
        cache_entries: int = 128,
    ) -> None:
        if not topology:
            raise ValueError("root query plane needs at least one shard")
        self.topology = {s: tuple(ls) for s, ls in topology.items()}
        self._leaves = tuple(
            leaf for leaves in self.topology.values() for leaf in leaves
        )
        self._shard_of = {
            leaf: shard
            for shard, leaves in self.topology.items()
            for leaf in leaves
        }
        self._timeout_s = timeout_s
        self._fetch = fetch
        self._breakers = leaf_breakers
        self._wallclock = wallclock
        self._rlog = RateLimitedLogger(log)
        # Generation-keyed result cache, the fleet plane's discipline one
        # tier up: with a generation_fn (the root's round counter) every
        # panel — and every stream-hub shape evaluation — costs ONE
        # two-level fan-out per round, however many viewers ask. Without
        # one (pre-existing constructions), every query fans out, the
        # original behavior.
        self._generation_fn = generation_fn
        self._cache = QueryCache(cache_entries if generation_fn else 0)
        self._pool = ThreadPoolExecutor(
            max_workers=min(max(len(self._leaves), 1), max_workers),
            thread_name_prefix="tpu-root-query",
        )

    # ------------------------------------------------------------- public API

    def series(self) -> dict:
        return self._query("series", "/api/v1/series", {}, key=("series",))

    def query_range(
        self,
        metric: str,
        match: Mapping[str, str] | None = None,
        start: float | None = None,
        end: float | None = None,
        step: float = 0.0,
        agg: str = "last",
    ) -> dict:
        if end is None:
            end = self._wallclock()
        if start is None:
            start = end - 300.0
        if step > 0:
            # Grid alignment (fleet.py's): sliding dashboard windows land
            # on the same cache key within a generation, and grid points
            # given up at the OLD edge keep the widened range inside the
            # node-side resolution cap.
            start = (start // step) * step
            end = -((-end) // step) * step
            if (end - start) / step > 11000:
                start = end - 11000 * step
        match = dict(match or {})
        params = {"metric": metric, "start": f"{start:.3f}",
                  "end": f"{end:.3f}", "step": f"{step:g}", "agg": agg}
        for k, v in match.items():
            params[f"match[{k}]"] = v
        key = ("query_range", metric, tuple(sorted(match.items())),
               round(start, 3), round(end, 3), step, agg)
        return self._query("query_range", "/api/v1/query_range", params,
                           key=key)

    def window_stats(
        self,
        metric: str,
        match: Mapping[str, str] | None = None,
        window_s: float = 60.0,
    ) -> dict:
        match = dict(match or {})
        params = {"metric": metric, "window": f"{window_s:g}"}
        for k, v in match.items():
            params[f"match[{k}]"] = v
        key = ("window_stats", metric, tuple(sorted(match.items())),
               window_s)
        return self._query("window_stats", "/api/v1/window_stats", params,
                           key=key)

    # --------------------------------------------------------------- internals

    def _fetch_leaf(
        self, leaf: str, path: str, params: Mapping[str, str],
    ) -> tuple[str, str, dict | None, str, float]:
        """(leaf, state, envelope, error, duration)."""
        t0 = time.monotonic()
        url = target_query_url(leaf, path, params)
        try:
            doc = self._fetch(url, self._timeout_s)
        except urllib.error.HTTPError as e:
            dur = time.monotonic() - t0
            if e.code == 404:
                # The leaf answered: no samples anywhere in its shard.
                return leaf, "no_data", None, "", dur
            self._rlog.warning(f"query:{leaf}",
                               "root query to leaf %s failed: %s", leaf, e)
            return leaf, "error", None, f"HTTP {e.code}", dur
        except Exception as e:  # noqa: BLE001 — a down leaf is data, not death
            self._rlog.warning(f"query:{leaf}",
                               "root query to leaf %s failed: %s", leaf, e)
            return leaf, "error", None, str(e), time.monotonic() - t0
        return leaf, "ok", doc, "", time.monotonic() - t0

    # The ONE shape implementation (fleet.data_shape/rows_of) — tiers
    # must not drift.
    _rows_of = staticmethod(fleet_rows_of)
    _data_shape = staticmethod(fleet_data_shape)

    def _query(self, route: str, path: str,
               params: Mapping[str, str], key: tuple = ()) -> dict:
        generation = (self._generation_fn()
                      if self._generation_fn is not None else 0)
        cache_key = key + (generation,)
        cached = self._cache.get(cache_key)
        if cached is not None:
            # Shared + read-only, same contract as fleet.py's cache;
            # only the top-level marker differs per response.
            return {**cached, "cached": True}
        env = self._query_uncached(route, path, params, generation)
        self._cache.put(cache_key, env)
        return env

    def _query_uncached(self, route: str, path: str,
                        params: Mapping[str, str], generation: int) -> dict:
        t0 = time.monotonic()
        leaf_states: dict[str, dict] = {}
        futures = {}
        for leaf in self._leaves:
            br = self._breakers.get(leaf) if self._breakers else None
            if br is not None and br.state != CLOSED:
                # Scrape-plane quarantine trusted, probes not consumed —
                # same rule the leaf applies to its node targets.
                leaf_states[leaf] = {
                    "shard": self._shard_of[leaf],
                    "state": "quarantined",
                    "next_probe_in_s": round(br.seconds_until_probe, 3),
                }
                continue
            fut = self._pool.submit(self._fetch_leaf, leaf, path, params)
            futures[fut] = leaf
        envelopes: dict[str, dict] = {}
        # ONE overall deadline across the whole fan-out, fleet.py's
        # _fan_out discipline: a leaf drip-feeding bytes keeps each
        # socket op under timeout_s and would otherwise hold this query
        # for n_leaves x timeout — behind the server's 2-permit /api/v1
        # fence, two such queries would wedge the root's entire API.
        # Stragglers are marked `timeout` and left to finish on the pool.
        deadline = time.monotonic() + self._timeout_s + 0.5
        pending = set(futures)
        while pending:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            done, pending = futures_wait(pending, timeout=remaining,
                                         return_when=FIRST_COMPLETED)
            for fut in done:
                fut_leaf = futures[fut]
                try:
                    leaf, state, env, err, dur = fut.result()
                except Exception as e:  # noqa: BLE001 — a broken leg degrades, never fails
                    leaf_states[fut_leaf] = {
                        "shard": self._shard_of[fut_leaf],
                        "state": "error",
                        "error": str(e),
                    }
                    continue
                st: dict[str, Any] = {
                    "shard": self._shard_of[leaf],
                    "state": state,
                    "duration_s": round(dur, 6),
                }
                if err:
                    st["error"] = err
                if env is not None:
                    st["partial"] = bool(env.get("partial"))
                    envelopes[leaf] = env
                leaf_states[leaf] = st
        for fut in pending:
            leaf_states[futures[fut]] = {
                "shard": self._shard_of[futures[fut]],
                "state": "timeout",
                "error": "missed fan-out deadline",
            }

        # Per-series merge, freshest-wins on colliding keys: HA twins
        # answer with the SAME series for their shared shard, and the one
        # carrying the newer last_sample_wall_ts is at most one leaf round
        # fresher, never staler.
        chosen: dict[tuple, tuple[float, dict]] = {}
        order: list[tuple] = []
        duplicates = 0
        for leaf in self._leaves:
            env = envelopes.get(leaf)
            if env is None:
                continue
            for row in self._rows_of(route, env):
                if not isinstance(row, dict):
                    continue
                try:
                    key = (
                        row.get("metric", ""),
                        tuple(sorted((row.get("labels") or {}).items())),
                    )
                except TypeError:
                    continue
                ts = row.get("last_sample_wall_ts")
                ts_f = float(ts) if isinstance(ts, (int, float)) else 0.0
                prev = chosen.get(key)
                if prev is None:
                    chosen[key] = (ts_f, row)
                    order.append(key)
                else:
                    duplicates += 1
                    if ts_f > prev[0]:
                        chosen[key] = (ts_f, row)
        merged = [chosen[k][1] for k in order]

        # Per-target union across leaf envelopes: best state stands.
        targets: dict[str, dict] = {}
        for leaf in self._leaves:
            env = envelopes.get(leaf)
            if env is None:
                continue
            for t, st in (env.get("targets") or {}).items():
                prev_st = targets.get(t)
                if prev_st is None or (
                    _STATE_RANK.get(str(st.get("state")), 9)
                    < _STATE_RANK.get(str(prev_st.get("state")), 9)
                ):
                    targets[t] = st

        covered = {
            shard: any(
                leaf_states.get(leaf, {}).get("state") in ("ok", "no_data")
                for leaf in leaves
            )
            for shard, leaves in self.topology.items()
        }
        uncovered = sorted(s for s, ok in covered.items() if not ok)
        partial = bool(uncovered) or any(
            str(st.get("state")) in ("error", "timeout", "quarantined")
            for st in targets.values()
        )
        took = time.monotonic() - t0
        return {
            "status": "ok",
            "partial": partial,
            "route": route,
            # Two-level fan-out answers are "live"; the store-backed
            # wrapper (store.StoreQueryPlane) upgrades this to
            # live|store|merged — one envelope contract across tiers.
            "source": "live",
            "data": self._data_shape(route, merged),
            "targets": targets,
            "leaves": leaf_states,
            "fleet": {
                "shards": len(self.topology),
                "uncovered_shards": uncovered,
                "leaves": len(self._leaves),
                "leaves_ok": sum(
                    1 for st in leaf_states.values()
                    if st.get("state") == "ok"
                ),
                "targets": len(targets),
                "ok": sum(1 for st in targets.values()
                          if st.get("state") == "ok"),
                "merged_series": len(merged),
                "duplicate_series": duplicates,
            },
            "generation": generation,
            "took_s": round(took, 6),
        }

    # ------------------------------------------------- pressure shed hooks

    def cache_bytes(self) -> int:
        """Result-cache byte estimate for the memory ladder's component
        accounting (same number /debug/vars would report)."""
        return self._cache.bytes()

    def set_cache_enabled(self, enabled: bool) -> None:
        """fleet_cache memory rung, root flavor: clear + disable (every
        query re-fans-out; correctness unchanged). Reversible."""
        self._cache.set_enabled(enabled)

    def close(self) -> None:
        self._pool.shutdown(wait=False)


# ---------------------------------------------------------------- replicas


class ReplicaSourceProxy:
    """The /api/v1 front of a stateless read replica.

    Live queries serve from the replica's own two-level fan-out
    (``RootQueryPlane``) — identical to the root's answers by the
    freshest-wins dedup contract. ``?source=`` queries need the fleet
    store, which exactly one root owns: with ``--root-url`` configured
    they are proxied there verbatim (tagged ``proxied: true``, counted in
    ``tpu_replica_store_proxied_total``); without it they 400 with an
    actionable message — a replica silently answering ``source=store``
    from live data would let an operator trust history that is not there
    (the store.StoreQueryPlane honesty rule, one tier over).
    """

    # The server threads ?source= through to planes that declare it.
    handles_source = True

    def __init__(
        self,
        inner: RootQueryPlane,
        replica_id: str = "replica",
        root_url: str = "",
        fetch: Callable[..., dict] = default_api_fetch,
        timeout_s: float = 5.0,
    ) -> None:
        self._inner = inner
        self.replica_id = replica_id
        self._root_url = root_url.strip().rstrip("/")
        self._fetch = fetch
        self._timeout_s = timeout_s
        self._counters = CounterStore()
        for result in ("ok", "error"):
            self._counters.inc(
                schema.TPU_REPLICA_STORE_PROXIED_TOTAL.name, (result,), 0.0)

    # ------------------------------------------------------------- queries

    def series(self, source: str = "") -> dict:
        if source:
            return self._proxy("/api/v1/series", {"source": source})
        return self._inner.series()

    def query_range(
        self,
        metric: str,
        match: Mapping[str, str] | None = None,
        start: float | None = None,
        end: float | None = None,
        step: float = 0.0,
        agg: str = "last",
        source: str = "",
    ) -> dict:
        if source:
            if end is None:
                end = time.time()
            if start is None:
                start = end - 300.0
            params = {"metric": metric, "start": f"{start:.3f}",
                      "end": f"{end:.3f}", "step": f"{step:g}",
                      "agg": agg, "source": source}
            for k, v in dict(match or {}).items():
                params[f"match[{k}]"] = v
            return self._proxy("/api/v1/query_range", params)
        return self._inner.query_range(metric, match, start, end, step,
                                       agg=agg)

    def window_stats(
        self,
        metric: str,
        match: Mapping[str, str] | None = None,
        window_s: float = 60.0,
        source: str = "",
    ) -> dict:
        if source:
            params = {"metric": metric, "window": f"{window_s:g}",
                      "source": source}
            for k, v in dict(match or {}).items():
                params[f"match[{k}]"] = v
            return self._proxy("/api/v1/window_stats", params)
        return self._inner.window_stats(metric, match, window_s=window_s)

    def _proxy(self, path: str, params: Mapping[str, str]) -> dict:
        if not self._root_url:
            # Mapped to the same 400 contract as every other param error.
            raise ValueError(
                "source= requires the root's fleet store; this replica "
                "owns no store and has no --root-url to proxy to — query "
                "the root directly or start the replica with --root-url"
            )
        url = target_query_url(self._root_url, path, params)
        try:
            doc = self._fetch(url, self._timeout_s)
        except urllib.error.HTTPError as e:
            # The root ANSWERED (e.g. its own 400 for a store-less
            # ?source=): relay the refusal as a refusal, not an outage.
            self._counters.inc(
                schema.TPU_REPLICA_STORE_PROXIED_TOTAL.name, ("error",))
            raise ValueError(
                f"root store proxy refused: HTTP {e.code}") from e
        except Exception as e:  # noqa: BLE001 — a dead root degrades, never kills
            self._counters.inc(
                schema.TPU_REPLICA_STORE_PROXIED_TOTAL.name, ("error",))
            return {
                "status": "error", "proxied": True,
                "error": f"root store proxy failed: {e}",
                "root_url": self._root_url,
            }
        self._counters.inc(
            schema.TPU_REPLICA_STORE_PROXIED_TOTAL.name, ("ok",))
        if isinstance(doc, dict):
            return {**doc, "proxied": True}
        return {"status": "error", "proxied": True,
                "error": "root store proxy returned a non-object"}

    # ----------------------------------------------------------- exposition

    def emit(self, b: SnapshotBuilder) -> None:
        """Replica identity + proxy accounting (rides the replica's
        publish via its emit hook). tpu_replica_info doubles as the
        'am I talking to a replica?' probe for clients and drills."""
        for spec in schema.REPLICA_SPECS:
            b.declare(spec)
        b.add(schema.TPU_REPLICA_INFO, 1.0, (self.replica_id,))
        for lv, v in self._counters.items_for(
                schema.TPU_REPLICA_STORE_PROXIED_TOTAL.name):
            b.add(schema.TPU_REPLICA_STORE_PROXIED_TOTAL, v, lv)

    def close(self) -> None:
        self._inner.close()


# ------------------------------------------------------------------------ CLI


def _add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--port", type=int, default=9100)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--interval-s", type=float, default=5.0)
    p.add_argument("--timeout-s", type=float, default=2.0)
    p.add_argument("--debug-addr", default="127.0.0.1",
                   help="/debug/* exposure (same policy as the exporter)")
    p.add_argument("--render-splice", default="on", choices=("on", "off"),
                   help="incremental exposition render (splice changed "
                        "cells into a pre-rendered body template per "
                        "round); off restores the per-family full "
                        "re-render — the RUNBOOK's bisection step, same "
                        "switch as the exporter tier")
    p.add_argument("--state-dir", default="",
                   help="persist breaker + shard-map state here (atomic "
                        "JSON) so restarts keep quarantines and count real "
                        "reshard moves; empty disables")
    p.add_argument("--num-shards", type=int, default=1,
                   help="size of the consistent-hash ring (shard-0..n-1); "
                        "every leaf and the root must agree")
    p.add_argument("--targets-file", default="",
                   help="global node-target list, one per line; re-read on "
                        "mtime change (leaves re-apply their hash cut — "
                        "live resharding; the root counts fleet-wide "
                        "assignment moves)")
    p.add_argument("--log-level", default="info")
    p.add_argument("--log-format", default="text", choices=("text", "json"),
                   help="json = one Cloud-Logging-shaped object per line")
    # Streaming dashboard plane (tpu_pod_exporter_torch.stream): every
    # aggregation tier can serve /api/v1/stream — viewers register a
    # query once and receive per-round deltas instead of polling.
    p.add_argument("--stream", default="on", choices=("on", "off"),
                   help="/api/v1/stream subscriptions (SSE + long-poll "
                        "fallback): per-round deltas of a registered "
                        "query, one delta computation per query shape "
                        "per round however many viewers share it")
    p.add_argument("--stream-max-subscribers", type=int, default=10000,
                   help="admission cap on live stream subscriptions; "
                        "past it new subscribers get 429 and should "
                        "retry against a read replica")
    p.add_argument("--stream-heartbeat-s", type=float, default=10.0,
                   help="heartbeat frames to quiet subscribers (keeps "
                        "NAT/proxy paths alive between rounds); 0 "
                        "disables")
    p.add_argument("--stream-full-sync-s", type=float, default=60.0,
                   help="periodic full-answer frames on every stream "
                        "(delta-only streams rot — the egress full-sync "
                        "lesson); 0 disables")
    p.add_argument("--memory-budget-mb", type=float, default=0.0,
                   help="memory budget over the serving-tier components "
                        "(query result cache, stream hub retained "
                        "answers), enforced by the pressure governor: "
                        "past it the ladder sheds the result cache "
                        "first, then the OLDEST stream subscriptions "
                        "(stream_shed rung, counted + labeled; viewers "
                        "reconnect against a replica). 0 = no budget")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="tpu-pod-exporter-shard",
        description="Sharded HA aggregation tree: consistent-hash leaf "
                    "aggregators plus a freshest-wins root merge tier.",
    )
    p.add_argument("--role", required=True,
                   choices=("leaf", "root", "replica"))
    _add_common_flags(p)
    # Leaf-only:
    p.add_argument("--shard-index", type=int, default=0,
                   help="[leaf] which shard of --num-shards this leaf owns")
    p.add_argument("--leaf-id", default="",
                   help="[leaf] identity within the (possibly HA-paired) "
                        "shard, e.g. 2a/2b; default <shard-index>a")
    p.add_argument("--targets", default="",
                   help="[leaf] static global target list (the hash cut is "
                        "applied to it); prefer --targets-file")
    p.add_argument("--breaker-failures", type=int, default=3)
    p.add_argument("--breaker-backoff-s", type=float, default=0.0,
                   help="0 = auto: max(2x --interval-s, --timeout-s)")
    p.add_argument("--breaker-backoff-max-s", type=float, default=120.0)
    p.add_argument("--history-fallback-window", type=float, default=0.0)
    # Root-only:
    p.add_argument("--leaves", default="",
                   help="[root] shard topology: 'shard-0=addrA|addrB,"
                        "shard-1=addrC' — two addresses make an HA pair")
    p.add_argument("--fleet-query", default="on", choices=("on", "off"),
                   help="[root] two-level /api/v1 fan-out through the "
                        "leaves' federated query planes")
    p.add_argument("--stale-serve-s", type=float, default=0.0,
                   help="[root] keep merging an unreachable leaf's LAST-"
                        "KNOWN view for this many seconds (leaf_up stays "
                        "0, staleness grows, tpu_root_leaf_stale_served "
                        "flags it) so a root-leaf network partition "
                        "degrades the fleet view to stale-but-labeled "
                        "instead of emptying it; 0 disables, try 3x "
                        "--interval-s")
    p.add_argument("--store-dir", default="",
                   help="[root] fleet TSDB-lite: persist each round's "
                        "merged rollups + per-target series into disk-"
                        "backed downsample tiers here, so fleet history "
                        "spans DAYS and survives root restarts, leaf "
                        "death and resharding; /api/v1 answers gain "
                        "source=live|store|merged (store fills what the "
                        "live fan-out cannot reach; ?source=store "
                        "answers from the store alone). Empty disables")
    p.add_argument("--store-tiers", default="",
                   help="[root] store downsample tiers, step:capacity "
                        "pairs finest first (default 60:240,600:1008 = "
                        "4 h at 1 min + exactly 7 d at 10 min)")
    p.add_argument("--store-rules", default="",
                   help="[root] recording-rule file: one "
                        "'name = agg(metric{label=\"v\"}) by (labels)' "
                        "per line, evaluated each round into its own "
                        "stored series so dashboards hit precomputed "
                        "rollups instead of fan-outs; malformed rules "
                        "fail startup loudly")
    p.add_argument("--alert-rules", default="",
                   help="[root] native alerting-rule file: 'alert NAME = "
                        "<expr>' blocks with indented for/keep_firing/"
                        "labels/annotations/suppress clauses, evaluated "
                        "at the root each merge round (no external "
                        "Prometheus on the incident path); malformed "
                        "rules or unknown metric names fail startup "
                        "loudly. Generate one from prometheus-rules.yaml "
                        "with `python -m tpu_pod_exporter_torch.alerting "
                        "--import`. Empty disables alerting")
    p.add_argument("--alert-dir", default="",
                   help="[root] alerting state dir: the alert-status.json "
                        "sidecar (status --tree reads it) and the "
                        "notification WAL + exactly-once ledger live "
                        "here; required with --alert-webhook-url")
    p.add_argument("--alert-webhook-url", default="",
                   help="[root] POST firing/resolved transitions here as "
                        "JSON, exactly-once (WAL-buffered, seq-framed, "
                        "breaker-gated; outages backlog on disk and "
                        "drain contiguously across root restarts). "
                        "Empty = evaluate + record + stream, no "
                        "notifications")
    p.add_argument("--alert-webhook-timeout-s", type=float, default=5.0,
                   help="[root] per-notification webhook POST timeout")
    p.add_argument("--alert-suppression", default="on",
                   choices=("on", "off"),
                   help="[root] honor rules' suppress(...) clauses (the "
                        "partition false-positive guard). 'off' is the "
                        "drill negative control and an incident kill "
                        "switch — suppressed_total goes quiet and every "
                        "condition fires raw")
    p.add_argument("--store-max-disk-mb", type=float, default=0.0,
                   help="[root] disk budget over the store dir, enforced "
                        "by the pressure governor: past it the disk "
                        "ladder sheds store_thin (finest tier dropped "
                        "first, counted as reason=\"shed\"; coarse tiers "
                        "— the days-long window — shed last). 0 = no "
                        "budget (retention trim alone bounds disk)")
    # Replica-only:
    p.add_argument("--replica-id", default="",
                   help="[replica] identity published as tpu_replica_info"
                        "{replica=...}; default replica-<pid>")
    p.add_argument("--root-url", default="",
                   help="[replica] the real root's base URL: ?source= "
                        "store queries are proxied there (replicas own "
                        "no store); empty = such queries 400 honestly")
    ns = p.parse_args(argv)
    utils.setup_logging(ns.log_level, ns.log_format)
    if ns.role == "leaf":
        return _run_leaf(ns, p)
    if ns.role == "replica":
        return _run_replica(ns, p)
    return _run_root(ns, p)


def _serve_until_signal(loop: Any, server: Any,
                        closers: Sequence[Any]) -> int:
    stop = threading.Event()

    def _on_signal(signum: int, frame: Any) -> None:  # noqa: ARG001
        log.info("signal %d: draining", signum)
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    loop.start()
    server.start()
    stop.wait()
    loop.stop()
    server.stop()
    for c in closers:
        try:
            c.close()
        except Exception:  # noqa: BLE001 — draining must finish
            pass
    return 0


def _attach_stream_cli(ns: argparse.Namespace, agg: Any,
                       plane: Any,
                       alerts_fn: Any = None) -> tuple[Any, Any]:
    """Stream-hub wiring shared by every role: (hub, pump), or (None,
    None) with --stream off or no query plane to answer through."""
    if ns.stream != "on" or plane is None:
        return None, None
    from tpu_pod_exporter_torch.stream import attach_stream

    return attach_stream(
        agg, plane,
        heartbeat_s=ns.stream_heartbeat_s,
        full_sync_s=ns.stream_full_sync_s,
        max_subscribers=ns.stream_max_subscribers,
        alerts_fn=alerts_fn,
    )


def _run_leaf(ns: argparse.Namespace, p: argparse.ArgumentParser) -> int:
    from tpu_pod_exporter_torch.collector import CollectorLoop
    from tpu_pod_exporter_torch.server import MetricsServer

    if not ns.targets and not ns.targets_file:
        p.error("leaf role needs --targets or --targets-file")
    if not 0 <= ns.shard_index < ns.num_shards:
        p.error("--shard-index must be in [0, --num-shards)")
    shard_map = ShardMap(default_shards(ns.num_shards))
    shard_id = f"shard-{ns.shard_index}"
    leaf_id = ns.leaf_id or f"{ns.shard_index}a"
    breaker_store = shard_map_store = None
    if ns.state_dir:
        from tpu_pod_exporter_torch.persist import BreakerStateFile, ShardMapFile

        breaker_store = BreakerStateFile(
            os.path.join(ns.state_dir, f"leaf-{leaf_id}-breakers.json"))
        shard_map_store = ShardMapFile(
            os.path.join(ns.state_dir, f"leaf-{leaf_id}-shardmap.json"))
    store = SnapshotStore()
    backoff = (ns.breaker_backoff_s if ns.breaker_backoff_s > 0
               else max(2.0 * ns.interval_s, ns.timeout_s))
    agg = LeafAggregator(
        shard_id, leaf_id, shard_map,
        shard_map_store=shard_map_store,
        targets=tuple(
            t.strip() for t in ns.targets.split(",") if t.strip()
        ),
        targets_file=ns.targets_file,
        store=store,
        timeout_s=ns.timeout_s,
        loop_overruns_fn=lambda: loop.overruns,
        history_fallback_window_s=ns.history_fallback_window,
        breaker_failures=ns.breaker_failures,
        breaker_backoff_s=backoff,
        breaker_backoff_max_s=max(ns.breaker_backoff_max_s, backoff),
        breaker_store=breaker_store,
        render_splice=ns.render_splice == "on",
    )
    from tpu_pod_exporter_torch.fleet import FleetQueryPlane

    fleet = FleetQueryPlane(
        agg.targets,
        timeout_s=ns.timeout_s,
        breakers=agg.breakers,
        generation_fn=lambda: agg.rounds,
        targets_fn=lambda: agg.targets,
    )
    agg.set_fleet(fleet)
    hub, pump = _attach_stream_cli(ns, agg, fleet)
    loop = CollectorLoop(agg, interval_s=ns.interval_s)
    server = MetricsServer(
        store, host=ns.host, port=ns.port,
        health_max_age_s=max(10.0 * ns.interval_s, 10.0),
        debug_vars=agg.debug_vars, debug_addr=ns.debug_addr, fleet=fleet,
        ready_detail_fn=agg.ready_detail,
        stream_hub=hub,
    )
    agg.poll_once()  # synchronous first round so /readyz flips immediately
    log.info("leaf %s (%s) aggregating %d/%s targets on :%d every %.1fs",
             leaf_id, shard_id, len(agg.targets),
             ns.targets_file or "static", server.port, ns.interval_s)
    return _serve_until_signal(
        loop, server,
        [c for c in (pump, hub, fleet, agg) if c is not None])


def _run_root(ns: argparse.Namespace, p: argparse.ArgumentParser) -> int:
    from tpu_pod_exporter_torch.collector import CollectorLoop
    from tpu_pod_exporter_torch.server import MetricsServer

    if not ns.leaves:
        p.error("root role needs --leaves")
    topology = parse_leaf_topology(ns.leaves)
    # The ring: --num-shards when given, else inferred from the topology
    # (a partial rollout may list fewer shards than the ring has, so an
    # EXPLICIT flag wins — but never silently shrunk below the topology,
    # and every listed shard id must exist on the ring, or a config typo
    # would refuse every healthy leaf's body at runtime as 'all down').
    ring_n = max(ns.num_shards, 1)
    if ring_n < len(topology):
        if ns.num_shards > 1:
            p.error(f"--leaves lists {len(topology)} shards but "
                    f"--num-shards is {ns.num_shards}")
        ring_n = len(topology)
    shard_map = ShardMap(default_shards(ring_n))
    unknown = sorted(set(topology) - set(shard_map.shards))
    if unknown:
        p.error(f"--leaves names shard(s) {unknown} outside the "
                f"{ring_n}-shard ring (shard-0..shard-{ring_n - 1}); "
                f"check --num-shards")
    shard_map_store = breaker_store = None
    if ns.state_dir:
        from tpu_pod_exporter_torch.persist import BreakerStateFile, ShardMapFile

        shard_map_store = ShardMapFile(
            os.path.join(ns.state_dir, "root-shardmap.json"))
        breaker_store = BreakerStateFile(
            os.path.join(ns.state_dir, "root-leaf-breakers.json"))
    store = SnapshotStore()
    # Fleet TSDB-lite: open (and replay) the store BEFORE the root so the
    # first round already appends; malformed rules and an uncreatable dir
    # are startup errors, never silent no-ops.
    fleet_store: Any = None
    governor: Any = None
    if not ns.store_dir and (ns.store_max_disk_mb > 0 or ns.store_tiers
                             or ns.store_rules):
        # A budget/tier/rule flag without the store itself would silently
        # enforce nothing — the operator believes history is governed.
        p.error("--store-max-disk-mb/--store-tiers/--store-rules require "
                "--store-dir (no fleet store is configured)")
    if ns.store_dir:
        from tpu_pod_exporter_torch.store import (
            DEFAULT_STORE_TIERS,
            FleetStore,
            load_rules_file,
        )

        try:
            rules = (load_rules_file(ns.store_rules)
                     if ns.store_rules else ())
            fleet_store = FleetStore(
                ns.store_dir, tiers=ns.store_tiers or DEFAULT_STORE_TIERS,
                rules=rules)
            info = fleet_store.open()
        except (OSError, ValueError) as e:
            p.error(f"--store-dir/--store-rules: {e}")
        log.info("fleet store %s: %d tier(s), %d rule(s), replayed %d "
                 "buckets across %d series",
                 ns.store_dir, len(fleet_store.tier_spec),
                 len(fleet_store.rules), info["buckets"], info["series"])
        if ns.store_max_disk_mb > 0:
            from tpu_pod_exporter_torch.pressure import (
                PressureGovernor,
                register_store_rungs,
            )

            budget = int(ns.store_max_disk_mb * (1 << 20))
            governor = PressureGovernor(disk_budget_bytes=budget,
                                        sidecar_dir=ns.store_dir)
            register_store_rungs(governor, fleet_store)
            fleet_store.disk_budget_bytes = budget
            governor.start()
    # Native alerting plane: rules parse + validate BEFORE the first
    # round (a typo'd rule file is a startup error, never a silent
    # no-op), the notifier replays its WAL before the evaluator can
    # enqueue (backlog from a previous run drains first, in seq order).
    evaluator: Any = None
    if not ns.alert_rules and (ns.alert_dir or ns.alert_webhook_url):
        p.error("--alert-dir/--alert-webhook-url require --alert-rules "
                "(no alerting plane is configured)")
    if ns.alert_rules:
        from tpu_pod_exporter_torch.alerting import (
            AlertEvaluator,
            AlertNotifier,
            load_alert_rules_file,
        )

        if ns.alert_webhook_url and not ns.alert_dir:
            p.error("--alert-webhook-url needs --alert-dir (the "
                    "notification WAL and exactly-once ledger live "
                    "there)")
        notifier: Any = None
        try:
            alert_rules = load_alert_rules_file(ns.alert_rules)
            if ns.alert_dir:
                os.makedirs(ns.alert_dir, exist_ok=True)
            if ns.alert_webhook_url:
                notifier = AlertNotifier(
                    ns.alert_webhook_url, ns.alert_dir,
                    timeout_s=ns.alert_webhook_timeout_s)
                notifier.load()
                notifier.start()
            evaluator = AlertEvaluator(
                alert_rules,
                alert_dir=ns.alert_dir or None,
                notifier=notifier,
                store=fleet_store,
                recording_rules=(fleet_store.rules
                                 if fleet_store is not None else ()),
                suppression=ns.alert_suppression == "on",
            )
        except (OSError, ValueError) as e:
            p.error(f"--alert-rules: {e}")
        log.info("alerting plane: %d rule(s) from %s%s%s",
                 len(alert_rules), ns.alert_rules,
                 (f", webhook {ns.alert_webhook_url}"
                  if ns.alert_webhook_url else ", no webhook"),
                 ("" if ns.alert_suppression == "on"
                  else " [suppression OFF]"))
    root = RootAggregator(
        topology, store, timeout_s=ns.timeout_s,
        loop_overruns_fn=lambda: loop.overruns,
        targets_file=ns.targets_file,
        shard_map=shard_map,
        shard_map_store=shard_map_store,
        breaker_store=breaker_store,
        stale_serve_s=ns.stale_serve_s,
        fleet_store=fleet_store,
        alert_evaluator=evaluator,
        render_splice=ns.render_splice == "on",
    )
    if evaluator is not None:
        root.emit_hooks.append(evaluator.emit)
    plane: Any = None
    inner_plane: Any = None
    if ns.fleet_query == "on":
        plane = inner_plane = RootQueryPlane(
            topology, timeout_s=ns.timeout_s + 0.5,
            leaf_breakers=root._breakers,
            generation_fn=lambda: root.rounds)
    if fleet_store is not None:
        from tpu_pod_exporter_torch.store import StoreQueryPlane

        # Source-aware front: live fan-out + store fills (store-only when
        # --fleet-query off). Serves through the same server hook.
        plane = StoreQueryPlane(plane, fleet_store)
    hub, pump = _attach_stream_cli(
        ns, root, plane,
        alerts_fn=(evaluator.rows if evaluator is not None else None))
    if ns.memory_budget_mb > 0:
        from tpu_pod_exporter_torch.pressure import build_serving_governor

        # Serving-tier memory ladder: result cache sheds first, oldest
        # stream subscriptions last. Extends the store governor when one
        # exists (one governor per process), else builds + starts one.
        governor = build_serving_governor(
            int(ns.memory_budget_mb * (1 << 20)),
            sidecar_dir=ns.state_dir or ns.store_dir,
            cache_plane=inner_plane, hub=hub, governor=governor,
        )
    loop = CollectorLoop(root, interval_s=ns.interval_s)
    server = MetricsServer(
        store, host=ns.host, port=ns.port,
        health_max_age_s=max(10.0 * ns.interval_s, 10.0),
        debug_vars=root.debug_vars, debug_addr=ns.debug_addr, fleet=plane,
        ready_detail_fn=root.ready_detail,
        stream_hub=hub,
    )
    root.poll_once()
    log.info("root merging %d shard(s) / %d leaf(s) on :%d every %.1fs",
             len(topology), sum(len(v) for v in topology.values()),
             server.port, ns.interval_s)
    closers = [c for c in (pump, hub, plane, governor, root)
               if c is not None]
    return _serve_until_signal(loop, server, closers)


def _run_replica(ns: argparse.Namespace, p: argparse.ArgumentParser) -> int:
    """Stateless root read replica: scrape the leaves read-only exactly
    like the root (same merge, same freshest-wins dedup — replica reads
    are consistent by construction), serve /metrics + /api/v1 + the
    stream endpoint, own NOTHING durable: no egress, no persistence, no
    store writes. Viewer fan-out scales by adding replicas while exactly
    one root keeps the write-side duties."""
    from tpu_pod_exporter_torch.collector import CollectorLoop
    from tpu_pod_exporter_torch.server import MetricsServer

    if not ns.leaves:
        p.error("replica role needs --leaves (same topology as the root)")
    if ns.state_dir:
        p.error("replicas are stateless by design: --state-dir would "
                "persist breaker/shard state a replica must not own — "
                "drop the flag (the root keeps the durable state)")
    if ns.store_dir or ns.store_max_disk_mb > 0 or ns.store_tiers \
            or ns.store_rules:
        p.error("replicas own no fleet store: use --root-url to proxy "
                "?source= queries to the root's store instead of "
                "--store-* flags")
    topology = parse_leaf_topology(ns.leaves)
    ring_n = max(ns.num_shards, 1)
    if ring_n < len(topology):
        if ns.num_shards > 1:
            p.error(f"--leaves lists {len(topology)} shards but "
                    f"--num-shards is {ns.num_shards}")
        ring_n = len(topology)
    shard_map = ShardMap(default_shards(ring_n))
    unknown = sorted(set(topology) - set(shard_map.shards))
    if unknown:
        p.error(f"--leaves names shard(s) {unknown} outside the "
                f"{ring_n}-shard ring (shard-0..shard-{ring_n - 1}); "
                f"check --num-shards")
    store = SnapshotStore()
    replica_id = ns.replica_id or f"replica-{os.getpid()}"
    root = RootAggregator(
        topology, store, timeout_s=ns.timeout_s,
        loop_overruns_fn=lambda: loop.overruns,
        targets_file=ns.targets_file,
        shard_map=shard_map,
        stale_serve_s=ns.stale_serve_s,
        render_splice=ns.render_splice == "on",
    )
    plane: Any = None
    inner_plane: Any = None
    if ns.fleet_query == "on":
        inner_plane = RootQueryPlane(
            topology, timeout_s=ns.timeout_s + 0.5,
            leaf_breakers=root._breakers,
            generation_fn=lambda: root.rounds)
        plane = ReplicaSourceProxy(
            inner_plane,
            replica_id=replica_id,
            root_url=ns.root_url,
        )
        root.emit_hooks.append(plane.emit)
    else:
        # Identity must publish even without a query plane — clients and
        # drills probe tpu_replica_info to tell a replica from the root.
        def _emit_identity(b: SnapshotBuilder) -> None:
            for spec in schema.REPLICA_SPECS:
                b.declare(spec)
            b.add(schema.TPU_REPLICA_INFO, 1.0, (replica_id,))

        root.emit_hooks.append(_emit_identity)
    hub, pump = _attach_stream_cli(ns, root, plane)
    governor: Any = None
    if ns.memory_budget_mb > 0:
        from tpu_pod_exporter_torch.pressure import build_serving_governor

        governor = build_serving_governor(
            int(ns.memory_budget_mb * (1 << 20)),
            cache_plane=inner_plane, hub=hub,
        )
    loop = CollectorLoop(root, interval_s=ns.interval_s)
    server = MetricsServer(
        store, host=ns.host, port=ns.port,
        health_max_age_s=max(10.0 * ns.interval_s, 10.0),
        debug_vars=root.debug_vars, debug_addr=ns.debug_addr, fleet=plane,
        ready_detail_fn=root.ready_detail,
        stream_hub=hub,
    )
    root.poll_once()
    log.info("replica %s merging %d shard(s) / %d leaf(s) READ-ONLY on "
             ":%d every %.1fs (store proxy: %s)",
             replica_id, len(topology),
             sum(len(v) for v in topology.values()),
             server.port, ns.interval_s, ns.root_url or "off")
    closers = [c for c in (pump, hub, plane, governor, root)
               if c is not None]
    return _serve_until_signal(loop, server, closers)


if __name__ == "__main__":
    import sys

    sys.exit(main())
