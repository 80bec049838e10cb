"""The cases of tests/test_shard.py against ``tpu_pod_exporter_torch``, with the
imports renamed; the shard demo waits for the port's ``loadgen.fleet``.

Sharded HA aggregation tree (tpu_pod_exporter_torch.shard) tests.

Covers the acceptance surface:

- consistent-hash properties: assignment stability, bounded movement on
  target add/remove (only the churned targets move) and shard add/remove
  (≤ targets/n + slack), shard-map persistence roundtrip across a leaf
  restart;
- TargetSet live membership (--targets-file mtime reload, filter cut,
  breaker carryover for targets that reshard in);
- leaf component emission and the root's freshest-wins HA dedup (zero
  series loss when one HA leaf dies, stale-win counting when the freshest
  leaf lacks a series);
- root rollups equal to a flat single-aggregator oracle over the same
  scrape set;
- the two-level query plane's envelope (per-leaf state + per-target
  state, uncovered-shard partiality);
- the chaos leaf-kill timeline grammar and hook;
- status --tree rendering.
"""

from __future__ import annotations

import math
import os
import time

import pytest

from tpu_pod_exporter_torch import shard as sh
from tpu_pod_exporter_torch.aggregate import (
    SliceAggregator,
    TargetSet,
    read_targets_file,
)
from tpu_pod_exporter_torch.metrics import SnapshotStore, schema
from tpu_pod_exporter_torch.metrics.parse import parse_families


# --------------------------------------------------------------- fixtures


def node_body(idx: int, rnd: int = 0, chips: int = 2, n_slices: int = 4) -> str:
    """Deterministic synthetic exporter body for target ``idx`` at round
    ``rnd`` — the no-sockets twin of loadgen's SynthTargetFarm.body."""
    sl = idx % n_slices
    host = f"host-{idx:04d}"
    base = (f'accelerator="v5p-sim",slice_name="slice-{sl}",host="{host}",'
            f'worker_id="{idx}"')
    pod = f"job-{idx % 5}"
    lines = []
    pod_hbm = 0.0
    for c in range(chips):
        cl = (f'chip_id="{c}",device_path="",{base},pod="{pod}",'
              f'namespace="sim",container="w"')
        hbm = float((idx + 1) * 2**20 + rnd * 65536 + c * 4096)
        pod_hbm += hbm
        lines.append(f'tpu_chip_info{{{cl},device_kind="",coords=""}} 1')
        lines.append(f'tpu_hbm_used_bytes{{{cl}}} {hbm:.1f}')
        lines.append(f'tpu_hbm_total_bytes{{{cl}}} {float(96 * 2**30):.1f}')
        lines.append(
            f'tpu_tensorcore_duty_cycle_percent{{{cl}}} '
            f'{float((idx * 7 + c + rnd) % 100):.1f}')
    lines.append(
        f'tpu_host_info{{{base},multislice_group="ms-{sl % 2}",'
        f'num_slices="2"}} 1')
    lines.append(
        f'tpu_pod_chip_count{{pod="{pod}",namespace="sim",{base}}} {chips}')
    lines.append(
        f'tpu_pod_hbm_used_bytes{{pod="{pod}",namespace="sim",{base}}} '
        f'{pod_hbm:.1f}')
    return "\n".join(lines) + "\n"


def target_name(idx: int) -> str:
    return f"h{idx}:8000"


def make_fetch(rnd_ref, down=()):
    down = set(down)

    def fetch(target, timeout_s):
        if target in down:
            raise ConnectionError(f"{target} down")
        idx = int(target.split(":")[0][1:])
        return node_body(idx, rnd_ref[0])

    return fetch


ROLLUPS = (
    "tpu_slice_hosts_reporting",
    "tpu_slice_chip_count",
    "tpu_slice_hbm_used_bytes",
    "tpu_slice_hbm_total_bytes",
    "tpu_slice_hbm_used_percent",
    "tpu_slice_tensorcore_duty_cycle_avg_percent",
    "tpu_multislice_slices_reporting",
    "tpu_multislice_hosts_reporting",
    "tpu_multislice_chip_count",
    "tpu_multislice_hbm_used_bytes",
    "tpu_workload_chip_count",
    "tpu_workload_hbm_used_bytes",
    "tpu_workload_hosts",
    "tpu_aggregator_target_up",
)


def rollup_map(text: str) -> dict:
    fams = parse_families(text)
    out = {}
    for name in ROLLUPS:
        for s in fams.get(name, ()):
            out[(name, tuple(sorted(s.labels.items())))] = s.value
    return out


def build_tree(targets, shards=2, ha=True, rnd_ref=None, down=()):
    """In-process tree over injected fetches: {leaf addr: (agg, store)},
    topology, shard map."""
    rnd_ref = rnd_ref if rnd_ref is not None else [0]
    fetch = make_fetch(rnd_ref, down)
    smap = sh.ShardMap(sh.default_shards(shards))
    leaves = {}
    topo = {}
    for si in range(shards):
        shard_id = f"shard-{si}"
        addrs = []
        for suffix in ("a", "b") if ha else ("a",):
            store = SnapshotStore()
            agg = sh.LeafAggregator(
                shard_id, f"{si}{suffix}", smap,
                targets=targets, store=store, fetch=fetch,
            )
            addr = f"leaf-{si}{suffix}:9100"
            leaves[addr] = (agg, store)
            addrs.append(addr)
        topo[shard_id] = tuple(addrs)
    return leaves, topo, smap, fetch, rnd_ref


def leaf_fetch_for(leaves, dead=()):
    dead = set(dead)

    def leaf_fetch(addr, timeout_s):
        if addr in dead:
            raise ConnectionError(f"{addr} killed")
        return leaves[addr][1].current().encode().decode()

    return leaf_fetch


# ------------------------------------------------------------- ShardMap


class TestShardMap:
    def test_assignment_stability(self):
        targets = [target_name(i) for i in range(500)]
        a = sh.ShardMap(sh.default_shards(8)).assignments(targets)
        b = sh.ShardMap(sh.default_shards(8)).assignments(targets)
        assert a == b

    def test_every_target_assigned_to_known_shard(self):
        m = sh.ShardMap(sh.default_shards(5))
        for i in range(200):
            assert m.assign(target_name(i)) in m.shards

    def test_distribution_roughly_even(self):
        m = sh.ShardMap(sh.default_shards(8))
        counts: dict[str, int] = {}
        for i in range(2000):
            s = m.assign(target_name(i))
            counts[s] = counts.get(s, 0) + 1
        # vnodes=64 keeps the spread within ~2x of ideal.
        ideal = 2000 / 8
        assert min(counts.values()) > ideal / 2
        assert max(counts.values()) < ideal * 2

    @pytest.mark.parametrize("seed", range(5))
    def test_target_churn_moves_only_churned_targets(self, seed):
        m = sh.ShardMap(sh.default_shards(8))
        targets = [target_name(seed * 1000 + i) for i in range(300)]
        before = m.assignments(targets)
        removed = targets[seed::17][:16]
        added = [target_name(seed * 1000 + 1000 + i) for i in range(16)]
        after_targets = [t for t in targets if t not in removed] + added
        after = m.assignments(after_targets)
        # Surviving targets NEVER move on pure target churn.
        for t in set(targets) & set(after_targets):
            assert before[t] == after[t]
        moves = sh.count_moves(before, after)
        assert moves == len(removed) + len(added)
        # The acceptance bound, with slack: churned + targets/shards.
        assert moves <= 32 + len(after_targets) // 8

    @pytest.mark.parametrize("n,delta", [(4, 1), (8, 1), (8, -1)])
    def test_shard_churn_bounded_movement(self, n, delta):
        targets = [target_name(i) for i in range(800)]
        before = sh.ShardMap(sh.default_shards(n)).assignments(targets)
        after = sh.ShardMap(sh.default_shards(n + delta)).assignments(targets)
        moved = sum(1 for t in targets if before[t] != after[t])
        smaller = min(n, n + delta)
        # One shard's worth of arcs, with 2x slack for vnode variance.
        assert moved <= 2 * len(targets) // smaller

    def test_doc_roundtrip(self):
        m = sh.ShardMap(sh.default_shards(3), vnodes=16)
        m2 = sh.ShardMap.from_doc(m.to_doc())
        targets = [target_name(i) for i in range(100)]
        assert m.assignments(targets) == m2.assignments(targets)

    def test_rejects_empty(self):
        with pytest.raises(ValueError):
            sh.ShardMap([])
        with pytest.raises(ValueError):
            sh.default_shards(0)


class TestShardMapFile:
    def test_roundtrip_and_tolerant_load(self, tmp_path):
        from tpu_pod_exporter_torch.persist import ShardMapFile

        f = ShardMapFile(str(tmp_path / "map.json"))
        assert f.load() == {}
        f.save({"ring": {"shards": ["shard-0"], "vnodes": 8}, "moves": 3})
        doc = f.load()
        assert doc["moves"] == 3
        assert doc["ring"]["shards"] == ["shard-0"]
        # Corrupt file: tolerated, never refuses.
        (tmp_path / "map.json").write_bytes(b"{truncated")
        assert f.load() == {}


# ------------------------------------------------------------- TargetSet


class TestTargetSet:
    def test_static_membership(self):
        ts = TargetSet(("a:1", "b:1", "a:1"))
        assert ts.targets == ("a:1", "b:1")
        assert ts.refresh() == (0, 0)

    def test_filter_cut(self):
        ts = TargetSet(("a:1", "b:1", "c:1"),
                       filter_fn=lambda t: [x for x in t if x != "b:1"])
        assert ts.targets == ("a:1", "c:1")

    def test_file_reload_on_mtime_change(self, tmp_path):
        f = tmp_path / "targets"
        f.write_text("a:1\nb:1\n")
        ts = TargetSet(targets_file=str(f))
        assert ts.targets == ("a:1", "b:1")
        assert ts.moves == 0  # boot population is not churn
        f.write_text("a:1\nc:1\n# comment\n")
        os.utime(f, (time.time() + 5, time.time() + 5))
        assert ts.refresh() == (1, 1)
        assert ts.targets == ("a:1", "c:1")
        assert ts.moves == 2
        # Unchanged mtime: no reload work.
        assert ts.refresh() == (0, 0)

    def test_unreadable_file_keeps_membership(self, tmp_path):
        f = tmp_path / "targets"
        f.write_text("a:1\n")
        ts = TargetSet(targets_file=str(f))
        f.unlink()
        assert ts.refresh() == (0, 0)
        assert ts.targets == ("a:1",)

    def test_breakers_follow_membership(self):
        ts = TargetSet(("a:1", "b:1"), breaker_failures=2)
        assert set(ts.breakers) == {"a:1", "b:1"}
        br_map_identity = ts.breakers
        ts.set_targets(("b:1", "c:1"))
        assert set(ts.breakers) == {"b:1", "c:1"}
        # The dict OBJECT is stable: fleet-plane holders see live state.
        assert ts.breakers is br_map_identity

    def test_saved_breaker_restored_when_target_reshards_in(self, tmp_path):
        from tpu_pod_exporter_torch.persist import BreakerStateFile

        store = BreakerStateFile(str(tmp_path / "b.json"))
        ts = TargetSet(("a:1",), breaker_failures=1, breaker_store=store)
        ts.breakers["a:1"].record_failure()
        assert ts.breakers["a:1"].state != "closed"
        ts.maybe_save_breakers()
        # New process, target arrives LATER via a membership change: the
        # quarantine must still carry over.
        ts2 = TargetSet((), targets_file="", breaker_failures=1,
                        breaker_store=BreakerStateFile(str(tmp_path / "b.json")))
        ts2.set_targets(("a:1",))
        assert ts2.breakers["a:1"].state != "closed"

    def test_empty_reload_keeps_membership_and_breakers(self, tmp_path):
        # A truncated in-place rewrite reads as an EMPTY file for one
        # round; applying it would wipe every quarantine and empty the
        # fleet view. The reload must keep the last known membership.
        f = tmp_path / "targets"
        f.write_text("a:1\nb:1\n")
        ts = TargetSet(targets_file=str(f), breaker_failures=1)
        ts.breakers["a:1"].record_failure()
        assert ts.breakers["a:1"].state != "closed"
        f.write_text("")
        os.utime(f, (time.time() + 5, time.time() + 5))
        assert ts.refresh() == (0, 0)
        assert ts.targets == ("a:1", "b:1")
        assert ts.breakers["a:1"].state != "closed"
        # The repaired file (fresh mtime) applies normally.
        f.write_text("b:1\n")
        os.utime(f, (time.time() + 10, time.time() + 10))
        assert ts.refresh() == (0, 1)
        assert ts.targets == ("b:1",)

    def test_recovered_target_not_requarantined_from_stale_boot_doc(
            self, tmp_path):
        from tpu_pod_exporter_torch.persist import BreakerStateFile

        store = BreakerStateFile(str(tmp_path / "b.json"))
        ts = TargetSet(("a:1",), breaker_failures=1, breaker_store=store)
        ts.breakers["a:1"].record_failure()
        ts.maybe_save_breakers()
        # New process: boot restores OPEN, the target recovers...
        ts2 = TargetSet(("a:1",), breaker_failures=1,
                        breaker_store=BreakerStateFile(str(tmp_path / "b.json")))
        assert ts2.breakers["a:1"].state != "closed"
        ts2.breakers["a:1"].record_success()
        br = ts2.breakers["a:1"]
        while br.state != "closed":  # half_open probe path
            br.decide()
            br.record_success()
        # ...then bounces out and back: the consumed boot doc must NOT
        # re-quarantine the healthy target.
        ts2.set_targets(())
        ts2.set_targets(("a:1",))
        assert ts2.breakers["a:1"].state == "closed"

    def test_quarantine_survives_remove_readd_bounce(self):
        ts = TargetSet(("a:1", "b:1"), breaker_failures=1)
        ts.breakers["a:1"].record_failure()
        assert ts.breakers["a:1"].state != "closed"
        ts.set_targets(("b:1",))       # a:1 bounces out (partial read)...
        ts.set_targets(("a:1", "b:1"))  # ...and back next round
        assert ts.breakers["a:1"].state != "closed"

    def test_read_targets_file_grammar(self, tmp_path):
        f = tmp_path / "t"
        f.write_text("a:1, b:1\n# all of c\nc:1\n\na:1\n")
        assert read_targets_file(str(f)) == ("a:1", "b:1", "c:1")


# ---------------------------------------------------------------- leaf tier


class TestLeafAggregator:
    def test_shard_filter_partitions_targets(self):
        targets = tuple(target_name(i) for i in range(60))
        leaves, topo, smap, fetch, rnd = build_tree(targets, shards=3,
                                                    ha=False)
        owned = []
        for addr, (agg, _store) in leaves.items():
            owned.extend(agg.targets)
            for t in agg.targets:
                assert smap.assign(t) == agg.shard_id
        assert sorted(owned) == sorted(targets)

    def test_component_emission(self):
        targets = tuple(target_name(i) for i in range(10))
        leaves, topo, smap, fetch, rnd = build_tree(targets, shards=1,
                                                    ha=False)
        agg, store = leaves["leaf-0a:9100"]
        agg.poll_once()
        fams = parse_families(store.current().encode().decode())
        comp = fams[schema.TPU_LEAF_SLICE_COMPONENT.name]
        fields = {s.labels["field"] for s in comp}
        assert fields == set(schema.LEAF_SLICE_FIELDS)
        # chips component must agree with the public rollup.
        chips_pub = {
            s.labels["slice_name"]: s.value
            for s in fams["tpu_slice_chip_count"]
        }
        chips_comp = {
            s.labels["slice_name"]: s.value
            for s in comp if s.labels["field"] == "chips"
        }
        assert chips_pub == chips_comp
        info = fams[schema.TPU_LEAF_SHARD_INFO.name][0]
        assert info.labels["shard"] == "shard-0"
        assert fams[schema.TPU_LEAF_TARGETS.name][0].value == 10.0
        assert schema.TPU_LEAF_WORKLOAD_COMPONENT.name in fams
        assert schema.TPU_LEAF_SLICE_GROUP_INFO.name in fams

    def test_live_reshard_via_targets_file(self, tmp_path):
        f = tmp_path / "targets"
        targets = [target_name(i) for i in range(20)]
        f.write_text("\n".join(targets) + "\n")
        rnd = [0]
        smap = sh.ShardMap(sh.default_shards(2))
        store = SnapshotStore()
        agg = sh.LeafAggregator(
            "shard-0", "0a", smap, targets_file=str(f),
            store=store, fetch=make_fetch(rnd),
        )
        before = set(agg.targets)
        assert all(smap.assign(t) == "shard-0" for t in before)
        # Churn the GLOBAL list; the leaf keeps only its own cut.
        added = [target_name(100 + i) for i in range(10)]
        f.write_text("\n".join(targets[5:] + added) + "\n")
        os.utime(f, (time.time() + 5, time.time() + 5))
        agg.poll_once()
        after = set(agg.targets)
        assert all(smap.assign(t) == "shard-0" for t in after)
        expected = {
            t for t in (targets[5:] + added) if smap.assign(t) == "shard-0"
        }
        assert after == expected
        # Moves counted = targets that entered/left THIS shard.
        delta = len(before - after) + len(after - before)
        assert agg._tset.moves == delta

    def test_shard_map_persistence_roundtrip_across_restart(self, tmp_path):
        from tpu_pod_exporter_torch.persist import ShardMapFile

        f = tmp_path / "targets"
        targets = [target_name(i) for i in range(20)]
        f.write_text("\n".join(targets) + "\n")
        rnd = [0]
        smap = sh.ShardMap(sh.default_shards(2))
        mstore = ShardMapFile(str(tmp_path / "map.json"))
        agg = sh.LeafAggregator(
            "shard-0", "0a", smap, shard_map_store=mstore,
            targets_file=str(f), store=SnapshotStore(),
            fetch=make_fetch(rnd),
        )
        first = set(agg.targets)
        # Reshard while "down": rewrite the file, then boot a NEW leaf on
        # the same store — the boot delta counts as moves, carried on top
        # of the restored counter.
        added = [target_name(200 + i) for i in range(8)]
        f.write_text("\n".join(targets[4:] + added) + "\n")
        os.utime(f, (time.time() + 5, time.time() + 5))
        agg2 = sh.LeafAggregator(
            "shard-0", "0a", smap,
            shard_map_store=ShardMapFile(str(tmp_path / "map.json")),
            targets_file=str(f), store=SnapshotStore(),
            fetch=make_fetch(rnd),
        )
        second = set(agg2.targets)
        delta = len(first - second) + len(second - first)
        assert agg2._tset.moves == delta
        doc = ShardMapFile(str(tmp_path / "map.json")).load()
        assert doc["ring"] == smap.to_doc()
        assert set(doc["assigned"]) == second


# ------------------------------------------------------- root merge / dedup


class TestMergeShardViews:
    def _view(self, leaf, ts, slices=None, targets=None):
        v = sh.LeafView(leaf=leaf, round_ts=ts)
        for key, chips in (slices or {}).items():
            v.slice_fields[key] = {"chips": chips, "hosts": 1.0}
        for t, up in (targets or {}).items():
            v.target_up[t] = up
        return v

    def test_freshest_leaf_wins_per_series(self):
        a = self._view("a", 100.0, slices={("s", "v"): 4.0},
                       targets={"t1": 1.0})
        b = self._view("b", 200.0, slices={("s", "v"): 8.0},
                       targets={"t1": 0.0})
        out = sh.merge_shard_views([a, b])
        assert out.slices[("s", "v")].chips == 8.0
        assert out.target_up["t1"] == (0.0, 200.0)
        assert out.stale_wins == 0

    def test_stale_win_counted_when_freshest_lacks_series(self):
        # b is freshest but mid-warmup: it has no view of slice ("s2","v")
        # or target t2 — the stale leaf's values must still land.
        a = self._view("a", 100.0,
                       slices={("s", "v"): 4.0, ("s2", "v"): 2.0},
                       targets={"t1": 1.0, "t2": 1.0})
        b = self._view("b", 200.0, slices={("s", "v"): 8.0},
                       targets={"t1": 1.0})
        out = sh.merge_shard_views([a, b])
        assert out.slices[("s2", "v")].chips == 2.0
        assert out.target_up["t2"] == (1.0, 100.0)
        assert out.stale_wins == 2
        assert out.slices[("s", "v")].chips == 8.0  # fresh one still wins

    def test_single_view_passthrough(self):
        a = self._view("a", 50.0, slices={("s", "v"): 4.0})
        out = sh.merge_shard_views([a])
        assert out.slices[("s", "v")].chips == 4.0
        assert out.stale_wins == 0

    def test_empty(self):
        out = sh.merge_shard_views([])
        assert out.slices == {} and out.stale_wins == 0


class TestRootAggregator:
    def test_root_equals_flat_oracle(self):
        targets = tuple(target_name(i) for i in range(40))
        rnd = [0]
        leaves, topo, smap, fetch, rnd = build_tree(targets, shards=2,
                                                    ha=True, rnd_ref=rnd)
        for agg, _s in leaves.values():
            agg.poll_once()
        root_store = SnapshotStore()
        root = sh.RootAggregator(topo, root_store,
                                 fetch=leaf_fetch_for(leaves))
        root.poll_once()
        oracle_store = SnapshotStore()
        oracle = SliceAggregator(targets, oracle_store,
                                 fetch=make_fetch(rnd))
        oracle.poll_once()
        rm = rollup_map(root_store.current().encode().decode())
        om = rollup_map(oracle_store.current().encode().decode())
        assert set(rm) == set(om)
        for k in om:
            assert math.isclose(rm[k], om[k], rel_tol=1e-9), (k, rm[k], om[k])
        root.close()
        oracle.close()

    def test_ha_leaf_death_loses_zero_series(self):
        targets = tuple(target_name(i) for i in range(40))
        leaves, topo, smap, fetch, rnd = build_tree(targets, shards=2,
                                                    ha=True)
        for agg, _s in leaves.values():
            agg.poll_once()
        root_store = SnapshotStore()
        root = sh.RootAggregator(topo, root_store,
                                 fetch=leaf_fetch_for(leaves))
        root.poll_once()
        before = rollup_map(root_store.current().encode().decode())
        dead = topo["shard-0"][0]
        root._fetch = leaf_fetch_for(leaves, dead=[dead])
        root.poll_once()
        body = root_store.current().encode().decode()
        after = rollup_map(body)
        assert set(after) == set(before)
        for k in before:
            assert math.isclose(after[k], before[k], rel_tol=1e-9)
        fams = parse_families(body)
        up = {(s.labels["shard"], s.labels["leaf"]): s.value
              for s in fams[schema.TPU_ROOT_LEAF_UP.name]}
        assert up[("shard-0", dead)] == 0.0
        assert up[("shard-0", topo["shard-0"][1])] == 1.0
        root.close()

    def test_both_leaves_of_shard_dead_drops_only_that_shard(self):
        targets = tuple(target_name(i) for i in range(40))
        leaves, topo, smap, fetch, rnd = build_tree(targets, shards=2,
                                                    ha=True)
        for agg, _s in leaves.values():
            agg.poll_once()
        root_store = SnapshotStore()
        root = sh.RootAggregator(
            topo, root_store,
            fetch=leaf_fetch_for(leaves, dead=list(topo["shard-0"])),
            breaker_failures=0,
        )
        root.poll_once()
        fams = parse_families(root_store.current().encode().decode())
        up_targets = {s.labels["target"]
                      for s in fams["tpu_aggregator_target_up"]}
        shard1_targets = {t for t in targets
                          if smap.assign(t) == "shard-1"}
        assert up_targets == shard1_targets
        root.close()

    def test_shard_claim_mismatch_rejected(self):
        targets = tuple(target_name(i) for i in range(10))
        leaves, topo, smap, fetch, rnd = build_tree(targets, shards=2,
                                                    ha=False)
        for agg, _s in leaves.values():
            agg.poll_once()
        # Cross-wire: put shard-1's leaf under shard-0 in the topology.
        bad_topo = {"shard-0": (topo["shard-1"][0],)}
        root_store = SnapshotStore()
        root = sh.RootAggregator(bad_topo, root_store,
                                 fetch=leaf_fetch_for(leaves))
        root.poll_once()
        fams = parse_families(root_store.current().encode().decode())
        up = {s.labels["leaf"]: s.value
              for s in fams[schema.TPU_ROOT_LEAF_UP.name]}
        # The mis-claimed body is refused: the leaf reads down.
        assert up[topo["shard-1"][0]] == 0.0
        root.close()

    def test_removed_target_counter_series_pruned(self, tmp_path):
        # Per-target counters must leave the exposition with the target:
        # on a churning fleet they would otherwise accumulate forever.
        f = tmp_path / "targets"
        f.write_text("h1:8000\nh2:8000\n")
        rnd = [0]

        def fetch(target, timeout_s):
            if target == "h1:8000":
                raise ConnectionError("down")
            return node_body(2, rnd[0])

        store = SnapshotStore()
        agg = SliceAggregator((), store, fetch=fetch, breaker_failures=0,
                              targets_file=str(f))
        agg.poll_once()
        fams = parse_families(store.current().encode().decode())
        errs = {s.labels["target"]
                for s in fams["tpu_aggregator_scrape_errors_total"]}
        assert errs == {"h1:8000"}
        f.write_text("h2:8000\n")
        os.utime(f, (time.time() + 5, time.time() + 5))
        agg.poll_once()
        fams = parse_families(store.current().encode().decode())
        assert "tpu_aggregator_scrape_errors_total" not in fams or not [
            s for s in fams["tpu_aggregator_scrape_errors_total"]
            if s.labels["target"] == "h1:8000"
        ]
        agg.close()

    def test_root_empty_targets_file_keeps_assignments(self, tmp_path):
        targets = [target_name(i) for i in range(20)]
        f = tmp_path / "targets"
        f.write_text("\n".join(targets) + "\n")
        leaves, topo, smap, fetch, rnd = build_tree(tuple(targets),
                                                    shards=2, ha=False)
        for agg, _s in leaves.values():
            agg.poll_once()
        root_store = SnapshotStore()
        root = sh.RootAggregator(topo, root_store,
                                 fetch=leaf_fetch_for(leaves),
                                 targets_file=str(f), shard_map=smap)
        root.poll_once()
        f.write_text("")  # torn in-place rewrite reads empty for a round
        os.utime(f, (time.time() + 5, time.time() + 5))
        root.poll_once()
        fams = parse_families(root_store.current().encode().decode())
        assert fams[schema.TPU_ROOT_RESHARD_MOVES_TOTAL.name][0].value == 0.0
        root.close()

    def test_ring_mismatch_rejected(self):
        # Same shard id, different ring: a leaf restarted with a new
        # --num-shards covers a different target subset — summing its
        # body would double-count. The root must refuse it.
        targets = tuple(target_name(i) for i in range(10))
        rnd = [0]
        smap16 = sh.ShardMap(sh.default_shards(16))
        store = SnapshotStore()
        agg = sh.LeafAggregator("shard-0", "0a", smap16, targets=targets,
                                store=store, fetch=make_fetch(rnd))
        agg.poll_once()
        leaves = {"leaf-0a:9100": (agg, store)}
        root_store = SnapshotStore()
        root = sh.RootAggregator(
            {"shard-0": ("leaf-0a:9100",)}, root_store,
            fetch=leaf_fetch_for(leaves),
            shard_map=sh.ShardMap(sh.default_shards(8)),
        )
        root.poll_once()
        fams = parse_families(root_store.current().encode().decode())
        up = {s.labels["leaf"]: s.value
              for s in fams[schema.TPU_ROOT_LEAF_UP.name]}
        assert up["leaf-0a:9100"] == 0.0
        root.close()
        agg.close()

    def test_reshard_accounting_via_targets_file(self, tmp_path):
        from tpu_pod_exporter_torch.persist import ShardMapFile

        targets = [target_name(i) for i in range(30)]
        f = tmp_path / "targets"
        f.write_text("\n".join(targets) + "\n")
        leaves, topo, smap, fetch, rnd = build_tree(tuple(targets),
                                                    shards=2, ha=False)
        for agg, _s in leaves.values():
            agg.poll_once()
        root_store = SnapshotStore()
        root = sh.RootAggregator(
            topo, root_store, fetch=leaf_fetch_for(leaves),
            targets_file=str(f), shard_map=smap,
            shard_map_store=ShardMapFile(str(tmp_path / "rm.json")),
        )
        root.poll_once()
        fams = parse_families(root_store.current().encode().decode())
        assert fams[schema.TPU_ROOT_RESHARD_MOVES_TOTAL.name][0].value == 0.0
        f.write_text("\n".join(targets[4:]) + "\n")
        os.utime(f, (time.time() + 5, time.time() + 5))
        root.poll_once()
        fams = parse_families(root_store.current().encode().decode())
        assert fams[schema.TPU_ROOT_RESHARD_MOVES_TOTAL.name][0].value == 4.0
        # Restart: counter restored from the shard-map file.
        root2 = sh.RootAggregator(
            topo, SnapshotStore(), fetch=leaf_fetch_for(leaves),
            targets_file=str(f), shard_map=smap,
            shard_map_store=ShardMapFile(str(tmp_path / "rm.json")),
        )
        store2 = root2._store
        root2.poll_once()
        fams = parse_families(store2.current().encode().decode())
        assert fams[schema.TPU_ROOT_RESHARD_MOVES_TOTAL.name][0].value == 4.0
        root.close()
        root2.close()


class TestParseLeafTopology:
    def test_grammar(self):
        topo = sh.parse_leaf_topology(
            "shard-0=a:1|b:1, shard-1=c:1")
        assert topo == {"shard-0": ("a:1", "b:1"), "shard-1": ("c:1",)}

    @pytest.mark.parametrize("bad", [
        "", "shard-0", "shard-0=", "=a:1", "shard-0=a:1,shard-0=b:1",
    ])
    def test_rejects(self, bad):
        with pytest.raises(ValueError):
            sh.parse_leaf_topology(bad)


# ------------------------------------------------------ two-level queries


class TestRootQueryPlane:
    def _leaf_env(self, rows, targets=None, partial=False):
        return {
            "status": "ok", "partial": partial,
            "data": {"result": rows},
            "targets": targets or {},
        }

    def _row(self, metric, host, value, ts):
        return {"metric": metric, "labels": {"host": host},
                "stats": {"last": value}, "last_sample_wall_ts": ts}

    def test_ha_dedup_freshest_row_wins(self):
        topo = {"shard-0": ("la:1", "lb:1")}
        envs = {
            "la:1": self._leaf_env(
                [self._row("m", "h0", 1.0, 100.0)],
                targets={"t0": {"state": "ok"}}),
            "lb:1": self._leaf_env(
                [self._row("m", "h0", 2.0, 200.0)],
                targets={"t0": {"state": "ok"}}),
        }

        def fetch(url, timeout_s):
            for leaf, env in envs.items():
                if leaf.split(":")[0] in url:
                    return env
            raise ConnectionError(url)

        plane = sh.RootQueryPlane(topo, fetch=fetch)
        out = plane.window_stats("m")
        assert out["partial"] is False
        rows = out["data"]["result"]
        assert len(rows) == 1 and rows[0]["stats"]["last"] == 2.0
        assert out["fleet"]["duplicate_series"] == 1
        assert out["leaves"]["la:1"]["state"] == "ok"
        assert out["targets"]["t0"]["state"] == "ok"
        plane.close()

    def test_dead_leaf_with_live_twin_not_partial(self):
        topo = {"shard-0": ("la:1", "lb:1")}

        def fetch(url, timeout_s):
            if "la" in url:
                raise ConnectionError("down")
            return self._leaf_env([self._row("m", "h0", 2.0, 200.0)],
                                  targets={"t0": {"state": "ok"}})

        plane = sh.RootQueryPlane(topo, fetch=fetch)
        out = plane.window_stats("m")
        assert out["partial"] is False
        assert out["leaves"]["la:1"]["state"] == "error"
        assert out["fleet"]["uncovered_shards"] == []
        plane.close()

    def test_uncovered_shard_is_partial(self):
        topo = {"shard-0": ("la:1",), "shard-1": ("lb:1",)}

        def fetch(url, timeout_s):
            if "la" in url:
                raise ConnectionError("down")
            return self._leaf_env([self._row("m", "h1", 1.0, 10.0)])

        plane = sh.RootQueryPlane(topo, fetch=fetch)
        out = plane.window_stats("m")
        assert out["partial"] is True
        assert out["fleet"]["uncovered_shards"] == ["shard-0"]
        plane.close()

    def test_404_everywhere_is_no_data_not_partial(self):
        import urllib.error

        topo = {"shard-0": ("la:1",)}

        def fetch(url, timeout_s):
            raise urllib.error.HTTPError(url, 404, "nf", None, None)

        plane = sh.RootQueryPlane(topo, fetch=fetch)
        out = plane.window_stats("m")
        assert out["partial"] is False
        assert out["leaves"]["la:1"]["state"] == "no_data"
        assert out["data"]["result"] == []
        plane.close()

    def test_slow_leaf_marked_timeout_within_overall_deadline(self):
        # A leaf drip-feeding bytes keeps every socket op under the fetch
        # timeout; the ONE overall deadline must mark it `timeout` and
        # answer from the live twin instead of blocking the query.
        topo = {"shard-0": ("la:1", "lb:1")}

        def fetch(url, timeout_s):
            if "la" in url:
                time.sleep(5.0)  # well past the 0.2 + 0.5 deadline
                return self._leaf_env([])
            return self._leaf_env([self._row("m", "h0", 2.0, 200.0)])

        plane = sh.RootQueryPlane(topo, timeout_s=0.2, fetch=fetch)
        t0 = time.monotonic()
        out = plane.window_stats("m")
        assert time.monotonic() - t0 < 3.0
        assert out["leaves"]["la:1"]["state"] == "timeout"
        assert out["leaves"]["lb:1"]["state"] == "ok"
        assert out["partial"] is False  # twin covers the shard
        assert out["data"]["result"][0]["stats"]["last"] == 2.0
        plane.close()

    def test_target_state_best_wins(self):
        topo = {"shard-0": ("la:1", "lb:1")}
        envs = {
            "la": self._leaf_env([], targets={"t0": {"state": "error"}},
                                 partial=True),
            "lb": self._leaf_env([], targets={"t0": {"state": "ok"}}),
        }

        def fetch(url, timeout_s):
            return envs["la" if "la" in url else "lb"]

        plane = sh.RootQueryPlane(topo, fetch=fetch)
        out = plane.window_stats("m")
        assert out["targets"]["t0"]["state"] == "ok"
        assert out["partial"] is False
        plane.close()


# --------------------------------------------------------------- leaf chaos


class TestLeafTimeline:
    def test_parse(self):
        from tpu_pod_exporter_torch.chaos import parse_leaf_timeline

        evs = parse_leaf_timeline("kill:1a@3#12, restart:1a@6")
        assert [(e.action, e.leaf, e.round_idx, e.at_call) for e in evs] == [
            ("kill", "1a", 3, 12), ("restart", "1a", 6, None)]

    @pytest.mark.parametrize("bad", [
        "", "boom:1a@3", "kill:1a", "kill:1a@x", "restart:1a@3#5",
    ])
    def test_parse_rejects(self, bad):
        from tpu_pod_exporter_torch.chaos import parse_leaf_timeline

        with pytest.raises(ValueError):
            parse_leaf_timeline(bad)

    def test_hook_fires_at_coordinates(self):
        from tpu_pod_exporter_torch.chaos import LeafKillHook, parse_leaf_timeline

        killed, restarted = [], []
        hook = LeafKillHook(
            parse_leaf_timeline("kill:1a@2#3,restart:1a@4,kill:0b@5"),
            kill_fn=killed.append, restart_fn=restarted.append,
        )
        hook.begin_round(2)
        assert killed == []  # mid-round kill waits for its scrape index
        assert hook.on_scrape("1a", 2, 1) is False
        assert hook.on_scrape("1a", 2, 3) is True
        assert hook.on_scrape("1a", 2, 4) is False  # one-shot
        assert killed == ["1a"]
        hook.begin_round(4)
        assert restarted == ["1a"]
        hook.begin_round(5)
        assert killed == ["1a", "0b"]  # whole-round kill, no #call
        assert hook.executed == [
            (2, "kill", "1a"), (4, "restart", "1a"), (5, "kill", "0b")]


# -------------------------------------------------------------- status --tree


class TestStatusTree:
    def test_fetch_and_render(self):
        from tpu_pod_exporter_torch.server import MetricsServer
        from tpu_pod_exporter_torch.status import fetch_tree, render_tree

        targets = tuple(target_name(i) for i in range(20))
        leaves, topo, smap, fetch, rnd = build_tree(targets, shards=2,
                                                    ha=True)
        for agg, _s in leaves.values():
            agg.poll_once()
        root_store = SnapshotStore()
        dead = topo["shard-1"][0]
        root = sh.RootAggregator(topo, root_store,
                                 fetch=leaf_fetch_for(leaves, dead=[dead]))
        root.poll_once()
        srv = MetricsServer(root_store, host="127.0.0.1", port=0)
        srv.start()
        try:
            doc = fetch_tree(f"127.0.0.1:{srv.port}")
        finally:
            srv.stop()
            root.close()
        assert set(doc["shards"]) == {"shard-0", "shard-1"}
        assert doc["shards"]["shard-1"]["leaves"][dead]["up"] == 0.0
        assert doc["fleet"]["targets"] == 20
        text = render_tree(doc)
        assert "shard-0" in text and "DOWN" in text
        assert "fleet:" in text and "leaves down:" in text
