"""The cases of tests/test_store.py against ``tpu_pod_exporter_torch``, with the
imports renamed; the root wiring case (``loadgen.fleet._ShardSim``) and the
store_continuity drill wait for the port's ``loadgen`` fleet and scenario
modules.

Fleet TSDB-lite: durable, queryable fleet history at the root.

Covers the tier generalization (disk-backed TierRing push/replay/
accumulator-restore), recording-rule parsing + evaluation, the FleetStore
append/query/persistence contract, the seeded torn-segment fuzz (boot
always succeeds, restored buckets are a clean prefix, no duplicate bucket
on replay), the store_thin pressure rung, the source-aware query plane,
the cross-tier ``source`` envelope contract (node == leaf == root shapes),
root wiring + exposition, the status --tree store footer, and the
store_continuity scenario drill with its store-off negative control.
"""

import json
import os
import random
import urllib.error
import urllib.request

import pytest

from tpu_pod_exporter_torch.history import HistoryStore, TierRing, tier_items
from tpu_pod_exporter_torch.metrics import SnapshotBuilder, SnapshotStore, schema
from tpu_pod_exporter_torch.store import (
    DEFAULT_STORE_TIERS,
    FleetStore,
    StoreQueryPlane,
    evaluate_rule,
    parse_rules,
    series_key,
    store_status_summary,
)

BASE_WALL = 1_700_000_000.0


@pytest.fixture
def quiet_logs():
    """Silence the stack's WARNING chatter for the e2e runs (the
    test_scenario.py fixture, local twin)."""
    import logging

    loggers = [logging.getLogger(f"tpu_pod_exporter_torch.{n}")
               for n in ("shard", "aggregate", "fleet", "store",
                         "pressure", "chaos", "server")]
    old = [lg.level for lg in loggers]
    for lg in loggers:
        lg.setLevel(logging.ERROR)
    yield
    for lg, lv in zip(loggers, old):
        lg.setLevel(lv)


def get_json(url):
    try:
        resp = urllib.request.urlopen(url, timeout=5)
        return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def fleet_snapshot(r, n_targets=4, n_slices=2, wall=BASE_WALL):
    """One root-shaped published snapshot: per-target up + slice rollups."""
    b = SnapshotBuilder()
    b.declare(schema.TPU_AGG_TARGET_UP)
    b.declare(schema.TPU_SLICE_HBM_USED_BYTES)
    b.declare(schema.TPU_SLICE_CHIP_COUNT)
    for i in range(n_targets):
        b.add(schema.TPU_AGG_TARGET_UP,
              0.0 if (i + r) % 19 == 0 else 1.0, (f"t{i}",))
    for sl in range(n_slices):
        b.add(schema.TPU_SLICE_HBM_USED_BYTES,
              float(1000 * (sl + 1) + r), (f"slice-{sl}", "v5p", "tpu"))
        b.add(schema.TPU_SLICE_CHIP_COUNT, 8.0, (f"slice-{sl}", "v5p", "tpu"))
    return b.build(timestamp=wall)


def make_store(tmp_path, tiers="10:20,60:40", rules_text="", **kw):
    rules = parse_rules(rules_text) if rules_text else ()
    st = FleetStore(str(tmp_path / "store"), tiers=tiers, rules=rules, **kw)
    st.open()
    return st


def feed_rounds(store, n, dt=10.0, start_wall=BASE_WALL, **snap_kw):
    wall = start_wall
    for r in range(n):
        wall += dt
        store.append_snapshot(fleet_snapshot(r, wall=wall, **snap_kw),
                              now_wall=wall)
    return wall


# ------------------------------------------------------ tier generalization


class TestTierGeneralization:
    def bucket(self, bid, step=10.0, v=1.0, cnt=2.0):
        t0 = bid * step + 1.0
        return (t0, t0 + 5, t0, t0 + 5, v, v + 1, v * cnt, cnt, v, v + 1,
                0.5)

    def test_push_keeps_order_and_wraps(self):
        r = TierRing(10.0, 3)
        for bid in range(5):
            r.push(self.bucket(bid))
        ids = [int(b[2] // 10.0) for b in tier_items(r.copy())]
        assert ids == [2, 3, 4]  # newest kept, oldest evicted

    def test_push_same_bucket_replaces(self):
        r = TierRing(10.0, 4)
        r.push(self.bucket(7, v=1.0))
        r.push(self.bucket(7, v=9.0))  # re-finalization record supersedes
        items = tier_items(r.copy())
        assert len(items) == 1
        assert items[0][4] == 9.0

    def test_pop_to_accumulator_merges_same_bucket(self):
        r = TierRing(10.0, 4)
        r.push(self.bucket(3, v=5.0, cnt=2.0))
        r.pop_to_accumulator()
        assert r.n == 0
        assert r.bucket == 3
        # A live sample in the SAME wall bucket merges exactly.
        r.add(36.0, 36.0, 7.0, 2.0)
        ob = r.open_bucket()
        assert ob is not None
        assert ob[7] == 3.0        # cnt resumed: 2 restored + 1 live
        assert ob[5] == 7.0        # max updated
        assert ob[8] == 5.0        # first preserved from the restore

    def test_open_bucket_none_when_empty(self):
        assert TierRing(10.0, 4).open_bucket() is None


# --------------------------------------------------------- recording rules


class TestRules:
    def test_parse_happy_path(self):
        rules = parse_rules(
            "# comment\n"
            "\n"
            "fleet:hbm:by_slice = sum(tpu_slice_hbm_used_bytes) "
            "by (slice_name)\n"
            'up:count = count(tpu_aggregator_target_up{target="t1"})\n'
            "duty:avg = avg(tpu_slice_tensorcore_duty_cycle_avg_percent)\n"
        )
        assert [r.name for r in rules] == [
            "fleet:hbm:by_slice", "up:count", "duty:avg"]
        assert rules[0].by == ("slice_name",)
        assert rules[1].match == (("target", "t1"),)
        assert rules[2].by == ()

    @pytest.mark.parametrize("line,fragment", [
        ("bogus", "want name = agg"),
        ("x = frobnicate(tpu_slice_chip_count)", "unknown aggregation"),
        ("x = sum(no_such_metric)", "unknown metric"),
        ("x = sum(tpu_slice_chip_count) by (nope)", "not a label"),
        ('x = sum(tpu_slice_chip_count{nope="v"})', "not a label"),
        ("tpu_slice_chip_count = sum(tpu_slice_chip_count)", "shadows"),
        ("x = sum(tpu_slice_chip_count)\nx = sum(tpu_slice_chip_count)",
         "duplicate rule name"),
    ])
    def test_parse_errors_are_actionable(self, line, fragment):
        with pytest.raises(ValueError, match=fragment):
            parse_rules(line)

    def test_evaluate_sum_by_and_match(self):
        snap = fleet_snapshot(0, n_targets=6, n_slices=3)
        (rule,) = parse_rules(
            "s = sum(tpu_slice_hbm_used_bytes) by (slice_name)")
        out = dict((tuple(sorted(lbl.items())), v)
                   for lbl, v in evaluate_rule(rule, snap))
        assert out[(("slice_name", "slice-1"),)] == 2000.0
        (cnt,) = parse_rules("c = count(tpu_aggregator_target_up)")
        assert evaluate_rule(cnt, snap)[0][1] == 6.0
        (m,) = parse_rules(
            'm = max(tpu_slice_hbm_used_bytes{accelerator="v5p"})')
        assert evaluate_rule(m, snap)[0][1] == 3000.0

    def test_evaluate_absent_family_is_empty(self):
        (rule,) = parse_rules("d = sum(tpu_slice_dcn_bytes_per_second)")
        assert evaluate_rule(rule, fleet_snapshot(0)) == []


# --------------------------------------------------- append/query contract


class TestStoreAppendQuery:
    def test_rows_carry_source_tier_staleness(self, tmp_path):
        st = make_store(tmp_path)
        wall = feed_rounds(st, 12)
        rows = st.query_range(schema.TPU_SLICE_HBM_USED_BYTES.name,
                              {"slice_name": "slice-1"},
                              start=wall - 100, end=wall, step=0.0)
        assert len(rows) == 1
        row = rows[0]
        assert row["source"] == "store"
        assert row["tier"] == 10.0
        assert row["last_sample_wall_ts"] == wall
        assert len(row["values"]) >= 10
        st.close()

    def test_grid_and_agg(self, tmp_path):
        st = make_store(tmp_path)
        wall = feed_rounds(st, 12)
        rows = st.query_range(schema.TPU_SLICE_HBM_USED_BYTES.name,
                              {"slice_name": "slice-0"},
                              start=wall - 60, end=wall, step=10.0,
                              agg="min")
        assert rows and len(rows[0]["values"]) == 7
        # min over one-sample buckets == the sample
        assert rows[0]["values"][-1][1] == 1000.0 + 11

    def test_step_escalates_to_coarse_tier(self, tmp_path):
        st = make_store(tmp_path)
        wall = feed_rounds(st, 40)  # finest (cap 20) wrapped
        rows = st.query_range(schema.TPU_SLICE_CHIP_COUNT.name,
                              {"slice_name": "slice-0"},
                              start=wall - 390, end=wall, step=0.0)
        assert rows[0]["tier"] == 60.0  # escalated for coverage
        rows = st.query_range(schema.TPU_SLICE_CHIP_COUNT.name,
                              {"slice_name": "slice-0"},
                              start=wall - 100, end=wall, step=0.0)
        assert rows[0]["tier"] == 10.0

    def test_window_stats_and_counter_rate(self, tmp_path):
        st = make_store(tmp_path)
        wall = BASE_WALL
        for r in range(20):
            wall += 10.0
            st.append_samples(
                [("my_bytes_total", {"link": "0"}, 100.0 * r)],
                now_wall=wall)
        rows = st.window_stats("my_bytes_total", {"link": "0"},
                               window_s=150.0, now_wall=wall)
        assert rows[0]["source"] == "store"
        assert rows[0]["stats"]["rate"] == pytest.approx(10.0)
        st.close()

    def test_rule_series_stored(self, tmp_path):
        st = make_store(
            tmp_path,
            rules_text="fleet:hbm = sum(tpu_slice_hbm_used_bytes) "
                       "by (slice_name)")
        wall = feed_rounds(st, 6)
        rows = st.query_range("fleet:hbm", {"slice_name": "slice-0"},
                              start=wall - 100, end=wall, step=0.0)
        assert rows and rows[0]["values"][-1][1] == 1000.0 + 5
        assert st.stats()["rules"] == 1
        st.close()

    def test_series_list(self, tmp_path):
        st = make_store(tmp_path)
        feed_rounds(st, 3, n_targets=2, n_slices=1)
        names = {s["metric"] for s in st.series_list()}
        assert schema.TPU_AGG_TARGET_UP.name in names
        assert all(s["source"] == "store" for s in st.series_list())


# ----------------------------------------------------- persistence/replay


class TestPersistence:
    def test_restart_replays_and_continues(self, tmp_path):
        st = make_store(tmp_path)
        wall = feed_rounds(st, 15)
        before = st.query_range(schema.TPU_SLICE_HBM_USED_BYTES.name,
                                {"slice_name": "slice-0"},
                                start=0, end=wall, step=0.0)[0]["values"]
        st.close()
        st2 = make_store(tmp_path)
        after = st2.query_range(schema.TPU_SLICE_HBM_USED_BYTES.name,
                                {"slice_name": "slice-0"},
                                start=0, end=wall, step=0.0)[0]["values"]
        # Everything finalized before the restart answers after it.
        assert after == before
        # And live appends continue the same series with NO duplicate
        # bucket even when the first post-restart sample lands in the
        # same wall bucket the pre-restart accumulator owned.
        st2.append_snapshot(fleet_snapshot(15, wall=wall + 1.0),
                            now_wall=wall + 1.0)
        st2.append_snapshot(fleet_snapshot(16, wall=wall + 11.0),
                            now_wall=wall + 11.0)
        vals = st2.query_range(schema.TPU_SLICE_HBM_USED_BYTES.name,
                               {"slice_name": "slice-0"},
                               start=wall - 80, end=wall + 12,
                               step=0.0)[0]["values"]
        ids = [int(t // 10.0) for t, _v in vals]
        assert len(ids) == len(set(ids)), f"duplicate bucket: {ids}"
        st2.close()

    def test_same_bucket_merge_is_exact(self, tmp_path):
        st = make_store(tmp_path, tiers="100:10")
        st.append_samples([("g", {}, 1.0)], now_wall=BASE_WALL + 110.0)
        st.append_samples([("g", {}, 5.0)], now_wall=BASE_WALL + 120.0)
        st.close()
        st2 = make_store(tmp_path, tiers="100:10")
        st2.append_samples([("g", {}, 9.0)], now_wall=BASE_WALL + 130.0)
        rows = st2.window_stats("g", window_s=500.0,
                                now_wall=BASE_WALL + 130.0)
        s = rows[0]["stats"]
        assert s["samples"] == 3       # restored 2 + live 1, ONE bucket
        assert s["min"] == 1.0 and s["max"] == 9.0 and s["first"] == 1.0
        st2.close()

    def test_counter_rate_survives_restart(self, tmp_path):
        st = make_store(tmp_path, tiers="10:40")
        wall = BASE_WALL
        for r in range(8):
            wall += 10.0
            st.append_samples([("c_total", {}, 50.0 * r)], now_wall=wall)
        st.close()
        st2 = make_store(tmp_path, tiers="10:40")
        for r in range(8, 12):
            wall += 10.0
            st2.append_samples([("c_total", {}, 50.0 * r)], now_wall=wall)
        rows = st2.window_stats("c_total", window_s=110.0, now_wall=wall)
        # The boundary delta across the restart contributes: pv was
        # restored from the replayed accumulator, not re-learned as NaN.
        assert rows[0]["stats"]["rate"] == pytest.approx(5.0)
        st2.close()

    def test_backward_clock_step_keeps_buckets_monotone(self, tmp_path):
        """Regression (review finding): the egress clock fence, applied to
        the store — a backward NTP step must not open an OLDER bucket id
        (non-monotone buckets would break align_grid's forward walk and
        replay's replace-newest dedup)."""
        st = make_store(tmp_path, tiers="10:40")
        wall = BASE_WALL
        for r in range(6):
            wall += 10.0
            st.append_samples([("g", {}, float(r))], now_wall=wall)
        # 45 s backward step: samples keep folding at the fenced wall.
        for r in range(6, 9):
            st.append_samples([("g", {}, float(r))], now_wall=wall - 45.0)
        # Clock catches back up and passes the fence.
        st.append_samples([("g", {}, 9.0)], now_wall=wall + 20.0)
        rows = st.query_range("g", start=0, end=wall + 30, step=0.0)
        ts = [t for t, _v in rows[0]["values"]]
        assert ts == sorted(ts)
        ids = [int(t // 10.0) for t in ts]
        assert len(ids) == len(set(ids))
        st.close()

    def test_last_append_stamp_is_durability_not_ingestion(self, tmp_path):
        """Regression (review finding): the published last-append
        timestamp must stop advancing while the WAL refuses writes —
        it is the AppendFailing alert's age arm."""
        st = make_store(tmp_path, tiers="10:20")
        wall = feed_rounds(st, 5, n_targets=1, n_slices=1)
        durable = st.stats()["last_append_wall"]
        assert durable > 0

        def refuse(payload):
            raise OSError(28, "No space left on device")

        for buf in st._buffers:
            buf.append = refuse
        wall = feed_rounds(st, 5, start_wall=wall, n_targets=1, n_slices=1)
        stats = st.stats()
        assert stats["append_failures"] > 0
        assert stats["last_append_wall"] == durable  # aged, not refreshed
        for buf in st._buffers:
            del buf.append  # restore the real method (disk "recovers")
        st.close()
        assert st.stats()["last_append_wall"] >= durable

    def test_key_discipline_matches_snapshot_path(self):
        labels = {"target": "t1"}
        assert series_key(schema.TPU_AGG_TARGET_UP.name, labels) == (
            schema.TPU_AGG_TARGET_UP.name, ("t1",))
        # Rule names fall back to sorted-items keys.
        assert series_key("my:rule", {"b": "2", "a": "1"}) == (
            "my:rule", (("a", "1"), ("b", "2")))


# -------------------------------------------- torn-segment fuzz (satellite)


class TestTornSegmentFuzz:
    def _written_ids(self, wall0, rounds, step=10.0):
        return [int((wall0 + (r + 1) * 10.0) // step) for r in range(rounds)]

    def _restored_ids(self, store, step=10.0):
        key = series_key(schema.TPU_SLICE_HBM_USED_BYTES.name,
                         {"slice_name": "slice-0", "accelerator": "v5p", "family": "tpu"})
        s = store._series.get(key)
        if s is None:
            return []
        return [int(b[2] // step) for b in tier_items(s.tiers[0].copy())]

    def _segments(self, tmp_path):
        tier_dir = tmp_path / "store" / "tier-10"
        return sorted(p for p in tier_dir.iterdir()
                      if p.name.startswith("seg-"))

    def test_tail_truncation_keeps_clean_prefix(self, tmp_path):
        rng = random.Random(1234)
        for trial in range(8):
            root = tmp_path / f"t{trial}"
            root.mkdir()
            st = make_store(root, tiers="10:64,60:32")
            feed_rounds(st, 30, n_targets=2, n_slices=1)
            st.close()
            seg = self._segments(root)[-1]
            size = seg.stat().st_size
            os.truncate(seg, rng.randrange(8, size))
            st2 = make_store(root, tiers="10:64,60:32")  # must not raise
            ids = self._restored_ids(st2)
            written = self._written_ids(BASE_WALL, 30)
            # Clean prefix: some leading run of the written buckets,
            # nothing invented, nothing reordered, nothing duplicated.
            assert ids == written[:len(ids)]
            st2.close()

    def test_scramble_never_breaks_boot_or_duplicates(self, tmp_path):
        rng = random.Random(99)
        for trial in range(8):
            root = tmp_path / f"t{trial}"
            root.mkdir()
            st = make_store(root, tiers="10:64,60:32",
                            segment_max_bytes=2048)
            feed_rounds(st, 30, n_targets=2, n_slices=1)
            st.close()
            segs = self._segments(root)
            victim = segs[rng.randrange(len(segs))]
            data = bytearray(victim.read_bytes())
            if len(data) > 16:
                off = rng.randrange(8, len(data))
                data[off] = (data[off] + 1 + rng.randrange(255)) % 256
                victim.write_bytes(bytes(data))
            st2 = make_store(root, tiers="10:64,60:32",
                             segment_max_bytes=2048)  # must not raise
            ids = self._restored_ids(st2)
            written = self._written_ids(BASE_WALL, 30)
            assert len(ids) == len(set(ids)), "duplicate bucket on replay"
            # Restored buckets are a subsequence of what was written — a
            # mid-segment tear loses that segment's tail, never invents
            # or reorders data.
            it = iter(written)
            assert all(any(w == b for w in it) for b in ids)
            st2.close()


# ------------------------------------------------- thin rung + retention


class TestThinAndRetention:
    def test_thin_drops_finest_keeps_coarse(self, tmp_path):
        st = make_store(tmp_path)
        wall = feed_rounds(st, 30)
        st.set_thin(True)
        stats = st.stats()
        assert stats["thinned"] is True
        assert stats["tiers"][0]["enabled"] is False
        assert stats["tiers"][0]["buckets"] == 0
        # The tier's WAL records shed on the APPENDER's next pass (one
        # cursor-mover per buffer — set_thin may run on the governor
        # thread), so the counter lands after one more round.
        feed_rounds(st, 1, start_wall=wall)
        assert st.stats()["dropped"]["shed"] > 0
        assert st._buffers[0].pending() == 0
        # Queries keep answering from the coarse tier.
        rows = st.query_range(schema.TPU_SLICE_HBM_USED_BYTES.name,
                              {"slice_name": "slice-0"},
                              start=wall - 200, end=wall, step=0.0)
        assert rows and rows[0]["tier"] == 60.0
        # Memory accounting stays HONEST while thinned: the rings are
        # preallocated and set_thin only resets counters (it frees disk,
        # not memory) — reporting less would feed the memory ladder
        # phantom headroom.
        thin_mem = st.memory_bytes()
        st.set_thin(False)
        assert st.memory_bytes() == thin_mem
        # The re-enabled tier refills from live rounds.
        feed_rounds(st, 3, start_wall=wall)
        assert st.stats()["tiers"][0]["buckets"] > 0
        st.close()

    def test_release_does_not_mask_coarse_coverage(self, tmp_path):
        """Regression (review finding): a just-released finest tier
        refills from EMPTY — it must not claim infinite coverage via the
        oldest_wall() not-wrapped convention and silently answer minutes
        where the coarse tier still holds the long span."""
        st = make_store(tmp_path)
        wall = feed_rounds(st, 30)
        st.set_thin(True)
        st.set_thin(False)
        # A few refill rounds: finest now holds ONLY the newest samples.
        wall = feed_rounds(st, 3, start_wall=wall)
        rows = st.query_range(schema.TPU_SLICE_HBM_USED_BYTES.name,
                              {"slice_name": "slice-0"},
                              start=wall - 300, end=wall, step=0.0)
        assert rows and rows[0]["tier"] == 60.0  # coarse serves the span
        assert len(rows[0]["values"]) >= 5
        # A window INSIDE the refilled coverage stays on the finest tier.
        rows = st.query_range(schema.TPU_SLICE_HBM_USED_BYTES.name,
                              {"slice_name": "slice-0"},
                              start=wall - 15, end=wall, step=0.0)
        assert rows and rows[0]["tier"] == 10.0
        st.close()

    def test_single_tier_store_refuses_thin(self, tmp_path):
        st = make_store(tmp_path, tiers="10:20")
        feed_rounds(st, 5)
        st.set_thin(True)
        assert st.stats()["thinned"] is False
        st.close()

    def test_retention_trims_wal_to_ring_span(self, tmp_path):
        st = make_store(tmp_path, tiers="10:8")
        feed_rounds(st, 60)
        # Records per tier stay near ring capacity (cap + slack), so disk
        # is bounded by the tier's own span, not by uptime.
        assert st._buffers[0].pending() <= 8 + 16
        assert st.stats()["dropped"]["retention"] > 0
        st.close()

    def test_governor_rung_sheds_and_recovers(self, tmp_path):
        from tpu_pod_exporter_torch.pressure import (
            PressureGovernor,
            register_store_rungs,
        )

        st = make_store(tmp_path)
        gov = PressureGovernor(hysteresis_s=0.0)
        register_store_rungs(gov, st)
        wall = feed_rounds(st, 30)
        usage = sum(
            os.path.getsize(os.path.join(d, f))
            for d in st.disk_paths() if os.path.isdir(d)
            for f in os.listdir(d)
            if os.path.isfile(os.path.join(d, f))
        )
        gov.set_disk_budget_bytes(max(usage // 2, 1024))
        gov.tick()
        assert st.stats()["thinned"] is True
        gov.set_disk_budget_bytes(10 * usage)
        gov.tick()  # first quiet tick arms the recovery window…
        gov.tick()  # …second releases the rung (hysteresis 0)
        assert st.stats()["thinned"] is False
        _ = wall
        st.close()


# --------------------------------------------------- source-aware plane


class FakeLivePlane:
    def __init__(self, rows):
        self.rows = rows
        self.closed = False

    def _env(self, route, data):
        return {"status": "ok", "partial": False, "route": route,
                "source": "live", "data": data, "targets": {},
                "took_s": 0.001}

    def series(self):
        return self._env("series", [
            {"metric": r["metric"], "labels": r["labels"]}
            for r in self.rows
        ])

    def query_range(self, metric, match=None, start=None, end=None,
                    step=0.0, agg="last"):
        rows = [r for r in self.rows if r["metric"] == metric]
        return self._env("query_range",
                         {"resultType": "matrix", "result": rows})

    def window_stats(self, metric, match=None, window_s=60.0):
        rows = [r for r in self.rows if r["metric"] == metric]
        return self._env("window_stats", {"result": rows})

    def close(self):
        self.closed = True


class TestStoreQueryPlane:
    HBM = schema.TPU_SLICE_HBM_USED_BYTES.name

    def make(self, tmp_path, live_rows=None):
        st = make_store(
            tmp_path,
            rules_text="fleet:hbm = sum(" + self.HBM + ") by (slice_name)")
        wall = feed_rounds(st, 8)
        live = FakeLivePlane(live_rows if live_rows is not None else [{
            "metric": self.HBM,
            "labels": {"slice_name": "slice-0", "accelerator": "v5p", "family": "tpu"},
            "values": [[wall, 1.0]],
        }])
        return StoreQueryPlane(live, st), st, wall

    def test_merged_fills_missing_series(self, tmp_path):
        plane, st, wall = self.make(tmp_path)
        env = plane.query_range(self.HBM, start=wall - 100, end=wall,
                                step=0.0)
        rows = env["data"]["result"]
        srcs = {r["labels"].get("slice_name"): r["source"] for r in rows}
        assert srcs["slice-0"] == "live"    # live coverage wins
        assert srcs["slice-1"] == "store"   # store fills the hole
        assert env["source"] == "merged"
        assert env["store"]["filled_series"] == 1

    def test_merged_without_fills_stays_live(self, tmp_path):
        plane, st, wall = self.make(tmp_path)
        env = plane.query_range("nothing_stored", start=wall - 50,
                                end=wall, step=0.0)
        assert env["source"] == "live"
        assert env["store"]["filled_series"] == 0

    def test_store_only(self, tmp_path):
        plane, st, wall = self.make(tmp_path)
        env = plane.query_range(self.HBM, start=wall - 100, end=wall,
                                step=0.0, source="store")
        assert env["source"] == "store"
        assert env["partial"] is False
        assert all(r["source"] == "store" for r in env["data"]["result"])
        # Rule series answer store-only by construction.
        renv = plane.query_range("fleet:hbm", start=wall - 100, end=wall,
                                 step=0.0, source="store")
        assert renv["data"]["result"]

    def test_live_only_tags_rows(self, tmp_path):
        plane, st, wall = self.make(tmp_path)
        env = plane.query_range(self.HBM, start=wall - 100, end=wall,
                                step=0.0, source="live")
        assert env["source"] == "live"
        assert all(r["source"] == "live" for r in env["data"]["result"])
        assert "store" not in env

    def test_bad_source_raises(self, tmp_path):
        plane, st, wall = self.make(tmp_path)
        with pytest.raises(ValueError, match="source must be one of"):
            plane.query_range(self.HBM, source="bogus")

    def test_no_live_plane_serves_store(self, tmp_path):
        st = make_store(tmp_path)
        wall = feed_rounds(st, 5)
        plane = StoreQueryPlane(None, st)
        env = plane.query_range(self.HBM, start=wall - 100, end=wall)
        assert env["source"] == "store"
        with pytest.raises(ValueError, match="no live query plane"):
            plane.query_range(self.HBM, source="live")

    def test_window_stats_and_series_merge(self, tmp_path):
        plane, st, wall = self.make(tmp_path)
        env = plane.window_stats(self.HBM, window_s=100.0)
        assert env["source"] in ("merged", "live")
        senv = plane.series()
        names = {r["metric"] for r in senv["data"]}
        assert schema.TPU_AGG_TARGET_UP.name in names  # store fill

    def test_cached_live_envelope_never_mutated(self, tmp_path):
        plane, st, wall = self.make(tmp_path)
        live_rows = plane._live.rows
        plane.query_range(self.HBM, start=wall - 100, end=wall, step=0.0)
        assert "source" not in live_rows[0]  # rows tagged on COPIES


# -------------------------------- cross-tier source contract (satellite 6)


class TestSourceContract:
    """The envelope-shape contract: every tier's /api/v1/query_range
    answers carry ``source``, with the same key and the same value
    domain — node (live), leaf fan-out (live), store-backed root
    (live|store|merged) — so parsers cannot drift between tiers."""

    def _serve(self, **kw):
        from tpu_pod_exporter_torch.server import MetricsServer

        server = MetricsServer(SnapshotStore(), host="127.0.0.1", port=0,
                               **kw)
        server.start()
        return server, f"http://127.0.0.1:{server.port}"

    def test_node_tier_carries_live_source(self):
        import time as _time

        h = HistoryStore(capacity=16, max_series=16, retention_s=0.0)
        now = _time.time()
        mono = _time.monotonic()
        for i in range(5):
            h.append("tpu_hbm_used_bytes", {"chip_id": "0"}, float(i),
                     t_mono=mono - 10 + i, t_wall=now - 10 + i)
        server, base = self._serve(history=h)
        try:
            status, doc = get_json(
                base + "/api/v1/query_range?metric=tpu_hbm_used_bytes"
                       f"&start={now - 60:.3f}&end={now:.3f}")
            assert status == 200
            assert doc["source"] == "live"
            # ALL THREE node routes carry the key (drift guard).
            status, doc = get_json(base + "/api/v1/series")
            assert status == 200 and doc["source"] == "live"
            status, doc = get_json(
                base + "/api/v1/window_stats?metric=tpu_hbm_used_bytes"
                       "&window=600")
            assert status == 200 and doc["source"] == "live"
            # A node has no store: ?source= must 400, not be ignored.
            status, doc = get_json(
                base + "/api/v1/query_range?metric=tpu_hbm_used_bytes"
                       "&source=store")
            assert status == 400
            assert "store-backed" in doc["error"]
        finally:
            server.stop()

    def test_store_backed_root_over_http(self, tmp_path):
        st = make_store(tmp_path)
        wall = feed_rounds(st, 8)
        plane = StoreQueryPlane(None, st)
        server, base = self._serve(fleet=plane)
        try:
            metric = schema.TPU_SLICE_HBM_USED_BYTES.name
            status, doc = get_json(
                base + f"/api/v1/query_range?metric={metric}"
                       f"&start={wall - 100:.3f}&end={wall:.3f}")
            assert status == 200
            assert doc["source"] == "store"
            status, doc = get_json(
                base + f"/api/v1/query_range?metric={metric}"
                       f"&start={wall - 100:.3f}&end={wall:.3f}"
                       "&source=store")
            assert status == 200
            assert all(r["source"] == "store"
                       for r in doc["data"]["result"])
            status, doc = get_json(
                base + f"/api/v1/query_range?metric={metric}&source=nope")
            assert status == 400
            assert "source must be one of" in doc["error"]
        finally:
            server.stop()
            st.close()

    def test_all_tiers_same_key_same_domain(self, tmp_path):
        """One assertion over every tier's envelope: the drift guard."""
        import time as _time

        from tpu_pod_exporter_torch.fleet import FleetQueryPlane

        envelopes = []
        # Node tier.
        h = HistoryStore(capacity=16, max_series=16, retention_s=0.0)
        now = _time.time()
        h.append("tpu_hbm_used_bytes", {}, 1.0, t_mono=0.0, t_wall=now)
        server, base = self._serve(history=h)
        try:
            _st, doc = get_json(
                base + "/api/v1/query_range?metric=tpu_hbm_used_bytes"
                       f"&start={now - 60:.3f}&end={now + 1:.3f}")
            envelopes.append(doc)
        finally:
            server.stop()
        # Leaf fan-out tier (fetch injected — no sockets needed).
        plane = FleetQueryPlane(
            ["n0:1"], timeout_s=1.0,
            fetch=lambda url, t: {"status": "ok", "data": {
                "resultType": "matrix",
                "result": [{"metric": "m", "labels": {},
                            "values": [[now, 1.0]]}]}},
        )
        envelopes.append(plane.query_range("m", start=now - 60, end=now))
        plane.close()
        # Store-backed root tier.
        st = make_store(tmp_path)
        wall = feed_rounds(st, 4)
        sp = StoreQueryPlane(None, st)
        envelopes.append(sp.query_range(
            schema.TPU_SLICE_HBM_USED_BYTES.name,
            start=wall - 100, end=wall))
        st.close()
        for env in envelopes:
            assert env.get("source") in ("live", "store", "merged"), env


# ------------------------------------------------- status --tree footer


class TestStatusFooter:
    def test_store_line_renders(self, tmp_path):
        from tpu_pod_exporter_torch.status import store_line

        st = make_store(tmp_path)
        feed_rounds(st, 10)
        st.write_sidecar()
        st.close()
        doc = store_status_summary(str(tmp_path / "store"))
        assert doc is not None
        line = store_line(doc)
        assert line.startswith("store: span ")
        assert "rules 0" in line
        assert "series" in line

    def test_render_tree_appends_footer(self, tmp_path):
        from tpu_pod_exporter_torch.status import render_tree

        doc = {"shards": {}, "fleet": {"targets": 0, "targets_up": 0,
                                       "chips": 0.0},
               "store": {"span_s": 3600.0, "disk_bytes": 1024,
                         "disk_budget_bytes": 2048, "rules": 2,
                         "rules_evaluated_total": 10, "series": 5,
                         "last_append_wall": 0, "thinned": True}}
        out = render_tree(doc)
        assert "store: span 1.0h" in out
        assert "THINNED" in out

    def test_missing_sidecar_is_none(self, tmp_path):
        assert store_status_summary(str(tmp_path)) is None


# ------------------------------------------------------------- demo smoke


class TestDemos:
    def test_retention_demo_small(self, tmp_path, capsys):
        from tpu_pod_exporter_torch.store import run_retention_demo

        rc = run_retention_demo(str(tmp_path / "ret"), targets=30,
                                days=0.5, verbose=False)
        out = capsys.readouterr().out
        assert rc == 0, out
