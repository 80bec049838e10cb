"""Fleet scenario engine tests, the JAX package's cases run against the port.

Covers:

- the scenario timeline DSL (tpu_pod_exporter_torch.scenario): every event
  kind's happy path plus the actionable-error contract — unknown kinds,
  bad coordinates, bad modes/edges, overlapping same-identity events;
- parse_leaf_timeline error paths (the PR-8 grammar the satellite names);
- the partition switchboard (chaos.PartitionState / PartitionedFetch /
  PartitionedSend): tier vs instance selectors, symmetric cuts, seeded
  deterministic flapping, heal, blocked accounting;
- ChaosReceiver's scenario outage switch (503s without consuming the
  seeded rule schedule);
- RootAggregator stale-serve: last-known views merged while a leaf is
  unreachable (leaf_up 0, stale_served 1, partition_suspected with a
  reachable twin, zero series lost), expiry past the budget, and the
  /readyz degradation contract at root and flat-aggregator tiers;
- status --tree --watch's unreachable-root rendering;
- a small end-to-end run of the scenario engine, plus the negative
  control proving the invariants catch a disabled hardening.
"""

from __future__ import annotations

import pytest

from tpu_pod_exporter_torch import scenario as sc
from tpu_pod_exporter_torch import shard as sh
from tpu_pod_exporter_torch.aggregate import SliceAggregator
from tpu_pod_exporter_torch.chaos import (
    ChaosReceiver,
    PartitionError,
    PartitionState,
    PartitionedFetch,
    PartitionedSend,
    parse_chaos_spec,
    parse_leaf_timeline,
)
from tpu_pod_exporter_torch.metrics import SnapshotStore
from tpu_pod_exporter_torch.metrics.parse import parse_families


# ----------------------------------------------------------- timeline DSL


class TestScenarioGrammar:
    def test_every_kind_parses(self):
        evs = sc.parse_scenario(
            "partition(leaf<->root, symmetric)@3+2; "
            "partition(node<->leaf, flapping)@9+2, "
            "preempt(slice-2)@6+3; restart_wave(6, stagger=2)@12; "
            "churn_storm(8)@15+2; hotspot(job-3)@18+2; recv_outage()@21+4"
        )
        kinds = [e.kind for e in evs]
        assert kinds == ["partition", "preempt", "partition",
                         "restart_wave", "churn_storm", "hotspot",
                         "recv_outage"]
        part = evs[0]
        assert part.edge == ("leaf", "root")
        assert part.mode == "symmetric"
        assert (part.at_round, part.duration) == (3, 2)
        wave = evs[3]
        assert wave.count == 6
        assert wave.stagger == 2
        assert wave.duration == 3  # ceil(6/2), derived

    def test_named_scenarios_all_parse(self):
        for name, scn in sc.SCENARIOS.items():
            evs = scn.events()
            assert evs, name
            assert sc.total_rounds(evs, scn.settle_rounds) > max(
                e.end_round for e in evs
            )

    @pytest.mark.parametrize("spec,needle", [
        ("frobnicate(x)@1", "unknown event kind 'frobnicate'"),
        ("partition(leaf<->root)@1", "exactly (tierA<->tierB, mode)"),
        ("partition(leaf->root, symmetric)@1", "bad edge 'leaf->root'"),
        ("partition(leaf<->leaf, symmetric)@1", "connects 'leaf' to itself"),
        ("partition(node<->root, symmetric)@1", "no node<->root seam"),
        ("partition(leaf<->root, sometimes)@1", "unknown partition mode"),
        ("partition(leaf<->rooot, symmetric)@1", "unknown tier 'rooot'"),
        ("partition(leaf<->root, symmetric)", "want kind(args)@round"),
        ("partition(leaf<->root, symmetric)@-2", "round -2 is negative"),
        ("partition(leaf<->root, symmetric)@2+0", "must be at least +1"),
        ("preempt(slice-x)@1", "bad slice coordinate 'slice-x'"),
        ("preempt()@1", "exactly (slice-N)"),
        ("restart_wave(zero)@1", "bad host count 'zero'"),
        ("restart_wave(4, skew=2)@1", "unknown restart_wave option"),
        ("restart_wave(4, stagger=0)@1", "stagger 0 must be >= 1"),
        ("restart_wave(4, stagger=2)@1+7", "derives its duration"),
        ("churn_storm(1)@1", "churn size 1 must be >= 2"),
        ("hotspot()@1", "exactly (podname)"),
        ("recv_outage(now)@1", "takes no arguments"),
        ("", "contains no events"),
    ])
    def test_actionable_errors(self, spec, needle):
        with pytest.raises(ValueError) as ei:
            sc.parse_scenario(spec)
        assert needle in str(ei.value)

    def test_overlap_same_identity_rejected(self):
        with pytest.raises(ValueError) as ei:
            sc.parse_scenario("preempt(slice-1)@2+3; preempt(slice-1)@4")
        msg = str(ei.value)
        assert "overlap" in msg
        assert "preempt(slice-1)@2+3" in msg

    def test_overlap_different_identity_allowed(self):
        evs = sc.parse_scenario(
            "preempt(slice-1)@2+3; preempt(slice-2)@2+3; "
            "partition(leaf<->root, flapping)@2+4"
        )
        assert len(evs) == 3

    def test_partition_edges_order_insensitive(self):
        a = sc.parse_event("partition(root<->leaf, symmetric)@1")
        b = sc.parse_event("partition(leaf<->root, symmetric)@1")
        assert a.overlap_key() == b.overlap_key()


class TestLeafTimelineGrammar:
    """parse_leaf_timeline error paths — bad coordinates and
    unknown kinds must be actionable messages, not tracebacks."""

    def test_valid(self):
        evs = parse_leaf_timeline("kill:1a@3#12,restart:1a@6")
        assert [(e.action, e.leaf, e.round_idx, e.at_call) for e in evs] == [
            ("kill", "1a", 3, 12), ("restart", "1a", 6, None),
        ]

    @pytest.mark.parametrize("spec,needle", [
        ("explode:1a@3", "unknown action 'explode'"),
        ("kill:1a", "want action:leaf@round"),
        ("kill@3", "want action:leaf@round"),
        ("kill:1a@x", "want action:leaf@round"),
        ("kill:1a@-3", "want action:leaf@round"),
        ("kill:1a@3#x", "want action:leaf@round"),
        ("restart:1a@3#4", "#call only applies to kill"),
        ("", "contains no events"),
        (" , ", "contains no events"),
    ])
    def test_actionable_errors(self, spec, needle):
        with pytest.raises(ValueError) as ei:
            parse_leaf_timeline(spec)
        assert needle in str(ei.value)


# --------------------------------------------------- partition switchboard


class TestPartitionState:
    def test_symmetric_cut_and_heal(self):
        net = PartitionState(seed=1)
        net.cut("root", "leaf")
        assert net.is_cut("root", "leaf:1a")
        assert net.is_cut("root", "leaf:0b")
        assert not net.is_cut("leaf:1a", "node:3")  # other edges open
        net.heal("root", "leaf")
        assert not net.is_cut("root", "leaf:1a")
        assert not net.any_cuts()

    def test_instance_selector_cuts_only_that_instance(self):
        net = PartitionState(seed=1)
        net.cut("root", "leaf:1a")
        assert net.is_cut("root", "leaf:1a")
        assert not net.is_cut("root", "leaf:1b")

    def test_flapping_is_round_keyed_and_seed_deterministic(self):
        def schedule(seed):
            net = PartitionState(seed=seed)
            net.cut("root", "leaf", flapping=True)
            out = []
            for r in range(8):
                net.advance(r)
                out.append(net.is_cut("root", "leaf:0a"))
            return out

        a, b = schedule(7), schedule(7)
        assert a == b                      # deterministic under one seed
        assert True in a and False in a    # actually flaps
        assert all(a[i] != a[i + 1] for i in range(7))  # alternates/round

    def test_active_lists_only_effective_cuts(self):
        net = PartitionState(seed=3)
        net.cut("root", "recv")
        net.cut("root", "leaf", flapping=True)
        net.advance(0)
        eff0 = net.active()
        net.advance(1)
        eff1 = net.active()
        # The static cut is always effective; the flapping one only on
        # alternating rounds.
        assert ("root", "recv", False) in eff0
        assert ("root", "recv", False) in eff1
        assert (("root", "leaf", True) in eff0) != (
            ("root", "leaf", True) in eff1)
        assert net.any_cuts()

    def test_partitioned_fetch_blocks_and_counts(self):
        net = PartitionState(seed=1)
        calls = []

        def inner(target, timeout_s):
            calls.append(target)
            return "body"

        pf = PartitionedFetch(net, "leaf:1a", lambda t: f"node:{t}", inner)
        assert pf("7", 1.0) == "body"
        net.cut("leaf", "node:7")
        with pytest.raises(PartitionError):
            pf("7", 1.0)
        assert pf.blocked == 1
        assert calls == ["7"]  # the cut call never reached the wire
        assert isinstance(PartitionError("x"), ConnectionError)

    def test_partitioned_send_blocks(self):
        net = PartitionState(seed=1)
        sent = []

        def inner(url, body, headers, timeout_s):
            sent.append(url)
            return 200

        ps = PartitionedSend(net, "root", "recv", inner)
        assert ps("http://r/w", b"x", {}, 1.0) == 200
        net.cut("root", "recv")
        with pytest.raises(PartitionError):
            ps("http://r/w", b"x", {}, 1.0)
        assert ps.blocked == 1
        assert sent == ["http://r/w"]


class TestReceiverOutage:
    def test_outage_503s_without_consuming_schedule(self):
        import urllib.error
        import urllib.request

        recv = ChaosReceiver(parse_chaos_spec("err:recv:1:x1"), seed=0)
        recv.start()
        try:
            recv.set_outage(True)
            for _ in range(2):
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(  # noqa: S310 — loopback test
                        urllib.request.Request(
                            recv.url, data=b"x", method="POST"),
                        timeout=5)
                assert ei.value.code == 503
            stats = recv.stats()
            assert stats["outage_responses"] == 2
            # The seeded rule schedule was NOT consumed by outage answers.
            assert stats["calls"] == 0
            assert stats["injected"] == []
            recv.set_outage(False)
            # First scheduled request now draws the err rule → 500.
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(  # noqa: S310 — loopback test
                    urllib.request.Request(
                        recv.url, data=b"x", method="POST"),
                    timeout=5)
            assert ei.value.code == 500
            assert recv.stats()["injected"] == [(0, "err")]
        finally:
            recv.stop()


# ------------------------------------------------------- root stale-serve


def _node_body(idx: int, rnd: int = 0) -> str:
    cl = (f'chip_id="0",device_path="",accelerator="sim",'
          f'slice_name="slice-{idx % 2}",host="host-{idx}",'
          f'worker_id="{idx}",pod="job-{idx % 3}",namespace="s",'
          f'container="w"')
    hbm = float((idx + 1) * 2**20 + rnd * 4096)
    return (
        f'tpu_chip_info{{{cl},device_kind="",coords=""}} 1\n'
        f'tpu_hbm_used_bytes{{{cl}}} {hbm:.1f}\n'
        f'tpu_hbm_total_bytes{{{cl}}} {float(2**30):.1f}\n'
    )


def _build_ha_tree(stale_serve_s: float, wallclock):
    """One HA shard over injected fetches; returns (root, store, state)
    where state controls which leaves are reachable."""
    targets = tuple(f"h{i}:8000" for i in range(4))
    rnd = [0]

    def node_fetch(target, timeout_s):
        return _node_body(int(target.split(":")[0][1:]), rnd[0])

    smap = sh.ShardMap(sh.default_shards(1))
    leaves = {}
    for leaf_id in ("0a", "0b"):
        store = SnapshotStore()
        agg = sh.LeafAggregator(
            "shard-0", leaf_id, smap, targets=targets, store=store,
            fetch=node_fetch, wallclock=wallclock,
        )
        leaves[f"leaf-{leaf_id}:9100"] = (agg, store)
    state = {"down": set(), "rnd": rnd}

    def leaf_fetch(addr, timeout_s):
        if addr in state["down"]:
            raise ConnectionError(f"{addr} unreachable (cut)")
        return leaves[addr][1].current().encode().decode()

    root_store = SnapshotStore()
    root = sh.RootAggregator(
        {"shard-0": tuple(leaves)}, root_store, fetch=leaf_fetch,
        stale_serve_s=stale_serve_s, wallclock=wallclock,
        breaker_failures=0,
    )
    return root, root_store, state, leaves


def _poll_all(root, leaves, rnd_bump=True):
    for agg, _store in leaves.values():
        agg.poll_once()
    root.poll_once()


class TestRootStaleServe:
    def _fams(self, store):
        return parse_families(store.current().encode().decode())

    def test_stale_serve_keeps_series_and_labels_them(self):
        clock = [1000.0]
        root, store, state, leaves = _build_ha_tree(
            stale_serve_s=30.0, wallclock=lambda: clock[0])
        _poll_all(root, leaves)
        fams = self._fams(store)
        baseline = {
            (s.name, tuple(sorted(s.labels.items())))
            for name in ("tpu_slice_chip_count", "tpu_aggregator_target_up",
                         "tpu_workload_chip_count")
            for s in fams.get(name, ())
        }
        # Cut BOTH leaves (symmetric partition): everything unreachable.
        state["down"] = set(leaves)
        clock[0] += 5.0
        root.poll_once()
        fams = self._fams(store)
        now = {
            (s.name, tuple(sorted(s.labels.items())))
            for name in ("tpu_slice_chip_count", "tpu_aggregator_target_up",
                         "tpu_workload_chip_count")
            for s in fams.get(name, ())
        }
        assert baseline <= now  # zero series lost
        ups = {s.labels["leaf"]: s.value
               for s in fams["tpu_root_leaf_up"]}
        served = {s.labels["leaf"]: s.value
                  for s in fams["tpu_root_leaf_stale_served"]}
        assert set(ups.values()) == {0.0}   # honestly down…
        assert set(served.values()) == {1.0}  # …but stale-served
        stale = {s.labels["leaf"]: s.value
                 for s in fams["tpu_root_leaf_staleness_seconds"]}
        assert all(v >= 5.0 for v in stale.values())
        # No twin reachable → partition suspicion stays 0 (could be a
        # dead tier, not a one-sided cut).
        suspected = {s.labels["leaf"]: s.value
                     for s in fams["tpu_root_leaf_partition_suspected"]}
        assert set(suspected.values()) == {0.0}
        # readyz detail degrades.
        detail = root.ready_detail()
        assert detail["leaf_tier"]["reachable"] == 0
        assert detail["degraded_sources"]

    def test_one_sided_cut_suspects_partition_and_twin_covers(self):
        clock = [1000.0]
        root, store, state, leaves = _build_ha_tree(
            stale_serve_s=30.0, wallclock=lambda: clock[0])
        _poll_all(root, leaves)
        victim = next(iter(leaves))
        state["down"] = {victim}
        clock[0] += 2.0
        root.poll_once()
        fams = self._fams(store)
        by_leaf = {s.labels["leaf"]: s.value
                   for s in fams["tpu_root_leaf_partition_suspected"]}
        assert by_leaf[victim] == 1.0
        assert all(v == 0.0 for leaf, v in by_leaf.items() if leaf != victim)
        # Twin fresh → the merged view keeps every series, values live.
        assert len(fams["tpu_aggregator_target_up"]) == 4
        # Reachable twins keep the root un-degraded.
        assert "degraded_sources" not in root.ready_detail()

    def test_stale_serve_expires_past_budget(self):
        clock = [1000.0]
        root, store, state, leaves = _build_ha_tree(
            stale_serve_s=10.0, wallclock=lambda: clock[0])
        _poll_all(root, leaves)
        state["down"] = set(leaves)
        clock[0] += 60.0  # way past the budget
        root.poll_once()
        fams = self._fams(store)
        assert not fams.get("tpu_slice_chip_count")
        served = {s.value for s in fams["tpu_root_leaf_stale_served"]}
        assert served == {0.0}

    def test_disabled_stale_serve_keeps_old_behavior(self):
        clock = [1000.0]
        root, store, state, leaves = _build_ha_tree(
            stale_serve_s=0.0, wallclock=lambda: clock[0])
        _poll_all(root, leaves)
        state["down"] = set(leaves)
        root.poll_once()
        fams = self._fams(store)
        assert not fams.get("tpu_slice_chip_count")

    def test_freshest_wins_stable_under_flapping_reachability(self):
        """The freshest-wins winner must not flap while one HA leaf's
        reachability strobes: the cached view keeps its frozen round_ts,
        so the live twin stays the winner for every shared group."""
        clock = [1000.0]
        root, store, state, leaves = _build_ha_tree(
            stale_serve_s=30.0, wallclock=lambda: clock[0])
        victim = next(iter(leaves))
        values = []
        for i in range(6):
            state["rnd"][0] = i
            for addr, (agg, _s) in leaves.items():
                if addr != victim:
                    agg.poll_once()
            # Flap the victim's reachability every other root round; its
            # body (when reachable) is one leaf-round stale.
            state["down"] = {victim} if i % 2 else set()
            clock[0] += 1.0
            root.poll_once()
            fams = self._fams(store)
            hbm = sum(s.value
                      for s in fams.get("tpu_slice_hbm_used_bytes", ()))
            values.append(hbm)
        # The live twin's fresh values win every round: the published sum
        # tracks the advancing rounds monotonically, never dips back to a
        # stale flap value.
        assert values == sorted(values)


class TestAggregatorReadyDetail:
    def test_all_targets_dark_degrades(self):
        store = SnapshotStore()

        def fetch(target, timeout_s):
            raise ConnectionError("cut")

        agg = SliceAggregator(("h0:1", "h1:1"), store, fetch=fetch,
                              breaker_failures=0)
        agg.poll_once()
        detail = agg.ready_detail()
        assert detail["scrape_plane"] == {
            "targets_ok": 0, "quarantined": 0, "targets": 2}
        assert "partition suspected" in detail["degraded_sources"][0]

    def test_partial_outage_is_detail_not_degradation(self):
        store = SnapshotStore()

        def fetch(target, timeout_s):
            if target == "h0:1":
                raise ConnectionError("down")
            return _node_body(1)

        agg = SliceAggregator(("h0:1", "h1:1"), store, fetch=fetch,
                              breaker_failures=0)
        agg.poll_once()
        detail = agg.ready_detail()
        assert detail["scrape_plane"]["targets_ok"] == 1
        assert "degraded_sources" not in detail

    def test_served_through_readyz_http(self):
        import json
        import urllib.request

        from tpu_pod_exporter_torch.server import MetricsServer

        store = SnapshotStore()

        def fetch(target, timeout_s):
            raise ConnectionError("cut")

        agg = SliceAggregator(("h0:1",), store, fetch=fetch,
                              breaker_failures=0)
        agg.poll_once()
        server = MetricsServer(store, host="127.0.0.1", port=0,
                               ready_detail_fn=agg.ready_detail)
        server.start()
        try:
            with urllib.request.urlopen(  # noqa: S310 — loopback test
                    f"http://127.0.0.1:{server.port}/readyz",
                    timeout=5) as r:
                doc = json.loads(r.read())
            assert doc["state"] == "degraded"
            assert doc["scrape_plane"]["targets"] == 1
        finally:
            server.stop()


# ------------------------------------------------------ status --tree watch


class TestTreeWatchRender:
    DOC = {
        "root": "r:9100",
        "shards": {
            "shard-0": {
                "targets": 4, "quarantined": 0,
                "leaves": {"l0a": {"up": 1.0, "staleness_s": 0.4},
                           "l0b": {"up": 1.0, "staleness_s": 1.2}},
                "freshest": "l0a",
            },
        },
        "fleet": {"targets": 4, "targets_up": 4, "chips": 8.0,
                  "dedup_stale_wins_total": 0.0,
                  "reshard_moves_total": 0.0,
                  "last_round_ts": None, "round_duration_s": 0.1},
    }

    def test_unreachable_with_last_known_state(self):
        from tpu_pod_exporter_torch.status import render_tree_screen

        out = render_tree_screen("r:9100", self.DOC,
                                 error=ConnectionError("refused"),
                                 unreachable_s=12.3)
        assert "shard-0" in out           # last-known table still renders
        assert "unreachable (12s)" in out
        assert "showing last-known state" in out

    def test_unreachable_before_any_fetch(self):
        from tpu_pod_exporter_torch.status import render_tree_screen

        out = render_tree_screen("r:9100", None,
                                 error=ConnectionError("refused"),
                                 unreachable_s=3.0)
        assert "no tree fetched yet" in out

    def test_healthy_frame_has_no_footer(self):
        from tpu_pod_exporter_torch.status import render_tree_screen

        out = render_tree_screen("r:9100", self.DOC)
        assert "unreachable" not in out


# --------------------------------------------------------- engine end-to-end


@pytest.fixture
def quiet_logs():
    import logging

    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


class TestFuzzDerivedDrills:
    """The fuzz_* SCENARIOS entries are ddmin'd fuzzer finds promoted to
    named regression drills; they must stay canonical so the fuzzer's
    replay/minimize tooling round-trips them byte-for-byte."""

    FUZZ_DRILLS = ("fuzz_root_restart_egress", "fuzz_hotspot_churn")

    @pytest.mark.parametrize("name", FUZZ_DRILLS)
    def test_timeline_is_canonical_fixpoint(self, name):
        scn = sc.SCENARIOS[name]
        assert sc.render_timeline(sc.parse_scenario(scn.timeline)) \
            == scn.timeline

    @pytest.mark.parametrize("name", FUZZ_DRILLS)
    def test_provenance_documented(self, name):
        scn = sc.SCENARIOS[name]
        assert scn.uses_egress, name
        assert "fuzz" in scn.description.lower(), (
            "fuzz-derived drills must document their provenance")

    def test_headline_find_cites_replay_coordinates(self):
        desc = sc.SCENARIOS["fuzz_root_restart_egress"].description
        assert "seed 1 trial 7" in desc


class TestScenarioEngine:
    def test_asymmetric_partition_end_to_end(self, tmp_path, quiet_logs):
        from tpu_pod_exporter_torch.loadgen.scenario import _Run

        run = _Run(sc.SCENARIOS["partition_asymmetric"], 16, 2, 2,
                   str(tmp_path / "state"), seed=42)
        result = run.run()
        assert result["ok"], result.get("problems")
        assert result["recovered"]
        assert result["readyz_state"] == "ready"
        eg = result["egress"]
        assert eg["accepted"] == eg["batches"] > 0
        assert eg["duplicate_seqs"] == 0
        assert eg["duplicate_samples"] == 0
        assert run.trace  # per-tick invariant records exist

    def test_negative_control_catches_disabled_hardening(
            self, tmp_path, quiet_logs):
        """With stale-serve OFF, the symmetric-partition drill must FAIL
        (series vanish / not stale-served) — the invariants are not
        vacuous, they read the same exposition the hardening feeds."""
        from tpu_pod_exporter_torch.loadgen.scenario import _Run

        run = _Run(sc.SCENARIOS["partition_symmetric"], 12, 2, 2,
                   str(tmp_path / "state"), seed=42, stale_serve_s=0.0)
        result = run.run()
        assert not result["ok"]
        assert any("lost during partition" in p or "not stale-served" in p
                   for p in result["problems"])
