"""Scenario fuzzer: renderer fixpoint, generator validity/determinism,
seam-registry completeness, coverage ledger, minimizer, and the
determinism audit of the engine under --seed.

tpu-pod-exporter — chaos drills only prove the failure modes someone
thought to write down. These tests pin the machinery that generates the
rest: canonical rendering (so reproducers are copy-pasteable DSL),
seeded generation (so (seed, trial) IS the corpus), seam bookkeeping (so
a new injector can't silently contribute zero coverage), and the ddmin
minimizer (so a 4-event failure lands in the repo as a 1-2 event drill).
"""

from __future__ import annotations

import random

import pytest

from tpu_pod_exporter_torch import fuzz
from tpu_pod_exporter_torch import scenario as sc
from tpu_pod_exporter_torch.chaos import SEAM_REGISTRY, register_seam, registered_seams

# ----------------------------------------------------- canonical renderer


class TestCanonicalRenderer:
    @pytest.mark.parametrize("kind", sc.EVENT_KINDS)
    def test_render_parse_fixpoint_per_kind(self, kind):
        """render(parse(render(e))) == render(e) for generated events of
        EVERY kind — canonical text is a fixpoint of the round trip."""
        for seed in range(25):
            rng = random.Random(f"fixpoint:{kind}:{seed}")
            text = sc.generate_event(kind, rng)
            ev = sc.parse_scenario(text)[0]
            once = sc.render_event(ev)
            again = sc.render_event(sc.parse_scenario(once)[0])
            assert once == again

    def test_render_timeline_fixpoint_named_drills(self):
        for name, scn in sc.SCENARIOS.items():
            if not scn.timeline:
                continue
            events = sc.parse_scenario(scn.timeline)
            once = sc.render_timeline(events)
            assert sc.render_timeline(sc.parse_scenario(once)) == once, name

    def test_render_is_order_insensitive(self):
        a = sc.parse_scenario("preempt(slice-0)@2+2; clock_step(45)@5")
        assert sc.render_timeline(list(reversed(a))) == sc.render_timeline(a)

    def test_render_omits_defaults(self):
        text = sc.render_timeline(sc.parse_scenario(
            "restart_wave(3, stagger=1)@2; hotspot(job-1)@4+1"))
        # stagger=1 and +1 are the parser defaults; canonical text drops
        # them (and restart_wave's derived duration is never rendered).
        assert text == "restart_wave(3)@2; hotspot(job-1)@4"


# ------------------------------------------------------------- generation


class TestGeneration:
    def test_generated_timelines_always_valid(self):
        for seed in range(40):
            text = sc.generate_timeline(random.Random(seed))
            events = sc.parse_scenario(text)  # must not raise
            assert events
            assert sc.render_timeline(events) == text  # already canonical

    def test_generation_is_deterministic(self):
        for seed in (0, 7, 99):
            assert (sc.generate_timeline(random.Random(seed))
                    == sc.generate_timeline(random.Random(seed)))

    def test_timeline_for_trial_is_pure(self):
        """Bias weights derive from generated timelines only, so the
        (seed, trial) → timeline map needs no corpus state."""
        got = [fuzz.timeline_for_trial(11, t) for t in range(4)]
        assert got == [fuzz.timeline_for_trial(11, t) for t in range(4)]
        assert len(set(got)) > 1  # trials actually differ

    def test_generation_touches_no_wallclock_or_global_rng(self, monkeypatch):
        """The determinism audit's sharp edge: generation must draw ONLY
        from the passed rng. Wall clock and the global random module are
        booby-trapped; any leak raises."""
        import time

        def boom(*a, **k):
            raise AssertionError("unseeded source consulted")

        monkeypatch.setattr(time, "time", boom)
        monkeypatch.setattr(time, "monotonic", boom)
        for fn in ("random", "randint", "choice", "choices", "uniform"):
            monkeypatch.setattr(random, fn, boom)
        text = fuzz.timeline_for_trial(3, 2)
        assert sc.parse_scenario(text)

    def test_weights_bias_kind_selection(self):
        heavy = {k: 0.0 for k in sc.EVENT_KINDS}
        heavy["clock_step"] = 1.0
        text = sc.generate_timeline(random.Random(5), max_events=3,
                                    weights=heavy)
        assert all(e.kind == "clock_step"
                   for e in sc.parse_scenario(text))

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError, match="no generator"):
            sc.generate_event("warp_core_breach", random.Random(0))


# ---------------------------------------------------- seam registry check


class TestSeamRegistry:
    def test_registry_and_kind_map_are_closed(self):
        """Zero drift in either direction: every event kind maps to
        registered seams and every registered seam is reachable."""
        assert fuzz.seam_map_problems() == []

    def test_every_kind_mapped(self):
        assert set(fuzz.KIND_SEAMS) == set(sc.EVENT_KINDS)

    def test_partition_resolves_per_edge(self):
        events = sc.parse_scenario(
            "partition(node<->leaf, symmetric)@2; "
            "partition(root<->recv, symmetric)@5")
        assert fuzz.seams_of(events) == {"wire:node-leaf", "wire:root-recv"}

    def test_duplicate_registration_rejected(self):
        with pytest.raises(ValueError, match="registered twice"):
            register_seam("disk", "twice")

    def test_unregistered_seam_surfaces_in_report(self):
        ledger = fuzz.CoverageLedger()
        ledger.record({"wire:node-leaf", "unmapped:ghost"}, ["egress_ledger"])
        rep = ledger.report()
        assert rep["unregistered_seams"] == ["unmapped:ghost"]
        assert rep["matrix"]["wire:node-leaf"]["egress_ledger"] == 1


# --------------------------------------------------------- coverage ledger


class TestCoverageLedger:
    def test_dark_pairs_shrink_as_trials_record(self):
        ledger = fuzz.CoverageLedger()
        total = len(registered_seams()) * len(sc.INVARIANTS)
        assert len(ledger.dark_pairs()) == total
        ledger.record({"disk"}, sc.INVARIANTS)
        assert len(ledger.dark_pairs()) == total - len(sc.INVARIANTS)
        rep = ledger.report()
        assert rep["pairs_covered"] == len(sc.INVARIANTS)
        assert rep["trials"] == 1

    def test_kind_weights_favor_dark_seams(self):
        counts = {s: 3 for s in registered_seams()}
        counts["wallclock"] = 0
        w = fuzz.kind_weights(counts)
        assert w["clock_step"] > w["preempt"]
        # All-lit registry → uniform weights.
        assert len(set(fuzz.kind_weights(
            {s: 1 for s in registered_seams()}).values())) == 1


# -------------------------------------------------------------- minimizer


COMPOSITE = ("mem_pressure()@2+2; clock_step(3600)@3; "
             "preempt(slice-1)@5+2; churn_storm(6)@6+2")


class TestMinimizer:
    def test_shrinks_composite_to_culprit(self):
        """A 4-event timeline whose failure needs only the clock_step
        must shrink to exactly that event, with its magnitude and round
        floored — and every candidate the predicate saw must have been a
        valid timeline."""
        seen: list[str] = []

        def failing(events):
            text = sc.render_timeline(events)
            sc.parse_scenario(text)  # invalid candidate would raise here
            seen.append(text)
            return any(e.kind == "clock_step" for e in events)

        out = fuzz.minimize(sc.parse_scenario(COMPOSITE), failing)
        assert len(out) == 1
        assert out[0].kind == "clock_step"
        assert out[0].step_s == 45.0
        assert out[0].at_round == fuzz.TRIAL_BOUNDS.min_round
        assert len(seen) > 3  # it actually searched

    def test_minimize_to_interacting_pair(self):
        def failing(events):
            kinds = {e.kind for e in events}
            return {"preempt", "churn_storm"} <= kinds

        out = fuzz.minimize(sc.parse_scenario(COMPOSITE), failing)
        assert sorted(e.kind for e in out) == ["churn_storm", "preempt"]

    def test_minimize_is_deterministic(self):
        def failing(events):
            return any(e.kind == "churn_storm" for e in events)

        a = fuzz.minimize(sc.parse_scenario(COMPOSITE), failing)
        b = fuzz.minimize(sc.parse_scenario(COMPOSITE), failing)
        assert sc.render_timeline(a) == sc.render_timeline(b)
        assert len(a) == 1 and a[0].count == 2  # churn floor is 2

    def test_shrink_variants_always_valid(self):
        for seed in range(20):
            text = sc.generate_timeline(random.Random(f"sv:{seed}"))
            for ev in sc.parse_scenario(text):
                for cand in fuzz._shrink_variants(ev):
                    sc.parse_scenario(sc.render_event(cand))  # no raise

    def test_budget_respected(self):
        calls = [0]

        def failing(events):
            calls[0] += 1
            return True

        fuzz.minimize(sc.parse_scenario(COMPOSITE), failing, max_checks=5)
        assert calls[0] <= 5

    def test_invalid_input_rejected(self):
        with pytest.raises(ValueError, match="not valid"):
            fuzz.minimize([], lambda e: True)


# ------------------------------------------------------ alert bounds


class TestAlertBounds:
    def test_asymmetric_leaf_root_requires_partition_alert(self):
        req, allowed = fuzz.expected_alert_bounds(sc.parse_scenario(
            "partition(leaf<->root, asymmetric)@3+2"))
        assert req == ("TpuRootLeafPartitioned",)
        assert "TpuRootLeafDown" in allowed

    def test_symmetric_cut_only_allows(self):
        req, allowed = fuzz.expected_alert_bounds(sc.parse_scenario(
            "partition(leaf<->root, symmetric)@3+2"))
        assert req == ()
        assert set(allowed) == {"TpuRootLeafDown", "TpuRootLeafPartitioned"}

    def test_asymmetric_overlapping_dead_root_demoted_to_allowed(self):
        req, allowed = fuzz.expected_alert_bounds(sc.parse_scenario(
            "root_restart()@3+3; partition(leaf<->root, asymmetric)@4+2"))
        assert req == ()
        assert "TpuRootLeafPartitioned" in allowed

    def test_unrelated_events_stay_exact(self):
        req, allowed = fuzz.expected_alert_bounds(sc.parse_scenario(
            "mem_pressure()@2+2; scrape_storm(40)@4"))
        assert req == () and allowed == ()


# ------------------------------------------- fuzzer-found regressions


class TestFuzzerFoundRegressions:
    """Minimized fuzzer finds, committed as named drills. Each green test
    has a negative control proving the drill bites with the fix gone."""

    def test_root_restart_egress_drill_green(self, tmp_path, quiet_logs):
        """root_restart()@2 (ddmin'd from a 4-event composite): a frozen
        snapshot must never be framed twice — zero duplicate samples in
        the exactly-once ledger across the dead window."""
        from tpu_pod_exporter_torch.loadgen.scenario import run_one

        result, _ = run_one(sc.SCENARIOS["fuzz_root_restart_egress"],
                            16, 2, 1, str(tmp_path / "state"), seed=42)
        assert result["ok"], result.get("problems")
        assert result["egress"]["duplicate_samples"] == 0

    def test_root_restart_egress_negative_control(
            self, tmp_path, quiet_logs, monkeypatch):
        """Fix reverted (the same-poll-instant guard disabled): the drill
        must FAIL with duplicate samples — the regression drill is not
        vacuous."""
        from tpu_pod_exporter_torch.egress import RemoteWriteShipper
        from tpu_pod_exporter_torch.loadgen.scenario import run_one

        monkeypatch.setattr(RemoteWriteShipper, "_same_poll_instant",
                            lambda self, wall: False)
        result, _ = run_one(sc.SCENARIOS["fuzz_root_restart_egress"],
                            16, 2, 1, str(tmp_path / "state"), seed=42)
        assert not result["ok"]
        assert any("duplicate" in p for p in result["problems"])

    def test_hotspot_churn_drill_green(self, tmp_path, quiet_logs):
        """hotspot x churn_storm: pod_gen rotation mid-window must not
        orphan the hot set — attributability holds through the churn."""
        from tpu_pod_exporter_torch.loadgen.scenario import run_one

        result, _ = run_one(sc.SCENARIOS["fuzz_hotspot_churn"],
                            16, 2, 1, str(tmp_path / "state"), seed=42)
        assert result["ok"], result.get("problems")


# ---------------------------------------------- determinism audit (engine)


@pytest.fixture
def quiet_logs():
    import logging

    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


@pytest.mark.slow
class TestFuzzSoak:
    def test_soak_larger_budget(self, tmp_path, quiet_logs):
        """The bigger trial budget behind -m slow: several seeds, every
        failure minimized, coverage written, exit 0 (no live bugs)."""
        rc = fuzz.main([
            "--seeds", "1,2,3,4,6,7", "--trials", "6", "--keep-going",
            "--state-root", str(tmp_path / "soak"),
        ])
        assert rc == 0


class TestDeterminismAudit:
    def test_same_seed_trial_gives_identical_schedule_trace(
            self, tmp_path, quiet_logs):
        """Two full engine runs of one (seed, trial): the injected
        schedule — rounds, active windows, effective cuts — must match
        tick for tick. This is the property --fuzz-replay stands on."""
        seed, trial = 5, 0
        timeline = fuzz.timeline_for_trial(seed, trial)
        traces = []
        for leg in ("a", "b"):
            _result, trace = fuzz.run_trial(
                seed, trial, timeline, str(tmp_path / leg))
            traces.append(fuzz.schedule_trace(trace))
        assert traces[0] == traces[1]
        assert any(t["active"] or t["cuts"] for t in traces[0])
