"""Scenario fuzzer — generate the drill corpus, minimize failures, track
(seam × invariant) coverage.

The scenario engine holds ~16 hand-written timelines against a far larger
injection surface. This module is breadth-by-generation: a seeded
generator composes random *valid* timelines from every DSL event kind
(:func:`tpu_pod_exporter_torch.scenario.generate_timeline` — the parser's
overlap/validity rules ARE the rejection oracle), drives each through the
full scenario engine with all per-tick invariants armed, and on failure
runs a delta-debugging minimizer that shrinks the timeline to a minimal
reproducer emitted as canonical DSL text plus the exact (seed, trial)
coordinates for deterministic replay.

Determinism contract — the whole point of the design:

- ``timeline_for_trial(seed, trial)`` is a pure function: generation
  draws only from ``random.Random(f"{seed}:{trial}:timeline")`` plus the
  coverage-bias weights, which are themselves derived from the GENERATED
  timelines of trials ``0..trial-1`` (never from run outcomes, which
  would make replay depend on wall-clock-flavored engine state).
- The engine run is seeded the same way every named drill is; the
  injected schedule (rounds, active windows, effective cuts — see
  :func:`schedule_trace`) is identical across replays of one trial.
- So ``--replay SEED:TRIAL`` (also reachable as the engine's
  ``--fuzz-replay``) rebuilds the exact failing run from two integers.

Coverage: a :class:`CoverageLedger` tracks which (injection seam ×
invariant) pairs each trial exercised. Seams are enumerated from the
chaos seam registry (:data:`tpu_pod_exporter_torch.chaos.SEAM_REGISTRY`) and
cross-checked against :data:`KIND_SEAMS` in BOTH directions — an
injector registered without a generator path, or a generator naming a
ghost seam, fails :func:`seam_map_problems` (asserted under tier-1), so
a seam added later can't be silently omitted. Generation is biased
toward kinds that reach still-dark seams.

CLI (``make fuzz-smoke``)::

    python -m tpu_pod_exporter_torch.fuzz --seeds 5,7 --trials 6 \\
        --state-root fuzz-state

On failure: the original + minimized timelines, the engine result, and
the per-tick trace land under ``<state-root>/failure-s<seed>-t<trial>/``
(uploaded as CI artifacts), and the exit is non-zero. See RUNBOOK
"Reproducing a fuzzer failure".
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import shutil
import sys
from collections.abc import Callable, Iterable

from tpu_pod_exporter_torch.chaos import SEAM_REGISTRY, registered_seams
from tpu_pod_exporter_torch.scenario import (
    EVENT_KINDS,
    INVARIANTS,
    GenBounds,
    Scenario,
    ScenarioEvent,
    generate_timeline,
    parse_scenario,
    render_event,
    render_timeline,
)

# ----------------------------------------------------------- trial envelope

# Fixed per-trial engine shape: replay from (seed, trial) alone requires
# these to be constants, not flags. Small fleet — a trial is a smoke
# drill, not a soak; the named demo set keeps the big fleets.
TRIAL_TARGETS = 24
TRIAL_SHARDS = 2
TRIAL_CHIPS = 1
TRIAL_MAX_EVENTS = 4
TRIAL_BOUNDS = GenBounds()

# Invariants a generated trial arms BY CONSTRUCTION (egress + alerting
# always attached; the three always-on tick checks). oracle_equality
# arms lazily at runtime — the ledger records what the run reports.
TRIAL_STATIC_INVARIANTS: tuple[str, ...] = (
    "egress_ledger", "alerts_correctness", "bounded_staleness",
    "fault_attribution", "series_rss_leaks",
)

# ------------------------------------------------------------ seam mapping

# DSL event kind → chaos seams it injects through. partition is resolved
# per edge by seams_of (one wire seam per cut edge). Cross-checked
# against SEAM_REGISTRY in both directions by seam_map_problems().
KIND_SEAMS: dict[str, tuple[str, ...]] = {
    "partition": ("wire:node-leaf", "wire:leaf-root", "wire:root-recv"),
    "preempt": ("target-process",),
    "restart_wave": ("target-process",),
    "churn_storm": ("membership", "workload"),
    "hotspot": ("workload",),
    "recv_outage": ("receiver",),
    "disk_full": ("disk",),
    "mem_pressure": ("memory",),
    "scrape_storm": ("serving",),
    "clock_step": ("wallclock",),
    "root_restart": ("root-process",),
    "dashboard_storm": ("stream",),
}

_TIER_ORDER = {"node": 0, "leaf": 1, "root": 2, "recv": 3}


def seams_of(events: list[ScenarioEvent]) -> set[str]:
    """The chaos seams a timeline injects through. An unmapped kind
    yields an ``unmapped:`` pseudo-seam the ledger flags as unregistered
    — a new EVENT_KINDS entry cannot silently contribute zero
    coverage."""
    out: set[str] = set()
    for ev in events:
        if ev.kind == "partition":
            a, b = sorted(ev.edge or ("?", "?"),
                          key=lambda t: _TIER_ORDER.get(t, 9))
            out.add(f"wire:{a}-{b}")
        else:
            out.update(KIND_SEAMS.get(ev.kind, (f"unmapped:{ev.kind}",)))
    return out


def seam_map_problems() -> list[str]:
    """Both directions of the registry cross-check: every kind mapped,
    every mapped seam registered, every registered seam reachable by
    some kind. Non-empty means the coverage matrix would lie — asserted
    under tier-1 and checked again by the CLI before any trial runs."""
    problems: list[str] = []
    for kind in EVENT_KINDS:
        if kind not in KIND_SEAMS:
            problems.append(
                f"event kind {kind!r} has no KIND_SEAMS entry — its "
                f"trials would count zero seam coverage")
    mapped: set[str] = set()
    for kind, seams in KIND_SEAMS.items():
        mapped.update(seams)
        for s in seams:
            if s not in SEAM_REGISTRY:
                problems.append(
                    f"kind {kind!r} maps to unregistered seam {s!r} "
                    f"(register it in tpu_pod_exporter_torch.chaos)")
    for s in registered_seams():
        if s not in mapped:
            problems.append(
                f"registered seam {s!r} unreachable by any event kind — "
                f"the fuzzer can never exercise it (map a kind to it or "
                f"drop the registration)")
    return problems


# ---------------------------------------------------------- alert envelope

def expected_alert_bounds(
    events: list[ScenarioEvent],
) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """Derive (required, allowed) alert names for a generated timeline
    under the engine's drill rule set. Required alerts MUST fire; allowed
    ones MAY (a random composition can make them legitimately correct —
    a symmetric cut leaves no twin to vouch, so TpuRootLeafDown firing is
    the evaluator being right). Anything outside the union may neither
    fire nor be suppressed (the bound-mode verdict)."""
    required: set[str] = set()
    allowed: set[str] = set()
    root_dead = [(e.at_round, e.end_round) for e in events
                 if e.kind == "root_restart"]
    if root_dead:
        # A fresh root's first merge rounds can transiently drop/suspect
        # leaves; either alert may (correctly) latch around the boundary.
        allowed |= {"TpuRootLeafPartitioned", "TpuRootLeafDown"}
    for e in events:
        if e.kind != "partition" or frozenset(e.edge or ()) != frozenset(
                {"leaf", "root"}):
            continue
        overlaps_dead = any(
            e.at_round < dead_end and dead_start < e.end_round
            for dead_start, dead_end in root_dead
        )
        if e.mode == "asymmetric":
            # One-sided cut with reachable twins: suspicion must latch
            # and the partition alert must fire — unless the root is dead
            # for (part of) the window and may never observe the cut.
            allowed |= {"TpuRootLeafPartitioned", "TpuRootLeafDown"}
            if not overlaps_dead:
                required.add("TpuRootLeafPartitioned")
        else:
            # symmetric/flapping: no twin reachable on cut rounds, so
            # LeafDown is legitimate; staggered heal re-admission can
            # also transiently latch suspicion (the partition_symmetric
            # drill's documented shape).
            allowed |= {"TpuRootLeafPartitioned", "TpuRootLeafDown"}
    return tuple(sorted(required)), tuple(sorted(allowed - required))


def scenario_for_timeline(timeline: str, name: str) -> Scenario:
    """Wrap one generated timeline as an engine Scenario with every
    armable invariant on: egress attached, alerting attached in
    suppress-aware bound mode with the derived envelope."""
    required, allowed = expected_alert_bounds(parse_scenario(timeline))
    return Scenario(
        name=name,
        timeline=timeline,
        description="fuzzer-generated timeline",
        settle_rounds=3,
        uses_egress=True,
        expected_alerts=required,
        allowed_alerts=allowed,
    )


# --------------------------------------------------------- coverage ledger

class CoverageLedger:
    """The (injection seam × invariant) coverage matrix across trials.

    Rows come from the chaos seam registry at construction time (never a
    hardcoded list — a later-registered seam appears as a dark row, not
    a missing one); columns from the engine's INVARIANTS. ``record``
    flags any seam outside the registry instead of counting it, so the
    report's ``unregistered_seams`` is the loud path for drift."""

    def __init__(self) -> None:
        self.seams: tuple[str, ...] = registered_seams()
        self.invariants: tuple[str, ...] = INVARIANTS
        self.trials = 0
        self.pair_trials: dict[tuple[str, str], int] = {}
        self.seam_trials: dict[str, int] = {s: 0 for s in self.seams}
        self.unregistered: set[str] = set()

    def record(self, seams: set[str], invariants: Iterable[str]) -> None:
        """One trial's coverage: every (seam, armed-invariant) pair it
        exercised."""
        self.trials += 1
        armed = tuple(invariants)
        for s in seams:
            if s not in SEAM_REGISTRY:
                self.unregistered.add(s)
                continue
            self.seam_trials[s] = self.seam_trials.get(s, 0) + 1
            for inv in armed:
                self.pair_trials[(s, inv)] = (
                    self.pair_trials.get((s, inv), 0) + 1)

    def dark_pairs(self) -> list[tuple[str, str]]:
        """(seam, invariant) pairs no trial has exercised yet — the
        generation bias's target."""
        return [(s, inv) for s in self.seams for inv in self.invariants
                if (s, inv) not in self.pair_trials]

    def report(self) -> dict:
        matrix = {
            s: {inv: self.pair_trials.get((s, inv), 0)
                for inv in self.invariants}
            for s in self.seams
        }
        pairs_total = len(self.seams) * len(self.invariants)
        dark = self.dark_pairs()
        return {
            "trials": self.trials,
            "seams": list(self.seams),
            "invariants": list(self.invariants),
            "matrix": matrix,
            "pairs_total": pairs_total,
            "pairs_covered": pairs_total - len(dark),
            "dark_pairs": [list(p) for p in dark],
            "unregistered_seams": sorted(self.unregistered),
        }


def kind_weights(seam_trials: dict[str, int]) -> dict[str, float]:
    """Generation bias: kinds whose seams are still dark draw more
    often. Seam-level darkness is the right proxy for pair-level
    darkness here because a trial's armed-invariant set is fixed by
    construction (TRIAL_STATIC_INVARIANTS) — once a seam has been hit,
    its reachable pairs light together."""
    out: dict[str, float] = {}
    for kind, seams in KIND_SEAMS.items():
        dark = sum(1 for s in seams if seam_trials.get(s, 0) == 0)
        out[kind] = 1.0 + 2.0 * dark
    return out


# -------------------------------------------------------------- generation

def _trial_rng(seed: int, trial: int) -> random.Random:
    return random.Random(f"{seed}:{trial}:timeline")


def timeline_for_trial(seed: int, trial: int) -> str:
    """The pure (seed, trial) → canonical timeline function. Bias weights
    are reconstructed by replaying GENERATION (not engine runs) of the
    earlier trials of this seed — cheap, and the reason a reproducer is
    two integers instead of a corpus file."""
    counts: dict[str, int] = {s: 0 for s in registered_seams()}
    for t in range(trial + 1):
        tl = generate_timeline(
            _trial_rng(seed, t), TRIAL_BOUNDS, TRIAL_MAX_EVENTS,
            weights=kind_weights(counts),
        )
        if t == trial:
            return tl
        for s in seams_of(parse_scenario(tl)):
            if s in counts:
                counts[s] += 1
    raise AssertionError("unreachable")


def schedule_trace(trace: list[dict]) -> list[dict]:
    """The deterministic projection of a per-tick engine trace: the
    injected schedule (round, active windows, effective cuts — flap
    phases included, they are seeded). Wall-clock-paced fields (breaker
    re-admission, stale-serve flips) are excluded by design; the
    determinism audit asserts THIS projection is identical across two
    runs of one (seed, trial)."""
    return [{"round": t["round"], "active": t["active"],
             "cuts": t["cuts"]} for t in trace]


# --------------------------------------------------------------- minimizer

def _revalidate(events: list[ScenarioEvent]) -> list[ScenarioEvent] | None:
    """Canonical render→parse round trip; None when the candidate is not
    a valid timeline (overlaps introduced by a shrink, empty list). The
    minimizer only ever hands VALIDATED candidates to its predicate."""
    if not events:
        return None
    try:
        return parse_scenario(render_timeline(events))
    except ValueError:
        return None


def _shrink_variants(ev: ScenarioEvent) -> list[ScenarioEvent]:
    """Single-field shrinks of one event, strongest first. Every variant
    goes through render→parse (restart_wave re-derives its duration;
    anything the grammar rejects is dropped here, not downstream)."""
    out: list[ScenarioEvent] = []

    def variant(**kw: object) -> None:
        cand = dataclasses.replace(ev, **kw)  # type: ignore[arg-type]
        if cand.kind == "restart_wave":
            cand.duration = -(-cand.count // cand.stagger)
        try:
            parsed = parse_scenario(render_event(cand))
        except ValueError:
            return
        out.append(parsed[0])

    floor = 2 if ev.kind == "dashboard_storm" else 1
    if ev.kind not in ("restart_wave", "clock_step") and ev.duration > floor:
        variant(duration=floor)
    count_floors = {"restart_wave": 1, "churn_storm": 2,
                    "scrape_storm": 1, "dashboard_storm": 1}
    if ev.kind in count_floors and ev.count > count_floors[ev.kind]:
        variant(count=count_floors[ev.kind],
                stagger=min(ev.stagger, count_floors[ev.kind])
                if ev.kind == "restart_wave" else ev.stagger)
    if ev.kind == "restart_wave" and ev.stagger > 1:
        variant(stagger=1)
    if ev.kind == "clock_step" and abs(ev.step_s) > 45.0:
        variant(step_s=45.0 if ev.step_s > 0 else -45.0)
    if ev.at_round > TRIAL_BOUNDS.min_round:
        variant(at_round=TRIAL_BOUNDS.min_round)
    return out


def minimize(
    events: list[ScenarioEvent],
    failing: Callable[[list[ScenarioEvent]], bool],
    max_checks: int = 64,
) -> list[ScenarioEvent]:
    """Delta-debugging minimizer: ddmin over the event list, then greedy
    per-event field shrinks. ``failing(candidate)`` returns True when the
    candidate still fails; candidates are enumerated in a fixed order and
    validated (render→parse) BEFORE the predicate sees them, so shrink
    steps never produce an invalid timeline and the result is
    deterministic for a deterministic predicate. ``max_checks`` bounds
    predicate invocations (each may be a full engine run)."""
    checks = 0

    def still_fails(cand: list[ScenarioEvent]) -> bool:
        nonlocal checks
        if checks >= max_checks:
            return False
        valid = _revalidate(cand)
        if valid is None:
            return False
        checks += 1
        return failing(valid)

    cur = _revalidate(events)
    if cur is None:
        raise ValueError("minimize: the input timeline is not valid")

    # Phase 1: classic ddmin to a 1-minimal SUBSET of events.
    granularity = 2
    while len(cur) >= 2:
        chunk = max(len(cur) // granularity, 1)
        reduced = False
        for i in range(0, len(cur), chunk):
            cand = cur[:i] + cur[i + chunk:]
            if cand and still_fails(cand):
                cur = _revalidate(cand) or cur
                granularity = max(granularity - 1, 2)
                reduced = True
                break
        if not reduced:
            if chunk == 1:
                break
            granularity = min(granularity * 2, len(cur))

    # Phase 2: greedy field shrinks, repeated until a full pass holds.
    improved = True
    while improved and checks < max_checks:
        improved = False
        for idx in range(len(cur)):
            for shrunk in _shrink_variants(cur[idx]):
                cand = [*cur[:idx], shrunk, *cur[idx + 1:]]
                if still_fails(cand):
                    cur = _revalidate(cand) or cur
                    improved = True
                    break
            if improved:
                break
    return cur


# ------------------------------------------------------------- trial runs

def run_trial(seed: int, trial: int, timeline: str,
              state_dir: str) -> tuple[dict, list[dict]]:
    """One generated timeline through the full engine (same _Run the
    named drills use — zero harness drift).

    The state dir is wiped first: a leftover WAL from a previous run
    makes the shipper resume its persisted seq counter against a fresh
    receiver ledger, which the contiguity invariant would (correctly,
    but spuriously for replay purposes) flag as acked-sample loss.
    """
    from tpu_pod_exporter_torch.loadgen.scenario import run_one

    shutil.rmtree(state_dir, ignore_errors=True)
    scn = scenario_for_timeline(timeline, f"fuzz_s{seed}_t{trial}")
    return run_one(scn, TRIAL_TARGETS, TRIAL_SHARDS, TRIAL_CHIPS,
                   state_dir, seed)


def _engine_predicate(seed: int,
                      min_root: str) -> Callable[[list[ScenarioEvent]], bool]:
    """The minimizer's predicate for real failures: render the candidate,
    run it on a fresh stack, True when the run fails. Each candidate gets
    its own state dir so reproducer state survives for the artifact."""
    counter = [0]

    def failing(events: list[ScenarioEvent]) -> bool:
        counter[0] += 1
        result, _trace = run_trial(
            seed, 10_000 + counter[0], render_timeline(events),
            os.path.join(min_root, f"min-{counter[0]:03d}"))
        return not result["ok"]

    return failing


def _write_failure_artifacts(state_root: str, seed: int, trial: int,
                             timeline: str, minimized: str,
                             result: dict, trace: list[dict]) -> str:
    fdir = os.path.join(state_root, f"failure-s{seed}-t{trial}")
    os.makedirs(fdir, exist_ok=True)
    def _put(name: str, text: str) -> None:
        with open(os.path.join(fdir, name), "w", encoding="utf-8") as f:
            f.write(text)
    _put("timeline.txt", timeline + "\n")
    _put("minimized.txt", minimized + "\n")
    _put("replay.txt",
         f"python -m tpu_pod_exporter_torch.loadgen.scenario "
         f"--fuzz-replay {seed}:{trial}\n"
         f"python -m tpu_pod_exporter_torch.loadgen.scenario "
         f"--timeline '{minimized}'\n")
    _put("result.json", json.dumps(result, indent=1, default=str))
    _put("scenario-trace.json", json.dumps(trace, indent=1, default=str))
    return fdir


def replay(seed: int, trial: int, state_root: str = "fuzz-state") -> int:
    """Deterministic replay of one trial from its coordinates alone (the
    engine's ``--fuzz-replay`` delegates here). Regenerates the timeline,
    reruns it, writes the same artifacts a fuzzing run would."""
    timeline = timeline_for_trial(seed, trial)
    print(f"fuzz replay s{seed} t{trial}: {timeline}")
    state_dir = os.path.join(state_root, f"replay-s{seed}-t{trial}")
    result, trace = run_trial(seed, trial, timeline, state_dir)
    if result["ok"]:
        print(f"fuzz replay s{seed} t{trial} OK "
              f"({result.get('trace_ticks')} ticks)")
        return 0
    fdir = _write_failure_artifacts(state_root, seed, trial, timeline,
                                    timeline, result, trace)
    print(f"fuzz replay s{seed} t{trial} FAILED: "
          f"{'; '.join(result.get('problems', [])[:2])} — artifacts in "
          f"{fdir}", file=sys.stderr)
    return 1


# -------------------------------------------------------------------- CLI

def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="tpu-scenario-fuzz",
        description="Seeded scenario fuzzer: random valid timelines "
                    "through the full engine with every invariant armed; "
                    "failures delta-debugged to minimal reproducers; "
                    "(seam x invariant) coverage tracked against the "
                    "chaos seam registry (make fuzz-smoke).",
    )
    p.add_argument("--seeds", default="5",
                   help="comma-separated seed list (each runs --trials "
                        "trials)")
    p.add_argument("--trials", type=int, default=6,
                   help="trials per seed")
    p.add_argument("--state-root", default="fuzz-state",
                   help="per-trial state dirs + coverage.json + failure "
                        "artifact dirs (uploaded by CI on failure)")
    p.add_argument("--replay", default="", metavar="SEED:TRIAL",
                   help="replay one trial deterministically from its "
                        "coordinates instead of fuzzing")
    p.add_argument("--max-shrink-runs", type=int, default=24,
                   help="minimizer budget: engine runs spent shrinking "
                        "one failure")
    p.add_argument("--keep-going", action="store_true",
                   help="run every trial even after a failure (default: "
                        "stop at the first, like the scenario demo)")
    p.add_argument("--log-level", default="warning")
    ns = p.parse_args(argv)

    from tpu_pod_exporter_torch import utils as _utils
    _utils.setup_logging(ns.log_level)

    problems = seam_map_problems()
    if problems:
        for msg in problems:
            print(f"SEAM REGISTRY DRIFT: {msg}", file=sys.stderr)
        return 2

    if ns.replay:
        try:
            seed_s, _, trial_s = ns.replay.partition(":")
            seed, trial = int(seed_s), int(trial_s)
        except ValueError:
            p.error(f"--replay wants SEED:TRIAL (got {ns.replay!r})")
        return replay(seed, trial, state_root=ns.state_root)

    try:
        seeds = [int(s) for s in ns.seeds.split(",") if s.strip()]
    except ValueError:
        p.error(f"--seeds wants comma-separated integers "
                f"(got {ns.seeds!r})")
    os.makedirs(ns.state_root, exist_ok=True)
    ledger = CoverageLedger()
    failures: list[tuple[int, int]] = []
    for seed in seeds:
        # Bias weights replay generation per seed (see timeline_for_trial
        # — the incremental form of the same pure function).
        counts: dict[str, int] = {s: 0 for s in registered_seams()}
        for trial in range(ns.trials):
            timeline = generate_timeline(
                _trial_rng(seed, trial), TRIAL_BOUNDS, TRIAL_MAX_EVENTS,
                weights=kind_weights(counts),
            )
            events = parse_scenario(timeline)
            seams = seams_of(events)
            for s in seams:
                if s in counts:
                    counts[s] += 1
            state_dir = os.path.join(ns.state_root, f"s{seed}-t{trial}")
            result, trace = run_trial(seed, trial, timeline, state_dir)
            ledger.record(
                seams,
                result.get("invariants_armed") or TRIAL_STATIC_INVARIANTS)
            status = "ok" if result["ok"] else "FAILED"
            print(f"  s{seed} t{trial:<3} {status:<7} {timeline}",
                  flush=True)
            if result["ok"]:
                continue
            failures.append((seed, trial))
            print(f"    problems: "
                  f"{'; '.join(result.get('problems', [])[:2])}",
                  flush=True)
            minimized_events = minimize(
                events,
                _engine_predicate(
                    seed, os.path.join(ns.state_root,
                                       f"minimize-s{seed}-t{trial}")),
                max_checks=ns.max_shrink_runs,
            )
            minimized = render_timeline(minimized_events)
            fdir = _write_failure_artifacts(
                ns.state_root, seed, trial, timeline, minimized,
                result, trace)
            print(f"    minimized: {minimized}\n"
                  f"    replay:    python -m "
                  f"tpu_pod_exporter_torch.loadgen.scenario --fuzz-replay "
                  f"{seed}:{trial}\n"
                  f"    artifacts: {fdir}", flush=True)
            if not ns.keep_going:
                break
        if failures and not ns.keep_going:
            break

    report = ledger.report()
    try:
        with open(os.path.join(ns.state_root, "coverage.json"), "w",
                  encoding="utf-8") as f:
            json.dump(report, f, indent=1)
    except OSError:
        pass
    print(f"fuzz: {report['trials']} trial(s), "
          f"{report['pairs_covered']}/{report['pairs_total']} "
          f"(seam x invariant) pairs covered, "
          f"{len(report['dark_pairs'])} dark, "
          f"{len(failures)} failure(s)")
    if report["unregistered_seams"]:
        print(f"fuzz: UNREGISTERED seams referenced: "
              f"{report['unregistered_seams']}", file=sys.stderr)
        return 2
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
