"""Declarative fleet scenario timelines — the chaos DSL for end-to-end drills.

Every chaos tool so far is per-subsystem: ``chaos.py`` wraps one source,
``LeafKillHook`` kills one leaf, ``ChaosReceiver`` flaps one receiver. A
real TPU-fleet incident is a *composition* — a network partition during a
reshard during an egress backlog drain — and nothing scripted those
against the whole stack. This module is the timeline language for the
fleet scenario engine (``tpu_pod_exporter_torch.loadgen.scenario``): a seeded,
deterministic schedule of named events on a logical round clock, parsed
up front with loud, actionable errors (the ``parse_chaos_spec`` contract:
a typo'd drill must fail at parse time, not silently inject nothing).

Grammar (``--timeline``; events separated by ``;`` or top-level ``,``)::

    timeline := event ((";" | ",") event)*
    event    := kind "(" args ")" "@" round ["+" duration]

    partition(tierA<->tierB, symmetric|asymmetric|flapping)
    preempt(slice-N)                  SIGTERM-shaped: every host of the slice
    restart_wave(N [, stagger=K])     N hosts restart, K per round
    churn_storm(N)                    N targets removed+added per window,
                                      plus a workload label-churn wave
    hotspot(podname)                  one workload's duty/HBM spikes
    recv_outage()                     the remote-write receiver answers 503
    disk_full()                       the disk budget collapses under the
                                      durable-state dirs (pressure governor
                                      must shed, reclaim, and recover)
    mem_pressure()                    the memory budget collapses under the
                                      byte-accounted caches/rings
    scrape_storm(N)                   N aggressive keep-alive connections
                                      hammer the serving tier
    clock_step(S)                     one NTP-shaped wall-clock step of S
                                      seconds (signed; instantaneous)
    root_restart()                    SIGKILL-shaped root death for the
                                      +duration window, then a fresh root
                                      (and fleet store) on the same dirs

``@round`` is the event's first engine round (0-based); ``+duration`` is
the window length in rounds (default 1). Examples::

    partition(leaf<->root, symmetric)@3+3
    partition(leaf<->root, asymmetric)@2+4; recv_outage()@4+2
    preempt(slice-2)@3+3, restart_wave(6, stagger=2)@8

Partition semantics (interpreted by the engine through
``chaos.PartitionState``):

- ``symmetric`` — every edge between the two tiers is cut, both logical
  directions (for an HTTP pull seam the fetch direction is the wire; a
  symmetric tier cut means *no* leaf of an HA pair is reachable).
- ``asymmetric`` — a one-sided cut: only the FIRST leaf of each HA pair
  (or, for ``node<->leaf``, only the ``a`` leaves' paths) loses the edge,
  so every shard keeps a healthy path via its twin. This is the
  "reachable by everyone except the root" shape the HA dedup must absorb
  without losing a series or flapping the freshest-wins winner.
- ``flapping`` — the cut alternates open/cut per engine round on a
  seeded phase (``chaos.Cut``), the shape that punishes breakers whose
  half-open probe success resets their backoff.

Named scenarios (the ``make scenario-demo`` set) live in
:data:`SCENARIOS`; each is just a timeline string plus the engine's
per-tick invariants, so new drills are one dict entry, not new code.
"""

from __future__ import annotations

import random
import re
from collections.abc import Callable
from dataclasses import dataclass, field

EVENT_KINDS: tuple[str, ...] = (
    "partition", "preempt", "restart_wave", "churn_storm", "hotspot",
    "recv_outage",
    # Resource-pressure kinds: the MACHINE misbehaving —
    # interpreted by the engine through the pressure governor and the
    # chaos host-level injectors (ClockStepper / ScrapeStorm).
    "disk_full", "mem_pressure", "scrape_storm", "clock_step",
    # Fleet-store kind: SIGKILL-shaped root death for
    # +duration rounds, then a fresh root (and fleet store, when one is
    # attached) rebuilt on the same state dirs — the store-continuity
    # drill's boundary.
    "root_restart",
    # Streaming dashboard kind: N stream subscriptions held
    # against the root's /api/v1/stream for the window; per-tick
    # invariants assert delta-replay == polled answer, zero seq gaps/
    # dups, and bounded push latency. --stream off is the drill's
    # negative control (the subscriptions cannot register; the run must
    # fail).
    "dashboard_storm",
)

TIERS: tuple[str, ...] = ("node", "leaf", "root", "recv")

# The scenario engine's invariant families, enumerable for the fuzzer's
# (seam × invariant) coverage ledger. Names, not code: each maps to a
# check documented in tpu_pod_exporter_torch.loadgen.scenario (its docstring's
# numbered invariants plus the PR-16 alerting verdict). Declared here —
# the typed DSL layer — so the fuzzer and tests can enumerate them
# without importing the engine.
INVARIANTS: tuple[str, ...] = (
    "oracle_equality",      # quiet-round root == oracle rollup equality
    "egress_ledger",        # exactly-once receiver ledger
    "bounded_staleness",    # per-tier staleness budgets
    "series_rss_leaks",     # series set + RSS bounded after churn
    "fault_attribution",    # every fault readable from the exposition
    "alerts_correctness",   # fired-set / suppress-aware alert verdict
)

PARTITION_MODES: tuple[str, ...] = ("symmetric", "asymmetric", "flapping")

# Tier pairs the engine knows how to cut (unordered): the three seams the
# stack actually crosses. node<->root would be meaningless (the root never
# talks to nodes) and is rejected at parse time.
PARTITION_EDGES: frozenset[frozenset[str]] = frozenset({
    frozenset({"node", "leaf"}),
    frozenset({"leaf", "root"}),
    frozenset({"root", "recv"}),
})

_EVENT_RE = re.compile(
    r"^(?P<kind>[a-z_]+)\((?P<args>[^()]*)\)"
    r"@(?P<round>-?\d+)(?:\+(?P<dur>-?\d+))?$"
)
_EDGE_RE = re.compile(r"^(?P<a>[a-z]+)\s*<->\s*(?P<b>[a-z]+)$")
_SLICE_RE = re.compile(r"^slice-(?P<n>\d+)$")


@dataclass
class ScenarioEvent:
    """One parsed timeline event. ``at_round`` .. ``end_round`` (exclusive)
    is the injected window; single-round events have duration 1."""

    kind: str
    at_round: int
    duration: int = 1
    edge: tuple[str, str] | None = None  # partition: (tierA, tierB) as given
    mode: str = ""                       # partition: symmetric|asymmetric|flapping
    subject: str = ""                    # preempt: slice id; hotspot: pod
    count: int = 0                       # restart_wave / churn_storm / scrape_storm
    stagger: int = 1                     # restart_wave: hosts per round
    step_s: float = 0.0                  # clock_step: signed seconds
    raw: str = field(default="", compare=False)

    @property
    def end_round(self) -> int:
        return self.at_round + self.duration

    def overlap_key(self) -> tuple:
        """Identity for the no-overlapping-events rule: two events with the
        same key may not have intersecting windows (the engine cannot
        apply e.g. two preempts of the same slice at once, and silently
        merging them would make the drill lie about what it injected)."""
        if self.kind == "partition":
            return ("partition", frozenset(self.edge or ()))
        if self.kind in ("preempt", "hotspot"):
            return (self.kind, self.subject)
        return (self.kind,)


def _err(raw: str, msg: str) -> ValueError:
    return ValueError(f"scenario event {raw!r}: {msg}")


def _split_events(spec: str) -> list[str]:
    """Split a timeline on ``;`` and top-level ``,`` (commas inside an
    event's parens belong to its arg list)."""
    out: list[str] = []
    buf: list[str] = []
    depth = 0
    for ch in spec:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(depth - 1, 0)
        if ch == ";" or (ch == "," and depth == 0):
            out.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    out.append("".join(buf))
    return [s.strip() for s in out if s.strip()]


def parse_event(raw: str) -> ScenarioEvent:
    """One event string → :class:`ScenarioEvent`; raises ValueError with a
    message naming the offending token and what would be accepted."""
    m = _EVENT_RE.match(raw.strip())
    if m is None:
        raise _err(raw, "want kind(args)@round[+duration], e.g. "
                        "partition(leaf<->root, symmetric)@3+2")
    kind = m.group("kind")
    if kind not in EVENT_KINDS:
        raise _err(raw, f"unknown event kind {kind!r} "
                        f"(want one of {'/'.join(EVENT_KINDS)})")
    at_round = int(m.group("round"))
    if at_round < 0:
        raise _err(raw, f"round {at_round} is negative — the timeline "
                        f"starts at round 0")
    duration = int(m.group("dur")) if m.group("dur") is not None else 1
    if duration < 1:
        raise _err(raw, f"duration +{duration} must be at least +1 round")
    args = [a.strip() for a in m.group("args").split(",") if a.strip()]
    ev = ScenarioEvent(kind=kind, at_round=at_round, duration=duration,
                       raw=raw.strip())

    if kind == "partition":
        if len(args) != 2:
            raise _err(raw, "partition wants exactly (tierA<->tierB, mode)")
        em = _EDGE_RE.match(args[0])
        if em is None:
            raise _err(raw, f"bad edge {args[0]!r}: want tierA<->tierB "
                            f"with tiers from {'/'.join(TIERS)}")
        a, b = em.group("a"), em.group("b")
        for t in (a, b):
            if t not in TIERS:
                raise _err(raw, f"unknown tier {t!r} "
                                f"(want one of {'/'.join(TIERS)})")
        if a == b:
            raise _err(raw, f"edge {args[0]!r} connects {a!r} to itself")
        if frozenset({a, b}) not in PARTITION_EDGES:
            valid = ", ".join(sorted(
                "<->".join(sorted(e)) for e in PARTITION_EDGES))
            raise _err(raw, f"the stack has no {a}<->{b} seam "
                            f"(cuttable edges: {valid})")
        if args[1] not in PARTITION_MODES:
            raise _err(raw, f"unknown partition mode {args[1]!r} "
                            f"(want one of {'/'.join(PARTITION_MODES)})")
        ev.edge = (a, b)
        ev.mode = args[1]
        return ev

    if kind == "preempt":
        if len(args) != 1:
            raise _err(raw, "preempt wants exactly (slice-N)")
        if _SLICE_RE.match(args[0]) is None:
            raise _err(raw, f"bad slice coordinate {args[0]!r}: want "
                            f"slice-N (the farm's slice ids)")
        ev.subject = args[0]
        return ev

    if kind == "restart_wave":
        if not args or len(args) > 2:
            raise _err(raw, "restart_wave wants (N[, stagger=K])")
        try:
            ev.count = int(args[0])
        except ValueError:
            raise _err(raw, f"bad host count {args[0]!r}: want an integer"
                       ) from None
        if ev.count < 1:
            raise _err(raw, f"host count {ev.count} must be >= 1")
        if len(args) == 2:
            k, sep, v = args[1].partition("=")
            if not sep or k.strip() != "stagger":
                raise _err(raw, f"unknown restart_wave option {args[1]!r} "
                                f"(want stagger=K)")
            try:
                ev.stagger = int(v)
            except ValueError:
                raise _err(raw, f"bad stagger {v!r}: want an integer"
                           ) from None
            if ev.stagger < 1:
                raise _err(raw, f"stagger {ev.stagger} must be >= 1")
        # A wave IS its own duration: ceil(count / stagger) rounds of
        # restarts. An explicit +duration on a wave would either truncate
        # it (silently skipping restarts) or pad it (idle rounds lying in
        # the injected window), so it is rejected.
        if m.group("dur") is not None:
            raise _err(raw, "restart_wave derives its duration from "
                            "count/stagger; drop the +duration")
        ev.duration = -(-ev.count // ev.stagger)
        return ev

    if kind == "churn_storm":
        if len(args) != 1:
            raise _err(raw, "churn_storm wants exactly (N targets per wave)")
        try:
            ev.count = int(args[0])
        except ValueError:
            raise _err(raw, f"bad churn size {args[0]!r}: want an integer"
                       ) from None
        if ev.count < 2:
            raise _err(raw, f"churn size {ev.count} must be >= 2 "
                            f"(each wave removes and adds)")
        return ev

    if kind == "hotspot":
        if len(args) != 1 or not args[0]:
            raise _err(raw, "hotspot wants exactly (podname)")
        ev.subject = args[0]
        return ev

    if kind == "scrape_storm":
        if len(args) != 1:
            raise _err(raw, "scrape_storm wants exactly (N connections)")
        try:
            ev.count = int(args[0])
        except ValueError:
            raise _err(raw, f"bad connection count {args[0]!r}: want an "
                            f"integer") from None
        if ev.count < 1:
            raise _err(raw, f"connection count {ev.count} must be >= 1")
        return ev

    if kind == "dashboard_storm":
        if len(args) != 1:
            raise _err(raw, "dashboard_storm wants exactly "
                            "(N subscriptions)")
        try:
            ev.count = int(args[0])
        except ValueError:
            raise _err(raw, f"bad subscription count {args[0]!r}: want an "
                            f"integer") from None
        if ev.count < 1:
            raise _err(raw, f"subscription count {ev.count} must be >= 1")
        if ev.duration < 2:
            raise _err(raw, "dashboard_storm needs +duration >= 2 — a "
                            "one-round stream never receives a delta, so "
                            "the replay invariant would assert nothing")
        return ev

    if kind == "clock_step":
        if len(args) != 1:
            raise _err(raw, "clock_step wants exactly (±seconds)")
        try:
            ev.step_s = float(args[0])
        except ValueError:
            raise _err(raw, f"bad step {args[0]!r}: want signed seconds, "
                            f"e.g. -45 or +3600") from None
        if ev.step_s == 0:
            raise _err(raw, "a clock step of 0 seconds injects nothing")
        # A step is an INSTANT, not a window: an explicit +duration would
        # either re-step every round (compounding, lying about the fault)
        # or idle (padding the injected window) — same rule as
        # restart_wave's derived duration.
        if m.group("dur") is not None:
            raise _err(raw, "clock_step is instantaneous; drop the "
                            "+duration")
        return ev

    # recv_outage / disk_full / mem_pressure / root_restart
    # (root_restart's +duration is the DOWNTIME window in rounds: the
    # root is dead for the window, restarted when it closes.)
    if args:
        raise _err(raw, f"{kind} takes no arguments (got {args})")
    return ev


def parse_scenario(spec: str) -> list[ScenarioEvent]:
    """Full timeline → event list sorted by start round, with the
    no-overlap rule enforced across events of the same identity."""
    events = [parse_event(raw) for raw in _split_events(spec)]
    if not events:
        raise ValueError(f"scenario timeline {spec!r} contains no events")
    events.sort(key=lambda e: (e.at_round, e.raw))
    by_key: dict[tuple, ScenarioEvent] = {}
    for ev in events:
        prev = by_key.get(ev.overlap_key())
        if prev is not None and ev.at_round < prev.end_round:
            raise ValueError(
                f"scenario events {prev.raw!r} and {ev.raw!r} overlap "
                f"(rounds {ev.at_round}..{min(prev.end_round, ev.end_round) - 1}); "
                f"the engine applies one event per identity at a time — "
                f"stagger them or merge the windows"
            )
        by_key[ev.overlap_key()] = ev
    return events


def total_rounds(events: list[ScenarioEvent], settle: int = 3) -> int:
    """Driver rounds a timeline needs: past the last window plus settle
    rounds for heal/recovery assertions."""
    return max(ev.end_round for ev in events) + settle


# ---------------------------------------------------------------- rendering

# Tier order for canonical edge rendering: node<->leaf, never leaf<->node.
_TIER_RANK: dict[str, int] = {t: i for i, t in enumerate(TIERS)}


def render_event(ev: ScenarioEvent) -> str:
    """One event → its canonical DSL text (the alert-rule ``render_rules``
    pattern). ``parse_event`` accepts every output: edges are tier-ordered,
    defaulted fields (``+1`` duration, ``stagger=1``) are omitted, and the
    kinds whose duration is derived or rejected (restart_wave, clock_step)
    never render one — so render∘parse is idempotent and a minimized fuzz
    reproducer commits as a plain string that replays byte-identically."""
    if ev.kind == "partition":
        a, b = sorted(ev.edge or ("?", "?"), key=lambda t: _TIER_RANK.get(t, 9))
        args = f"{a}<->{b}, {ev.mode}"
    elif ev.kind in ("preempt", "hotspot"):
        args = ev.subject
    elif ev.kind == "restart_wave":
        args = str(ev.count)
        if ev.stagger != 1:
            args += f", stagger={ev.stagger}"
    elif ev.kind in ("churn_storm", "scrape_storm", "dashboard_storm"):
        args = str(ev.count)
    elif ev.kind == "clock_step":
        args = f"{ev.step_s:g}"
    else:
        args = ""
    out = f"{ev.kind}({args})@{ev.at_round}"
    if ev.duration != 1 and ev.kind not in ("restart_wave", "clock_step"):
        out += f"+{ev.duration}"
    return out


def render_timeline(events: list[ScenarioEvent]) -> str:
    """Event list → canonical timeline text. Events sort by
    ``(at_round, rendered)`` — exactly the order ``parse_scenario`` yields
    for canonical text (it sorts on ``raw``, which IS the rendered form
    after one round trip) — so ``render_timeline(parse_scenario(s))`` is a
    fixpoint for every valid ``s``."""
    return "; ".join(
        r for _at, r in sorted((e.at_round, render_event(e)) for e in events)
    )


# --------------------------------------------------------------- generation

@dataclass(frozen=True)
class GenBounds:
    """The fuzzer's draw envelope. Bounds are ENGINE-facing, not
    grammar-facing: the grammar allows unbounded counts and rounds, but a
    generated drill must finish inside a smoke budget against a small
    farm, so coordinates and sizes are capped here. Every value is a cap
    on what :func:`generate_event` draws — the generated text still goes
    through :func:`parse_event`, whose rules remain the only validity
    oracle."""

    # Window coordinates: after the engine's 2 warmup rounds, bounded so
    # total_rounds stays smoke-sized.
    min_round: int = 2
    max_round: int = 8
    max_duration: int = 3
    # Farm-shape caps (the fuzz harness runs small fleets).
    slices: int = 4
    pods: int = 8
    max_wave: int = 6
    max_churn: int = 12
    max_storm_conns: int = 64
    max_dash_subs: int = 32
    # NTP-shaped steps the clock fence must absorb, both directions.
    clock_steps: tuple[float, ...] = (-3600.0, -45.0, 45.0, 3600.0)


def generate_event(kind: str, rng: random.Random,
                   bounds: GenBounds = GenBounds()) -> str:
    """Draw one random event of ``kind`` as DSL text. Each branch mirrors
    ``parse_event``'s argument shape; an unknown kind raises, so the
    every-kind property test fails loudly when a new EVENT_KINDS entry
    lands without a generator branch (the can't-silently-omit rule)."""
    at = rng.randint(bounds.min_round, bounds.max_round)
    dur = rng.randint(1, bounds.max_duration)
    suffix = f"@{at}" + (f"+{dur}" if dur != 1 else "")
    if kind == "partition":
        edges = sorted(
            "<->".join(sorted(e, key=lambda t: _TIER_RANK.get(t, 9)))
            for e in PARTITION_EDGES
        )
        return (f"partition({rng.choice(edges)}, "
                f"{rng.choice(PARTITION_MODES)}){suffix}")
    if kind == "preempt":
        return f"preempt(slice-{rng.randrange(bounds.slices)}){suffix}"
    if kind == "restart_wave":
        count = rng.randint(1, bounds.max_wave)
        stagger = rng.randint(1, count)
        opt = f", stagger={stagger}" if stagger != 1 else ""
        return f"restart_wave({count}{opt})@{at}"
    if kind == "churn_storm":
        return f"churn_storm({rng.randint(2, bounds.max_churn)}){suffix}"
    if kind == "hotspot":
        return f"hotspot(job-{rng.randrange(bounds.pods)}){suffix}"
    if kind == "recv_outage" or kind == "disk_full" \
            or kind == "mem_pressure" or kind == "root_restart":
        return f"{kind}(){suffix}"
    if kind == "scrape_storm":
        return f"scrape_storm({rng.randint(1, bounds.max_storm_conns)}){suffix}"
    if kind == "clock_step":
        return f"clock_step({rng.choice(bounds.clock_steps):g})@{at}"
    if kind == "dashboard_storm":
        dur = rng.randint(2, max(2, bounds.max_duration))
        return f"dashboard_storm({rng.randint(1, bounds.max_dash_subs)})@{at}+{dur}"
    raise ValueError(
        f"no generator for event kind {kind!r} — every EVENT_KINDS entry "
        f"needs a generate_event branch (the fuzzer's coverage depends on "
        f"it)")


def generate_timeline(
    rng: random.Random,
    bounds: GenBounds = GenBounds(),
    max_events: int = 4,
    kinds: tuple[str, ...] = EVENT_KINDS,
    weights: dict[str, float] | None = None,
    reject: Callable[[list[ScenarioEvent]], bool] | None = None,
) -> str:
    """Compose one random VALID timeline and return its canonical text.

    Kinds are drawn (optionally weighted — the fuzzer biases toward dark
    coverage pairs), each event generated, and a draw survives only if
    the grown timeline still parses: :func:`parse_scenario` IS the
    rejection oracle (overlap rule included), so the generator can never
    drift from the grammar. ``reject(events) -> bool`` layers an
    engine-level validity predicate on top (the fuzz harness passes its
    supported-composition rule); rejected draws are redrawn, never
    repaired, so the output distribution stays a pure function of the
    rng stream."""
    want = rng.randint(1, max(1, max_events))
    chosen: list[str] = []
    kind_list = list(kinds)
    weight_list = (
        [float(weights.get(k, 1.0)) for k in kind_list]
        if weights is not None else None
    )
    for _attempt in range(32 * max(want, 1)):
        if len(chosen) >= want:
            break
        if weight_list is not None:
            kind = rng.choices(kind_list, weights=weight_list, k=1)[0]
        else:
            kind = rng.choice(kind_list)
        cand = [*chosen, generate_event(kind, rng, bounds)]
        try:
            events = parse_scenario("; ".join(cand))
        except ValueError:
            continue
        if reject is not None and reject(events):
            continue
        chosen = cand
    if not chosen:
        # Unreachable with sane bounds (any single partition parses), but
        # a degenerate reject predicate must not return an empty timeline.
        raise ValueError("generate_timeline: no valid draw survived the "
                         "rejection oracle — bounds or reject predicate "
                         "exclude every single-event timeline")
    return render_timeline(parse_scenario("; ".join(chosen)))


@dataclass(frozen=True)
class Scenario:
    """One named drill: a timeline plus what the engine should expect."""

    name: str
    timeline: str
    description: str
    # Tunables the engine reads:
    settle_rounds: int = 3
    uses_egress: bool = True
    # Attach a FleetStore to the root (tpu_pod_exporter_torch.store): the
    # store-continuity drill's subject. The engine's --store off flag
    # is this drill's negative control — the continuity invariant still
    # runs and must FAIL on the gap.
    uses_store: bool = False
    # Minimum wall time per engine round. The store drill NEEDS paced
    # rounds: a bucket only becomes durable when the NEXT one opens, and
    # a SIGKILL legitimately loses the open bucket — back-to-back
    # subsecond rounds would cram every pre-kill sample into one open
    # bucket and make the (correct) continuity invariant flaky.
    round_pause_s: float = 0.0
    # Mixed-fleet drills: the engine farm's LAST gpu_slices slices become
    # GPU node pools (gpu_* node surface, family="gpu" rollups). 0 keeps
    # the farm homogeneous — every pre-GPU drill runs byte-identically.
    gpu_slices: int = 0
    # Alerting teeth: when non-None the engine attaches an in-root
    # AlertEvaluator (tpu_pod_exporter_torch.alerting) with the drill rule set
    # and asserts at finish that EXACTLY this set of alert names reached
    # firing — no more, no fewer. () means "alerting on, nothing may
    # fire". None keeps the drill alert-free (pre-alerting drills run
    # byte-identically). --alert-suppression off is the negative
    # control: suppression is disabled, the suppressed alert fires too,
    # and the fired-set assertion must FAIL.
    expected_alerts: tuple[str, ...] | None = None
    # Suppress-aware BOUND mode for GENERATED timelines (the fuzzer): a
    # random composition can make an allowed-but-not-required alert fire
    # legitimately (a symmetric cut leaves no twin to vouch, so
    # TpuRootLeafDown is correct, not a violation). When non-None the
    # finish asserts expected ⊆ fired ⊆ expected ∪ allowed instead of
    # exact equality — and anything the evaluator SUPPRESSED must also
    # sit inside that envelope. None keeps the hand-written drills'
    # exact-set assertion (strictly stronger; never weakened by fuzzing).
    allowed_alerts: tuple[str, ...] | None = None

    def events(self) -> list[ScenarioEvent]:
        return parse_scenario(self.timeline)


# The make scenario-demo set. Round coordinates assume the engine's 2
# warmup rounds (0-1) before any window opens; every scenario ends with
# settle rounds in which the stack must return to oracle-equal health.
SCENARIOS: dict[str, Scenario] = {
    s.name: s
    for s in (
        Scenario(
            name="partition_symmetric",
            timeline="partition(leaf<->root, symmetric)@3+3",
            description=(
                "Every leaf unreachable from the root for 3 rounds: the "
                "root must keep serving last-known shard data (stale-but-"
                "labeled, leaf_up=0, staleness growing), flip /readyz to "
                "degraded, and converge back to oracle-equal after heal. "
                "No alert assertion here: staggered post-heal "
                "re-admission makes one twin reachable while the other "
                "is still quarantined — honestly one-sided to the root, "
                "so partition suspicion transiently (and correctly) "
                "latches. The clean alert drills are the asymmetric ones."
            ),
        ),
        Scenario(
            name="partition_asymmetric",
            timeline="partition(leaf<->root, asymmetric)@3+4",
            description=(
                "The root loses one leaf of every HA pair while the twins "
                "stay reachable: zero series lost, rollups oracle-equal "
                "THROUGH the window (the twin is fresh), partition "
                "suspicion attributable per cut leaf, and the two-level "
                "query plane stays partial-free."
            ),
            expected_alerts=("TpuRootLeafPartitioned",),
        ),
        Scenario(
            name="partition_flapping",
            timeline=(
                "partition(leaf<->root, flapping)@3+6; "
                "partition(root<->recv, flapping)@3+6"
            ),
            description=(
                "Alternating cuts on the root-leaf and egress seams: "
                "freshest-wins must not flap (no series lost any round), "
                "and the egress breaker's half-open probes must not reset "
                "its backoff each open half-round — the ledger stays "
                "exactly-once through the whole window."
            ),
        ),
        Scenario(
            name="preempt_slice",
            timeline="preempt(slice-1)@3+3",
            description=(
                "Slice preemption: every host of slice-1 goes down for 3 "
                "rounds (quarantines learned), then returns — the healed "
                "targets must be re-admitted by the leaf breakers within "
                "the backoff budget, never black-holed as dead."
            ),
            settle_rounds=4,
        ),
        Scenario(
            name="restart_wave",
            timeline="restart_wave(6, stagger=2)@3; hotspot(job-3)@3+4",
            description=(
                "A 6-host rolling restart, 2 per round, composed with a "
                "workload hotspot: never more than one stagger-width of "
                "targets down in any round (read from the exposition), "
                "the hot pod attributable from the workload rollups "
                "while hosts churn, full recovery after the wave."
            ),
        ),
        Scenario(
            name="churn_storm",
            timeline="churn_storm(16)@3+2",
            description=(
                "Target add/remove waves through the shared targets file "
                "plus a workload label-churn storm: bounded reshard "
                "moves, and NO series or RSS leak — the exposition "
                "returns to exactly the expected series set after settle."
            ),
            settle_rounds=4,
        ),
        Scenario(
            name="disk_full",
            timeline="clock_step(-45)@2; disk_full()@3+4",
            description=(
                "The disk budget under the durable-state dirs collapses "
                "(with a backward NTP step landing first): the pressure "
                "governor must shed by policy — egress segment "
                "compaction reclaims acked bytes — bring usage back "
                "down, keep the egress exactly-once ledger intact "
                "through the whole window, and recover rung by rung "
                "after the budget returns. The backward step must not "
                "stall batch shipping (the clock fence)."
            ),
            settle_rounds=4,
        ),
        Scenario(
            name="mem_pressure",
            timeline="mem_pressure()@3+4; hotspot(job-2)@3+3",
            description=(
                "The memory budget over the byte-accounted components "
                "collapses while a workload hotspot churns the caches: "
                "the governor sheds coarse-tiers-last (fleet caches "
                "first), the accounted bytes come back under budget, "
                "every shed is attributable from the governor's own "
                "surface, and RSS growth stays bounded."
            ),
            settle_rounds=4,
        ),
        Scenario(
            name="scrape_storm",
            timeline="scrape_storm(120)@3+2",
            description=(
                "An aggressive keep-alive scrape fleet hammers the root's "
                "serving tier: admission control holds open connections "
                "at the cap (the storm costs rejected requests, never "
                "FDs), a polite scraper's latency stays flat, and the "
                "rejects are attributable from the reject counters."
            ),
            settle_rounds=3,
        ),
        Scenario(
            name="store_continuity",
            timeline="root_restart()@4+2; churn_storm(8)@7+1",
            description=(
                "Fleet TSDB-lite continuity: the root dies SIGKILL-shaped "
                "for 2 rounds mid-retention, restarts on the same store "
                "dir (tier replay), and a reshard churn wave lands right "
                "after. A query over the boundary must be gap-free — the "
                "store fills the dead window from replayed buckets — with "
                "per-row source attribution honest (store rows say store, "
                "live rows say live) and recording-rule series answerable "
                "from the store alone. With --store off the SAME check "
                "must fail on the gap (the negative control CI asserts)."
            ),
            settle_rounds=4,
            uses_egress=False,
            uses_store=True,
            # One finest store bucket (engine tiers: 0.25 s) must
            # finalize per pre-kill round — see round_pause_s above.
            round_pause_s=0.35,
        ),
        Scenario(
            name="mixed_wedge",
            timeline="preempt(slice-1)@3+3; preempt(slice-2)@10+3",
            description=(
                "The GPU parity drill (mixed TPU+GPU tree, 2 of 4 slices "
                "GPU): wedge one whole TPU slice, settle, then wedge one "
                "whole GPU slice the same way. Both wedges must degrade "
                "IDENTICALLY — target_up drops for exactly the victims, "
                "leaf breakers quarantine them, the wedged family's fleet "
                "chip count drops by exactly the victims' chips while the "
                "OTHER family's sums hold steady — and the egress ledger "
                "stays exactly-once through both windows. slice-1 is TPU, "
                "slice-2 GPU (the farm's last gpu_slices slices)."
            ),
            settle_rounds=4,
            gpu_slices=2,
        ),
        Scenario(
            name="dashboard_storm",
            timeline=("dashboard_storm(192)@2+6; "
                      "partition(leaf<->root, asymmetric)@4+2"),
            description=(
                "The streaming dashboard plane under viewer load WITH a "
                "mid-stream partial partition: 192 subscriptions register "
                "against the root's /api/v1/stream and ride per-round "
                "deltas while the root loses one leaf of every HA pair. "
                "Per tick: every sampled subscriber's delta replay equals "
                "the polled answer at the same generation (bit for bit, "
                "through the partition — streamed and polled viewers must "
                "never disagree), zero seq gaps/dups across subscribers, "
                "push latency bounded, and the subscription count "
                "attributable from the tpu_stream_* exposition. With "
                "--stream off the SAME drill must fail (subscriptions "
                "cannot register) — the negative control CI asserts."
            ),
            settle_rounds=3,
        ),
        Scenario(
            name="recv_outage",
            timeline="recv_outage()@3+4",
            description=(
                "The remote-write receiver answers 503 for 4 rounds: the "
                "egress breaker opens (attributable from the egress "
                "exposition), the backlog buffers to disk, and the drain "
                "after heal delivers every batch exactly once. No leaf "
                "is cut, so NO alert may fire — the empty expected set "
                "is asserted, not assumed."
            ),
            settle_rounds=4,
            expected_alerts=(),
        ),
        Scenario(
            name="alert_partition",
            timeline=("partition(leaf<->root, asymmetric)@3+5; "
                      "recv_outage()@2+4"),
            description=(
                "The alerting-teeth drill: an asymmetric cut makes every "
                "cut leaf look down (leaf_up=0) while its HA twin proves "
                "the pod is alive (partition_suspected=1) — "
                "TpuRootLeafPartitioned must fire, TpuRootLeafDown must "
                "be suppressed, and nothing else may fire. The receiver "
                "outage covers the partition onset, so the firing "
                "notifications wedge the alert webhook too: "
                "notifications buffer through the WAL-backed backlog and "
                "the post-heal drain must land a contiguous exactly-once "
                "ledger. The firing states ride the FleetStore as ALERTS "
                "series (queryable source=store) and the stream plane's "
                "alerts route must agree with the evaluator. "
                "--alert-suppression off is the negative control: "
                "TpuRootLeafDown fires as well and the fired-set "
                "assertion must FAIL (CI asserts the non-zero exit)."
            ),
            settle_rounds=4,
            uses_store=True,
            expected_alerts=("TpuRootLeafPartitioned",),
        ),
        Scenario(
            name="fuzz_root_restart_egress",
            timeline="root_restart()@2",
            description=(
                "Fuzzer-found regression (minimized by ddmin from a "
                "4-event composite; replay: fuzz seed 1 trial 7): a dead "
                "root freezes the snapshot, and with the engine's "
                "interval_s=0 shipper the heartbeat ride-along re-framed "
                "the SAME poll instant every round — identical (series, "
                "timestamp) samples under fresh seqs, duplicate samples "
                "in the exactly-once ledger. The shipper now refuses to "
                "frame a poll instant twice (_same_poll_instant); this "
                "drill pins it. The root-process seam was never composed "
                "with an armed egress ledger by any hand-written drill — "
                "the coverage matrix's first dark-pair catch."
            ),
            settle_rounds=3,
        ),
        Scenario(
            name="fuzz_hotspot_churn",
            timeline="hotspot(job-3)@3+4; churn_storm(8)@4+2",
            description=(
                "Fuzzer-found regression (surfaced by generated "
                "hotspot+churn overlaps; minimized by hand — the "
                "campaign artifact predates the coverage ledger): a "
                "churn storm bumping pod_gen "
                "mid-hotspot rotated every pod label, orphaning the hot "
                "index set resolved at window start — the subject rolled "
                "up to zero and attributability collapsed (the old code "
                "admitted the composition was unsupported 'only by "
                "convention'). The engine now re-resolves the hot set "
                "after ALL events have mutated membership each round."
            ),
            settle_rounds=3,
        ),
    )
}

DEFAULT_SCENARIO_ORDER: tuple[str, ...] = tuple(SCENARIOS)
