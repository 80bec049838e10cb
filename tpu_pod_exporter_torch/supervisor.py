"""Source supervision — per-phase deadlines and breaker-gated reconnects.

The collector's per-phase error containment (``collector.py``) only covers
calls that *return*. A wedged libtpu stream, a stuck gRPC channel, or a hung
``/proc`` read parks the single poll thread forever: ``/metrics`` serves an
ever-staler snapshot until ``health_max_age_s`` finally flips ``/healthz``,
and nothing ever tries to recover. This module closes that gap with two
cooperating pieces:

- :class:`SourceSupervisor` runs each phase call on a dedicated worker
  thread with a hard deadline. On deadline the call is **abandoned** — the
  worker is fenced off (its eventual result is discarded; it exits when the
  blocked call finally returns) and is never joined-on-blocking, so the poll
  loop keeps its cadence. The phase degrades exactly as an error does.
- :class:`CircuitBreaker` tracks consecutive failures per source:
  closed → open (exponential backoff + jitter) → half-open single probe →
  closed. While open, calls are *skipped* (SourceSkipped) instead of burning
  a deadline each poll; each half-open probe first runs the source's
  ``reconnect`` hook (``close()``; the gRPC clients lazily re-``open`` on
  the next call), so a wedged channel is actually **replaced**, not retried
  into.

Breaker state, transitions, abandoned calls, skips, and reconnects surface
as first-class metrics (``metrics/schema.py``) and feed ``/readyz``'s
degraded-source detail. The aggregator reuses :class:`CircuitBreaker`
per scrape target (``aggregate.py``).
"""

from __future__ import annotations

import logging
import queue
import random
import threading
import time
from typing import Any, Callable

from tpu_pod_exporter_torch import trace as trace_mod
from tpu_pod_exporter_torch.utils import RateLimitedLogger

log = logging.getLogger("tpu_pod_exporter_torch.supervisor")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# Gauge encoding of breaker state (tpu_exporter_source_breaker_state).
STATE_VALUES = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}

# A source is reported degraded in /readyz once it has (re-)opened this many
# consecutive times without reaching closed — "open for one backoff window"
# is an incident in progress, "open across N probes" is a wedged source.
DEGRADED_AFTER_REOPENS = 3

# Consecutive successes AFTER a half-open probe success before the breaker
# forgets its backoff history. One probe succeeding proves only that one
# request got through — under a flapping network partition that is the
# NORMAL failure shape (the scenario drills' flapping-partition case): a
# full reset on the probe would restart every incident at the base backoff
# and probe-storm the unreachable endpoint forever. Until this many
# follow-up successes land, a re-open resumes from the retained (halved)
# backoff and the cumulative reopen count, so a flapping cut settles at
# the backoff ceiling instead of oscillating at the base.
PROBATION_SUCCESSES = 2


class SourceTimeout(RuntimeError):
    """A supervised call exceeded its phase deadline and was abandoned."""


class SourceSkipped(RuntimeError):
    """The breaker is open and its backoff has not elapsed; no call made."""


class CircuitBreaker:
    """Consecutive-failure breaker with exponential backoff + jitter.

    Not thread-safe by design: each instance belongs to exactly one caller
    thread (the collector's poll thread, or one aggregator round's scrape
    of one target — the pool maps each target to a single call per round).

    ``decide()`` returns what the caller may do *now*:
    - ``"call"``  — closed; call normally.
    - ``"probe"`` — open and the backoff elapsed; the breaker has moved to
      half-open and admits exactly this one probe call.
    - ``"skip"``  — open (backoff pending) or a probe already in flight.
    """

    __slots__ = (
        "failure_threshold", "backoff_base_s", "backoff_max_s", "jitter",
        "state", "consecutive_failures", "reopens", "transitions",
        "_backoff_s", "_next_probe_at", "_clock", "_rng", "_probation",
    )

    def __init__(
        self,
        failure_threshold: int = 3,
        backoff_base_s: float = 1.0,
        backoff_max_s: float = 30.0,
        jitter: float = 0.2,
        clock: Callable[[], float] = time.monotonic,
        rng: random.Random | None = None,
    ) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if backoff_base_s <= 0 or backoff_max_s < backoff_base_s:
            raise ValueError("need 0 < backoff_base_s <= backoff_max_s")
        self.failure_threshold = failure_threshold
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.jitter = jitter
        self.state = CLOSED
        self.consecutive_failures = 0
        # Times the breaker (re-)entered OPEN without an intervening close —
        # the /readyz degraded-source signal (DEGRADED_AFTER_REOPENS).
        self.reopens = 0
        # Cumulative entries into each state since construction; closed
        # counts only recoveries (not the initial state), so a never-failed
        # source shows all-zero transitions.
        self.transitions = {CLOSED: 0, OPEN: 0, HALF_OPEN: 0}
        self._backoff_s = 0.0
        self._next_probe_at = 0.0
        # Successes still owed before backoff history is forgotten (set by
        # a half-open probe success; see PROBATION_SUCCESSES).
        self._probation = 0
        self._clock = clock
        self._rng = rng if rng is not None else random.Random()

    def decide(self) -> str:
        if self.state == CLOSED:
            return "call"
        if self.state == HALF_OPEN:
            # Single-probe rule: a probe is already in flight (only possible
            # if the caller re-enters before recording the probe's outcome).
            return "skip"
        if self._clock() >= self._next_probe_at:
            self._enter(HALF_OPEN)
            return "probe"
        return "skip"

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state != CLOSED:
            # A half-open probe success closes the breaker but keeps the
            # backoff and the reopen count on probation: one request
            # surviving a flapping partition must not reset the incident —
            # the next re-open DOUBLES from here toward the ceiling
            # instead of restarting the dance at the base backoff.
            self._probation = PROBATION_SUCCESSES
            self._enter(CLOSED)
        elif self._probation > 0:
            self._probation -= 1
            if self._probation == 0:
                self.reopens = 0
                self._backoff_s = 0.0
        else:
            self.reopens = 0
            self._backoff_s = 0.0

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == HALF_OPEN or (
            self.state == CLOSED
            and self.consecutive_failures >= self.failure_threshold
        ):
            self._open()

    @property
    def seconds_until_probe(self) -> float:
        """How long until the next half-open probe (0 when callable now)."""
        if self.state != OPEN:
            return 0.0
        return max(self._next_probe_at - self._clock(), 0.0)

    # ------------------------------------------------- persistence (persist.py)

    def export_state(self, wallclock: Callable[[], float] = time.time) -> dict:
        """Serializable breaker state for crash-safe persistence. The open
        window is exported as an absolute WALL deadline (``open_until_wall``)
        because the monotonic clock does not survive a restart."""
        return {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "reopens": self.reopens,
            "backoff_s": self._backoff_s,
            "open_until_wall": (
                wallclock() + self.seconds_until_probe
                if self.state == OPEN else 0.0
            ),
            "transitions": dict(self.transitions),
        }

    def restore_state(self, doc: dict, wallclock: Callable[[], float] = time.time) -> None:
        """Rehydrate from :meth:`export_state` output (defensively: the
        payload crossed a process death and a disk). A restored OPEN
        breaker keeps its remaining backoff window — the restarted process
        must not re-learn a still-wedged source from closed — and a
        breaker persisted mid-probe (HALF_OPEN) restores as OPEN with the
        probe due immediately: the in-flight probe died with the process,
        so the honest state is 'quarantined, probe now'."""
        state = doc.get("state")
        if state not in (CLOSED, OPEN, HALF_OPEN):
            return
        self.consecutive_failures = max(int(doc.get("consecutive_failures", 0)), 0)
        self.reopens = max(int(doc.get("reopens", 0)), 0)
        self._backoff_s = min(
            max(float(doc.get("backoff_s", 0.0)), 0.0), self.backoff_max_s
        )
        transitions = doc.get("transitions")
        if isinstance(transitions, dict):
            for key in self.transitions:
                try:
                    self.transitions[key] = max(int(transitions.get(key, 0)), 0)
                except (TypeError, ValueError):
                    pass
        if state == CLOSED:
            self.state = CLOSED
            return
        self.state = OPEN
        remaining = 0.0
        if state == OPEN:
            try:
                remaining = float(doc.get("open_until_wall", 0.0)) - wallclock()
            except (TypeError, ValueError):
                remaining = 0.0
        # Clamp into [0, ceiling]: a wall clock that stepped during the
        # restart must not quarantine a source for hours, nor probe in
        # the past.
        self._next_probe_at = self._clock() + min(
            max(remaining, 0.0), self.backoff_max_s
        )

    def _open(self) -> None:
        if self._backoff_s <= 0:
            self._backoff_s = self.backoff_base_s
        else:
            self._backoff_s = min(self._backoff_s * 2.0, self.backoff_max_s)
        # Symmetric jitter (±jitter fraction): de-synchronizes a fleet of
        # exporters that all lost the same dependency at the same instant.
        factor = 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        self._next_probe_at = self._clock() + self._backoff_s * factor
        self.reopens += 1
        self._enter(OPEN)

    def _enter(self, state: str) -> None:
        self.state = state
        self.transitions[state] += 1


class _Call:
    __slots__ = ("fn", "done", "result", "exc")

    def __init__(self, fn: Callable[[], Any]) -> None:
        self.fn = fn
        self.done = threading.Event()
        self.result = None
        self.exc: BaseException | None = None


class _Worker:
    """One reusable phase-worker thread. ``fenced`` is set when a call it is
    running was abandoned; the loop exits as soon as the blocked call
    returns (never joined while blocking)."""

    _seq = 0
    _seq_lock = threading.Lock()

    def __init__(self, source: str) -> None:
        with _Worker._seq_lock:
            _Worker._seq += 1
            n = _Worker._seq
        self.fenced = False
        self.inbox: queue.Queue[_Call | None] = queue.Queue()
        self.thread = threading.Thread(
            target=self._run, name=f"tpu-sup-{source}-{n}", daemon=True
        )
        self.thread.start()

    def _run(self) -> None:
        while True:
            call = self.inbox.get()
            if call is None:
                return
            try:
                call.result = call.fn()
            except BaseException as e:  # noqa: BLE001  # lint: disable=bare-except(relayed to the supervised caller via call.exc and re-raised there; swallowing here would hang the deadline wait)
                call.exc = e
            call.done.set()
            if self.fenced:
                # The supervisor gave up on this call; a replacement worker
                # owns the inbox of future calls. Exit quietly.
                return


class SourceSupervisor:
    """Deadline + breaker + reconnect supervision for one source's calls.

    ``fn`` is the phase call (e.g. ``lambda: backend.sample()`` — late-bound
    so tests that monkeypatch ``backend.sample`` keep working);
    ``reconnect`` (optional) is invoked on the worker thread before each
    half-open probe, normally ``source.close`` — the gRPC clients lazily
    rebuild their channel on the next call, so close-then-call IS the
    reconnect.

    Single-caller contract (the poll thread); the abandoned-worker cap is
    the only cross-thread state and is monotonic/advisory.
    """

    def __init__(
        self,
        source: str,
        fn: Callable[[], Any],
        reconnect: Callable[[], None] | None = None,
        deadline_s: float = 4.0,
        breaker: CircuitBreaker | None = None,
        max_abandoned: int = 8,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        self.source = source
        self.deadline_s = deadline_s
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self._fn = fn
        self._reconnect = reconnect
        self._clock = clock
        self._worker: _Worker | None = None
        # Workers fenced off mid-call; pruned when their blocked call
        # finally returns and the thread exits. Capped: a permanently-wedged
        # syscall must not accrete a thread per probe forever.
        self._fenced: list[_Worker] = []
        self._max_abandoned = max_abandoned
        self.abandoned = 0
        self.skipped = 0
        self.reconnects = 0
        # Monotonic bookkeeping for recovery log lines; sub-threshold flap
        # recoveries are rate-limited through _rlog (see _note_success).
        self._rlog = RateLimitedLogger(log)
        self._failed_since: float | None = None
        self._failures_this_incident = 0

    # ------------------------------------------------------------------ call

    def call(self) -> Any:
        """Run one supervised phase call; returns its result.

        Raises SourceSkipped (breaker open, backoff pending), SourceTimeout
        (deadline hit; call abandoned), or whatever the call itself raised.
        """
        decision = self.breaker.decide()
        if decision == "skip":
            self.skipped += 1
            # Span annotation (no-op outside a traced poll): the quarantine
            # decision is part of the poll's causal story.
            trace_mod.annotate(
                f"breaker open: call skipped, next probe in "
                f"{self.breaker.seconds_until_probe:.1f}s"
            )
            raise SourceSkipped(
                f"{self.source}: breaker open, next probe in "
                f"{self.breaker.seconds_until_probe:.1f}s"
            )
        fn = self._fn
        if decision == "probe":
            trace_mod.annotate(
                "half-open probe"
                + (": reconnect + single call" if self._reconnect is not None
                   else "")
            )
        if decision == "probe" and self._reconnect is not None:
            # Reconnect ON the worker thread: close() of a wedged channel
            # may itself block, and that must be abandonable too. The
            # counter increments there too, so a probe refused by the
            # abandoned-worker cap is not counted as a reconnect.
            inner, reconnect = self._fn, self._reconnect

            def fn() -> Any:
                self.reconnects += 1
                reconnect()
                return inner()

        try:
            result = self._submit(fn)
        except BaseException:
            self._note_failure()
            self.breaker.record_failure()
            raise
        self._note_success()
        self.breaker.record_success()
        return result

    def _submit(self, fn: Callable[[], Any]) -> Any:
        self._prune_fenced()
        if len(self._fenced) >= self._max_abandoned:
            # Every abandoned worker is still blocked. Spawning another
            # thread into the same wedge buys nothing and leaks a thread;
            # fail the phase immediately instead (counts as a failure, so
            # the breaker keeps backing off).
            trace_mod.annotate(
                f"{len(self._fenced)} abandoned workers still blocked; "
                f"call refused without spawning another"
            )
            raise SourceTimeout(
                f"{self.source}: {len(self._fenced)} abandoned calls still "
                f"blocked; refusing to spawn more workers"
            )
        # Carry the poll thread's trace context onto the worker: the call
        # body (and anything it triggers — chaos injections, provider logs)
        # annotates the PHASE span, not limbo. Restored in a finally so a
        # reused worker never leaks one poll's span into the next.
        span = trace_mod.current_span()
        if span is not None:
            inner = fn

            def fn() -> Any:
                prev = trace_mod.swap_current(span)
                try:
                    return inner()
                finally:
                    trace_mod.swap_current(prev)

        w = self._worker
        if w is None or not w.thread.is_alive():
            w = self._worker = _Worker(self.source)
        call = _Call(fn)
        w.inbox.put(call)
        if not call.done.wait(self.deadline_s):
            # Fence, don't join: the worker exits on its own when (if) the
            # blocked call returns; its late result is discarded.
            w.fenced = True
            # Wake-up pill for the completion race: if the call finished
            # right at the deadline, the worker may have checked ``fenced``
            # (still False) and looped back to inbox.get() before the flag
            # landed — without this it would park there forever, eating an
            # abandoned-worker slot. A worker still blocked in the call
            # never consumes it (it sees ``fenced`` after the call returns
            # and exits first); the stray item dies with the queue.
            w.inbox.put(None)
            self._worker = None
            self._fenced.append(w)
            self.abandoned += 1
            trace_mod.annotate(
                f"deadline {self.deadline_s:g}s exceeded; worker "
                f"{w.thread.name} fenced ({len(self._fenced)} abandoned alive)"
            )
            raise SourceTimeout(
                f"{self.source}: call exceeded {self.deadline_s:g}s phase "
                f"deadline; worker abandoned"
            )
        if call.exc is not None:
            raise call.exc
        return call.result

    def _prune_fenced(self) -> None:
        if self._fenced:
            self._fenced = [w for w in self._fenced if w.thread.is_alive()]

    def _note_failure(self) -> None:
        if self._failed_since is None:
            self._failed_since = self._clock()
        self._failures_this_incident += 1

    def _note_success(self) -> None:
        if self._failed_since is not None:
            duration = self._clock() - self._failed_since
            n = self._failures_this_incident
            # An isolated incident's end always logs (recovery rides its
            # own rate-limit window, not the fault lines'); per-poll
            # flapping collapses to one recovery line per window.
            self._rlog.recovery(
                self.source,
                "source %s healthy again after %d failure(s) over %.1fs "
                "(%d call(s) abandoned, %d reconnect(s))",
                self.source, n, duration, self.abandoned, self.reconnects,
            )
            self._failed_since = None
            self._failures_this_incident = 0

    # ----------------------------------------------------------------- state

    @property
    def degraded(self) -> bool:
        """True once the source has re-opened >= DEGRADED_AFTER_REOPENS
        consecutive times — the /readyz degraded-source predicate."""
        return (
            self.breaker.state != CLOSED
            and self.breaker.reopens >= DEGRADED_AFTER_REOPENS
        )

    def stats(self) -> dict:
        b = self.breaker
        return {
            "state": b.state,
            "state_value": STATE_VALUES[b.state],
            "transitions": dict(b.transitions),
            "consecutive_failures": b.consecutive_failures,
            "reopens": b.reopens,
            "seconds_until_probe": b.seconds_until_probe,
            "abandoned": self.abandoned,
            "skipped": self.skipped,
            "reconnects": self.reconnects,
            "abandoned_alive": len(self._fenced),
            "deadline_s": self.deadline_s,
            "degraded": self.degraded,
        }

    def shutdown(self) -> None:
        """Release the idle worker (fenced/blocked ones exit on their own)."""
        w = self._worker
        self._worker = None
        if w is not None and w.thread.is_alive():
            w.fenced = True
            w.inbox.put(None)
