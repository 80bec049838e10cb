"""The cases of tests/test_supervisor.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

Unit tests for the source supervision layer (supervisor.py): breaker
state machine, backoff+jitter, deadline abandonment, fenced workers,
reconnect-on-probe, and the abandoned-worker cap."""

import logging
import random
import threading
import time

import pytest

from tpu_pod_exporter_torch.supervisor import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    PROBATION_SUCCESSES,
    STATE_VALUES,
    CircuitBreaker,
    SourceSkipped,
    SourceSupervisor,
    SourceTimeout,
)


class FixedRng:
    """random.Random stand-in whose random() is constant (jitter factor 1)."""

    def __init__(self, value: float = 0.5) -> None:
        self.value = value

    def random(self) -> float:
        return self.value


def make_breaker(clock, **kw):
    kw.setdefault("failure_threshold", 3)
    kw.setdefault("backoff_base_s", 1.0)
    kw.setdefault("backoff_max_s", 8.0)
    kw.setdefault("rng", FixedRng())
    return CircuitBreaker(clock=lambda: clock[0], **kw)


class TestCircuitBreaker:
    def test_stays_closed_below_threshold(self):
        clock = [0.0]
        br = make_breaker(clock)
        for _ in range(5):
            br.record_failure()
            br.record_failure()
            br.record_success()  # non-consecutive failures never open
        assert br.state == CLOSED
        assert br.transitions[OPEN] == 0

    def test_opens_on_consecutive_failures_and_probes_after_backoff(self):
        clock = [0.0]
        br = make_breaker(clock)
        for _ in range(3):
            assert br.decide() == "call"
            br.record_failure()
        assert br.state == OPEN
        assert br.decide() == "skip"          # backoff pending
        clock[0] = 0.99
        assert br.decide() == "skip"
        clock[0] = 1.0                        # base backoff, jitter factor 1
        assert br.decide() == "probe"
        assert br.state == HALF_OPEN
        assert br.decide() == "skip"          # single-probe rule
        br.record_success()
        assert br.state == CLOSED
        assert br.transitions == {CLOSED: 1, OPEN: 1, HALF_OPEN: 1}

    def test_backoff_doubles_and_caps(self):
        clock = [0.0]
        br = make_breaker(clock)  # base 1, max 8
        waits = []
        for _ in range(6):
            for _ in range(3 if br.state == CLOSED else 1):
                if br.state == OPEN:
                    clock[0] += br.seconds_until_probe
                    assert br.decide() == "probe"
                br.record_failure()
            waits.append(br.seconds_until_probe)
        assert waits == [1.0, 2.0, 4.0, 8.0, 8.0, 8.0]

    def test_sustained_success_resets_backoff(self):
        clock = [0.0]
        br = make_breaker(clock)
        for _ in range(3):
            br.record_failure()
        clock[0] += br.seconds_until_probe
        assert br.decide() == "probe"
        br.record_success()
        # The probe success alone is probation, not amnesty (see the
        # flapping-partition hardening): the reopen count survives until
        # PROBATION_SUCCESSES follow-up successes land.
        assert br.state == CLOSED
        assert br.reopens == 1
        for _ in range(PROBATION_SUCCESSES):
            br.record_success()
        assert br.reopens == 0
        for _ in range(3):
            br.record_failure()
        # A fresh incident starts over at the base backoff, not 2x.
        assert br.seconds_until_probe == pytest.approx(1.0)

    def test_probe_success_into_flapping_cut_keeps_backoff_memory(self):
        """The scenario-drill hardening: a half-open probe that succeeds
        into a flapping partition (immediately followed by failures) must
        resume from the retained backoff, not restart the incident at the
        base — a flapping cut settles at the ceiling instead of probe-
        storming at base cadence forever."""
        clock = [0.0]
        br = make_breaker(clock)  # base 1, max 8
        waits = []
        for _flap in range(5):
            # Fail to (re-)open: 3 consecutive from closed, 1 from probe.
            while br.state != OPEN:
                if br.state == HALF_OPEN:
                    br.record_failure()
                    continue
                br.record_failure()
            waits.append(br.seconds_until_probe)
            clock[0] += br.seconds_until_probe
            assert br.decide() == "probe"
            br.record_success()  # the flap's open window lets one through
            assert br.state == CLOSED
        # Monotone non-decreasing toward the ceiling: no reset-to-base.
        assert waits == sorted(waits)
        assert waits[-1] == pytest.approx(8.0)
        assert waits[0] == pytest.approx(1.0)
        assert br.reopens == 5  # the whole flap incident is one incident

    def test_jitter_bounds(self):
        for draw in (0.0, 0.25, 0.75, 1.0 - 1e-9):
            clock = [0.0]
            br = make_breaker(clock, rng=FixedRng(draw), jitter=0.2)
            for _ in range(3):
                br.record_failure()
            assert 0.8 <= br.seconds_until_probe <= 1.2

    def test_jitter_uses_injectable_rng_deterministically(self):
        def schedule(seed):
            clock = [0.0]
            br = make_breaker(clock, rng=random.Random(seed))
            out = []
            for _ in range(4):
                for _ in range(3 if br.state == CLOSED else 1):
                    if br.state == OPEN:
                        clock[0] += br.seconds_until_probe
                        br.decide()
                    br.record_failure()
                out.append(round(br.seconds_until_probe, 6))
            return out

        assert schedule(7) == schedule(7)
        assert schedule(7) != schedule(8)

    def test_state_values_cover_all_states(self):
        assert set(STATE_VALUES) == {CLOSED, OPEN, HALF_OPEN}

    def test_validation(self):
        with pytest.raises(ValueError):
            CircuitBreaker(failure_threshold=0)
        with pytest.raises(ValueError):
            CircuitBreaker(backoff_base_s=5.0, backoff_max_s=1.0)


class TestSourceSupervisor:
    def test_passthrough_result_and_exceptions(self):
        sup = SourceSupervisor("s", lambda: 42, deadline_s=1.0)
        try:
            assert sup.call() == 42
            boom = RuntimeError("boom")

            def bad():
                raise boom

            sup2 = SourceSupervisor("s2", bad, deadline_s=1.0)
            with pytest.raises(RuntimeError) as ei:
                sup2.call()
            assert ei.value is boom  # the ORIGINAL exception, relayed
            sup2.shutdown()
        finally:
            sup.shutdown()

    def test_deadline_abandons_worker_and_next_call_succeeds(self):
        release = threading.Event()
        state = {"blocked": 0}

        def fn():
            if state["blocked"] == 0:
                state["blocked"] = 1
                release.wait(10.0)
                return "late"
            return "ok"

        sup = SourceSupervisor(
            "wedge", fn, deadline_s=0.1,
            breaker=CircuitBreaker(failure_threshold=99),
        )
        try:
            t0 = time.monotonic()
            with pytest.raises(SourceTimeout):
                sup.call()
            # The abandon returned at the deadline, NOT after the block.
            assert time.monotonic() - t0 < 5.0
            assert sup.abandoned == 1
            assert sup.stats()["abandoned_alive"] == 1
            # A fresh worker serves the next call while the old one is
            # still blocked.
            assert sup.call() == "ok"
            # Release the wedge: the fenced worker exits on its own.
            release.set()
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                sup._prune_fenced()
                if sup.stats()["abandoned_alive"] == 0:
                    break
                time.sleep(0.01)
            assert sup.stats()["abandoned_alive"] == 0
        finally:
            release.set()
            sup.shutdown()

    def test_abandoned_cap_refuses_new_workers(self):
        release = threading.Event()
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            release.wait(10.0)

        sup = SourceSupervisor(
            "cap", fn, deadline_s=0.05, max_abandoned=2,
            breaker=CircuitBreaker(failure_threshold=99),
        )
        try:
            for _ in range(2):
                with pytest.raises(SourceTimeout):
                    sup.call()
            assert calls["n"] == 2
            # Cap reached: fails fast WITHOUT spawning/calling again.
            with pytest.raises(SourceTimeout):
                sup.call()
            assert calls["n"] == 2
            assert sup.abandoned == 2  # the refusal is not an abandonment
        finally:
            release.set()
            sup.shutdown()

    def test_breaker_skip_raises_skipped_without_calling(self):
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            raise RuntimeError("down")

        clock = [0.0]
        sup = SourceSupervisor(
            "skip", fn, deadline_s=1.0,
            breaker=make_breaker(clock, failure_threshold=2),
        )
        try:
            for _ in range(2):
                with pytest.raises(RuntimeError):
                    sup.call()
            with pytest.raises(SourceSkipped):
                sup.call()
            assert calls["n"] == 2
            assert sup.skipped == 1
        finally:
            sup.shutdown()

    def test_probe_reconnects_then_calls(self):
        events = []
        healthy = {"v": False}

        def fn():
            events.append("call")
            if not healthy["v"]:
                raise RuntimeError("down")
            return "data"

        clock = [0.0]
        sup = SourceSupervisor(
            "rc", fn, reconnect=lambda: events.append("reconnect"),
            deadline_s=1.0, breaker=make_breaker(clock, failure_threshold=2),
        )
        try:
            for _ in range(2):
                with pytest.raises(RuntimeError):
                    sup.call()
            clock[0] += 10.0  # past backoff: next call is a half-open probe
            healthy["v"] = True
            assert sup.call() == "data"
            assert events == ["call", "call", "reconnect", "call"]
            assert sup.reconnects == 1
            assert sup.breaker.state == CLOSED
        finally:
            sup.shutdown()

    def test_recovery_logs_warning_unconditionally(self, caplog):
        flip = {"fail": True}

        def fn():
            if flip["fail"]:
                raise RuntimeError("down")
            return 1

        sup = SourceSupervisor(
            "rlog", fn, deadline_s=1.0,
            breaker=CircuitBreaker(failure_threshold=99),
        )
        try:
            with caplog.at_level(logging.WARNING,
                                 logger="tpu_pod_exporter_torch.supervisor"):
                for _ in range(3):
                    with pytest.raises(RuntimeError):
                        sup.call()
                flip["fail"] = False
                sup.call()
            msgs = [r.getMessage() for r in caplog.records]
            assert any(
                "healthy again after 3 failure(s)" in m for m in msgs
            )
        finally:
            sup.shutdown()

    def test_degraded_after_reopens(self):
        clock = [0.0]
        sup = SourceSupervisor(
            "deg", lambda: (_ for _ in ()).throw(RuntimeError("down")),
            deadline_s=1.0, breaker=make_breaker(clock, failure_threshold=1),
        )
        try:
            for _ in range(3):
                clock[0] += 100.0
                with pytest.raises((RuntimeError, SourceSkipped)):
                    sup.call()
            assert sup.breaker.reopens >= 3
            assert sup.degraded
            assert sup.stats()["degraded"] is True
        finally:
            sup.shutdown()

    def test_worker_thread_is_named_for_debug_stacks(self):
        seen = {}

        def fn():
            seen["name"] = threading.current_thread().name
            return 1

        sup = SourceSupervisor("device", fn, deadline_s=1.0)
        try:
            sup.call()
            assert seen["name"].startswith("tpu-sup-device-")
        finally:
            sup.shutdown()

    def test_shutdown_releases_idle_worker(self):
        sup = SourceSupervisor("sd", lambda: 1, deadline_s=1.0)
        sup.call()
        worker = sup._worker
        sup.shutdown()
        worker.thread.join(timeout=5.0)
        assert not worker.thread.is_alive()
