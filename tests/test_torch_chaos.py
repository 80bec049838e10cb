"""The port's chaos harness held against the JAX package's.

The cases of tests/test_chaos.py run against ``tpu_pod_exporter_torch.chaos``
with the imports renamed (spec parsing, deterministic schedules, garbage
values, the wedge scenario). Then the two packages' ``ChaosWrapper``s take
the same (spec, seed) and must inject on the same call indices, and the one
place the two differ is pinned: ``nvml=`` codes go through each package's
NVML table, and the port carries nvml.h's codes (IRQ_ISSUE is 11, 13 is
FUNCTION_NOT_FOUND) where the JAX table has IRQ_ISSUE = 13.
"""

import json
import threading
import time
import urllib.request

import pytest

from tpu_pod_exporter_torch.app import ExporterApp
from tpu_pod_exporter_torch.backend.fake import FakeBackend
from tpu_pod_exporter_torch.chaos import (
    ChaosError,
    ChaosRule,
    ChaosWrapper,
    apply_chaos,
    parse_chaos_spec,
)
from tpu_pod_exporter_torch.config import ExporterConfig


class TestSpecParsing:
    def test_documented_example_spec(self):
        rules = parse_chaos_spec(
            "hang:device:0.01,err:attribution:0.05,slow:procscan:500ms"
        )
        assert [(r.kind, r.source) for r in rules] == [
            ("hang", "device"), ("err", "attribution"), ("slow", "procscan"),
        ]
        assert rules[0].prob == 0.01
        assert rules[0].effective_duration_s == 3600.0  # hang default
        assert rules[1].prob == 0.05
        assert rules[2].prob == 1.0                     # duration-only rule
        assert rules[2].effective_duration_s == 0.5

    def test_duration_count_and_prob_tokens_in_any_order(self):
        (r,) = parse_chaos_spec("hang:device:x3:10s:0.5")
        assert (r.prob, r.duration_s, r.max_count) == (0.5, 10.0, 3)
        (r,) = parse_chaos_spec("slow:procscan:0.25:250ms")
        assert (r.prob, r.duration_s) == (0.25, 0.25)

    @pytest.mark.parametrize("bad", [
        "explode:device:0.1",      # unknown kind
        "hang:gpu:0.1",            # unknown source
        "hang",                    # no source
        "hang:device:2",           # bare number > 1: ambiguous
        "hang:device:10sec",       # bad unit
        "hang:device:x3.5",        # non-integer count
        "",                        # no rules
        " , ,",                    # nothing but separators
    ])
    def test_malformed_specs_fail_loudly(self, bad):
        with pytest.raises(ValueError):
            parse_chaos_spec(bad)


class TestDeterminism:
    def _schedule(self, seed, calls=200):
        rules = [ChaosRule(kind="err", source="device", prob=0.3)]
        w = ChaosWrapper(FakeBackend(chips=1), "device", rules, seed=seed)
        for _ in range(calls):
            try:
                w.sample()
            except ChaosError:
                pass
        return list(w.injected)

    def test_same_seed_same_schedule(self):
        assert self._schedule(seed=7) == self._schedule(seed=7)

    def test_different_seed_different_schedule(self):
        assert self._schedule(seed=7) != self._schedule(seed=8)

    def test_count_cap_and_exhaustion_keeps_later_rules_stable(self):
        # Every rule consumes one draw per call regardless of what earlier
        # rules did, so a later rule's own hit schedule is a stable
        # function of (seed, call index) — capping rule 1 can only hand
        # rule 2 MORE of its scheduled hits, never move them.
        def run(cap):
            rules = [
                ChaosRule(kind="err", source="device", prob=0.5,
                          max_count=cap),
                ChaosRule(kind="slow", source="device", prob=0.2,
                          duration_s=0.0),
            ]
            w = ChaosWrapper(FakeBackend(chips=1), "device", rules, seed=3,
                             sleep=lambda s: None)
            for _ in range(100):
                try:
                    w.sample()
                except ChaosError:
                    pass
            return w

        capped, uncapped = run(2), run(None)
        assert capped.rules[0].fired == 2
        slow_hits = lambda w: {i for i, k in w.injected if k == "slow"}  # noqa: E731
        assert slow_hits(capped) >= slow_hits(uncapped)
        assert slow_hits(uncapped)  # the invariant actually got exercised

    def test_garbage_payloads_do_not_shift_the_schedule(self):
        # Payload contents draw from a dedicated rng; the schedule stream
        # stays one-draw-per-rule-per-call, so capping (or effectively
        # removing) the garbage rule never moves a later rule's hits.
        def run(cap):
            rules = [
                ChaosRule(kind="garbage", source="device", prob=0.5,
                          max_count=cap),
                ChaosRule(kind="err", source="device", prob=0.2),
            ]
            w = ChaosWrapper(FakeBackend(chips=1), "device", rules, seed=11)
            for _ in range(100):
                try:
                    w.sample()
                except ChaosError:
                    pass
            return {i for i, k in w.injected if k == "err"}

        assert run(cap=2) >= run(cap=None)
        assert run(cap=None)  # err actually fired in the uncapped run

    def test_slow_injection_sleeps_then_proceeds(self):
        slept = []
        rules = [ChaosRule(kind="slow", source="device", prob=1.0,
                           duration_s=0.123)]
        w = ChaosWrapper(FakeBackend(chips=1), "device", rules, seed=0,
                         sleep=slept.append)
        sample = w.sample()
        assert slept == [0.123]
        assert len(sample.chips) == 1  # the real call still ran


class TestGarbage:
    def test_garbage_device_sample_does_not_crash_collector(self):
        from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
        from tpu_pod_exporter_torch.collector import Collector
        from tpu_pod_exporter_torch.metrics import SnapshotStore

        rules = [ChaosRule(kind="garbage", source="device", prob=1.0)]
        backend = ChaosWrapper(FakeBackend(chips=2), "device", rules, seed=1)
        store = SnapshotStore()
        c = Collector(backend, FakeAttribution(), store)
        stats = c.poll_once()
        # A garbage sample is a *successful* read of hostile values: the
        # chip publishes, partial errors are counted, and the exposition
        # still renders (NaN duty, negative HBM, regressed counter).
        assert "device_partial" in stats.errors
        text = store.current().encode().decode()
        assert "tpu_chip_info" in text
        assert 'chip_id="999"' in text
        c.close()

    def test_garbage_attribution_is_label_hostile_but_contained(self):
        from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
        from tpu_pod_exporter_torch.collector import Collector
        from tpu_pod_exporter_torch.metrics import SnapshotStore

        rules = [ChaosRule(kind="garbage", source="attribution", prob=1.0)]
        attr = ChaosWrapper(FakeAttribution(), "attribution", rules, seed=1)
        store = SnapshotStore()
        c = Collector(FakeBackend(chips=1), attr, store)
        stats = c.poll_once()
        assert stats.ok
        # The exposition must still parse: hostile pod names are escaped.
        from prometheus_client.parser import text_string_to_metric_families

        list(text_string_to_metric_families(store.current().encode().decode()))
        c.close()


class TestApplyChaos:
    def test_only_matching_sources_wrapped(self):
        from tpu_pod_exporter_torch.attribution.fake import FakeAttribution

        b, a, s, wrappers = apply_chaos(
            "err:device:0.5", 1, FakeBackend(chips=1), FakeAttribution(), None
        )
        assert isinstance(b, ChaosWrapper)
        assert isinstance(a, FakeAttribution)  # untouched
        assert s is None
        assert set(wrappers) == {"device"}

    def test_wrapper_passes_through_introspection(self):
        b, _, _, _ = apply_chaos(
            "err:device:0", 1, FakeBackend(chips=1), None, None
        )
        b.fail_next(1)  # FakeBackend API reachable through the wrapper
        assert b.name.startswith("chaos(")


def _metric_value(body: str, prefix: str) -> float | None:
    for line in body.splitlines():
        if line.startswith(prefix):
            try:
                return float(line.rsplit(" ", 1)[1])
            except ValueError:
                return None
    return None


def _scrape(port: int, path: str = "/metrics") -> str:
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=5
    ) as r:
        return r.read().decode()


class TestWedgedDeviceBackend:
    """Acceptance scenario: a device-backend hang must be survived
    visibly — up drops within one phase deadline, scrapes stay fast on the
    stale snapshot, the breaker opens, the backend is reconnected, and up
    converges back to 1. Scaled-down timings; deterministic x3 hang count."""

    DEADLINE_S = 0.25

    @pytest.fixture
    def wedged_app(self):
        cfg = ExporterConfig(
            port=0, host="127.0.0.1", interval_s=0.05,
            backend="fake", fake_chips=2, attribution="none",
            phase_deadline_s=self.DEADLINE_S,
            breaker_failures=2, breaker_backoff_s=0.1,
            breaker_backoff_max_s=0.3,
            # First three device reads hang (each worker unblocks after 3 s
            # and exits); everything after is healthy.
            chaos_spec="hang:device:1:3s:x3", chaos_seed=42,
            history_retention_s=0.0,
        )
        app = ExporterApp(cfg)
        app.start()
        yield app
        app.stop()

    def test_wedge_abandon_reconnect_recover(self, wedged_app):
        app = wedged_app
        # (1) up drops: the very first poll hit the hang and was abandoned
        # at the deadline, so the serving snapshot already reports up=0.
        body = _scrape(app.port)
        assert _metric_value(body, "tpu_exporter_up ") == 0.0

        # (2) scrapes stay fast during the wedge (stale snapshot served):
        # well under the phase deadline, let alone the hang duration.
        t0 = time.monotonic()
        _scrape(app.port)
        assert time.monotonic() - t0 < self.DEADLINE_S

        # (3) breaker opens and the backend is reconnected; up returns to 1.
        deadline = time.monotonic() + 15.0
        saw_open = False
        while time.monotonic() < deadline:
            body = _scrape(app.port)
            state = _metric_value(
                body, 'tpu_exporter_source_breaker_state{source="device"}'
            )
            saw_open = saw_open or state in (1.0, 2.0)
            if (
                saw_open
                and _metric_value(body, "tpu_exporter_up ") == 1.0
                and state == 0.0
            ):
                break
            time.sleep(0.05)
        else:
            raise AssertionError(
                f"never recovered (saw_open={saw_open}): "
                + app.supervisors["device"].stats().__repr__()
            )

        # (4) the mechanism is visible in the exposition: calls were
        # abandoned, the breaker cycled, the backend was reconnected.
        assert _metric_value(
            body, 'tpu_exporter_source_calls_abandoned_total{source="device"}'
        ) == 3.0
        assert _metric_value(
            body, 'tpu_exporter_source_reconnects_total{source="device"}'
        ) >= 1.0
        assert _metric_value(
            body,
            'tpu_exporter_source_breaker_transitions_total'
            '{source="device",state="closed"}',
        ) >= 1.0
        # The wedge never killed the loop.
        assert _metric_value(body, "tpu_exporter_polls_total ") > 0

        # (5) skip-vs-error split: quarantine skips were plentiful but only
        # the 3 real failures (deadline abandonments) count as poll errors —
        # the TpuExporterPollErrors alert must not fire on designed backoff.
        assert _metric_value(
            body, 'tpu_exporter_poll_errors_total{source="device_read"}'
        ) == 3.0
        assert _metric_value(
            body, 'tpu_exporter_source_calls_skipped_total{source="device"}'
        ) >= 1.0

    def test_chaos_state_visible_in_debug_vars(self, wedged_app):
        app = wedged_app
        dv = json.loads(_scrape(app.port, "/debug/vars"))
        assert "device" in dv["supervisors"]
        assert dv["chaos"]["device"]["calls"] >= 1


class TestReadyzDegradedDetail:
    def test_persistently_wedged_source_reported_degraded(self):
        cfg = ExporterConfig(
            port=0, host="127.0.0.1", interval_s=0.02,
            backend="fake", fake_chips=1, attribution="none",
            phase_deadline_s=2.0,
            breaker_failures=1, breaker_backoff_s=0.02,
            breaker_backoff_max_s=0.05,
            history_retention_s=0.0,
        )
        app = ExporterApp(cfg)
        try:
            app.backend.fail_next(10_000)
            app.start()
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                if app.supervisors["device"].stats()["reopens"] >= 3:
                    break
                time.sleep(0.02)
            else:
                raise AssertionError("breaker never re-opened 3 times")
            with urllib.request.urlopen(
                f"http://127.0.0.1:{app.port}/readyz", timeout=5
            ) as r:
                body = json.loads(r.read())
            assert r.status == 200  # degraded is detail, not unreadiness
            assert body["ready"] is True
            sources = [d["source"] for d in body["degraded_sources"]]
            assert "device" in sources
        finally:
            app.stop()


class TestChaosSoak:
    def test_converges_after_every_wedge(self):
        """Repeated injected wedges; the exporter must converge back to
        up=1 after each one."""
        cfg = ExporterConfig(
            port=0, host="127.0.0.1", interval_s=0.02,
            backend="fake", fake_chips=2, attribution="none",
            phase_deadline_s=0.15,
            breaker_failures=2, breaker_backoff_s=0.05,
            breaker_backoff_max_s=0.2,
            history_retention_s=0.0,
        )
        app = ExporterApp(cfg)
        app.start()
        try:
            wrapper = None
            for burst in range(3):
                # Inject a fresh 3-call hang burst directly into the chaos
                # layer... which is absent (no --chaos-spec), so wedge via
                # a blocking sample wrapper instead.
                release = threading.Event()
                inner = app.backend.sample
                remaining = [3]

                def wedged(inner=inner, release=release, remaining=remaining):
                    if remaining[0] > 0:
                        remaining[0] -= 1
                        release.wait(3.0)
                    return inner()

                app.backend.sample = wedged
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline:
                    if _metric_value(_scrape(app.port),
                                     "tpu_exporter_up ") == 0.0:
                        break
                    time.sleep(0.02)
                else:
                    raise AssertionError(f"burst {burst}: up never dropped")
                release.set()
                app.backend.sample = inner
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline:
                    if _metric_value(_scrape(app.port),
                                     "tpu_exporter_up ") == 1.0:
                        break
                    time.sleep(0.02)
                else:
                    raise AssertionError(f"burst {burst}: never recovered")
        finally:
            app.stop()


# ------------------------------------------------------- the two packages


SPECS = [
    "err:device:0.3,slow:device:0.2:1ms,garbage:device:0.1",
    "hang:device:0.05:1ms,err:device:0.5:@10:x4,kill:device:0",
    "err:attribution:0.4,slow:procscan:0.25:1ms",
]


def _injected(chaos_mod, backend, spec, seed, source, calls=200):
    rules = chaos_mod.parse_chaos_spec(spec)
    w = chaos_mod.ChaosWrapper(backend, source, rules, seed=seed, sleep=lambda s: None)
    for _ in range(calls):
        try:
            w.sample()
        except Exception:  # noqa: BLE001 — injected errors of either package
            pass
    return list(w.injected)


class TestWrappersAcrossPackages:
    @pytest.mark.parametrize("seed", [0, 7])
    @pytest.mark.parametrize("spec", SPECS)
    def test_same_spec_and_seed_inject_on_the_same_calls(self, spec, seed):
        from tpu_pod_exporter import chaos as jax_chaos
        from tpu_pod_exporter.backend.fake import FakeBackend as JaxBackend
        from tpu_pod_exporter_torch import chaos as port_chaos

        source = spec.split(":")[1]
        want = _injected(jax_chaos, JaxBackend(chips=1), spec, seed, source)
        got = _injected(port_chaos, FakeBackend(chips=1), spec, seed, source)
        assert got == want
        if source == "device":
            assert want  # the schedule was exercised

    def test_nvml_codes_follow_each_package_table(self):
        from tpu_pod_exporter import chaos as jax_chaos
        from tpu_pod_exporter.backend import nvml as jax_nvml
        from tpu_pod_exporter_torch import chaos as port_chaos
        from tpu_pod_exporter_torch.backend import nvml as port_nvml

        def raised(chaos_mod, nvml_mod, backend, spec):
            (rule,) = chaos_mod.parse_chaos_spec(spec)
            w = chaos_mod.ChaosWrapper(backend, "device", [rule], seed=1)
            with pytest.raises(nvml_mod.NvmlError) as info:
                w.sample()
            return info.value.code_name, info.value.code

        spec = "err:device:1:nvml=irq_issue"
        assert raised(jax_chaos, jax_nvml, FakeBackend(chips=1), spec) == (
            "NVML_ERROR_IRQ_ISSUE", 13)
        assert raised(port_chaos, port_nvml, FakeBackend(chips=1), spec) == (
            "NVML_ERROR_IRQ_ISSUE", 11)
        # The same name for gpu_is_lost in both.
        spec = "err:device:1:nvml=gpu_is_lost"
        assert raised(jax_chaos, jax_nvml, FakeBackend(chips=1), spec) == raised(
            port_chaos, port_nvml, FakeBackend(chips=1), spec) == (
            "NVML_ERROR_GPU_IS_LOST", 15)
        # A raw 13 names different errors in the two packages.
        assert jax_nvml.normalize_nvml_code(13) == ("NVML_ERROR_IRQ_ISSUE", 13)
        assert port_nvml.normalize_nvml_code(13) == ("NVML_ERROR_FUNCTION_NOT_FOUND", 13)
        with pytest.raises(ValueError):
            jax_nvml.normalize_nvml_code("function_not_found")
