"""The cases of tests/test_integration.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

End-to-end integration: full app over real HTTP with fakes (SURVEY.md §4.3).

Covers baseline configs 1 (0 devices) and 2 (v4-8, one pod), plus the
CollectorLoop cadence and clean shutdown.
"""

import time
import urllib.request

import pytest
from prometheus_client.parser import text_string_to_metric_families

from tpu_pod_exporter_torch.app import ExporterApp
from tpu_pod_exporter_torch.attribution.fake import FakeAttribution, simple_allocation
from tpu_pod_exporter_torch.backend.fake import FakeBackend, FakeChipScript
from tpu_pod_exporter_torch.config import ExporterConfig


def scrape(port: int) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
        return r.read().decode()


def make_app(backend, attribution, interval_s=0.05, **cfg_kw) -> ExporterApp:
    cfg = ExporterConfig(
        port=0,
        host="127.0.0.1",
        interval_s=interval_s,
        accelerator=cfg_kw.pop("accelerator", "v4-8"),
        node_name=cfg_kw.pop("node_name", "testhost"),
        worker_id="0",
        slice_name="test-slice",
        **cfg_kw,
    )
    return ExporterApp(cfg, backend=backend, attribution=attribution)


@pytest.fixture
def app_factory():
    apps = []

    def factory(*args, **kw):
        app = make_app(*args, **kw)
        apps.append(app)
        app.start()
        return app

    yield factory
    for app in apps:
        app.stop()


class TestConfig1ZeroDevices:
    def test_smoke(self, app_factory):
        app = app_factory(FakeBackend(chips=0), FakeAttribution())
        text = scrape(app.port)
        fams = {f.name: f for f in text_string_to_metric_families(text)}
        assert fams["tpu_exporter_up"].samples[0].value == 1
        # full schema present even with zero devices
        assert "tpu_hbm_used_bytes" in fams
        assert not fams["tpu_hbm_used_bytes"].samples

    def test_readyz_immediately_after_start(self, app_factory):
        app = app_factory(FakeBackend(chips=0), FakeAttribution())
        with urllib.request.urlopen(
            f"http://127.0.0.1:{app.port}/readyz", timeout=5
        ) as r:
            assert r.status == 200


class TestConfig2SingleHostOnePod:
    def test_per_chip_series_with_attribution(self, app_factory):
        backend = FakeBackend(
            chips=4,
            script=FakeChipScript(
                hbm_total_bytes=32 * 1024**3, hbm_used_bytes=8 * 1024**3,
                duty_cycle_percent=90.0,
            ),
        )
        attr = FakeAttribution(
            [simple_allocation("train-0", ["0", "1", "2", "3"], namespace="ml")]
        )
        app = app_factory(backend, attr)
        text = scrape(app.port)
        fams = {f.name: f for f in text_string_to_metric_families(text)}
        used = fams["tpu_hbm_used_bytes"].samples
        assert len(used) == 4
        for s in used:
            assert s.labels["pod"] == "train-0"
            assert s.labels["namespace"] == "ml"
            assert s.labels["accelerator"] == "v4-8"
            assert s.labels["host"] == "testhost"
            assert s.value == 8 * 1024**3
        perc = {s.labels["chip_id"]: s.value for s in fams["tpu_hbm_used_percent"].samples}
        assert perc == {"0": 25.0, "1": 25.0, "2": 25.0, "3": 25.0}
        pod_count = fams["tpu_pod_chip_count"].samples
        assert len(pod_count) == 1 and pod_count[0].value == 4


class TestDebugVars:
    def test_debug_vars_endpoint(self, app_factory):
        import json

        app = app_factory(FakeBackend(chips=2), FakeAttribution())
        with urllib.request.urlopen(
            f"http://127.0.0.1:{app.port}/debug/vars", timeout=5
        ) as r:
            doc = json.load(r)
        assert doc["last_poll"]["ok"] is True
        assert doc["config"]["backend"] == "fake"
        assert doc["series"] > 0
        assert doc["snapshot_age_s"] >= 0


class TestLoopCadence:
    def test_background_polling_advances(self, app_factory):
        backend = FakeBackend(chips=1)
        app = app_factory(backend, FakeAttribution(), interval_s=0.02)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if backend.sample_calls >= 5:
                break
            time.sleep(0.01)
        assert backend.sample_calls >= 5

    def test_stop_is_clean_and_closes_backends(self):
        backend = FakeBackend(chips=1)
        attr = FakeAttribution()
        app = make_app(backend, attr, interval_s=0.02)
        app.start()
        app.stop()
        assert backend.closed and attr.closed
        calls_after_stop = backend.sample_calls
        time.sleep(0.1)
        assert backend.sample_calls == calls_after_stop

    def test_scrape_during_churn_always_consistent(self, app_factory):
        """Scrapes racing the poll loop must always parse and be complete."""
        backend = FakeBackend(chips=4)
        attr = FakeAttribution([simple_allocation("a", ["0", "1", "2", "3"])])
        app = app_factory(backend, attr, interval_s=0.01)
        for i in range(20):
            attr.set_allocations([simple_allocation(f"pod-{i}", ["0", "1", "2", "3"])])
            fams = {f.name: f for f in text_string_to_metric_families(scrape(app.port))}
            assert len(fams["tpu_hbm_used_bytes"].samples) == 4
            pods = {s.labels["pod"] for s in fams["tpu_hbm_used_bytes"].samples}
            assert len(pods) == 1  # never a half-applied attribution
