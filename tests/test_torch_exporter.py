"""The port's exporter held against the JAX package's.

One fake-backend config goes through both packages' ``ExporterApp`` and is
scraped over HTTP: the /metrics bodies must have the same lines in the same
order, with equal values outside the timing and process self-metrics. Then
the port's hwcheck orchestration (mirrors tests/test_hwcheck.py), and the
backend, attribution and flag selection: what builds, and what the port
still refuses. A second config with persistence and egress on goes through
both apps the same way.
"""

import json
import re
import time
import urllib.error
import urllib.request

import pytest
import torch

from tpu_pod_exporter.app import ExporterApp as JaxExporterApp
from tpu_pod_exporter.config import ExporterConfig as JaxExporterConfig
from tpu_pod_exporter_torch import app as tapp
from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
from tpu_pod_exporter_torch.backend import BackendError
from tpu_pod_exporter_torch.config import ExporterConfig
from tpu_pod_exporter_torch.hwcheck import main as hwcheck_main
from tpu_pod_exporter_torch.hwcheck import run_check

# Families whose values depend on wall time or on this process: poll
# timings, the poll timestamp, and the exporter's own CPU and RSS.
VOLATILE_FAMILIES = (
    "tpu_exporter_poll_duration_seconds",
    "tpu_exporter_poll_phase_duration_seconds",
    "tpu_exporter_last_poll_timestamp_seconds",
    "tpu_exporter_cpu_seconds_total",
    "tpu_exporter_rss_bytes",
)

# The port's own instrumentation families, which the JAX package (kept as
# the reference, unedited) does not serve: the server loop's timer lag, the
# poll's device-read instants, the aggregator's round phases and fetch
# stages. The
# line-for-line comparisons against the JAX package drop them from the
# port's body first (``without_port_instrumentation``); every other line
# is still compared in order and value.
PORT_INSTRUMENTATION_FAMILIES = (
    "tpu_exporter_server_loop_lag_seconds",
    "tpu_exporter_last_device_read_timestamp_seconds",
    "tpu_aggregator_round_phase_seconds",
    "tpu_aggregator_fetch_stage_seconds",
)


def _line_family(line: str) -> str:
    """The family an exposition line belongs to (a histogram's _bucket,
    _count and _sum lines to their parent)."""
    if line.startswith("# HELP ") or line.startswith("# TYPE "):
        return line.split(" ", 3)[2]
    name = re.split(r"[{ ]", line, maxsplit=1)[0]
    return re.sub(r"_(bucket|count|sum)$", "", name)


def without_port_instrumentation(body: str) -> str:
    """``body`` without the lines (samples, HELP and TYPE) of
    PORT_INSTRUMENTATION_FAMILIES, its ``tpu_exporter_series`` count less
    the samples dropped."""
    kept, dropped = [], 0
    for line in body.splitlines(keepends=True):
        if _line_family(line) not in PORT_INSTRUMENTATION_FAMILIES:
            kept.append(line)
        elif not line.startswith("#"):
            dropped += 1
    for i, line in enumerate(kept):
        if line.startswith("tpu_exporter_series "):
            count = float(line.split(" ", 1)[1]) - dropped
            kept[i] = f"tpu_exporter_series {count:g}" + line[len(line.rstrip("\n")):]
    return "".join(kept)


FAKE_CONFIG = dict(port=0, host="127.0.0.1", backend="fake",
                   fake_chips=4, attribution="none", accelerator="v4-8")


def _get(base: str, path: str) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(base + path, timeout=5) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _serve(app):
    """Poll ``app`` once and serve it (no poll loop, so both apps publish
    the same single poll); return its URL."""
    app.collector.poll_once()
    app.server.start()
    return f"http://127.0.0.1:{app.port}"


@pytest.fixture
def both_apps():
    apps = [JaxExporterApp(JaxExporterConfig(**FAKE_CONFIG)),
            tapp.ExporterApp(ExporterConfig(**FAKE_CONFIG))]
    try:
        yield [_serve(app) for app in apps]
    finally:
        for app in apps:
            app.stop()


def _split(line: str) -> tuple[str, str | None]:
    """(series key or comment line, value or None)."""
    if line.startswith("#"):
        return line, None
    key, value = line.rsplit(" ", 1)
    return key, value


class TestMetricsParity:
    def test_metrics_bodies_match_line_for_line(self, both_apps):
        jax_base, torch_base = both_apps
        (jax_status, jax_body), (torch_status, torch_body) = (
            _get(jax_base, "/metrics"), _get(torch_base, "/metrics"))
        assert jax_status == torch_status == 200
        jax_lines = jax_body.decode().splitlines()
        torch_lines = without_port_instrumentation(torch_body.decode()).splitlines()
        assert len(jax_lines) == len(torch_lines) > 100
        for want, got in zip(jax_lines, torch_lines):
            want_key, want_value = _split(want)
            got_key, got_value = _split(got)
            assert got_key == want_key
            if want_value != got_value:
                assert want_key.startswith(VOLATILE_FAMILIES), (want, got)
        assert "gpu_hbm_used_bytes" not in torch_body.decode()  # tpu-family fakes

    def test_state_dir_and_egress_bodies_match_line_for_line(self, tmp_path):
        """--state-dir and --egress-url on: the persister and shipper add
        their self-metrics to both bodies alike."""
        apps = []
        try:
            for name, app_cls, cfg_cls in (("jax", JaxExporterApp, JaxExporterConfig),
                                           ("torch", tapp.ExporterApp, ExporterConfig)):
                apps.append(app_cls(cfg_cls(
                    **FAKE_CONFIG, state_dir=str(tmp_path / name / "state"),
                    egress_url="http://127.0.0.1:9/api/v1/write",
                    egress_dir=str(tmp_path / name / "egress"))))
            jax_body, torch_body = (_get(_serve(app), "/metrics")[1].decode()
                                    for app in apps)
        finally:
            for app in apps:
                app.stop()
        jax_lines = jax_body.splitlines()
        torch_lines = without_port_instrumentation(torch_body).splitlines()
        assert len(jax_lines) == len(torch_lines) > 100
        for want, got in zip(jax_lines, torch_lines):
            want_key, want_value = _split(want)
            got_key, got_value = _split(got)
            assert got_key == want_key
            if want_value != got_value:
                assert want_key.startswith(VOLATILE_FAMILIES), (want, got)
        assert "tpu_exporter_egress_backlog_batches" in torch_body
        assert "tpu_exporter_persist_wal_bytes" in torch_body

    def test_stream_route_answers_the_same_404(self, both_apps):
        jax_base, torch_base = both_apps
        path = "/api/v1/stream?metric=tpu_hbm_used_bytes"
        want = _get(jax_base, path)
        got = _get(torch_base, path)
        assert want[0] == 404
        assert got == want
        assert b"streaming not enabled" in got[1]

    def test_history_query_answers(self, both_apps):
        jax_base, torch_base = both_apps
        path = "/api/v1/query_range?metric=tpu_hbm_used_bytes&window=60"
        status, body = _get(torch_base, path)
        assert status == _get(jax_base, path)[0] == 200
        assert json.loads(body)["status"] == "ok"


@pytest.fixture(scope="module")
def instrumented_bodies():
    """{family prefix: body}: the port's exporter body (scraped, then
    polled) and the body of a port aggregator that fetched it with
    default_fetch."""
    from tpu_pod_exporter_torch.aggregate import SliceAggregator
    from tpu_pod_exporter_torch.metrics import SnapshotStore

    app = tapp.ExporterApp(ExporterConfig(**FAKE_CONFIG))
    app.collector.poll_once()
    app.server.start()
    agg_store = SnapshotStore()
    agg = SliceAggregator((f"127.0.0.1:{app.port}",), agg_store)
    try:
        for _ in range(2):
            agg.poll_once()
        time.sleep(0.25)  # the loop's lag probe fires every 100 ms
        app.collector.poll_once()
        exporter = _get(f"http://127.0.0.1:{app.port}", "/metrics")[1].decode()
    finally:
        agg.close()
        app.stop()
    return {"tpu_exporter_": exporter,
            "tpu_aggregator_": agg_store.current().encode().decode()}


@pytest.mark.parametrize("family", PORT_INSTRUMENTATION_FAMILIES)
def test_port_instrumentation_family_is_served(family, instrumented_bodies):
    """Each family the parity comparisons drop is in the port's own body,
    typed and with samples."""
    body = next(b for prefix, b in instrumented_bodies.items() if family.startswith(prefix))
    assert f"\n# TYPE {family} " in body
    samples = [line for line in body.splitlines()
               if not line.startswith("#") and _line_family(line) == family]
    assert samples, family


class TestHwcheckFake:
    def test_fake_backend_full_pass(self):
        report = run_check(backend="fake", idle_s=0.6, load_s=0.8)
        assert report["ok"] is True
        assert report["family"] == "tpu"  # the fake's chips are tpu-family
        assert report["checks"]["hbm_rises_under_load"] is True
        assert report["checks"]["hbm_falls_after_release"] is True
        assert report["checks"]["duty_cycle_responds"] is True
        assert report["phases"]["load"]["hbm_used_bytes"] > (
            report["phases"]["idle"]["hbm_used_bytes"]
        )
        probe = report["probe"]
        assert probe["runtime"] == "nvml"
        assert isinstance(probe["reachable"], bool)
        assert set(probe) >= {"count", "devices", "supported", "errors"}

    def test_fake_backend_failure_detected(self):
        # A stimulus that does nothing must fail the rise/fall checks —
        # the harness can't report success for an exporter that ignores load.
        class Inert:
            def start(self):
                pass

            def stop(self):
                pass

        report = run_check(backend="fake", idle_s=0.4, load_s=0.4,
                           stimulus=Inert())
        assert report["ok"] is False
        assert report["checks"]["hbm_rises_under_load"] is False

    def test_cli_writes_artifact(self, tmp_path, capsys):
        out = tmp_path / "HWCHECK.json"
        rc = hwcheck_main([
            "--backend", "fake", "--idle-s", "0.4", "--load-s", "0.5",
            "--out", str(out),
        ])
        assert rc == 0
        doc = json.loads(out.read_text())
        assert doc["ok"] is True
        assert json.loads(capsys.readouterr().out) == doc

    def test_torch_backend_without_cuda_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(BackendError):
            run_check(backend="torch", idle_s=0.0, load_s=0.0)

    def test_unported_backend_refused(self):
        with pytest.raises(ValueError):
            run_check(backend="jax")


class TestRefusals:
    @pytest.mark.parametrize("backend", ["auto", "torch"])
    def test_card_backends_without_cuda_raise(self, backend, monkeypatch):
        """torch raises without CUDA; auto never builds torch: with no
        /dev/nvidia<minor> node it serves a 0-chip surface."""
        from tpu_pod_exporter_torch.backend import discovery

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(discovery, "local_chip_count", lambda root="/": 0)
        cfg = ExporterConfig(port=0, backend=backend, attribution="none")
        if backend == "torch":
            with pytest.raises(BackendError, match="no CUDA device"):
                tapp.ExporterApp(cfg)
            return
        app = tapp.ExporterApp(cfg)
        try:
            assert app.backend.name == "fake"
            assert app.backend.sample().chips == ()
        finally:
            app.stop()

    def test_cli_torch_backend_without_cuda_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(BackendError):
            tapp.main(["--backend", "torch", "--attribution", "none",
                       "--port", "0"])

    @pytest.mark.parametrize("backend", ["jax", "libtpu", "nvml", "recorded"])
    def test_unported_backends_raise(self, backend):
        """jax is still refused; libtpu, nvml and recorded build."""
        if backend in tapp.UNPORTED_BACKENDS:
            with pytest.raises(ValueError, match=f"{backend}.*not yet ported"):
                tapp.ExporterApp(ExporterConfig(port=0, backend=backend,
                                                attribution="none"))
            return
        source = {"nvml": {"nvml_sim_gpus": 2},
                  "recorded": {"recording_path": "tests/fixtures/gpu-recorded.jsonl"},
                  "libtpu": {"libtpu_metrics_addr": "unix:///nonexistent/libtpu.sock"}}
        family, resource = (("tpu", "google.com/tpu") if backend == "libtpu"
                            else ("gpu", "nvidia.com/gpu"))
        app = tapp.ExporterApp(ExporterConfig(port=0, backend=backend, attribution="none",
                                              **source[backend]))
        try:
            assert (app.backend.name, app.backend.family) == (backend, family)
            assert app.resource_name == resource
        finally:
            app.stop()

    def test_unknown_backend_raises(self):
        with pytest.raises(ValueError, match="unknown backend"):
            tapp.build_backend(ExporterConfig(backend="tpu9000"))

    @pytest.mark.parametrize("field,value,flag", [
        ("record_to", "trace.jsonl", "--record-to"),
        ("chaos_spec", "err:device:0.5", "--chaos-spec"),
        ("process_metrics", True, "--process-metrics"),
        ("state_dir", "state", "--state-dir"),
        ("egress_url", "http://127.0.0.1:9/write", "--egress-url"),
    ])
    def test_unported_flags_raise(self, field, value, flag, tmp_path, monkeypatch):
        """Every one of these flags builds its layer: --record-to the
        recording backend, --chaos-spec the chaos wrappers, --process-metrics
        the scanner, --state-dir the persister, --egress-url the shipper."""
        monkeypatch.chdir(tmp_path)
        extra = {"egress_dir": str(tmp_path / "egress")} if flag == "--egress-url" else {}
        cfg = ExporterConfig(port=0, backend="fake", attribution="none",
                             **{field: value}, **extra)
        app = tapp.ExporterApp(cfg)
        try:
            if flag == "--record-to":
                assert app.backend.name == "recording(fake)"
            elif flag == "--chaos-spec":
                assert app.chaos and "device" in app.chaos
            elif flag == "--state-dir":
                assert app.persister is not None
            elif flag == "--egress-url":
                assert app.shipper is not None
                assert app.shipper.url == value
            else:
                assert app.process_scanner is not None
        finally:
            app.stop()
        if flag == "--record-to":
            assert (tmp_path / value).exists()

    @pytest.mark.parametrize("attribution", ["podresources", "checkpoint"])
    def test_unported_attribution_raises(self, attribution):
        """Both kubelet sources now build (they connect or read lazily)."""
        cfg = ExporterConfig(port=0, backend="fake", attribution=attribution)
        app = tapp.ExporterApp(cfg)
        try:
            assert app.attribution.name == attribution
        finally:
            app.stop()

    @staticmethod
    def _auto_attribution(tmp_path, *found: str) -> str:
        sources = {"podresources": tmp_path / "kubelet.sock",
                   "checkpoint": tmp_path / "checkpoint"}
        for name in found:
            sources[name].write_text("")
        provider = tapp.build_attribution(ExporterConfig(
            attribution="auto", podresources_socket=str(sources["podresources"]),
            checkpoint_path=str(sources["checkpoint"])))
        provider.close()
        return provider.name

    def test_auto_attribution_refuses_a_found_kubelet_source(self, tmp_path):
        """auto picks the kubelet source it finds, the socket first."""
        assert self._auto_attribution(tmp_path, "podresources", "checkpoint") == (
            "podresources")

    def test_auto_attribution_falls_back_to_the_checkpoint(self, tmp_path):
        assert self._auto_attribution(tmp_path, "checkpoint") == "checkpoint"

    def test_auto_attribution_without_a_source_is_disabled(self, tmp_path):
        cfg = ExporterConfig(attribution="auto",
                             podresources_socket=str(tmp_path / "absent.sock"),
                             checkpoint_path=str(tmp_path / "absent"))
        assert isinstance(tapp.build_attribution(cfg), FakeAttribution)
