"""The cases of tests/test_config.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

Config/flag system tests (SURVEY.md §5)."""

from tpu_pod_exporter_torch.config import ExporterConfig


class TestDefaults:
    def test_defaults(self):
        cfg = ExporterConfig.from_args([])
        assert cfg.port == 8000
        assert cfg.interval_s == 1.0
        assert cfg.backend == "auto"
        assert cfg.resource_name == "google.com/tpu"


class TestFlags:
    def test_flags_override(self):
        cfg = ExporterConfig.from_args(
            ["--port", "9100", "--interval-s", "0.5", "--backend", "fake",
             "--fake-chips", "4", "--accelerator", "v5p-64"]
        )
        assert cfg.port == 9100
        assert cfg.interval_s == 0.5
        assert cfg.backend == "fake"
        assert cfg.fake_chips == 4
        assert cfg.accelerator == "v5p-64"


class TestEnvFallback:
    def test_env_used_when_no_flag(self, monkeypatch):
        monkeypatch.setenv("TPE_PORT", "9200")
        monkeypatch.setenv("TPE_BACKEND", "fake")
        monkeypatch.setenv("TPE_INTERVAL_S", "2.5")
        cfg = ExporterConfig.from_args([])
        assert cfg.port == 9200
        assert cfg.backend == "fake"
        assert cfg.interval_s == 2.5

    def test_flag_beats_env(self, monkeypatch):
        monkeypatch.setenv("TPE_PORT", "9200")
        cfg = ExporterConfig.from_args(["--port", "9300"])
        assert cfg.port == 9300
