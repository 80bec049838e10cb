"""The cases of tests/test_hwcheck.py against ``tpu_pod_exporter_torch``, with
the imports renamed and the one designed difference expected as such.

The hardware-validation harness, orchestrated against the fake backend: the
instrument ships and is proven hardware-free.

The designed difference: the port's ``run_check`` records what the card's
NVML serves (``report["probe"]``, ``probe.probe_nvml``) where the JAX
package's asked a libtpu metrics service at ``libtpu_addr`` /
``--libtpu-addr`` (``report["libtpu"]``), and it takes further exporter
settings as ``exporter_args`` (``record_to`` among them) and the load as
``stimulus``. So each case first expects the reference's arguments to be
refused, then runs with the port's. This host has no ``libnvidia-ml``: the
probe records NVML as unreachable, and the check still passes.
"""

import json

import pytest

from tpu_pod_exporter_torch.hwcheck import main, run_check


class TestRunCheck:
    def test_fake_backend_full_pass(self, tmp_path):
        trace = tmp_path / "trace.jsonl"
        with pytest.raises(TypeError):
            run_check(backend="fake", idle_s=0.6, load_s=0.8, record_to=str(trace),
                      libtpu_addr=f"unix://{tmp_path}/absent.sock")
        report = run_check(
            backend="fake", idle_s=0.6, load_s=0.8,
            exporter_args={"record_to": str(trace)},
        )
        assert report["ok"] is True
        assert report["checks"]["hbm_rises_under_load"] is True
        assert report["checks"]["hbm_falls_after_release"] is True
        assert report["checks"]["duty_cycle_responds"] is True
        assert report["phases"]["load"]["hbm_used_bytes"] > (
            report["phases"]["idle"]["hbm_used_bytes"]
        )
        # the recorded trace captured all three phases end-to-end
        lines = [json.loads(l) for l in trace.read_text().splitlines()]
        assert len(lines) >= 3
        # unreachable NVML is documented, not fatal
        assert "libtpu" not in report
        assert report["probe"]["runtime"] == "nvml"
        assert report["probe"]["reachable"] is False

    def test_fake_backend_failure_detected(self, tmp_path):
        # A stimulus that does nothing must fail the rise/fall checks —
        # the harness can't report success for an exporter that ignores load.
        class Inert:
            def start(self):
                pass

            def stop(self):
                pass

        with pytest.raises(TypeError):
            run_check(backend="fake", idle_s=0.4, load_s=0.4,
                      libtpu_addr=f"unix://{tmp_path}/absent.sock", _stimulus=Inert())
        report = run_check(
            backend="fake", idle_s=0.4, load_s=0.4,
            stimulus=Inert(),
        )
        assert report["ok"] is False
        assert report["checks"]["hbm_rises_under_load"] is False

    def test_cli_writes_artifact(self, tmp_path, capsys):
        out = tmp_path / "HWCHECK.json"
        with pytest.raises(SystemExit) as refused:
            main(["--backend", "fake", "--idle-s", "0.4", "--load-s", "0.5",
                  "--libtpu-addr", f"unix://{tmp_path}/absent.sock", "--out", str(out)])
        assert refused.value.code == 2 and not out.exists()
        assert "--libtpu-addr" in capsys.readouterr().err
        rc = main([
            "--backend", "fake", "--idle-s", "0.4", "--load-s", "0.5",
            "--out", str(out),
        ])
        assert rc == 0
        doc = json.loads(out.read_text())
        assert doc["ok"] is True
        assert json.loads(capsys.readouterr().out) == doc
