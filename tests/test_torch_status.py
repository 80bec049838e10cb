"""The cases of tests/test_status.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

Status CLI tests — drive main() with fake-backend flags, capture stdout."""

import pytest

from tpu_pod_exporter_torch import status


@pytest.fixture
def run_status(capsys, monkeypatch):
    def run(argv):
        # isolate from the host's TPU env
        for var in ("TPU_ACCELERATOR_TYPE", "TPU_WORKER_ID", "TPU_SLICE_NAME"):
            monkeypatch.delenv(var, raising=False)
        rc = status.main(argv)
        out = capsys.readouterr()
        return rc, out.out, out.err

    return run


class TestStatusCli:
    def test_zero_devices(self, run_status):
        rc, out, _ = run_status(["--backend", "fake", "--fake-chips", "0",
                                 "--attribution", "none"])
        assert rc == 0
        assert "no TPU chips found" in out

    def test_chip_table(self, run_status):
        rc, out, _ = run_status(["--backend", "fake", "--fake-chips", "4",
                                 "--attribution", "none", "--accelerator", "v4-8"])
        assert rc == 0
        assert "accelerator: v4-8" in out
        assert "(4 chips / 1 hosts slice-wide)" in out
        for chip in range(4):
            assert f"/dev/accel{chip}" in out

    def test_recorded_trace(self, run_status, tmp_path):
        from tpu_pod_exporter_torch.backend.fake import FakeBackend
        from tpu_pod_exporter_torch.backend.recorded import RecordingBackend

        path = str(tmp_path / "t.jsonl")
        rec = RecordingBackend(FakeBackend(chips=2), path)
        rec.sample()
        rec.close()
        rc, out, _ = run_status(["--backend", "recorded", "--recording-path", path,
                                 "--attribution", "none"])
        assert rc == 0
        assert "chip" in out and "/dev/accel1" in out

    def test_fmt_bytes(self):
        assert status.fmt_bytes(0) == "0B"
        assert status.fmt_bytes(1024) == "1.0KiB"
        assert status.fmt_bytes(32 * 1024**3) == "32.0GiB"

    def test_holder_column_with_process_metrics(self, run_status, tmp_path):
        import os

        d = tmp_path / "77" / "fd"
        d.mkdir(parents=True)
        os.symlink("/dev/accel1", d / "3")
        (tmp_path / "77" / "comm").write_text("jax_worker\n")
        (tmp_path / "77" / "cgroup").write_text("0::/user.slice\n")
        rc, out, _ = run_status([
            "--backend", "fake", "--fake-chips", "2", "--attribution", "none",
            "--process-metrics", "--proc-root", str(tmp_path),
        ])
        assert rc == 0
        assert "holder" in out
        assert "77/jax_worker" in out

    def test_watch_flag_parses_and_passes_rest(self, run_status, monkeypatch):
        # One render then interrupt out of the sleep.
        import time as time_mod

        def boom(_):
            raise KeyboardInterrupt

        monkeypatch.setattr(time_mod, "sleep", boom)
        rc, out, _ = run_status([
            "--watch", "5", "--backend", "fake", "--fake-chips", "1",
            "--attribution", "none",
        ])
        assert rc == 0
        assert "/dev/accel0" in out

    def test_json_output(self, run_status, tmp_path):
        import json
        import os

        d = tmp_path / "42" / "fd"
        d.mkdir(parents=True)
        os.symlink("/dev/accel0", d / "3")
        (tmp_path / "42" / "comm").write_text("w\n")
        (tmp_path / "42" / "cgroup").write_text("0::/x\n")
        rc, out, _ = run_status([
            "--backend", "fake", "--fake-chips", "2", "--attribution", "none",
            "--accelerator", "v4-8", "--json",
            "--process-metrics", "--proc-root", str(tmp_path),
        ])
        assert rc == 0
        doc = json.loads(out)
        assert doc["accelerator"] == "v4-8"
        assert len(doc["chips"]) == 2
        chip0 = doc["chips"][0]
        assert chip0["device_path"] == "/dev/accel0"
        assert chip0["holders"] == [{"pid": 42, "comm": "w", "pod_uid": ""}]
        assert isinstance(chip0["ici"], dict)  # per-link counters (r4)
        assert doc["partial_errors"] == []
        assert doc["pods"] == []

    def test_json_zero_chips(self, run_status):
        import json

        rc, out, _ = run_status([
            "--backend", "fake", "--fake-chips", "0", "--attribution", "none",
            "--json",
        ])
        assert rc == 0
        assert json.loads(out)["chips"] == []

    def test_table_pod_rollup_counts_each_chip_once(self, run_status, tmp_path):
        # Regression: the per-pod table once double-counted chips/HBM when
        # the rollup block existed on both sides of the --json split.
        import json

        ckpt = tmp_path / "ckpt.json"
        ckpt.write_text(json.dumps({
            "Data": {
                "PodDeviceEntries": [
                    {
                        "PodUID": "u-1",
                        "ContainerName": "main",
                        "ResourceName": "google.com/tpu",
                        "DeviceIDs": ["0", "1"],
                    }
                ]
            }
        }))
        rc, out, _ = run_status([
            "--backend", "fake", "--fake-chips", "2",
            "--attribution", "checkpoint", "--checkpoint-path", str(ckpt),
        ])
        assert rc == 0
        pod_line = [l for l in out.splitlines() if "uid:u-1" in l and "GiB" not in l]
        # pods table row: "<ns>/<pod>  <chips>  <hbm>"
        assert any(" 2 " in l or l.rstrip().endswith("2  0B") or "  2  " in l
                   for l in pod_line), out
