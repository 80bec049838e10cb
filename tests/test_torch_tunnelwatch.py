"""Card liveness watchdog tests: state-transition logging without loading
CUDA or NVML. The JAX package's cases against the port, with ``sample()``'s
device-node keys in place of the tunnel's ports."""

import json
import sys

import pytest

from tpu_pod_exporter_torch import tunnelwatch


def test_sample_never_initializes_cuda_or_nvml():
    before = set(sys.modules)
    s = tunnelwatch.sample()
    assert set(s) == {"device_nodes", "nvidiactl"}
    assert all(isinstance(v, bool) for v in s.values())
    assert set(sys.modules) == before  # path checks only: nothing loaded


def test_main_logs_transitions_only(tmp_path, monkeypatch):
    out = tmp_path / "watch.jsonl"
    states = iter([
        {"device_nodes": False, "nvidiactl": False},
        {"device_nodes": False, "nvidiactl": False},  # no change: not logged
        {"device_nodes": True, "nvidiactl": False},   # transition: logged
        {"device_nodes": True, "nvidiactl": False},
    ])
    monkeypatch.setattr(tunnelwatch, "sample", lambda: next(states))
    monkeypatch.setattr(tunnelwatch.time, "sleep", lambda s: None)

    calls = [0]
    real_monotonic = tunnelwatch.time.monotonic

    def monotonic():
        calls[0] += 1
        # Expire after the 4th sample's loop check.
        return real_monotonic() + (1000.0 if calls[0] > 5 else 0.0)

    monkeypatch.setattr(tunnelwatch.time, "monotonic", monotonic)
    tunnelwatch.main(["--out", str(out), "--interval", "0",
                      "--max-seconds", "1", "--heartbeat-every", "1000"])
    records = [json.loads(l) for l in out.read_text().splitlines()]
    assert [r["device_nodes"] for r in records] == [False, True]
    assert records[0]["change"] is True and records[1]["change"] is True


@pytest.mark.parametrize("nodes, want", [
    ((), {"device_nodes": False, "nvidiactl": False}),
    (("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools", "nvidia-modeset"),
     {"device_nodes": False, "nvidiactl": True}),
    (("nvidia3",), {"device_nodes": True, "nvidiactl": False}),
    (("nvidia0", "nvidia3", "nvidiactl", "nvidia-uvm"),
     {"device_nodes": True, "nvidiactl": True}),
    (("nvidiaX", "accel0"), {"device_nodes": False, "nvidiactl": False}),
])
def test_sample_reads_card_and_control_nodes(tmp_path, nodes, want):
    """Only /dev/nvidia<digits> is a card; the driver's control nodes are
    not, and a host without /dev reads as all absent."""
    dev = tmp_path / "dev"
    dev.mkdir()
    for name in nodes:
        (dev / name).touch()
    assert tunnelwatch.sample(str(tmp_path)) == want


def test_sample_without_dev_reads_absent(tmp_path):
    assert tunnelwatch.sample(str(tmp_path / "missing")) == {
        "device_nodes": False, "nvidiactl": False}


def test_default_out_is_under_the_port():
    path = tunnelwatch.DEFAULT_OUT
    assert "tpu_pod_exporter_torch" in path and path.endswith("card-watch.jsonl")
    assert "tunnel-watch.jsonl" not in path


def test_heartbeat_every_zero_is_a_usage_error(capsys):
    # 0 used to ZeroDivisionError inside the loop; it must be
    # rejected at argparse time with a usage message instead.
    with pytest.raises(SystemExit) as ei:
        tunnelwatch.main(["--heartbeat-every", "0", "--max-seconds", "1"])
    assert ei.value.code == 2  # argparse usage error, not a traceback
    assert "must be >= 1" in capsys.readouterr().err


def test_heartbeat_every_one_records_every_sample(tmp_path, monkeypatch):
    out = tmp_path / "watch.jsonl"
    states = iter([{"device_nodes": False, "nvidiactl": False}] * 3)
    monkeypatch.setattr(tunnelwatch, "sample", lambda: next(states))
    monkeypatch.setattr(tunnelwatch.time, "sleep", lambda s: None)
    calls = [0]
    real = tunnelwatch.time.monotonic

    def monotonic():
        calls[0] += 1
        return real() + (1000.0 if calls[0] > 4 else 0.0)

    monkeypatch.setattr(tunnelwatch.time, "monotonic", monotonic)
    tunnelwatch.main(["--out", str(out), "--interval", "0",
                      "--max-seconds", "1", "--heartbeat-every", "1"])
    assert len(out.read_text().splitlines()) == 3  # one record per sample


def test_cli_writes_one_initial_record(tmp_path):
    """``--max-seconds 2 --interval 1`` as a subprocess: the initial record
    alone (the state does not change in between), in the chosen file."""
    import subprocess

    out = tmp_path / "w" / "watch.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_pod_exporter_torch.tunnelwatch", "--out", str(out),
         "--max-seconds", "2", "--interval", "1"],
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    records = [json.loads(l) for l in out.read_text().splitlines()]
    assert len(records) == 1 and records[0]["change"] is True
    assert set(records[0]) == {"t", "change", "device_nodes", "nvidiactl"}
