"""The port's numeric selftest and ``entry.dryrun_multichip`` on the CPU
(mirrors tests/test_parallel.py's selftest checks and tests/test_selftest.py).

One child process runs ``python -m tpu_pod_exporter_torch.loadgen.selftest
--n 4 --checks all --device cpu``, which starts a gloo world of 4 ranks;
every check is read from its one JSON line. ``dryrun_multichip(2,
device="cpu")`` starts a world of 2. Without CUDA, the defaults raise.
"""

import json

import pytest
import torch

from tests.conftest import require_jax
from tpu_pod_exporter_torch.loadgen import parallel as tp
from tpu_pod_exporter_torch.loadgen import selftest

N = 4


@pytest.fixture(scope="module")
def report():
    proc = selftest.run_subprocess(N, checks="all", timeout=120, device="cpu")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_names_are_the_jax_packages():
    require_jax()
    from tpu_pod_exporter.loadgen import parallel as jp
    from tpu_pod_exporter.loadgen import selftest as js

    assert list(selftest.CHECKS) == list(js.CHECKS)
    assert selftest.DRYRUN_CHECKS == js.DRYRUN_CHECKS
    assert tp.PARALLEL_PROGRAMS == jp.PARALLEL_PROGRAMS


def test_report_has_every_check(report):
    assert report["n_devices"] == N and report["ok"] is True
    assert list(report["checks"]) == list(selftest.CHECKS)


@pytest.mark.parametrize("name", list(selftest.CHECKS))
def test_check(report, name):
    result = report["checks"][name]
    assert result.get("ok"), f"{name}: {result}"
    if name == "multislice":
        assert "skipped" not in result  # a 2x2 mesh at n = 4
    if name == "dryrun_parallelism":
        assert set(result) == {"ok", "ring_attention", "ulysses_attention", "pipeline",
                               "moe", "fsdp", "multislice_dp_tp"}


def test_dryrun_checks_subset():
    assert set(selftest.DRYRUN_CHECKS) <= set(selftest.CHECKS)


def test_run_checks_reports_failures(monkeypatch):
    """A raising check surfaces as ok=False with the error, not a crash."""
    def boom(n, device):
        raise ValueError("x")

    monkeypatch.setitem(selftest.CHECKS, "boom", boom)
    results = selftest.run_checks(2, ["boom"], device="cpu")
    assert results["boom"]["ok"] is False
    assert "ValueError: x" in results["boom"]["error"]


def test_unknown_check_exits_2(capsys):
    assert selftest.main(["--n", "2", "--checks", "nope", "--device", "cpu"]) == 2
    assert "unknown checks" in capsys.readouterr().out


def test_dryrun_multichip_on_cpu():
    from tpu_pod_exporter_torch.entry import dryrun_multichip

    report = dryrun_multichip(2, device="cpu")
    assert report["ok"] and list(report["checks"]) == list(selftest.DRYRUN_CHECKS)


def test_dryrun_multichip_needs_cuda_unless_asked_for_cpu(monkeypatch):
    from tpu_pod_exporter_torch.entry import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)


def test_dryrun_multichip_needs_a_card_a_rank(monkeypatch):
    from tpu_pod_exporter_torch.entry import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        dryrun_multichip(2)
