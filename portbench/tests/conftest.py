"""Helpers for the benchmark's own tests (``python -m pytest portbench/tests``).

``rehearse`` drives a whole run of a cell in this process, on the CPU
(``--rehearse``: the card's capture through the exporter's simulated NVML
driver), so a test can break the timed path underneath with
``monkeypatch`` and read the result line.
"""

from __future__ import annotations

import contextlib
import io
import json

import pytest

from portbench import run as bench_run


def rehearse(workload: str, seed: int = 2**31 + 11, seconds: float = 3.0,
             trace: int = 0, control: bool = False) -> dict:
    out = io.StringIO()
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace), "--rehearse"] + (["--control"] if control else [])
    with contextlib.redirect_stdout(out):
        rc = bench_run.main(argv)
    assert rc == 0, f"run exited {rc}"
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture
def card():
    """Skips, here in the fixture and never at import, without a CUDA card."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
