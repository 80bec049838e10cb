"""pytest plugin: the port's runtime lock and loop witnesses over a test run.

    TPE_TORCH_LOCK_WITNESS=1 TPE_TORCH_LOOP_WITNESS=1 python -m pytest -m 'not slow' \\
        -p tpu_pod_exporter_torch.analysis.pytest_witness tests/test_torch_*.py
    python -m tpu_pod_exporter_torch.analysis --check-witness torch-lock-witness.json
    python -m tpu_pod_exporter_torch.analysis --check-loop-witness torch-loop-witness.json

Loaded with ``-p``, it installs the witnesses before any conftest or test
module imports the port, so module-level and constructor locks are created
through the patched factories. Its variables are not the JAX package's
``TPE_LOCK_WITNESS``/``TPE_LOOP_WITNESS``: under those, the JAX package's
conftest installs that package's witness, and a lock witness installed
later wraps the raw primitives and displaces an earlier one. Set one
package's variables per run.

Variables: ``TPE_TORCH_LOCK_WITNESS=1`` (dump at
``TPE_TORCH_LOCK_WITNESS_OUT``, default ``torch-lock-witness.json``; hold
warnings past ``TPE_TORCH_LOCK_WITNESS_HOLD_MS``) and
``TPE_TORCH_LOOP_WITNESS=1`` (dump at ``TPE_TORCH_LOOP_WITNESS_OUT``,
default ``torch-loop-witness.json``; stalls past
``TPE_TORCH_LOOP_WITNESS_STALL_MS``). A witnessed inversion makes the
session exit 3, a loop stall 4.
"""

from __future__ import annotations

import os

from tpu_pod_exporter_torch.analysis import witness

# The lock witness first: the loop witness imports the server module, and
# the lock factories must already be patched when that import runs.
_WITNESS = witness.install_from_env()
_LOOP_WITNESS = witness.install_loop_from_env()


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    """Witness session report: edge/hold summary, inversions verbatim.
    The dumps are written either way so they can be cross-checked against
    the static model."""
    tr = terminalreporter
    if _WITNESS is not None:
        out = os.environ.get("TPE_TORCH_LOCK_WITNESS_OUT", "torch-lock-witness.json")
        doc = _WITNESS.dump(out)
        tr.write_sep("-", "lock witness (tpu_pod_exporter_torch)")
        meta = doc["meta"]
        tr.write_line(
            f"lock witness: {meta['locks']} lock site(s), "
            f"{meta['acquisitions']} acquisition(s), {meta['edges']} order "
            f"edge(s); dump -> {out}")
        for inv in doc["inversions"]:
            tr.write_line(f"INVERSION: {inv['detail']}", red=True)
        if doc["long_holds"]:
            worst = max(doc["long_holds"], key=lambda h: h["held_ms"])
            tr.write_line(
                f"{len(doc['long_holds'])} hold(s) over "
                f"{meta['hold_warn_ms']} ms (worst: {worst['site']} "
                f"{worst['held_ms']} ms on {worst['thread']}) — review, "
                f"not a gate")
    if _LOOP_WITNESS is not None:
        out = os.environ.get("TPE_TORCH_LOOP_WITNESS_OUT", "torch-loop-witness.json")
        doc = _LOOP_WITNESS.dump(out)
        tr.write_sep("-", "loop witness (tpu_pod_exporter_torch)")
        meta = doc["meta"]
        tr.write_line(
            f"loop witness: {meta['callbacks']} distinct inline "
            f"callback(s) timed, {meta['stalls']} stall(s) over "
            f"{meta['threshold_ms']} ms; dump -> {out}")
        for stall in doc["stalls"]:
            tr.write_line(
                f"LOOP STALL: {stall['qualname']} ({stall['kind']}) ran "
                f"{stall['ms']} ms inline on the event loop", red=True)


def pytest_sessionfinish(session, exitstatus):
    """A witnessed lock-order inversion fails the run even if every test
    passed — the interleaving that deadlocks may just not have happened
    this time. A loop stall likewise: one stalled inline callback parks
    every connection, whether or not an assertion noticed."""
    if _WITNESS is not None and _WITNESS.inversions:
        session.exitstatus = 3
    if _LOOP_WITNESS is not None and _LOOP_WITNESS.stalls:
        session.exitstatus = 4
