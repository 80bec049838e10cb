"""The port's entry points, the counterparts of ``__graft_entry__.py``."""

from __future__ import annotations

import json
import subprocess

from tpu_pod_exporter_torch.loadgen.workload import flagship

# Wall-clock ceiling for the dry run's child: one step of the dp x tp step
# and of every collective program at tiny shapes takes seconds; a hard
# timeout turns a wedged world into a diagnostic instead of a hang.
_DRYRUN_TIMEOUT_S = 300


def entry(device=None):
    """(forward fn, example_args) for the flagship workload at width 128,
    depth 4, batch 32, on the CUDA card unless ``device`` names the CPU."""
    return flagship(width=128, depth=4, batch=32, device=device)


def _tail(stream, chars: int) -> str:
    if isinstance(stream, bytes):
        stream = stream.decode(errors="replace")
    return (stream or "")[-chars:]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One step of the dp x tp sharded training step and one of every
    collective program (ring attention, Ulysses attention, the GPipe
    pipeline, MoE, FSDP and, for an even n >= 4, multislice) on a world of
    n ranks, as ``selftest --checks dryrun`` in a child process; returns
    its report.

    Runs on n cards unless ``device`` is the CPU (n gloo ranks); with no
    CUDA, or fewer cards than n, it raises and never falls back to the CPU.
    Raises RuntimeError with the child's output tails when it times out,
    exits non-zero or reports a failed check.
    """
    from tpu_pod_exporter_torch.loadgen import sharded
    from tpu_pod_exporter_torch.loadgen.selftest import run_subprocess

    platform = sharded._platform(device)
    sharded.pick_devices(n_devices, platform)
    try:
        proc = run_subprocess(n_devices, checks="dryrun", timeout=_DRYRUN_TIMEOUT_S,
                              device=platform)
    except subprocess.TimeoutExpired as exc:
        raise RuntimeError(
            f"multichip dryrun child timed out after {_DRYRUN_TIMEOUT_S}s "
            f"(n_devices={n_devices});\nstdout tail: {_tail(exc.stdout, 800)!r}\n"
            f"stderr tail: {_tail(exc.stderr, 800)!r}"
        ) from exc
    if proc.returncode != 0:
        raise RuntimeError(
            f"multichip dryrun child exited rc={proc.returncode} "
            f"(n_devices={n_devices});\nstdout tail: {_tail(proc.stdout, 1000)!r}\n"
            f"stderr tail: {_tail(proc.stderr, 1000)!r}"
        )
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    if not report.get("ok"):
        raise RuntimeError(f"multichip dryrun checks failed: {report}")
    return report
