"""The port's entry point, the counterpart of ``__graft_entry__.entry``."""

from __future__ import annotations

from tpu_pod_exporter_torch.loadgen.workload import flagship


def entry(device=None):
    """(forward fn, example_args) for the flagship workload at width 128,
    depth 4, batch 32, on the CUDA card unless ``device`` names the CPU."""
    return flagship(width=128, depth=4, batch=32, device=device)
