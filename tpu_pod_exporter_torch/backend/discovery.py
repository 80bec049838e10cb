"""Local GPU device discovery — the analog of ``nvml.DeviceGetCount``
(``main.go:116-120``), without opening any device.

The NVIDIA driver exposes each card as ``/dev/nvidia<minor>``. Discovery is
a directory scan — no driver init, no NVML, safe to run next to a training
job.

Scan semantics:
- ``/dev/nvidia<digits>`` nodes only: ``nvidiactl``, ``nvidia-uvm``,
  ``nvidia-uvm-tools``, ``nvidia-modeset`` and ``nvidia-caps/`` are the
  driver's control nodes, which every CUDA process holds, not cards;
- sorted by minor number, numerically.
"""

from __future__ import annotations

import os
import re
from tpu_pod_exporter_torch.backend import ChipInfo

_NODE = re.compile(r"^nvidia([0-9]+)$")


def _scan(root: str) -> list[tuple[int, str]]:
    """(minor, "/dev/nvidia<minor>") of each card node, sorted by minor."""
    nodes: list[tuple[int, str]] = []
    try:
        for name in os.listdir(os.path.join(root, "dev")):
            m = _NODE.match(name)
            if m is not None:
                nodes.append((int(m.group(1)), f"/dev/{name}"))
    except OSError:
        pass
    return sorted(nodes)


def list_device_paths(root: str = "/") -> list[str]:
    """Paths of local GPU device nodes, sorted by minor number."""
    return [p for _, p in _scan(root)]


def local_chip_count(root: str = "/") -> int:
    return len(_scan(root))


def discover_chips(root: str = "/") -> list[ChipInfo]:
    """ChipInfo for each local device node, keyed by its minor number.
    Device-plugin IDs default to the minor as a string; the NVIDIA device
    plugin advertises GPU UUIDs, which only NVML reads.  [design]
    """
    return [ChipInfo(chip_id=minor, device_path=path, device_ids=(str(minor),),
                     family="gpu")
            for minor, path in _scan(root)]
