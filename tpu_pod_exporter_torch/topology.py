"""Slice/host topology labels for multi-host aggregation.

The reference has no topology dimension at all — it is single-node and its
labels are ``{pid, pod}`` (``main.go:22-35``). On TPU the interesting scale
is chips-per-host × hosts-per-slice (SURVEY.md §2.8): every host of a
multi-host slice runs its own exporter, and *cross-host aggregation happens
in Prometheus via labels*, never via exporter-to-exporter traffic. This
module derives those labels.

Sources, in precedence order:
1. explicit config overrides,
2. GKE/TPU-VM environment (``TPU_ACCELERATOR_TYPE``, ``TPU_WORKER_ID``,
   ``TPU_WORKER_HOSTNAMES``, GKE's ``NODE_NAME`` downward-API convention),
3. hostname fallback.

Accelerator-type parsing ("v5p-64" → generation v5p, 64 cores, 32 chips,
8 hosts) uses the public TPU topology tables. Marked **[design]** — none of
this exists in the reference.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass, field

# generation -> (tensorcores per chip, chips per host) for full hosts.
# v4/v5p expose one "megacore" device per chip but the product name counts
# 2 cores/chip; v5e ("v5litepod") and v6e count 1 core per chip.  [design]
_GEN_TABLE: dict[str, tuple[int, int]] = {
    "v2": (2, 4),
    "v3": (2, 4),
    "v4": (2, 4),
    "v5p": (2, 4),
    "v5e": (1, 8),
    "v5litepod": (1, 8),
    "v6e": (1, 8),
}


@dataclass(frozen=True)
class SliceTopology:
    accelerator: str = ""   # e.g. "v5p-64"
    generation: str = ""    # e.g. "v5p"
    total_cores: int = 0
    total_chips: int = 0
    chips_per_host: int = 0
    num_hosts: int = 0

    @property
    def multi_host(self) -> bool:
        return self.num_hosts > 1


def parse_accelerator_type(accel: str) -> SliceTopology:
    """Parse "v4-8" / "v5p-64" / "v5litepod-16" into a SliceTopology.

    Unknown shapes degrade to a zero-filled topology rather than raising —
    topology labels are best-effort context, not load-bearing joins.
    """
    accel = accel.strip()
    if not accel or "-" not in accel:
        return SliceTopology(accelerator=accel)
    gen, _, tail = accel.rpartition("-")
    gen = gen.lower()
    try:
        total_cores = int(tail)
    except ValueError:
        return SliceTopology(accelerator=accel)
    cores_per_chip, chips_per_host = _GEN_TABLE.get(gen, (0, 0))
    if cores_per_chip == 0 or total_cores <= 0:
        return SliceTopology(accelerator=accel, generation=gen, total_cores=total_cores)
    total_chips = max(total_cores // cores_per_chip, 1)
    # Single-host slices can be smaller than a full host (e.g. v5e-4).
    num_hosts = max((total_chips + chips_per_host - 1) // chips_per_host, 1)
    return SliceTopology(
        accelerator=accel,
        generation=gen,
        total_cores=total_cores,
        total_chips=total_chips,
        chips_per_host=min(chips_per_host, total_chips),
        num_hosts=num_hosts,
    )


@dataclass(frozen=True)
class HostTopology:
    """The label values this exporter instance attaches to every series.

    ``multislice_group``/``num_slices`` are NOT per-series labels (that
    would bloat every chip series for a dimension most deployments lack);
    they ride the once-per-host ``tpu_host_info`` series, which aggregators
    and recording rules join on (the Prometheus info-series pattern).
    """

    accelerator: str = ""
    slice_name: str = ""
    host: str = ""
    worker_id: str = ""
    # Multi-slice membership (BASELINE config 5, GKE multi-slice): the
    # group identity shared by all slices of one multi-slice workload, and
    # the expected slice count. Empty / "0" outside multi-slice.
    multislice_group: str = ""
    num_slices: str = ""
    slice_topology: SliceTopology = field(default_factory=SliceTopology)

    def labels(self) -> dict[str, str]:
        return {
            "accelerator": self.accelerator,
            "slice_name": self.slice_name,
            "host": self.host,
            "worker_id": self.worker_id,
        }

    def host_info_labels(self) -> dict[str, str]:
        return {
            **self.labels(),
            "multislice_group": self.multislice_group,
            "num_slices": self.num_slices,
        }


def detect_host_topology(
    env: dict[str, str] | None = None,
    accelerator: str = "",
    slice_name: str = "",
    host: str = "",
    worker_id: str = "",
    multislice_group: str = "",
) -> HostTopology:
    """Build HostTopology from overrides > environment > hostname."""
    e = os.environ if env is None else env
    accel = accelerator or e.get("TPU_ACCELERATOR_TYPE", "") or e.get("ACCELERATOR_TYPE", "")
    wid = worker_id or e.get("TPU_WORKER_ID", "") or e.get("WORKER_ID", "")
    hostname = host or e.get("NODE_NAME", "") or e.get("HOSTNAME", "") or socket.gethostname()
    sname = (
        slice_name
        or e.get("TPU_SLICE_NAME", "")
        or e.get("TPU_NAME", "")
        # GKE multi-slice: jobset/replicated-job identity downward-API convention
        or e.get("MEGASCALE_SLICE_ID", "")
    )
    # Multi-slice group identity: explicit override first (taken VERBATIM —
    # an operator's group name may legitimately contain colons), else the
    # MEGASCALE coordinator address every slice of one group shares (GKE
    # multi-slice injects it into all workers). A trailing :port is
    # stripped from the env value only when the tail is numeric, so a bare
    # IPv6 address is not mangled.
    group = multislice_group
    if not group:
        group = e.get("MEGASCALE_COORDINATOR_ADDRESS", "")
        if ":" in group:
            head, _, tail = group.rpartition(":")
            if tail.isdigit():
                group = head
    nslices = e.get("MEGASCALE_NUM_SLICES", "") if group else ""
    return HostTopology(
        accelerator=accel,
        slice_name=sname,
        host=hostname,
        worker_id=wid,
        multislice_group=group,
        num_slices=nslices,
        slice_topology=parse_accelerator_type(accel),
    )
