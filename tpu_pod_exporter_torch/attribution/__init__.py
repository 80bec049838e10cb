"""Pod ↔ device attribution — replaces the reference's L2+L3 entirely.

The reference joins device telemetry to pods via a cluster-wide pod list
(``main.go:77``), a per-pod ``kubectl exec … ps`` PID harvest
(``main.go:101-109``), and a triple-nested PID comparison
(``main.go:141-154``). That path is broken three ways (index-vs-value join,
PID-namespace mismatch, container mistargeting — SURVEY.md §2.6) and costs
O(pods) process spawns plus apiserver round-trips per poll.

Here attribution is one local call: the kubelet **podresources API**
(``List`` over ``/var/lib/kubelet/pod-resources/kubelet.sock``), which
reports exactly which ``google.com/tpu`` device IDs each container was
allocated. No apiserver traffic, no exec, no PID translation — and the join
key (device ID) is authoritative rather than heuristic.

Implementations:
- :class:`~tpu_pod_exporter_torch.attribution.fake.FakeAttribution` — scripted
  allocations for tests/bench, with churn and fault injection.
- :class:`~tpu_pod_exporter_torch.attribution.podresources.PodResourcesAttribution`
  — the real gRPC client (vendored proto, unix socket).
- :class:`~tpu_pod_exporter_torch.attribution.checkpoint.CheckpointAttribution` —
  zero-dependency fallback that reads the kubelet device-plugin checkpoint
  file directly.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field

TPU_RESOURCE_NAME = "google.com/tpu"


class AttributionError(RuntimeError):
    """Attribution source failed; the poll should degrade, not die."""


@dataclass(frozen=True)
class DeviceAllocation:
    """One container's claim on a set of device IDs."""

    pod: str
    namespace: str
    container: str
    device_ids: tuple[str, ...]
    resource_name: str = TPU_RESOURCE_NAME


@dataclass(frozen=True)
class AttributionSnapshot:
    """All allocations on this node at one instant.

    ``allocatable_device_ids`` is the kubelet's full device-plugin inventory
    for the resource (GetAllocatableResources); None when the source cannot
    report it (checkpoint fallback, old kubelets).
    """

    allocations: tuple[DeviceAllocation, ...] = ()
    allocatable_device_ids: tuple[str, ...] | None = None

    def by_device_id(self, resource_name: str = TPU_RESOURCE_NAME) -> dict[str, DeviceAllocation]:
        """device_id -> owning allocation. Kubelet guarantees a device is
        allocated to at most one container; on (buggy) duplicates the first
        claim wins deterministically."""
        out: dict[str, DeviceAllocation] = {}
        for alloc in self.allocations:
            if alloc.resource_name != resource_name:
                continue
            for did in alloc.device_ids:
                out.setdefault(did, alloc)
        return out


class AttributionProvider(abc.ABC):
    name: str = "abstract"

    @abc.abstractmethod
    def snapshot(self) -> AttributionSnapshot:
        """Current pod↔device allocations. Raises AttributionError on failure."""

    def close(self) -> None:
        return None


from tpu_pod_exporter_torch.attribution.fake import FakeAttribution  # noqa: E402

__all__ = [
    "TPU_RESOURCE_NAME",
    "AttributionError",
    "AttributionProvider",
    "AttributionSnapshot",
    "DeviceAllocation",
    "FakeAttribution",
]
