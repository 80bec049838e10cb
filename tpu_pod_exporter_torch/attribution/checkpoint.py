"""Kubelet device-plugin checkpoint reader — zero-dependency fallback.

The kubelet persists device-plugin allocations to
``/var/lib/kubelet/device-plugins/kubelet_internal_checkpoint`` as JSON:

    {"Data": {"PodDeviceEntries": [
        {"PodUID": "...", "ContainerName": "...",
         "ResourceName": "google.com/tpu",
         "DeviceIDs": {"-1": ["0", "1"]}},   # numa-node -> ids (k8s >=1.20)
       ...],
      "RegisteredDevices": {...}},
     "Checksum": ...}

Older kubelets store ``DeviceIDs`` as a flat list. Both shapes are handled.

This is a *fallback* for nodes where the podresources socket is not mounted:
it knows pod UIDs, not names/namespaces, so series carry
``pod="uid:<uid>"`` unless a UID→name hint map is provided. The primary path
(podresources) should be preferred whenever available.
"""

from __future__ import annotations

import json
import logging
from typing import Mapping

from tpu_pod_exporter_torch.attribution import (
    AttributionError,
    AttributionProvider,
    AttributionSnapshot,
    DeviceAllocation,
)

log = logging.getLogger("tpu_pod_exporter_torch.attribution.checkpoint")

DEFAULT_CHECKPOINT = "/var/lib/kubelet/device-plugins/kubelet_internal_checkpoint"


def parse_checkpoint(
    raw: str | bytes,
    uid_to_pod: Mapping[str, tuple[str, str]] | None = None,
) -> AttributionSnapshot:
    """Pure parser: checkpoint JSON → AttributionSnapshot.

    ``uid_to_pod`` optionally maps pod UID → (name, namespace).
    """
    try:
        doc = json.loads(raw)
    except json.JSONDecodeError as e:
        raise AttributionError(f"checkpoint is not valid JSON: {e}") from e

    entries = (doc.get("Data") or {}).get("PodDeviceEntries") or []
    allocations: list[DeviceAllocation] = []
    for entry in entries:
        if not isinstance(entry, dict):
            continue
        uid = entry.get("PodUID", "")
        resource = entry.get("ResourceName", "")
        container = entry.get("ContainerName", "")
        raw_ids = entry.get("DeviceIDs")
        if isinstance(raw_ids, dict):  # numa-node -> [ids]
            ids = [d for ids_list in raw_ids.values() for d in (ids_list or [])]
        elif isinstance(raw_ids, list):  # pre-1.20 flat shape
            ids = list(raw_ids)
        else:
            ids = []
        if not ids:
            continue
        if uid_to_pod and uid in uid_to_pod:
            pod, namespace = uid_to_pod[uid]
        else:
            pod, namespace = f"uid:{uid}", ""
        allocations.append(
            DeviceAllocation(
                pod=pod,
                namespace=namespace,
                container=container,
                device_ids=tuple(str(d) for d in ids),
                resource_name=resource,
            )
        )
    return AttributionSnapshot(tuple(allocations))


class CheckpointAttribution(AttributionProvider):
    name = "checkpoint"

    def __init__(
        self,
        path: str = DEFAULT_CHECKPOINT,
        uid_to_pod: Mapping[str, tuple[str, str]] | None = None,
        uid_source=None,
    ) -> None:
        """``uid_to_pod`` is a fixed mapping; ``uid_source`` is a live
        resolver with a ``mapping()`` method (``uidmap.StaticUidMap`` /
        ``uidmap.KubeletPodsUidMap``) re-consulted every snapshot so pod
        churn is picked up. If both are given the source wins."""
        self._path = path
        self._uid_to_pod = uid_to_pod
        self._uid_source = uid_source
        self._uid_map_errors = 0

    def error_counters(self) -> dict[str, float]:
        """Cumulative side-channel error counts, published by the collector
        as ``tpu_exporter_poll_errors_total{source="attribution.uid_map"}`` — covers
        both resolver exceptions seen here and the kubelet source's
        internal fetch failures (which degrade to last-good silently)."""
        total = self._uid_map_errors + int(
            getattr(self._uid_source, "fetch_errors", 0) or 0
        )
        return {"uid_map": float(total)} if total else {}

    def snapshot(self) -> AttributionSnapshot:
        try:
            with open(self._path, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise AttributionError(f"cannot read checkpoint {self._path}: {e}") from e
        uid_map = self._uid_to_pod
        if self._uid_source is not None:
            try:
                uid_map = self._uid_source.mapping()
            except Exception as e:  # noqa: BLE001 — names are best-effort
                # Degrade to uid:<uid> series rather than failing the whole
                # attribution phase: allocations are still correct.
                self._uid_map_errors += 1
                log.warning("uid map unavailable (%s); emitting uid-keyed pods", e)
                uid_map = self._uid_to_pod
        return parse_checkpoint(raw, uid_map)
