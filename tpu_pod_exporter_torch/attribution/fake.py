"""Scripted attribution provider — the podresources fake (SURVEY.md §4.2).

Supports instantaneous reassignment (``set_allocations``) for churn stress
(baseline config 5) and fault injection (``fail_next``) for §4.5.
"""

from __future__ import annotations

import threading
from typing import Iterable, Sequence

from tpu_pod_exporter_torch.attribution import (
    AttributionError,
    AttributionProvider,
    AttributionSnapshot,
    DeviceAllocation,
    TPU_RESOURCE_NAME,
)


class FakeAttribution(AttributionProvider):
    name = "fake"

    def __init__(
        self,
        allocations: Sequence[DeviceAllocation] = (),
        allocatable: Sequence[str] | None = None,
    ) -> None:
        self._lock = threading.Lock()
        self._snapshot = AttributionSnapshot(
            tuple(allocations),
            allocatable_device_ids=tuple(allocatable) if allocatable is not None else None,
        )
        self._fail_next = 0
        self.snapshot_calls = 0
        self.closed = False

    _KEEP = object()  # sentinel: preserve current allocatable on churn

    def set_allocations(
        self,
        allocations: Iterable[DeviceAllocation],
        allocatable: "Sequence[str] | None | object" = _KEEP,
    ) -> None:
        with self._lock:
            if allocatable is FakeAttribution._KEEP:
                # Real kubelets keep reporting the device inventory across
                # pod churn; the fake must too unless explicitly overridden.
                alloc_ids = self._snapshot.allocatable_device_ids
            else:
                alloc_ids = (
                    tuple(allocatable) if allocatable is not None else None  # type: ignore[arg-type]
                )
            self._snapshot = AttributionSnapshot(
                tuple(allocations), allocatable_device_ids=alloc_ids
            )

    def fail_next(self, n: int = 1) -> None:
        with self._lock:
            self._fail_next += n

    def snapshot(self) -> AttributionSnapshot:
        with self._lock:
            self.snapshot_calls += 1
            if self._fail_next > 0:
                self._fail_next -= 1
                raise AttributionError("fake attribution: injected failure")
            return self._snapshot

    def close(self) -> None:
        self.closed = True


def simple_allocation(
    pod: str,
    device_ids: Sequence[str],
    namespace: str = "default",
    container: str = "main",
) -> DeviceAllocation:
    return DeviceAllocation(
        pod=pod,
        namespace=namespace,
        container=container,
        device_ids=tuple(device_ids),
        resource_name=TPU_RESOURCE_NAME,
    )
