"""In-process CUDA device backend — live device memory via torch's allocator.

Ported from ``tpu_pod_exporter/backend/jaxdev.py`` (``JaxDeviceBackend``).
Like it, this backend runs inside the workload's process and reads that
process's own allocator, so it is for colocated dev and bench setups and
for the closed-loop check (``hwcheck``), not for a DaemonSet watching other
processes' GPUs.

Readings for each visible device ``i``:

- used: ``torch.cuda.memory_allocated(i)``, the caching allocator's live
  bytes — the counterpart of ``bytes_in_use``;
- total: ``torch.cuda.mem_get_info(i)[1]``;
- peak: ``torch.cuda.max_memory_allocated(i)``. The collector publishes
  peak only for tpu-family chips, so it never reaches the wire here;
- utilization: ``None``, as in the JAX backend.

Identity matches the NVML backend's, so the podresources join key is the
same: ``device_path=/dev/nvidia{i}``, ``device_ids=("GPU-<uuid>", str(i))``,
``device_kind`` the device name, ``family="gpu"``. Under
``CUDA_VISIBLE_DEVICES`` the torch index ``i`` is not the ``/dev/nvidiaN``
minor number; the UUID stays right, the path does not. The NVML backend
(``backend/nvml.py``) names the node by its minor number.

No CUDA raises :class:`BackendError` at construction. A device whose
memory stats raise gets ``None`` HBM plus a partial error, so the collector
publishes no ``gpu_hbm_*`` series for it.
"""

from __future__ import annotations

import logging

import torch

from tpu_pod_exporter_torch.backend import (
    BackendError,
    ChipInfo,
    ChipSample,
    DeviceBackend,
    HostSample,
)

log = logging.getLogger("tpu_pod_exporter_torch.backend.torchdev")


def _nvml_uuid(uuid: object) -> str:
    """torch's device UUID in NVML's text form, ``GPU-xxxxxxxx-…``."""
    text = str(uuid)
    return text if text.startswith("GPU-") else f"GPU-{text}"


class TorchCudaBackend(DeviceBackend):
    name = "torch"
    family = "gpu"

    def __init__(self) -> None:
        if not torch.cuda.is_available():
            raise BackendError(
                "no CUDA device is visible to torch "
                f"(torch {torch.__version__}, CUDA build {torch.version.cuda})"
            )
        self._identity: dict[int, tuple[str, str]] = {}

    def _identify(self, i: int) -> tuple[str, str]:
        """(device name, NVML-form UUID) of device ``i``, read once."""
        if i not in self._identity:
            props = torch.cuda.get_device_properties(i)
            self._identity[i] = (torch.cuda.get_device_name(i),
                                 _nvml_uuid(props.uuid))
        return self._identity[i]

    def sample(self) -> HostSample:
        try:
            count = torch.cuda.device_count()
        except Exception as e:  # noqa: BLE001 — total failure fails the poll
            raise BackendError(f"CUDA device count failed: {e}") from e
        chips: list[ChipSample] = []
        partial: list[str] = []
        for i in range(count):
            kind = uuid = ""
            try:
                kind, uuid = self._identify(i)
            except Exception as e:  # noqa: BLE001 — identity is optional
                partial.append(f"device {i}: identity unavailable: {e}")
            used = total = peak = None
            try:
                used = float(torch.cuda.memory_allocated(i))
                total = float(torch.cuda.mem_get_info(i)[1])
                peak = float(torch.cuda.max_memory_allocated(i))
            except Exception as e:  # noqa: BLE001 — absent beats fake-zero
                used = total = peak = None
                partial.append(f"device {i}: memory stats unavailable: {e}")
            chips.append(
                ChipSample(
                    info=ChipInfo(
                        chip_id=i,
                        # The torch index, which is the /dev/nvidiaN minor
                        # only when CUDA_VISIBLE_DEVICES is unset.
                        device_path=f"/dev/nvidia{i}",
                        device_ids=(uuid, str(i)) if uuid else (str(i),),
                        device_kind=kind,
                        family="gpu",
                    ),
                    hbm_used_bytes=used,
                    hbm_total_bytes=total,
                    tensorcore_duty_cycle_percent=None,  # not exposed via torch
                    hbm_peak_bytes=peak,
                )
            )
        return HostSample(chips=tuple(chips), partial_errors=tuple(partial))
