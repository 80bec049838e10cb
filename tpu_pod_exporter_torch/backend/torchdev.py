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
same: ``device_ids=("GPU-<uuid>", str(i))``, ``device_kind`` the device
name, ``family="gpu"``. The device node is the one the NVML backend
(``backend/nvml.py``) names: ``/dev/nvidia<minor>``, with the minor read
from NVML for the card's UUID. The torch index is not the minor: a
container given one card of a larger host sees it as index 0 while its
node keeps the host's minor. Where ``libnvidia-ml.so.1`` does not load, or
NVML cannot name the card, ``device_path`` is ``""``, as the JAX package's
in-process backend publishes it; the index is never published as a node.

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
from tpu_pod_exporter_torch.backend.nvml import NvmlDriverError
from tpu_pod_exporter_torch.backend.nvml_ctypes import CtypesNvmlDriver

log = logging.getLogger("tpu_pod_exporter_torch.backend.torchdev")


def _nvml_uuid(uuid: object) -> str:
    """torch's device UUID in NVML's text form, ``GPU-xxxxxxxx-…``."""
    text = str(uuid)
    return text if text.startswith("GPU-") else f"GPU-{text}"


def nvml_minors(driver=None) -> dict[str, int]:
    """{NVML UUID: minor number} of every card NVML lists; {} where
    ``libnvidia-ml.so.1`` does not load or a call fails (a partial map
    could misname a card). ``driver`` replaces the ctypes binding (any
    object with its NVML calls)."""
    try:
        if driver is None:
            driver = CtypesNvmlDriver()
        driver.nvmlInit()
    except (BackendError, NvmlDriverError) as e:
        log.info("NVML unavailable, device nodes unnamed: %s", e)
        return {}
    try:
        handles = map(driver.nvmlDeviceGetHandleByIndex,
                      range(driver.nvmlDeviceGetCount()))
        return {driver.nvmlDeviceGetUUID(h): driver.nvmlDeviceGetMinorNumber(h)
                for h in handles}
    except NvmlDriverError as e:
        log.warning("NVML could not list the device nodes: %s", e)
        return {}
    finally:
        try:
            driver.nvmlShutdown()
        except NvmlDriverError as e:
            log.warning("nvmlShutdown failed: %s", e)


class TorchCudaBackend(DeviceBackend):
    name = "torch"
    family = "gpu"

    def __init__(self, nvml_driver=None) -> None:
        if not torch.cuda.is_available():
            raise BackendError(
                "no CUDA device is visible to torch "
                f"(torch {torch.__version__}, CUDA build {torch.version.cuda})"
            )
        self._identity: dict[int, tuple[str, str]] = {}
        self._nvml_driver = nvml_driver
        self._minors: dict[str, int] | None = None

    def _device_path(self, uuid: str) -> str:
        """``/dev/nvidia<minor>`` of the card with this UUID, "" when NVML
        does not name it (the map is read from NVML once)."""
        if self._minors is None:
            self._minors = nvml_minors(self._nvml_driver)
        minor = self._minors.get(uuid)
        return "" if minor is None else f"/dev/nvidia{minor}"

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
                        # NVML's minor for this UUID; never the torch index.
                        device_path=self._device_path(uuid) if uuid else "",
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
