"""TorchCudaBackend against a stand-in ``torch.cuda`` (mirrors
tests/test_backend_jaxdev.py): no CUDA fails loudly, readings and identity
map as the NVML backend's do, the device node is NVML's minor for the UUID
(or "" without NVML, never the torch index), and a device whose stats raise
publishes no ``gpu_hbm_*`` series — absent beats fake-zero."""

from types import SimpleNamespace

import pytest
import torch

from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
from tpu_pod_exporter_torch.backend import BackendError
from tpu_pod_exporter_torch.backend import torchdev
from tpu_pod_exporter_torch.backend.torchdev import TorchCudaBackend
from tpu_pod_exporter_torch.collector import Collector
from tpu_pod_exporter_torch.metrics import SnapshotStore

GIB = 1024**3


class FakeCuda:
    """Per-device allocator counters, as ``torch.cuda`` reports them."""

    def __init__(self, n=2, fail=(), fail_identity=(), uuid_prefix=""):
        self.n = n
        self.fail = set(fail)
        self.fail_identity = set(fail_identity)
        self.uuid_prefix = uuid_prefix

    def _check(self, i):
        if i in self.fail:
            raise RuntimeError(f"CUDA error on device {i}")

    def install(self, monkeypatch):
        def no_nvml():
            raise BackendError("libnvidia-ml.so.1 could not be loaded")

        # The stand-in has no NVML beside it.
        monkeypatch.setattr(torchdev, "CtypesNvmlDriver", no_nvml)
        cuda = torch.cuda
        monkeypatch.setattr(cuda, "is_available", lambda: True)
        monkeypatch.setattr(cuda, "device_count", lambda: self.n)
        monkeypatch.setattr(cuda, "memory_allocated", self.memory_allocated)
        monkeypatch.setattr(cuda, "max_memory_allocated", self.max_memory_allocated)
        monkeypatch.setattr(cuda, "mem_get_info", self.mem_get_info)
        monkeypatch.setattr(cuda, "get_device_name", self.get_device_name)
        monkeypatch.setattr(cuda, "get_device_properties", self.get_device_properties)
        return self

    def memory_allocated(self, i):
        self._check(i)
        return (i + 1) * GIB

    def max_memory_allocated(self, i):
        self._check(i)
        return (i + 3) * GIB

    def mem_get_info(self, i):
        self._check(i)
        return (70 * GIB, 80 * GIB)

    def get_device_name(self, i):
        if i in self.fail_identity:
            raise RuntimeError("no name")
        return "NVIDIA H100 80GB HBM3"

    def get_device_properties(self, i):
        return SimpleNamespace(uuid=f"{self.uuid_prefix}0000000{i}-aaaa-bbbb-cccc-dddddddddddd")


class FakeNvml:
    """NVML's calls for the stand-in's cards, each at its own minor."""

    def __init__(self, minors):
        self.minors = minors  # index -> minor
        self.shut = False

    def nvmlInit(self):  # noqa: N802 — NVML API casing
        pass

    def nvmlShutdown(self):  # noqa: N802
        self.shut = True

    def nvmlDeviceGetCount(self):  # noqa: N802
        return len(self.minors)

    def nvmlDeviceGetHandleByIndex(self, i):  # noqa: N802
        return i

    def nvmlDeviceGetUUID(self, i):  # noqa: N802
        return f"GPU-0000000{i}-aaaa-bbbb-cccc-dddddddddddd"

    def nvmlDeviceGetMinorNumber(self, i):  # noqa: N802
        return self.minors[i]


class TestTorchCudaBackend:
    def test_no_cuda_raises_backend_error(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(BackendError, match="no CUDA device"):
            TorchCudaBackend()

    def test_readings_and_identity(self, monkeypatch):
        FakeCuda(n=2).install(monkeypatch)
        backend = TorchCudaBackend()
        assert (backend.name, backend.family) == ("torch", "gpu")
        sample = backend.sample()
        assert sample.partial_errors == ()
        assert len(sample.chips) == 2
        for i, chip in enumerate(sample.chips):
            assert chip.info.chip_id == i
            assert chip.info.device_path == ""  # no NVML: no node, never the index
            assert chip.info.device_ids == (
                f"GPU-0000000{i}-aaaa-bbbb-cccc-dddddddddddd", str(i))
            assert chip.info.device_kind == "NVIDIA H100 80GB HBM3"
            assert chip.info.family == "gpu"
            assert chip.hbm_used_bytes == float((i + 1) * GIB)
            assert chip.hbm_total_bytes == float(80 * GIB)
            assert chip.hbm_peak_bytes == float((i + 3) * GIB)
            assert chip.tensorcore_duty_cycle_percent is None

    def test_device_path_is_nvml_minor_for_the_uuid(self, monkeypatch):
        FakeCuda(n=1).install(monkeypatch)
        nvml = FakeNvml({0: 3})  # index 0 is the host's /dev/nvidia3
        (chip,) = TorchCudaBackend(nvml_driver=nvml).sample().chips
        assert chip.info.device_path == "/dev/nvidia3"
        assert nvml.shut

    def test_failing_nvml_call_leaves_the_node_unnamed(self, monkeypatch):
        from tpu_pod_exporter_torch.backend.nvml import NvmlDriverError

        FakeCuda(n=1).install(monkeypatch)
        nvml = FakeNvml({0: 3})

        def lost(i):
            raise NvmlDriverError("gpu_is_lost")

        nvml.nvmlDeviceGetMinorNumber = lost
        (chip,) = TorchCudaBackend(nvml_driver=nvml).sample().chips
        assert chip.info.device_path == ""
        assert nvml.shut

    def test_uuid_already_in_nvml_form_is_kept(self, monkeypatch):
        FakeCuda(n=1, uuid_prefix="GPU-").install(monkeypatch)
        (chip,) = TorchCudaBackend().sample().chips
        assert chip.info.device_ids[0] == "GPU-00000000-aaaa-bbbb-cccc-dddddddddddd"

    def test_raising_stats_yield_none_hbm_and_partial_error(self, monkeypatch):
        FakeCuda(n=2, fail={1}).install(monkeypatch)
        sample = TorchCudaBackend().sample()
        ok, bad = sample.chips
        assert ok.hbm_used_bytes == float(GIB)
        assert bad.hbm_used_bytes is None
        assert bad.hbm_total_bytes is None
        assert bad.hbm_peak_bytes is None
        assert len(sample.partial_errors) == 1
        assert "device 1: memory stats unavailable" in sample.partial_errors[0]

    def test_missing_identity_keeps_index_and_reports(self, monkeypatch):
        FakeCuda(n=1, fail_identity={0}).install(monkeypatch)
        sample = TorchCudaBackend().sample()
        (chip,) = sample.chips
        assert chip.info.device_ids == ("0",)
        assert chip.info.device_kind == ""
        assert chip.hbm_used_bytes == float(GIB)
        assert "identity unavailable" in sample.partial_errors[0]

    def test_collector_publishes_gpu_series_and_no_peak(self, monkeypatch):
        FakeCuda(n=1).install(monkeypatch)
        store = SnapshotStore()
        Collector(TorchCudaBackend(), FakeAttribution(), store).poll_once()
        text = store.current().encode().decode()
        assert "gpu_hbm_used_bytes{" in text
        assert "gpu_hbm_total_bytes{" in text
        assert "gpu_chip_info{" in text
        assert "hbm_peak_bytes{" not in text  # no gpu twin of the peak series
        assert "tpu_hbm_used_bytes{" not in text

    def test_collector_publishes_no_hbm_series_for_unreadable_device(self, monkeypatch):
        FakeCuda(n=1, fail={0}).install(monkeypatch)
        store = SnapshotStore()
        Collector(TorchCudaBackend(), FakeAttribution(), store).poll_once()
        text = store.current().encode().decode()
        assert "gpu_chip_info{" in text
        assert "gpu_hbm_used_bytes{" not in text
        assert "gpu_hbm_total_bytes{" not in text
        assert "gpu_hbm_used_percent{" not in text
