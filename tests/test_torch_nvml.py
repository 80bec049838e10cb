"""The port's NVML backend held against the JAX package's, and its ctypes
binding held against a fake ``libnvidia-ml``.

One simulated-driver spec (with injected NVML codes) goes through both
packages' ``NvmlBackend`` and both ``ExporterApp``s: equal samples, and the
same /metrics lines outside the timing and process self-metrics. The
ctypes driver is driven by an object that fills the NVML structs the way
the library does, so the sizing call, the NOT_AVAILABLE sentinel, the byte
strings and the return codes are checked without a driver.
"""

import ctypes
import dataclasses
import json

import pytest

from test_torch_exporter import VOLATILE_FAMILIES, _get, _split
from tpu_pod_exporter.app import ExporterApp as JaxExporterApp
from tpu_pod_exporter.attribution import DeviceAllocation as JaxAllocation
from tpu_pod_exporter.attribution.fake import FakeAttribution as JaxFakeAttribution
from tpu_pod_exporter.backend import nvml as jax_nvml
from tpu_pod_exporter.config import ExporterConfig as JaxExporterConfig
from tpu_pod_exporter_torch import app as tapp
from tpu_pod_exporter_torch.attribution import DeviceAllocation
from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
from tpu_pod_exporter_torch.backend import BackendError
from tpu_pod_exporter_torch.backend import nvml as torch_nvml
from tpu_pod_exporter_torch.backend import nvml_ctypes
from tpu_pod_exporter_torch.backend.fake import FakeBackend
from tpu_pod_exporter_torch.backend.nvml_ctypes import CtypesNvmlDriver
from tpu_pod_exporter_torch.config import ExporterConfig

GIB = 1024**3
SPEC = {
    "gpus": [
        {"mem_total": 80 * GIB, "mem_used": 21 * GIB, "utilization": 87,
         "name": "NVIDIA H100 80GB HBM3", "uuid": "GPU-0a1b",
         "processes": [[4242, 12 * GIB, "train"], [4243, 8 * GIB, "eval"]]},
        {"mem_total": 80 * GIB, "mem_used": 1 * GIB, "utilization": None,
         "uuid": "GPU-2c3d"},
        {"mem_used": 3 * GIB, "utilization": 10,
         "processes": [[77, 3 * GIB, "serve"]]},
    ],
    "faults": [
        {"call": "DeviceGetMemoryInfo", "code": "gpu_is_lost", "times": 1},
        {"call": "DeviceGetComputeRunningProcesses", "code": "no_permission"},
        {"call": "DeviceGetUtilizationRates", "code": 999},
    ],
}


def plain(value):
    """A sample, holder or snapshot as nested tuples of its field values, so
    that the two packages' classes compare by content."""
    if dataclasses.is_dataclass(value):
        return (type(value).__name__, plain(dataclasses.astuple(value)))
    if isinstance(value, tuple):
        return (type(value).__name__, *map(plain, value))
    return value


def _both_backends(spec=SPEC):
    return (jax_nvml.NvmlBackend(driver=jax_nvml.sim_driver_from_spec(spec)),
            torch_nvml.NvmlBackend(driver=torch_nvml.sim_driver_from_spec(spec)))


class TestSimulatedParity:
    def test_samples_equal_poll_by_poll(self):
        jax_backend, torch_backend = _both_backends()
        for _ in range(4):  # the faults fire in the first polls, then clear
            want, got = jax_backend.sample(), torch_backend.sample()
            assert plain(got) == plain(want)
        assert [c.info.device_path for c in got.chips] == [
            "/dev/nvidia0", "/dev/nvidia1", "/dev/nvidia2"]  # by index

    @pytest.mark.parametrize("call,code", [
        ("Init", "driver_not_loaded"), ("DeviceGetCount", "gpu_is_lost")])
    def test_total_failures_raise_the_same_code(self, call, code):
        spec = dict(SPEC, faults=[{"call": call, "code": code}])
        jax_backend, torch_backend = _both_backends(spec)
        with pytest.raises(jax_nvml.NvmlError) as want:
            jax_backend.sample()
        with pytest.raises(torch_nvml.NvmlError) as got:
            torch_backend.sample()
        assert (got.value.call, got.value.code, got.value.code_name) == (
            want.value.call, want.value.code, want.value.code_name)

    def test_metrics_bodies_match_line_for_line(self, tmp_path):
        spec = tmp_path / "spec.json"
        spec.write_text(json.dumps(SPEC))
        fields = dict(port=0, host="127.0.0.1", backend="nvml",
                      nvml_sim_spec=str(spec), legacy_metrics=True)
        ids = ("GPU-0a1b", "GPU-2c3d")
        apps = [
            JaxExporterApp(JaxExporterConfig(**fields), attribution=JaxFakeAttribution(
                [JaxAllocation("train-0", "ml", "main", ids, "nvidia.com/gpu")])),
            tapp.ExporterApp(ExporterConfig(**fields), attribution=FakeAttribution(
                [DeviceAllocation("train-0", "ml", "main", ids, "nvidia.com/gpu")])),
        ]
        try:
            bodies = []
            for app in apps:  # one poll, in which every fault fires
                app.collector.poll_once()
                app.server.start()
                status, body = _get(f"http://127.0.0.1:{app.port}", "/metrics")
                assert status == 200
                bodies.append(body.decode())
        finally:
            for app in apps:
                app.stop()
        want, got = (body.splitlines() for body in bodies)
        assert len(want) == len(got) > 100
        for want_line, got_line in zip(want, got):
            want_key, want_value = _split(want_line)
            got_key, got_value = _split(got_line)
            assert got_key == want_key
            if want_value != got_value:
                assert want_key.startswith(VOLATILE_FAMILIES), (want_line, got_line)
        for family in ("gpu_hbm_used_bytes", "gpu_utilization_percent",
                       "gpu_process_memory_used_bytes", "gpu_pod_memory_used_bytes",
                       "pod_gpu_memory_usage"):
            assert f"\n{family}{{" in bodies[1], family


class FakeNvmlLib:
    """The NVML symbols the ctypes driver binds, as plain functions that
    fill the ctypes arguments as ``libnvidia-ml`` does. ``procs`` is the
    process table ([(pid, used)]); ``growth[k]`` rows join it after its
    k-th call; ``codes`` maps a symbol to the code it returns."""

    def __init__(self, procs=(), growth=(), codes=None, minor=3,
                 uuid=b"GPU-bae8c9e4-2b9c-6a92-b426-c2e367abb292"):
        self.procs = list(procs)
        self.calls: list[tuple[str, int]] = []
        codes = codes or {}

        def symbol(name, body):
            def fn(*args):
                if name in codes:
                    return codes[name]
                return body(*args) or 0
            setattr(self, name, fn)

        def fill(count, infos):
            rows = list(self.procs)
            if len(self.calls) < len(growth):
                start = 9000 + len(self.procs)
                self.procs += [(start + i, GIB) for i in range(growth[len(self.calls)])]
            self.calls.append(("procs", count.value))
            if infos is None or count.value < len(rows):
                count.value = len(rows)
                return 0 if not rows else 7
            for i, (pid, used) in enumerate(rows):
                infos[i].pid = pid
                infos[i].usedGpuMemory = used
            count.value = len(rows)
            return 0

        def text(value):
            def body(handle, buf, length):
                assert length == 96
                buf.value = value
            return body

        def set_struct(**values):
            def body(handle, out):
                for field, v in values.items():
                    setattr(out, field, v)
            return body

        symbol("nvmlInit_v2", lambda: None)
        symbol("nvmlShutdown", lambda: None)
        symbol("nvmlDeviceGetCount_v2", lambda n: setattr(n, "value", 1))
        symbol("nvmlDeviceGetHandleByIndex_v2",
               lambda i, h: setattr(h, "value", 0x1000 + i))
        symbol("nvmlDeviceGetName", text(b"NVIDIA H100 80GB HBM3"))
        symbol("nvmlDeviceGetUUID", text(uuid))
        symbol("nvmlDeviceGetMinorNumber", lambda h, m: setattr(m, "value", minor))
        symbol("nvmlDeviceGetMemoryInfo",
               set_struct(total=80 * GIB, free=60 * GIB, used=20 * GIB))
        symbol("nvmlDeviceGetUtilizationRates", set_struct(gpu=93, memory=41))
        symbol("nvmlDeviceGetComputeRunningProcesses_v3",
               lambda handle, count, infos: fill(count, infos))


class TestCtypesDriver:
    def test_reads_every_call(self):
        drv = CtypesNvmlDriver(lib=FakeNvmlLib(procs=[(118, 17 * GIB)]))
        drv.nvmlInit()
        assert drv.nvmlDeviceGetCount() == 1
        h = drv.nvmlDeviceGetHandleByIndex(0)
        assert h == 0x1000
        assert drv.nvmlDeviceGetName(h) == "NVIDIA H100 80GB HBM3"
        assert drv.nvmlDeviceGetUUID(h) == "GPU-bae8c9e4-2b9c-6a92-b426-c2e367abb292"
        assert drv.nvmlDeviceGetMinorNumber(h) == 3
        assert drv.nvmlDeviceGetMemoryInfo(h) == {
            "total": 80 * GIB, "free": 60 * GIB, "used": 20 * GIB}
        assert drv.nvmlDeviceGetUtilizationRates(h) == {"gpu": 93, "memory": 41}
        assert drv.process_symbol == "nvmlDeviceGetComputeRunningProcesses_v3"

    @pytest.mark.parametrize("procs,growth,sizes", [
        ([], (), [0]),                                   # empty: one call
        ([(1, GIB), (2, 2 * GIB), (3, 3 * GIB)], (), [0, 3 + 8]),
        ([(1, GIB)], (5,), [0, 1 + 8]),                  # grew inside the slack
        ([(1, GIB)], (12,), [0, 1 + 8, 13 + 8]),         # grew past it
    ])
    def test_process_table_sizing_call(self, procs, growth, sizes):
        lib = FakeNvmlLib(procs=procs, growth=growth)
        rows = CtypesNvmlDriver(lib=lib).nvmlDeviceGetComputeRunningProcesses(0x1000)
        assert [size for _, size in lib.calls] == sizes
        assert [(r["pid"], r["usedGpuMemory"]) for r in rows] == lib.procs
        assert [r["comm"] for r in rows] == [""] * len(lib.procs)

    def test_table_growing_every_call_gives_up(self):
        lib = FakeNvmlLib(procs=[(1, GIB)], growth=(100,) * 10)
        with pytest.raises(torch_nvml.NvmlDriverError) as e:
            CtypesNvmlDriver(lib=lib).nvmlDeviceGetComputeRunningProcesses(0x1000)
        assert e.value.value == 7
        assert len(lib.calls) == 1 + nvml_ctypes.PROCESS_TABLE_TRIES

    def test_not_available_memory_is_none_and_skipped(self):
        lib = FakeNvmlLib(procs=[(5, nvml_ctypes.NVML_VALUE_NOT_AVAILABLE), (6, GIB)])
        rows = CtypesNvmlDriver(lib=lib).nvmlDeviceGetComputeRunningProcesses(0x1000)
        assert [r["usedGpuMemory"] for r in rows] == [None, GIB]
        (chip,) = torch_nvml.NvmlBackend(driver=CtypesNvmlDriver(lib=lib)).sample().chips
        assert [(p.pid, p.used_bytes) for p in chip.processes] == [(6, float(GIB))]

    def test_backend_names_the_node_by_minor_and_keys_on_the_uuid(self):
        backend = torch_nvml.NvmlBackend(driver=CtypesNvmlDriver(lib=FakeNvmlLib(minor=3)))
        sample = backend.sample()
        (chip,) = sample.chips
        assert sample.partial_errors == ()
        assert chip.info.chip_id == 0
        assert chip.info.device_path == "/dev/nvidia3"
        assert chip.info.device_ids == ("GPU-bae8c9e4-2b9c-6a92-b426-c2e367abb292", "0")
        assert (chip.hbm_used_bytes, chip.tensorcore_duty_cycle_percent) == (20 * GIB, 93.0)

    def test_minor_failure_falls_back_to_the_index_with_a_partial_error(self):
        lib = FakeNvmlLib(codes={"nvmlDeviceGetMinorNumber": 3})
        sample = torch_nvml.NvmlBackend(driver=CtypesNvmlDriver(lib=lib)).sample()
        assert sample.chips[0].info.device_path == "/dev/nvidia0"
        assert sample.partial_errors == (
            "DeviceGetMinorNumber(0): NVML_ERROR_NOT_SUPPORTED (3)",)

    @pytest.mark.parametrize("symbol,code,want", [
        ("nvmlDeviceGetCount_v2", 15, "NVML_ERROR_GPU_IS_LOST"),
        ("nvmlInit_v2", 9, "NVML_ERROR_DRIVER_NOT_LOADED"),
        ("nvmlDeviceGetCount_v2", 17, "NVML_ERROR_UNKNOWN"),  # not in the table
    ])
    def test_nonzero_code_is_an_nvml_error(self, symbol, code, want):
        backend = torch_nvml.NvmlBackend(
            driver=CtypesNvmlDriver(lib=FakeNvmlLib(codes={symbol: code})))
        with pytest.raises(torch_nvml.NvmlError) as e:
            backend.sample()
        assert e.value.code_name == want
        assert f"{code})" in f"{e.value} {e.value.__cause__}"

    def test_per_device_code_degrades_that_reading(self):
        lib = FakeNvmlLib(codes={"nvmlDeviceGetMemoryInfo": 15})
        sample = torch_nvml.NvmlBackend(driver=CtypesNvmlDriver(lib=lib)).sample()
        assert sample.chips[0].hbm_used_bytes is None
        assert sample.partial_errors == (
            "DeviceGetMemoryInfo(0): NVML_ERROR_GPU_IS_LOST (15)",)

    def test_v2_process_symbol_when_v3_is_absent(self):
        lib = FakeNvmlLib(procs=[(1, GIB)])
        lib.nvmlDeviceGetComputeRunningProcesses_v2 = (
            lib.nvmlDeviceGetComputeRunningProcesses_v3)
        del lib.nvmlDeviceGetComputeRunningProcesses_v3
        drv = CtypesNvmlDriver(lib=lib)
        assert drv.process_symbol == "nvmlDeviceGetComputeRunningProcesses_v2"
        assert drv.nvmlDeviceGetComputeRunningProcesses(0x1000)[0]["pid"] == 1

    def test_missing_symbol_is_a_backend_error(self):
        lib = FakeNvmlLib()
        del lib.nvmlDeviceGetMinorNumber
        with pytest.raises(BackendError, match="nvmlDeviceGetMinorNumber"):
            CtypesNvmlDriver(lib=lib)

    def test_error_codes_match_nvml_h(self):
        # nvmlReturn_t in nvml.h (CUDA 12.8). The JAX package's table has
        # IRQ_ISSUE = 13, which is FUNCTION_NOT_FOUND there; a real driver's
        # 13 would be misnamed and its 11 fall to UNKNOWN.
        header = {"UNINITIALIZED": 1, "INVALID_ARGUMENT": 2, "NOT_SUPPORTED": 3,
                  "NO_PERMISSION": 4, "NOT_FOUND": 6, "INSUFFICIENT_SIZE": 7,
                  "DRIVER_NOT_LOADED": 9, "TIMEOUT": 10, "IRQ_ISSUE": 11,
                  "LIBRARY_NOT_FOUND": 12, "FUNCTION_NOT_FOUND": 13, "GPU_IS_LOST": 15,
                  "RESET_REQUIRED": 16, "MEMORY": 20, "UNKNOWN": 999}
        assert torch_nvml.NVML_ERROR_CODES == {
            f"NVML_ERROR_{name}": code for name, code in header.items()}
        assert jax_nvml.NVML_ERROR_CODES["NVML_ERROR_IRQ_ISSUE"] == 13

    def test_structs_match_nvml_h(self):
        # nvml.h (CUDA 12): v1 memory, utilization, and nvmlProcessInfo_t.
        assert ctypes.sizeof(nvml_ctypes.NvmlMemory) == 24
        assert ctypes.sizeof(nvml_ctypes.NvmlUtilization) == 8
        assert ctypes.sizeof(nvml_ctypes.NvmlProcessInfo) == 24
        assert nvml_ctypes.NvmlProcessInfo.usedGpuMemory.offset == 8


class TestLibraryMissing:
    @pytest.fixture(autouse=True)
    def no_library(self, monkeypatch):
        monkeypatch.setattr(nvml_ctypes, "LIBRARY", "libnvidia-ml-absent.so.1")

    def test_driver_raises_backend_error_naming_the_fix(self):
        with pytest.raises(BackendError, match="libnvidia-ml-absent.so.1.*--nvml-sim-gpus"):
            CtypesNvmlDriver()

    def test_explicit_nvml_backend_raises(self):
        with pytest.raises(BackendError):
            tapp.build_backend(ExporterConfig(backend="nvml"))

    def test_auto_with_card_nodes_degrades_to_zero_chips(self, monkeypatch, caplog):
        from tpu_pod_exporter_torch.backend import discovery

        monkeypatch.setattr(discovery, "local_chip_count", lambda root="/": 1)
        backend = tapp.build_backend(ExporterConfig(backend="auto"))
        assert isinstance(backend, FakeBackend)
        assert backend.sample().chips == ()
        assert "auto-selected nvml backend unavailable" in caplog.text


def test_hwcheck_nvml_closed_loop_with_kubelet_join(tmp_path, monkeypatch):
    """run_check(backend="nvml") with the exporter flags the card's check
    uses: the load shows in the card's memory and utilization, the process
    table, the procfs holder, the pod rollup and the reference's series."""
    from test_torch_procscan import NVIDIA_LINKS, add_proc
    from tpu_pod_exporter_torch.hwcheck import run_check

    uuid = "GPU-bae8c9e4-2b9c-6a92-b426-c2e367abb292"
    load = {"on": False}
    script = torch_nvml.GpuScript(
        mem_used_bytes=lambda step: (18 if load["on"] else 1) * GIB,
        utilization_percent=lambda step: 97.0 if load["on"] else 0.0,
        processes=lambda step: [(1, 17 * GIB, "")] if load["on"] else [],
        uuid=uuid)
    driver = torch_nvml.SimulatedNvmlDriver([script])
    monkeypatch.setattr(torch_nvml, "SimulatedNvmlDriver", lambda gpus: driver)

    class Stimulus:
        def start(self):
            load["on"] = True

        def stop(self):
            load["on"] = False

    add_proc(tmp_path, 118, NVIDIA_LINKS)
    ckpt = tmp_path / "checkpoint"
    ckpt.write_text(json.dumps({"Data": {"PodDeviceEntries": [
        {"PodUID": "uid-1", "ContainerName": "main", "ResourceName": "nvidia.com/gpu",
         "DeviceIDs": {"-1": [uuid]}}]}}))
    uids = tmp_path / "uids.json"
    uids.write_text(json.dumps({"uid-1": ["burn-0", "smoke"]}))
    report = run_check(backend="nvml", idle_s=0.4, load_s=0.6, stimulus=Stimulus(),
                       exporter_args=dict(
                           nvml_sim_gpus=1, process_metrics=True, legacy_metrics=True,
                           proc_root=str(tmp_path), attribution="checkpoint",
                           checkpoint_path=str(ckpt), uid_map_file=str(uids)))
    assert report["ok"] is True and report["family"] == "gpu"
    assert report["checks"] == {"hbm_rises_under_load": True,
                                "hbm_falls_after_release": True,
                                "duty_cycle_responds": True}
    idle, loaded = report["phases"]["idle"], report["phases"]["load"]
    assert loaded["process_memory_bytes"] == {"1": 17 * GIB}
    assert idle["process_memory_bytes"] == {}
    assert loaded["holder_pids"] == ["118"]
    assert loaded["pod_memory_bytes"] == {"burn-0": 18 * GIB}
    assert loaded["legacy_pod_memory_bytes"] == {"118/burn-0": 18 * GIB}
    for timings in (loaded["poll_phase_mean_ms"], loaded["poll_phase_last_ms"]):
        assert {"device_read", "attribution", "process_scan", "total"} <= set(timings)
