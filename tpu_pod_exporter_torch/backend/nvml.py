"""NVML-shaped GPU device backend — the second real device family.

The reference binds NVML straight into ``main()`` via cgo (``nvml.Init`` /
``DeviceGetCount`` / ``DeviceGetHandleByIndex`` / ``GetMemoryInfo`` /
``GetComputeRunningProcesses`` / ``Shutdown``, ``main.go:44-54,116-138``),
which is exactly the seam this repo abstracted into
:class:`~tpu_pod_exporter_torch.backend.DeviceBackend`. This module closes the
loop: the same call surface, behind a swappable **driver binding**, proving
the backend seam with a second device family (ROADMAP "Prove the backend
seam").

Three bindings:

- :class:`~tpu_pod_exporter_torch.backend.nvml_ctypes.CtypesNvmlDriver` —
  the default: ``ctypes`` over the driver's own ``libnvidia-ml.so.1``.
- :class:`PynvmlDriver` — thin adapter over the real ``pynvml`` wheel when
  it is installed (it is NOT in the CI image; construction degrades with a
  :class:`BackendError` naming the fix, never an ImportError at import
  time).
- :class:`SimulatedNvmlDriver` — the CI-testable driver, the way
  ``fake.py``/``recorded.py`` set the pattern: scripted per-GPU memory /
  utilization / process tables (scalars or callables of the poll step) and
  injectable NVML error codes, so every failure shape the reference dies on
  (``main.go:119-137``) is exercisable without an NVIDIA driver.

Mapping to :class:`~tpu_pod_exporter_torch.backend.ChipSample`: device memory
rides ``hbm_used/total_bytes`` (the collector publishes it under the
``gpu_*`` twins keyed by ``ChipInfo.family == "gpu"``), the NVML
utilization rate rides ``tensorcore_duty_cycle_percent`` (published as
``gpu_utilization_percent``), and the per-process table —
the reference's headline dimension (``main.go:134-155``) — rides
``ChipSample.processes``, feeding the same podresources join the TPU path
uses for per-pod memory.

NVML error codes map to :class:`NvmlError` (a ``BackendError``): a failed
``Init``/``DeviceGetCount`` fails the whole sample (the collector degrades
the poll, inverting the reference's ``log.Fatalf``); a failed per-device
query degrades that chip only (absent fields + a ``partial_errors`` entry).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Sequence

from tpu_pod_exporter_torch.backend import (
    BackendError,
    ChipInfo,
    ChipSample,
    DeviceBackend,
    DeviceProcessSample,
    HostSample,
)

# The NVML return codes the simulated driver can speak and the backend maps
# (numeric values per nvml.h; names accepted with or without the prefix).
NVML_ERROR_CODES: dict[str, int] = {
    "NVML_ERROR_UNINITIALIZED": 1,
    "NVML_ERROR_INVALID_ARGUMENT": 2,
    "NVML_ERROR_NOT_SUPPORTED": 3,
    "NVML_ERROR_NO_PERMISSION": 4,
    "NVML_ERROR_NOT_FOUND": 6,
    "NVML_ERROR_INSUFFICIENT_SIZE": 7,
    "NVML_ERROR_DRIVER_NOT_LOADED": 9,
    "NVML_ERROR_TIMEOUT": 10,
    "NVML_ERROR_IRQ_ISSUE": 11,
    "NVML_ERROR_LIBRARY_NOT_FOUND": 12,
    "NVML_ERROR_FUNCTION_NOT_FOUND": 13,
    "NVML_ERROR_GPU_IS_LOST": 15,
    "NVML_ERROR_RESET_REQUIRED": 16,
    "NVML_ERROR_MEMORY": 20,
    "NVML_ERROR_UNKNOWN": 999,
}

_CODE_NAMES = {v: k for k, v in NVML_ERROR_CODES.items()}

DEFAULT_GPU_MEM_TOTAL = 80 * 1024**3  # A100/H100-class: 80 GiB  [design]


def normalize_nvml_code(code: str | int) -> tuple[str, int]:
    """``"gpu_is_lost"`` / ``"NVML_ERROR_GPU_IS_LOST"`` / ``15`` →
    ``("NVML_ERROR_GPU_IS_LOST", 15)``. Raises ValueError on an unknown
    code — a typo'd chaos/sim spec must fail loudly at parse time."""
    if isinstance(code, int):
        name = _CODE_NAMES.get(code)
        if name is None:
            raise ValueError(f"unknown NVML error code {code}")
        return name, code
    name = code.strip().upper()
    if not name.startswith("NVML_ERROR_"):
        name = "NVML_ERROR_" + name
    value = NVML_ERROR_CODES.get(name)
    if value is None:
        raise ValueError(
            f"unknown NVML error code {code!r} "
            f"(want one of {', '.join(sorted(NVML_ERROR_CODES))})"
        )
    return name, value


class NvmlError(BackendError):
    """An NVML call failed; carries the NVML return code so tests and the
    chaos layer can speak exact error shapes (``main.go:119-137`` dies on
    any of these — here they degrade)."""

    def __init__(self, call: str, code: str | int) -> None:
        self.call = call
        self.code_name, self.code = normalize_nvml_code(code)
        super().__init__(f"{call}: {self.code_name} ({self.code})")


class NvmlDriverError(RuntimeError):
    """Raised by a driver binding; the backend wraps it into NvmlError.
    Mirrors pynvml.NVMLError's ``.value`` attribute."""

    def __init__(self, code: str | int) -> None:
        name, value = normalize_nvml_code(code)
        self.value = value
        super().__init__(name)


@dataclass
class GpuScript:
    """Scripted telemetry for one simulated GPU. Values may be scalars
    (constant) or callables of the driver step — same convention as
    :class:`~tpu_pod_exporter_torch.backend.fake.FakeChipScript`."""

    mem_total_bytes: float = DEFAULT_GPU_MEM_TOTAL
    mem_used_bytes: float | Callable[[int], float] = 0.0
    utilization_percent: float | Callable[[int], float] | None = 0.0
    # [(pid, used_bytes, comm)] or a callable of the step returning that —
    # the GetComputeRunningProcesses table (main.go:134-138).
    processes: (
        Sequence[tuple[int, float, str]]
        | Callable[[int], Sequence[tuple[int, float, str]]]
    ) = ()
    name: str = "Simulated-GPU"
    uuid: str = ""  # defaults to GPU-sim-<index> at construction

    def _resolve(self, v, step: int) -> float:
        return float(v(step)) if callable(v) else float(v)


class SimulatedNvmlDriver:
    """NVML-shaped in-process driver: the exact call surface the reference
    uses (``main.go:44-54,116-138``) plus ``GetUtilizationRates``, over
    scripted tables, with injectable per-call NVML error codes.

    The step counter advances on each ``nvmlDeviceGetCount()`` — the first
    call of every backend sample pass, matching the reference's
    re-enumeration each loop iteration (``main.go:117``)."""

    def __init__(self, gpus: int | Sequence[GpuScript] = 1) -> None:
        if isinstance(gpus, int):
            scripts = [GpuScript() for _ in range(gpus)]
        else:
            scripts = list(gpus)
        for i, s in enumerate(scripts):
            if not s.uuid:
                s.uuid = f"GPU-sim-{i}"
        self.scripts = scripts
        self.step = -1  # first DeviceGetCount() makes it 0
        self.initialized = False
        self.init_calls = 0
        self.shutdown_calls = 0
        self._lock = threading.Lock()
        # call name -> [(code, remaining)] injection queue, FIFO.
        self._faults: dict[str, list[list]] = {}

    # -- fault injection ----------------------------------------------------

    def inject(self, call: str, code: str | int, times: int = 1) -> None:
        """Make the next ``times`` invocations of ``call`` (e.g.
        ``"DeviceGetMemoryInfo"``) raise the given NVML code."""
        name, _v = normalize_nvml_code(code)
        with self._lock:
            self._faults.setdefault(call, []).append([name, times])

    def _maybe_fault(self, call: str) -> None:
        with self._lock:
            q = self._faults.get(call)
            if not q:
                return
            name, remaining = q[0]
            if remaining <= 1:
                q.pop(0)
            else:
                q[0][1] = remaining - 1
        raise NvmlDriverError(name)

    def _handle(self, handle: int) -> GpuScript:
        if not self.initialized:
            raise NvmlDriverError("NVML_ERROR_UNINITIALIZED")
        if not 0 <= handle < len(self.scripts):
            raise NvmlDriverError("NVML_ERROR_INVALID_ARGUMENT")
        return self.scripts[handle]

    # -- the NVML call surface (main.go:44-54,116-138) ----------------------

    def nvmlInit(self) -> None:  # noqa: N802 — NVML API casing
        self._maybe_fault("Init")
        self.init_calls += 1
        self.initialized = True

    def nvmlShutdown(self) -> None:  # noqa: N802
        self._maybe_fault("Shutdown")
        self.shutdown_calls += 1
        self.initialized = False

    def nvmlDeviceGetCount(self) -> int:  # noqa: N802
        if not self.initialized:
            raise NvmlDriverError("NVML_ERROR_UNINITIALIZED")
        self._maybe_fault("DeviceGetCount")
        self.step += 1
        return len(self.scripts)

    def nvmlDeviceGetHandleByIndex(self, index: int) -> int:  # noqa: N802
        self._handle(index)
        self._maybe_fault("DeviceGetHandleByIndex")
        return index

    def nvmlDeviceGetName(self, handle: int) -> str:  # noqa: N802
        return self._handle(handle).name

    def nvmlDeviceGetUUID(self, handle: int) -> str:  # noqa: N802
        return self._handle(handle).uuid

    def nvmlDeviceGetMemoryInfo(self, handle: int):  # noqa: N802
        script = self._handle(handle)
        self._maybe_fault("DeviceGetMemoryInfo")
        step = max(self.step, 0)
        used = script._resolve(script.mem_used_bytes, step)
        total = script.mem_total_bytes
        return {"used": used, "total": total, "free": max(total - used, 0.0)}

    def nvmlDeviceGetUtilizationRates(self, handle: int):  # noqa: N802
        script = self._handle(handle)
        self._maybe_fault("DeviceGetUtilizationRates")
        if script.utilization_percent is None:
            raise NvmlDriverError("NVML_ERROR_NOT_SUPPORTED")
        step = max(self.step, 0)
        return {"gpu": script._resolve(script.utilization_percent, step)}

    def nvmlDeviceGetComputeRunningProcesses(self, handle: int):  # noqa: N802
        script = self._handle(handle)
        self._maybe_fault("DeviceGetComputeRunningProcesses")
        step = max(self.step, 0)
        procs = script.processes
        if callable(procs):
            procs = procs(step)
        return [
            {"pid": int(p[0]), "usedGpuMemory": float(p[1]),
             "comm": str(p[2]) if len(p) > 2 else ""}
            for p in procs
        ]


def sim_driver_from_spec(doc: dict) -> SimulatedNvmlDriver:
    """Build a simulated driver from a JSON spec (``--nvml-sim-spec``)::

        {"gpus": [{"mem_total": N, "mem_used": N, "utilization": N,
                   "name": "...", "uuid": "...",
                   "processes": [[pid, used_bytes, "comm"], ...]}, ...],
         "faults": [{"call": "DeviceGetMemoryInfo",
                     "code": "gpu_is_lost", "times": 2}, ...]}

    Scalars only (callables are for in-process tests); malformed specs
    raise ValueError at startup, same discipline as every other flag."""
    gpus = doc.get("gpus")
    if not isinstance(gpus, list) or not gpus:
        raise ValueError("nvml sim spec: want a non-empty 'gpus' list")
    scripts = []
    for i, g in enumerate(gpus):
        if not isinstance(g, dict):
            raise ValueError(f"nvml sim spec: gpus[{i}] must be an object")
        scripts.append(GpuScript(
            mem_total_bytes=float(g.get("mem_total", DEFAULT_GPU_MEM_TOTAL)),
            mem_used_bytes=float(g.get("mem_used", 0.0)),
            utilization_percent=(
                None if g.get("utilization") is None
                else float(g["utilization"])
            ),
            processes=tuple(
                (int(p[0]), float(p[1]), str(p[2]) if len(p) > 2 else "")
                for p in g.get("processes", ())
            ),
            name=str(g.get("name", "Simulated-GPU")),
            uuid=str(g.get("uuid", "")),
        ))
    driver = SimulatedNvmlDriver(scripts)
    for j, f in enumerate(doc.get("faults", ())):
        if not isinstance(f, dict) or "call" not in f or "code" not in f:
            raise ValueError(
                f"nvml sim spec: faults[{j}] wants {{call, code[, times]}}"
            )
        driver.inject(str(f["call"]), f["code"], int(f.get("times", 1)))
    return driver


class PynvmlDriver:
    """Adapter over the real ``pynvml`` wheel (same call names, NVML
    struct returns normalized to the dict shapes the simulated driver
    serves). Not importable in the CI image — construction raises
    BackendError, never ImportError."""

    def __init__(self) -> None:
        try:
            import pynvml  # noqa: PLC0415 — optional, driver-gated
        except ImportError as e:
            raise BackendError(
                "pynvml is not installed; --backend nvml needs either the "
                "NVIDIA driver + pynvml or --nvml-sim-gpus/--nvml-sim-spec "
                "for the simulated driver"
            ) from e
        self._nvml = pynvml

    def __getattr__(self, item: str):
        return getattr(self._nvml, item)


@dataclass
class _InitState:
    initialized: bool = False
    lock: threading.Lock = field(default_factory=threading.Lock)


def _nvml_str(v) -> str:
    """Real NVML bindings return ``bytes`` for name/UUID on widely-deployed
    nvidia-ml-py versions; ``str(b'GPU-…')`` would mangle the UUID and
    silently break the podresources attribution join."""
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="replace")
    return str(v)


class NvmlBackend(DeviceBackend):
    """The GPU device family behind the same seam: one ``HostSample`` per
    call, every local GPU's memory/utilization/process table, errors as
    :class:`NvmlError` instead of the reference's in-loop ``log.Fatalf``."""

    name = "nvml"
    family = "gpu"

    def __init__(self, driver=None,
                 device_path_fmt: str = "/dev/nvidia{index}") -> None:
        if driver is None:
            from tpu_pod_exporter_torch.backend.nvml_ctypes import CtypesNvmlDriver

            driver = CtypesNvmlDriver()
        self._driver = driver
        self._device_path_fmt = device_path_fmt
        self._init = _InitState()

    def _wrap(self, call: str, e: Exception) -> NvmlError:
        code = getattr(e, "value", None)
        if code is None or code not in _CODE_NAMES:
            code = "NVML_ERROR_UNKNOWN"
        return NvmlError(call, code)

    def _ensure_init(self) -> None:
        # Init-once, re-init after close(): the supervisor's breaker-gated
        # reconnect path is close()+re-call, and for NVML that is
        # Shutdown()+Init() — a lost GPU often needs exactly that.
        with self._init.lock:
            if self._init.initialized:
                return
            try:
                self._driver.nvmlInit()
            except NvmlDriverError as e:
                raise self._wrap("Init", e) from e
            except BackendError:
                raise
            except Exception as e:  # noqa: BLE001 — binding-level failure
                raise self._wrap("Init", e) from e
            self._init.initialized = True

    def sample(self) -> HostSample:
        self._ensure_init()
        d = self._driver
        try:
            count = d.nvmlDeviceGetCount()
        except Exception as e:  # noqa: BLE001 — total failure fails the poll
            raise self._wrap("DeviceGetCount", e) from e
        chips: list[ChipSample] = []
        partial: list[str] = []
        for i in range(int(count)):
            try:
                handle = d.nvmlDeviceGetHandleByIndex(i)
            except Exception as e:  # noqa: BLE001 — this device only
                partial.append(str(self._wrap(f"DeviceGetHandleByIndex({i})", e)))
                continue
            kind = ""
            uuid = ""
            try:
                kind = _nvml_str(d.nvmlDeviceGetName(handle))
                uuid = _nvml_str(d.nvmlDeviceGetUUID(handle))
            except Exception:  # noqa: BLE001 — identity is optional
                pass
            # The device node is /dev/nvidia<minor>, which is the index only
            # on a host that shows every card; a driver without the call
            # (the simulated one) names it by index.
            minor = i
            get_minor = getattr(d, "nvmlDeviceGetMinorNumber", None)
            if get_minor is not None:
                try:
                    minor = int(get_minor(handle))
                except Exception as e:  # noqa: BLE001 — the index stands in
                    partial.append(str(self._wrap(f"DeviceGetMinorNumber({i})", e)))
            info = ChipInfo(
                chip_id=i,
                device_path=self._device_path_fmt.format(index=minor),
                # The kubelet device plugin advertises nvidia.com/gpu
                # devices by GPU UUID — that is the attribution join key;
                # the bare index rides along for fakes/tests.
                device_ids=(uuid, str(i)) if uuid else (str(i),),
                device_kind=kind,
                family="gpu",
            )
            used = total = None
            try:
                mem = d.nvmlDeviceGetMemoryInfo(handle)
                used = float(mem["used"] if isinstance(mem, dict)
                             else mem.used)
                total = float(mem["total"] if isinstance(mem, dict)
                              else mem.total)
            except Exception as e:  # noqa: BLE001 — absent beats fake-zero
                partial.append(str(self._wrap(f"DeviceGetMemoryInfo({i})", e)))
            util = None
            try:
                rates = d.nvmlDeviceGetUtilizationRates(handle)
                util = float(rates["gpu"] if isinstance(rates, dict)
                             else rates.gpu)
            except Exception as e:  # noqa: BLE001
                code = getattr(e, "value", None)
                # NOT_SUPPORTED is a capability, not a fault: some boards
                # simply serve no utilization — absent series, no error.
                if code != NVML_ERROR_CODES["NVML_ERROR_NOT_SUPPORTED"]:
                    partial.append(
                        str(self._wrap(f"DeviceGetUtilizationRates({i})", e))
                    )
            procs: tuple[DeviceProcessSample, ...] = ()
            try:
                rows = d.nvmlDeviceGetComputeRunningProcesses(handle)
                proc_list = []
                for r in rows:
                    mem = (r["usedGpuMemory"] if isinstance(r, dict)
                           else r.usedGpuMemory)
                    if mem is None:
                        # NVML_VALUE_NOT_AVAILABLE (MIG, insufficient
                        # permissions): skip the N/A row, keep the rest of
                        # the table — absent beats fake-zero, and one
                        # unreadable row must not drop every process.
                        continue
                    proc_list.append(DeviceProcessSample(
                        pid=int(r["pid"] if isinstance(r, dict) else r.pid),
                        used_bytes=float(mem),
                        comm=str(r.get("comm", "")) if isinstance(r, dict)
                        else "",
                    ))
                procs = tuple(proc_list)
            except Exception as e:  # noqa: BLE001
                partial.append(str(self._wrap(
                    f"DeviceGetComputeRunningProcesses({i})", e)))
            chips.append(ChipSample(
                info=info,
                hbm_used_bytes=used,
                hbm_total_bytes=total,
                tensorcore_duty_cycle_percent=util,
                processes=procs,
            ))
        return HostSample(chips=tuple(chips), partial_errors=tuple(partial))

    def close(self) -> None:  # the analog of nvml.Shutdown (main.go:49-54)
        with self._init.lock:
            if not self._init.initialized:
                return
            self._init.initialized = False
            try:
                self._driver.nvmlShutdown()
            except Exception:  # noqa: BLE001 — closing a lost GPU still closes
                pass


def run_gpu_demo(recording: str, verbose: bool = True) -> int:
    """``make gpu-demo``: replay a recorded GPU trace through the REAL
    collector (no driver, no cluster) and assert the whole GPU node
    surface comes out — per-chip memory/utilization, the per-process
    table, per-pod memory via the podresources join, gpu_backend_up, and
    an injected per-device NVML fault degrading one chip only."""
    from tpu_pod_exporter_torch.attribution import DeviceAllocation
    from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
    from tpu_pod_exporter_torch.backend.recorded import RecordedBackend
    from tpu_pod_exporter_torch.collector import Collector
    from tpu_pod_exporter_torch.metrics import SnapshotStore
    from tpu_pod_exporter_torch.metrics.parse import parse_families

    backend = RecordedBackend(recording, loop=False)
    first = backend.sample()  # peek the chip set for the allocation join
    device_ids = [
        did for c in first.chips for did in c.info.device_ids
    ]
    backend = RecordedBackend(recording, loop=False)  # replay from poll 0
    attribution = FakeAttribution(allocations=[
        DeviceAllocation(pod="gpu-demo-pod", namespace="demo",
                         container="main", device_ids=tuple(device_ids)),
    ])
    store = SnapshotStore()
    collector = Collector(backend, attribution, store)
    partials = 0
    for _ in range(len(backend)):
        stats = collector.poll_once()
        partials += sum(1 for e in stats.errors if e == "device_partial")
    collector.close()
    text = store.current().encode().decode()
    fams = parse_families(text)
    problems: list[str] = []
    for name in ("gpu_chip_info", "gpu_hbm_used_bytes",
                 "gpu_hbm_total_bytes", "gpu_utilization_percent",
                 "gpu_process_memory_used_bytes", "gpu_pod_chip_count",
                 "gpu_pod_memory_used_bytes"):
        if not fams.get(name):
            problems.append(f"{name} absent from the replayed exposition")
    up = [s.value for s in fams.get("gpu_backend_up", ())]
    if up != [1.0]:
        problems.append(f"gpu_backend_up {up}, want [1.0]")
    pod_mem = [
        s for s in fams.get("gpu_pod_memory_used_bytes", ())
        if s.labels.get("pod") == "gpu-demo-pod"
    ]
    if not pod_mem:
        problems.append("per-pod GPU memory did not join to gpu-demo-pod")
    chip_mem = sum(s.value for s in fams.get("gpu_hbm_used_bytes", ()))
    if pod_mem and abs(pod_mem[0].value - chip_mem) > 1e-6:
        problems.append(
            f"pod memory {pod_mem[0].value} != summed chip memory "
            f"{chip_mem} (join drift)")
    if partials < 1:
        problems.append(
            "no device_partial observed — the recorded NVML fault did "
            "not replay")
    if verbose:
        chips = len(fams.get("gpu_chip_info", ()))
        procs = len(fams.get("gpu_process_memory_used_bytes", ()))
        print(f"gpu-demo: replayed {len(backend)} polls: {chips} GPUs, "
              f"{procs} process series, pod memory "
              f"{pod_mem[0].value / 2**30:.1f} GiB, "
              f"{partials} partial-fault poll(s)"
              if not problems else
              f"gpu-demo FAILED: {problems}")
    return 1 if problems else 0


def _main(argv: "list[str] | None" = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="tpu-pod-exporter-nvml",
        description="NVML-shaped GPU backend demo (make gpu-demo).",
    )
    p.add_argument("--demo", action="store_true", required=True)
    p.add_argument("--recording",
                   default="tests/fixtures/gpu-recorded.jsonl")
    ns = p.parse_args(argv)
    return run_gpu_demo(ns.recording)


if __name__ == "__main__":
    raise SystemExit(_main())
