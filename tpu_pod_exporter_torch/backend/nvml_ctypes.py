"""NVML over ``ctypes``: the port's binding to the NVIDIA driver.

The JAX package binds NVML through the ``pynvml`` wheel
(``tpu_pod_exporter/backend/nvml.py:PynvmlDriver``). This binding needs no
wheel: it loads the driver's own ``libnvidia-ml.so.1``, which every machine
with an NVIDIA driver has, and serves the call names and dict shapes of
:class:`~tpu_pod_exporter_torch.backend.nvml.SimulatedNvmlDriver`, so
:class:`~tpu_pod_exporter_torch.backend.nvml.NvmlBackend` reads a real card
and a simulated one through the same code. It also serves
``nvmlDeviceGetMinorNumber``, which names the card's ``/dev/nvidia<minor>``
node: inside a container given one card of a larger host, NVML calls that
card index 0 while its node keeps the host's minor.

Struct layouts and symbol versions follow ``nvml.h`` of CUDA 12:

- ``nvmlMemory_t`` (v1): ``total``, ``free``, ``used``, unsigned 64-bit;
- ``nvmlUtilization_t``: ``gpu``, ``memory``, unsigned 32-bit;
- ``nvmlProcessInfo_t``, the row of ``nvmlDeviceGetComputeRunningProcesses_v3``
  and ``_v2``: ``pid`` (32-bit), ``usedGpuMemory`` (64-bit, all ones when
  NVML cannot read it), ``gpuInstanceId``, ``computeInstanceId`` (32-bit);
- name and UUID buffers of 96 bytes (``NVML_DEVICE_NAME_V2_BUFFER_SIZE``,
  ``NVML_DEVICE_UUID_V2_BUFFER_SIZE``).

Every non-zero return raises :class:`NvmlDriverError` carrying the code as
``.value``; the backend maps it to :class:`NvmlError`. A library that does
not load, or lacks a symbol, raises :class:`BackendError` at construction.
Nothing is loaded when this module is imported.
"""

from __future__ import annotations

import ctypes

from tpu_pod_exporter_torch.backend import BackendError
from tpu_pod_exporter_torch.backend.nvml import (
    NVML_ERROR_CODES,
    NvmlDriverError,
)

LIBRARY = "libnvidia-ml.so.1"

NVML_SUCCESS = 0
NVML_ERROR_INSUFFICIENT_SIZE = NVML_ERROR_CODES["NVML_ERROR_INSUFFICIENT_SIZE"]
# usedGpuMemory when NVML cannot read it (MIG, no permission): all ones.
NVML_VALUE_NOT_AVAILABLE = (1 << 64) - 1
NVML_DEVICE_BUFFER_SIZE = 96
# Rows added to the process table's reported size, for processes that start
# between the sizing call and the fill; and how often a grown table is
# asked for again before the call gives up.
PROCESS_TABLE_SLACK = 8
PROCESS_TABLE_TRIES = 4


class NvmlMemory(ctypes.Structure):
    """``nvmlMemory_t`` (v1)."""

    _fields_ = [
        ("total", ctypes.c_ulonglong),
        ("free", ctypes.c_ulonglong),
        ("used", ctypes.c_ulonglong),
    ]


class NvmlUtilization(ctypes.Structure):
    """``nvmlUtilization_t``."""

    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class NvmlProcessInfo(ctypes.Structure):
    """``nvmlProcessInfo_t``, the row of the ``_v2``/``_v3`` process calls."""

    _fields_ = [
        ("pid", ctypes.c_uint),
        ("usedGpuMemory", ctypes.c_ulonglong),
        ("gpuInstanceId", ctypes.c_uint),
        ("computeInstanceId", ctypes.c_uint),
    ]


_UINT_P = ctypes.POINTER(ctypes.c_uint)
# symbol -> argtypes; every function returns nvmlReturn_t (an int).
_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlShutdown": [],
    "nvmlDeviceGetCount_v2": [_UINT_P],
    "nvmlDeviceGetHandleByIndex_v2": [ctypes.c_uint,
                                      ctypes.POINTER(ctypes.c_void_p)],
    "nvmlDeviceGetName": [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetUUID": [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetMinorNumber": [ctypes.c_void_p, _UINT_P],
    "nvmlDeviceGetMemoryInfo": [ctypes.c_void_p, ctypes.POINTER(NvmlMemory)],
    "nvmlDeviceGetUtilizationRates": [ctypes.c_void_p,
                                      ctypes.POINTER(NvmlUtilization)],
}
# The process table: the newest version the library exports.
_PROCESS_SYMBOLS = ("nvmlDeviceGetComputeRunningProcesses_v3",
                    "nvmlDeviceGetComputeRunningProcesses_v2")
_PROCESS_ARGTYPES = [ctypes.c_void_p, _UINT_P, ctypes.POINTER(NvmlProcessInfo)]


def _check(ret: int) -> None:
    if ret == NVML_SUCCESS:
        return
    if ret in NVML_ERROR_CODES.values():
        raise NvmlDriverError(ret)
    err = NvmlDriverError("NVML_ERROR_UNKNOWN")
    err.args = (f"NVML_ERROR_UNKNOWN (NVML returned {ret})",)
    raise err


class CtypesNvmlDriver:
    """The NVML calls :class:`NvmlBackend` makes, over ``libnvidia-ml.so.1``.

    ``lib`` replaces the loaded library (any object with the NVML symbols
    as attributes), so the struct handling is testable without a driver.
    """

    def __init__(self, lib=None) -> None:
        if lib is None:
            try:
                lib = ctypes.CDLL(LIBRARY)
            except OSError as e:
                raise BackendError(
                    f"{LIBRARY} could not be loaded ({e}); --backend nvml "
                    "needs the NVIDIA driver's NVML library, or "
                    "--nvml-sim-gpus/--nvml-sim-spec for the simulated driver"
                ) from e
        self._fns = {}
        for name, argtypes in _SIGNATURES.items():
            self._fns[name] = self._bind(lib, name, argtypes)
        for name in _PROCESS_SYMBOLS:
            if getattr(lib, name, None) is not None:
                self._procs = self._bind(lib, name, _PROCESS_ARGTYPES)
                self.process_symbol = name
                break
        else:
            raise BackendError(
                f"{LIBRARY} exports none of {', '.join(_PROCESS_SYMBOLS)}")

    @staticmethod
    def _bind(lib, name: str, argtypes: list):
        fn = getattr(lib, name, None)
        if fn is None:
            raise BackendError(f"{LIBRARY} does not export {name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def _call(self, name: str, *args) -> None:
        _check(self._fns[name](*args))

    def nvmlInit(self) -> None:  # noqa: N802 — NVML API casing
        self._call("nvmlInit_v2")

    def nvmlShutdown(self) -> None:  # noqa: N802
        self._call("nvmlShutdown")

    def nvmlDeviceGetCount(self) -> int:  # noqa: N802
        count = ctypes.c_uint(0)
        self._call("nvmlDeviceGetCount_v2", count)
        return count.value

    def nvmlDeviceGetHandleByIndex(self, index: int):  # noqa: N802
        handle = ctypes.c_void_p()
        self._call("nvmlDeviceGetHandleByIndex_v2", index, handle)
        return handle.value

    def _text(self, name: str, handle) -> str:
        buf = ctypes.create_string_buffer(NVML_DEVICE_BUFFER_SIZE)
        self._call(name, handle, buf, NVML_DEVICE_BUFFER_SIZE)
        return buf.value.decode("utf-8", errors="replace")

    def nvmlDeviceGetName(self, handle) -> str:  # noqa: N802
        return self._text("nvmlDeviceGetName", handle)

    def nvmlDeviceGetUUID(self, handle) -> str:  # noqa: N802
        return self._text("nvmlDeviceGetUUID", handle)

    def nvmlDeviceGetMinorNumber(self, handle) -> int:  # noqa: N802
        minor = ctypes.c_uint(0)
        self._call("nvmlDeviceGetMinorNumber", handle, minor)
        return minor.value

    def nvmlDeviceGetMemoryInfo(self, handle) -> dict:  # noqa: N802
        mem = NvmlMemory()
        self._call("nvmlDeviceGetMemoryInfo", handle, mem)
        return {"total": mem.total, "free": mem.free, "used": mem.used}

    def nvmlDeviceGetUtilizationRates(self, handle) -> dict:  # noqa: N802
        rates = NvmlUtilization()
        self._call("nvmlDeviceGetUtilizationRates", handle, rates)
        return {"gpu": rates.gpu, "memory": rates.memory}

    def nvmlDeviceGetComputeRunningProcesses(self, handle) -> list:  # noqa: N802
        """The compute process table: a sizing call with no room, then a
        call with the reported size plus slack, again while the table keeps
        growing in between."""
        count = ctypes.c_uint(0)
        table = None
        ret = self._procs(handle, count, None)
        for _ in range(PROCESS_TABLE_TRIES):
            if ret != NVML_ERROR_INSUFFICIENT_SIZE:
                break
            size = count.value + PROCESS_TABLE_SLACK
            table = (NvmlProcessInfo * size)()
            count = ctypes.c_uint(size)
            ret = self._procs(handle, count, table)
        _check(ret)
        if table is None:
            return []
        return [
            {"pid": row.pid,
             "usedGpuMemory": (None if row.usedGpuMemory == NVML_VALUE_NOT_AVAILABLE
                               else row.usedGpuMemory),
             "comm": ""}
            for row in table[:count.value]
        ]
