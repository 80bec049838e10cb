"""The reference's own read of the card through NVML, with ``ctypes``.

Written from ``nvml.h`` (CUDA 12) for the benchmark; it imports nothing of
the program. It reads what the exporter promises to publish: each card's
UUID, minor number, ``nvmlMemory_t`` (v1) used and total bytes, and the
compute process table (``nvmlDeviceGetComputeRunningProcesses_v3``).
Run as a module it is the sampler: a process of its own that keeps
reading the card while the program runs. ``card_from_spec`` reads the
same answers from a simulated driver's JSON spec, for rehearsals on a
machine without a card.
"""

from __future__ import annotations

import ctypes
import json
import select
import sys
import time
from dataclasses import dataclass, field

from portbench import moves

LIBRARY = "libnvidia-ml.so.1"
NOT_AVAILABLE = (1 << 64) - 1
INSUFFICIENT_SIZE = 7


@dataclass
class Gpu:
    index: int
    uuid: str
    minor: int
    name: str
    used: int
    total: int
    # (pid, used bytes), rows NVML cannot size left out
    processes: list[tuple[int, int]] = field(default_factory=list)


class _Memory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class _Process(ctypes.Structure):
    _fields_ = [("pid", ctypes.c_uint), ("usedGpuMemory", ctypes.c_ulonglong),
                ("gpuInstanceId", ctypes.c_uint), ("computeInstanceId", ctypes.c_uint)]


class NvmlError(RuntimeError):
    pass


def _check(rc: int, call: str) -> None:
    if rc != 0:
        raise NvmlError(f"{call} returned NVML code {rc}")


class Card:
    """An open NVML session on every card: the static identity once, then
    the memory and the process table at each read (``watch``)."""

    def __init__(self, library: str = LIBRARY) -> None:
        lib = self.lib = ctypes.CDLL(library)
        for fn in ("nvmlInit_v2", "nvmlShutdown", "nvmlDeviceGetCount_v2",
                   "nvmlDeviceGetHandleByIndex_v2", "nvmlDeviceGetUUID",
                   "nvmlDeviceGetName", "nvmlDeviceGetMinorNumber",
                   "nvmlDeviceGetMemoryInfo", "nvmlDeviceGetComputeRunningProcesses_v3"):
            getattr(lib, fn).restype = ctypes.c_int
        lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [ctypes.c_uint,
                                                      ctypes.POINTER(ctypes.c_void_p)]
        for fn in ("nvmlDeviceGetUUID", "nvmlDeviceGetName"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint]
        lib.nvmlDeviceGetMinorNumber.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]
        lib.nvmlDeviceGetMemoryInfo.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Memory)]
        lib.nvmlDeviceGetComputeRunningProcesses_v3.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(_Process)]
        _check(lib.nvmlInit_v2(), "nvmlInit_v2")
        count = ctypes.c_uint()
        _check(lib.nvmlDeviceGetCount_v2(ctypes.byref(count)), "nvmlDeviceGetCount_v2")
        self.cards = []
        for i in range(count.value):
            h = ctypes.c_void_p()
            _check(lib.nvmlDeviceGetHandleByIndex_v2(i, ctypes.byref(h)), "GetHandleByIndex")
            uuid, name = ctypes.create_string_buffer(96), ctypes.create_string_buffer(96)
            _check(lib.nvmlDeviceGetUUID(h, uuid, 96), "GetUUID")
            _check(lib.nvmlDeviceGetName(h, name, 96), "GetName")
            minor = ctypes.c_uint()
            _check(lib.nvmlDeviceGetMinorNumber(h, ctypes.byref(minor)), "GetMinorNumber")
            self.cards.append((h, uuid.value.decode(), int(minor.value), name.value.decode()))

    def memory(self) -> list[tuple[int, int]]:
        """Each card's used and total bytes."""
        out = []
        for h, _uuid, _minor, _name in self.cards:
            mem = _Memory()
            _check(self.lib.nvmlDeviceGetMemoryInfo(h, ctypes.byref(mem)), "GetMemoryInfo")
            out.append((int(mem.used), int(mem.total)))
        return out

    def processes(self) -> list[list[tuple[int, int]]]:
        """Each card's compute processes as ``(pid, used bytes)``, the rows
        NVML cannot size left out."""
        out = []
        for h, _uuid, _minor, _name in self.cards:
            size = 64
            while True:
                n = ctypes.c_uint(size)
                rows = (_Process * size)()
                rc = self.lib.nvmlDeviceGetComputeRunningProcesses_v3(h, ctypes.byref(n), rows)
                if rc == INSUFFICIENT_SIZE:
                    size = max(2 * size, n.value + 8)
                    continue
                _check(rc, "GetComputeRunningProcesses_v3")
                break
            out.append([(int(r.pid), int(r.usedGpuMemory)) for r in rows[: n.value]
                        if r.usedGpuMemory != NOT_AVAILABLE])
        return out

    def state(self, memory, processes) -> list[Gpu]:
        return [Gpu(i, uuid, minor, name, used, total, procs)
                for i, ((_h, uuid, minor, name), (used, total), procs)
                in enumerate(zip(self.cards, memory, processes))]

    def watch(self, process_every_s: float = 1.0):
        """A read that asks NVML for the process table only when a card's
        used memory has moved since the last read, or ``process_every_s``
        after the last table: the table changes only with the memory the
        processes hold, and each call the reference makes is one the
        program's reads may wait behind."""
        last: dict = {"memory": None, "processes": None, "at": 0.0}

        def read() -> list[Gpu]:
            memory = self.memory()
            now = time.monotonic()
            if memory != last["memory"] or now - last["at"] >= process_every_s:
                last.update(memory=memory, processes=self.processes(), at=now)
            return self.state(memory, last["processes"])
        return read

    def close(self) -> None:
        self.lib.nvmlShutdown()


class Reads:
    """The states the sampler read, ``(wall time, [Gpu])`` in time order."""

    def __init__(self, states: list[tuple[float, list[Gpu]]]) -> None:
        self.states = states

    def around(self, t: float, before_s: float, after_s: float) -> list[list[Gpu]]:
        """The distinct states read in ``[t - before_s, t + after_s]``."""
        out: list[list[Gpu]] = []
        for when, gpus in self.states:
            if t - before_s <= when <= t + after_s and gpus not in out:
                out.append(gpus)
        return out


def to_doc(gpus: list[Gpu]) -> list:
    return [[g.index, g.uuid, g.minor, g.name, g.used, g.total, g.processes] for g in gpus]


def from_doc(doc: list) -> list[Gpu]:
    return [Gpu(i, u, m, n, used, total, [tuple(p) for p in procs])
            for i, u, m, n, used, total, procs in doc]


def load(path) -> Reads:
    """The states a sampler process wrote."""
    with open(path) as f:
        return Reads([(when, from_doc(doc)) for when, doc in json.load(f)])


def simulated(sim: dict):
    """A read of a rehearsal's simulated card: the spec's cards, card 0
    and its first process holding the walk's block at the instant read."""
    phases = [tuple(p) for p in sim["walk"]]

    def read() -> list[Gpu]:
        block = moves.block_at(phases, time.time() - sim["origin"])
        gpus = card_from_spec(sim["spec"])
        g = gpus[0]
        g.used += block
        if g.processes:
            g.processes[0] = (g.processes[0][0], g.processes[0][1] + block)
        return gpus
    return read


def main(argv: list[str]) -> int:
    """``python -m portbench.reference.nvml OUT PERIOD_S [SIM]`` reads every
    card's memory every ``PERIOD_S`` seconds, and its process table where
    that moved (``Card.watch``), in a process of its own so that its reads
    take nothing from the harness's or the program's interpreter, from the
    ready line (which carries the first read) until its standard input
    closes; then it writes every ``(wall time, state)`` to ``OUT``.
    ``SIM`` (a JSON file: a simulated driver's spec, a walk and its
    origin) reads a rehearsal's simulated card instead of NVML."""
    out, period = argv[0], float(argv[1])
    if len(argv) > 2:
        with open(argv[2]) as f:
            read, card = simulated(json.load(f)), None
    else:
        card = Card()
        read = card.watch()
    states = [(time.time(), read())]
    print(json.dumps({"ready": True, "gpus": to_doc(states[0][1])}), flush=True)
    while not select.select([sys.stdin], [], [], period)[0]:
        states.append((time.time(), read()))
    sys.stdin.read()
    states.append((time.time(), read()))
    if card is not None:
        card.close()
    with open(out, "w") as f:
        json.dump([[when, to_doc(gpus)] for when, gpus in states], f)
    print(json.dumps({"done": True, "reads": len(states)}), flush=True)
    return 0


def card_from_spec(doc: dict) -> list[Gpu]:
    """The answers a simulated driver spec (``--nvml-sim-spec``) serves: a
    simulated driver has no minor numbers, so a card's node is its index."""
    return [Gpu(i, g["uuid"], i, g.get("name", ""), int(g["mem_used"]), int(g["mem_total"]),
                [(int(p[0]), int(p[1])) for p in g.get("processes", ())])
            for i, g in enumerate(doc["gpus"])]


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
