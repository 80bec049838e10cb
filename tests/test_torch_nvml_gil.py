"""The port's NVML binding releases the interpreter lock through each NVML call.

A stub ``libnvidia-ml`` built here with the C compiler exports the ten
symbols the binding binds (``_SIGNATURES`` and the ``_v3`` process table);
each call sleeps 50 us, as a driver call does, and the memory read can be
wedged until the test lets it go, as a driver or card fault wedges it. In
another process, environment variables slow or fail the memory read.
Loaded through the port's own ``CtypesNvmlDriver`` (``LIBRARY`` pointed at
the stub), one ``NvmlBackend.sample()`` of its one card makes 8 calls.

The binding loads the library with ``ctypes.CDLL``, so a wedged call blocks
only the supervisor's worker: the deadline abandons it while the poll loop,
``/metrics`` and ``/healthz`` go on. What each call costs beside a thread
that runs Python, under each loader, is timed on the card by
``chip_smoke.py``'s phase 12, not here.
"""

import ctypes
import shutil
import subprocess
import time
import urllib.request

import pytest

from tpu_pod_exporter_torch.app import ExporterApp
from tpu_pod_exporter_torch.backend import nvml_ctypes
from tpu_pod_exporter_torch.backend.nvml import NvmlBackend
from tpu_pod_exporter_torch.backend.nvml_ctypes import CtypesNvmlDriver
from tpu_pod_exporter_torch.config import ExporterConfig

GIB = 1 << 30
STUB_SOURCE = r"""
#include <stddef.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

typedef struct { unsigned long long total, free, used; } mem_t;
typedef struct { unsigned int gpu, memory; } util_t;
typedef struct { unsigned int pid; unsigned long long used; unsigned int gi, ci; } proc_t;

#define CALL() usleep(50)

/* While set, the memory read blocks, for 10 s at most: a wedged driver call. */
static volatile int wedged = 0;
static volatile int wedged_calls = 0;
static volatile int blocked = 0;
void stub_wedge(int on) { wedged = on; }
int stub_wedged_calls(void) { return wedged_calls; }
int stub_blocked(void) { return blocked; }

int nvmlInit_v2(void) { CALL(); return 0; }
int nvmlShutdown(void) { CALL(); return 0; }
int nvmlDeviceGetCount_v2(unsigned int *n) { CALL(); *n = 1; return 0; }
int nvmlDeviceGetHandleByIndex_v2(unsigned int i, void **h) {
  CALL(); *h = (void *)(size_t)(0x1000 + i); return 0;
}
int nvmlDeviceGetName(void *h, char *buf, unsigned int n) {
  CALL(); strncpy(buf, "Stub H100", n); return 0;
}
int nvmlDeviceGetUUID(void *h, char *buf, unsigned int n) {
  CALL(); strncpy(buf, "GPU-stub-0", n); return 0;
}
int nvmlDeviceGetMinorNumber(void *h, unsigned int *minor) { CALL(); *minor = 3; return 0; }
/* For a process that cannot call stub_wedge: every STUB_NVML_SLOW_EVERY-th
 * memory read takes STUB_NVML_SLOW_MS ms more, and the STUB_NVML_FAIL_AT-th
 * answers NVML_ERROR_GPU_IS_LOST (15). */
static int memory_reads = 0;
static int env_int(const char *name) { const char *v = getenv(name); return v ? atoi(v) : 0; }
int nvmlDeviceGetMemoryInfo(void *h, mem_t *m) {
  CALL();
  int n = ++memory_reads;
  if (n == env_int("STUB_NVML_FAIL_AT")) return 15;
  if (env_int("STUB_NVML_SLOW_EVERY") && n % env_int("STUB_NVML_SLOW_EVERY") == 0)
    usleep(1000 * env_int("STUB_NVML_SLOW_MS"));
  if (wedged) {
    wedged_calls++;
    blocked = 1;
    for (int ms = 0; wedged && ms < 10000; ms++) usleep(1000);
    blocked = 0;
  }
  m->total = 80ULL << 30; m->used = 17ULL << 30; m->free = m->total - m->used;
  return 0;
}
int nvmlDeviceGetUtilizationRates(void *h, util_t *u) {
  CALL(); u->gpu = 99; u->memory = 40; return 0;
}
/* One process: a table with no room for it answers INSUFFICIENT_SIZE. */
int nvmlDeviceGetComputeRunningProcesses_v3(void *h, unsigned int *count, proc_t *rows) {
  CALL();
  if (rows == NULL || *count < 1) { *count = 1; return 7; }
  rows[0].pid = 4242; rows[0].used = 16ULL << 30; rows[0].gi = 0; rows[0].ci = 0;
  *count = 1;
  return 0;
}
"""
DEADLINE_S = 0.25
WAIT_S = 15.0


@pytest.fixture(scope="module")
def stub_library(tmp_path_factory):
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        pytest.skip("needs a C compiler to build the stub NVML library")
    tmp = tmp_path_factory.mktemp("nvml-stub")
    src, lib = tmp / "stub_nvml.c", tmp / "libnvidia-ml-stub.so.1"
    src.write_text(STUB_SOURCE)
    subprocess.run([cc, "-shared", "-fPIC", "-O2", "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    return str(lib)


@pytest.fixture
def stub(monkeypatch, stub_library):
    monkeypatch.setattr(nvml_ctypes, "LIBRARY", stub_library)
    return stub_library


@pytest.fixture
def wedge(stub):
    """The stub's wedge switch: the same loaded library the binding calls."""
    control = ctypes.CDLL(stub)
    control.stub_wedge(0)
    yield control
    control.stub_wedge(0)


@pytest.fixture
def nvml_app(wedge):
    app = ExporterApp(ExporterConfig(
        port=0, host="127.0.0.1", interval_s=0.05, backend="nvml", attribution="none",
        phase_deadline_s=DEADLINE_S, breaker_failures=2, breaker_backoff_s=0.1,
        breaker_backoff_max_s=0.3, history_retention_s=0.0))
    app.start()
    try:
        yield app
    finally:
        wedge.stub_wedge(0)  # let every abandoned worker return before the stop
        app.stop()


def _get(port: int, path: str) -> tuple:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.status, r.read().decode()


def _metric(body: str, prefix: str) -> float | None:
    for line in body.splitlines():
        if line.startswith(prefix):
            return float(line.rsplit(" ", 1)[1])
    return None


def _wait_for(what: str, predicate) -> None:
    deadline = time.monotonic() + WAIT_S
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"not within {WAIT_S} s: {what}")
        time.sleep(0.01)


def _abandoned(app) -> float:
    body = _get(app.port, "/metrics")[1]
    return _metric(body, 'tpu_exporter_source_calls_abandoned_total{source="device"}') or 0.0


def test_the_loader_releases_the_interpreter_lock(stub):
    driver = CtypesNvmlDriver()
    # CDLL's functions lack the PYTHONAPI flag: called with the lock released.
    for name in nvml_ctypes._SIGNATURES:
        assert not driver._fns[name]._flags_ & ctypes._FUNCFLAG_PYTHONAPI, name
    assert not driver._procs._flags_ & ctypes._FUNCFLAG_PYTHONAPI
    assert driver.process_symbol == "nvmlDeviceGetComputeRunningProcesses_v3"


def test_sample_reads_the_stub_card(stub):
    backend = NvmlBackend()
    try:
        (chip,) = backend.sample().chips
    finally:
        backend.close()
    assert chip.info.device_path == "/dev/nvidia3"  # by minor, not index 0
    assert chip.info.device_kind == "Stub H100"
    assert chip.info.device_ids == ("GPU-stub-0", "0")
    assert chip.hbm_used_bytes == 17 * GIB and chip.hbm_total_bytes == 80 * GIB
    assert chip.tensorcore_duty_cycle_percent == 99.0
    assert [(p.pid, p.used_bytes) for p in chip.processes] == [(4242, 16 * GIB)]


def test_a_wedged_nvml_call_is_abandoned_while_healthz_answers(nvml_app, wedge):
    app = nvml_app
    assert _metric(_get(app.port, "/metrics")[1], "tpu_exporter_up ") == 1.0
    wedge.stub_wedge(1)
    _wait_for("a sample enters the wedged call", lambda: wedge.stub_wedged_calls() >= 1)
    # The deadline abandons the call, and the probes and the exposition
    # answer, while the call is still blocked in the driver. A loader that
    # kept the interpreter lock through the call would let nothing run
    # until it returned.
    _wait_for("the supervisor abandons the wedged call", lambda: _abandoned(app) >= 1)
    t0 = time.monotonic()
    assert _get(app.port, "/healthz")[0] == 200
    assert time.monotonic() - t0 < 1.0
    assert _metric(_get(app.port, "/metrics")[1], "tpu_exporter_up ") == 0.0
    assert wedge.stub_blocked() == 1


def test_the_device_source_recovers_once_the_wedged_call_returns(nvml_app, wedge):
    app = nvml_app
    wedge.stub_wedge(1)
    _wait_for("the supervisor abandons the wedged call", lambda: _abandoned(app) >= 1)
    wedge.stub_wedge(0)

    def recovered() -> bool:
        body = _get(app.port, "/metrics")[1]
        return (_metric(body, "tpu_exporter_up ") == 1.0
                and _metric(body, 'tpu_exporter_source_breaker_state{source="device"}') == 0.0)

    _wait_for("up returns to 1 with the breaker closed", recovered)
    body = _get(app.port, "/metrics")[1]
    assert _metric(body, "tpu_exporter_polls_total ") > 0
    assert _abandoned(app) >= 1


def test_chip_smoke_times_each_call_through_both_loaders(stub):
    # Phase 12's per-call record on the stub: every symbol of a sample
    # timed through each loader, the binding's own CDLL first.
    import chip_smoke

    assert chip_smoke.NVML_LOADERS == ("CDLL", "PyDLL")
    runs = chip_smoke.nvml_call_times(True, calls=10)
    symbols = {*nvml_ctypes._SIGNATURES} - {"nvmlInit_v2"} | {
        "nvmlDeviceGetComputeRunningProcesses_v3", "sample"}
    assert set(runs) == {"CDLL", "PyDLL"}
    for loader, calls in runs.items():
        assert set(calls) == symbols, loader
        assert calls["sample"]["calls"] == 10
        assert calls["nvmlDeviceGetComputeRunningProcesses_v3"]["calls"] == 10  # one a sample
        for name, quantiles in calls.items():
            assert 0 < quantiles["median"] <= quantiles["p99"], (loader, name)


def test_chip_smoke_times_the_process_table_both_ways(stub):
    # Phase 12's record of the process table on the stub's one process:
    # the pair makes two calls a round, the binding's read one.
    import chip_smoke

    ways = chip_smoke.process_table_times("GPU-stub-0", True, rounds=10)
    assert set(ways) == {"pair", "single"}
    assert ways["pair"]["nvml_calls"] == 20 and ways["single"]["nvml_calls"] == 10
    for way in ways.values():
        assert way["pids"] == [4242] and way["calls"] == 10
        assert 0 < way["median"] <= way["p99"] <= way["max"]


def test_timing_bootstrap_counts_one_process_table_call_a_sample(stub):
    # Phase 14's node exporter runs under NVML_TIMING_BOOTSTRAP: at its
    # drain it reports how many process-table calls each sample made.
    import json
    import signal
    import sys

    import chip_smoke

    code = (f"from tpu_pod_exporter_torch.backend import nvml_ctypes\n"
            f"nvml_ctypes.LIBRARY = {stub!r}\n" + chip_smoke.NVML_TIMING_BOOTSTRAP)
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--host", "127.0.0.1", "--port", "0",
         "--interval-s", "0.05", "--log-level", "warning", "--backend", "nvml",
         "--attribution", "none"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=chip_smoke.REPO)
    time.sleep(1.5)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=WAIT_S)
    assert proc.returncode == 0, err
    (line,) = [json.loads(x) for x in out.splitlines() if x.startswith('{"nvml_call_times"')]
    (row,) = line["process_table_calls"]
    calls, grown, samples = row
    assert (calls, grown) == (1, 0) and samples >= 2
    assert line["nvml_call_times"]["sample"]["calls"] == samples


@pytest.fixture(scope="module")
def nvml_probe(tmp_path_factory, stub_library):
    # Phases 12 and 14's C probe, built from chip_smoke's source as they build it.
    import chip_smoke

    if shutil.which("gcc") is None:
        pytest.skip("needs gcc to build the NVML probe")
    return chip_smoke.build_nvml_probe(tmp_path_factory.mktemp("nvml-probe"))


def _probe(binary, library, seconds=0.5, period_ms=10.0, **env):
    import os

    import chip_smoke

    t0 = time.monotonic()
    proc = subprocess.run(chip_smoke.probe_argv(binary, period_ms, seconds, library),
                          capture_output=True, text=True, timeout=WAIT_S,
                          env={**os.environ, **{k: str(v) for k, v in env.items()}})
    return proc, t0, time.monotonic()


def _port_sample_order() -> list:
    # The symbols one NvmlBackend.sample() calls through the binding, in order.
    driver = CtypesNvmlDriver()
    order = []

    def recorded(name, fn):
        def call(*args):
            order.append(name)
            return fn(*args)
        return call

    driver._fns = {name: recorded(name, fn) for name, fn in driver._fns.items()}
    driver._procs = recorded(driver.process_symbol, driver._procs)
    backend = NvmlBackend(driver=driver)
    try:
        backend.sample()  # nvmlInit first
        del order[:]
        backend.sample()
        return list(order)
    finally:
        backend.close()


def test_probe_makes_a_samples_calls_in_the_ports_order(stub, nvml_probe):
    import chip_smoke

    proc, _, _ = _probe(nvml_probe, stub)
    line = chip_smoke.probe_line(proc.returncode, proc.stdout, proc.stderr)
    order = _port_sample_order()
    assert len(order) == 8
    assert line["order"] == order
    assert line["calls_per_sample"] == 8.0 and line["grown"] == 0
    assert line["period_ms"] == 10.0 and line["limit_ms"] == chip_smoke.DEVICE_READ_LIMIT_MS
    assert line["slow_call_ms"] == chip_smoke.PROBE_SLOW_CALL_MS
    # A fixed 10 ms grid over 0.5 s: 50 slots, a few lost to a loaded host.
    assert 25 <= line["samples"] + line["late"] <= 50
    assert set(line["calls"]) == set(order)
    for name, times in line["calls"].items():
        assert times["calls"] == line["samples"], name
        assert 0 < times["wall_ms"]["median"] <= times["wall_ms"]["p99"] <= times["wall_ms"]["max"]
        assert times["cpu_ms"]["median"] >= 0
    assert line["sample"]["calls"] == line["samples"]
    assert line["over_limit"] == len(line["slow_samples"])


def test_probe_accounts_each_slot_of_its_grid_once(stub, nvml_probe):
    """Every sample takes over two of its 10 ms periods: each slot of the
    0.5 s grid is either sampled or late, and the slots that the last
    sample overran past the end do not count as late."""
    import chip_smoke

    proc, _, _ = _probe(nvml_probe, stub, STUB_NVML_SLOW_EVERY=1, STUB_NVML_SLOW_MS=25)
    line = chip_smoke.probe_line(proc.returncode, proc.stdout, proc.stderr)
    assert line["late"] >= line["samples"] > 0
    assert line["samples"] + line["late"] == 50


def test_probe_lists_every_slow_call_with_its_monotonic_start(stub, nvml_probe):
    import chip_smoke

    proc, t0, t1 = _probe(nvml_probe, stub, STUB_NVML_SLOW_EVERY=5, STUB_NVML_SLOW_MS=15)
    line = chip_smoke.probe_line(proc.returncode, proc.stdout, proc.stderr)
    slow = [c for c in line["slow_calls"]
            if c["call"] == "nvmlDeviceGetMemoryInfo" and c["wall_ms"] >= 15.0]
    # One memory read a sample; every fifth took 15 ms more.
    assert len(slow) == line["samples"] // 5 >= 3
    assert line["slow_calls_total"] == len(line["slow_calls"])
    for call in slow:
        assert t0 <= call["start_s"] <= t1
    # Each slow read makes its sample slow, and overruns the 10 ms slot.
    assert line["over_limit"] >= len(slow) and line["late"] >= 1
    for sample in line["slow_samples"]:
        assert sample["wall_ms"] > chip_smoke.DEVICE_READ_LIMIT_MS
        assert t0 <= sample["start_s"] <= t1
    starts = [s["start_s"] for s in line["slow_samples"]]
    for call in slow:
        assert any(s <= call["start_s"] <= s + 0.05 for s in starts)
    assert line["calls"]["nvmlDeviceGetMemoryInfo"]["wall_ms"]["max"] >= 15.0


def test_probe_exits_non_zero_on_an_nvml_error(stub, nvml_probe):
    import chip_smoke

    proc, _, _ = _probe(nvml_probe, stub, STUB_NVML_FAIL_AT=3)
    assert proc.returncode == 1
    assert "nvmlDeviceGetMemoryInfo returned 15" in proc.stderr
    assert '{"probe"' not in proc.stdout
    with pytest.raises(AssertionError, match="exited 1"):
        chip_smoke.probe_line(proc.returncode, proc.stdout, proc.stderr)


def test_probe_stops_on_sigterm_and_prints_its_line(stub, nvml_probe):
    import signal

    import chip_smoke

    proc = subprocess.Popen(chip_smoke.probe_argv(nvml_probe, 10.0, 60.0, stub),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    time.sleep(1.0)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=WAIT_S)
    line = chip_smoke.probe_line(proc.returncode, out, err)
    assert 5 <= line["samples"] and line["seconds"] < 10


def test_timing_bootstrap_stamps_slow_samples_with_a_monotonic_start(stub):
    import json
    import os
    import signal
    import sys

    import chip_smoke

    code = (f"from tpu_pod_exporter_torch.backend import nvml_ctypes\n"
            f"nvml_ctypes.LIBRARY = {stub!r}\n" + chip_smoke.NVML_TIMING_BOOTSTRAP)
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--host", "127.0.0.1", "--port", "0",
         "--interval-s", "0.05", "--log-level", "warning", "--backend", "nvml",
         "--attribution", "none"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=chip_smoke.REPO,
        env={**os.environ, "STUB_NVML_SLOW_EVERY": "2", "STUB_NVML_SLOW_MS": "15"})
    time.sleep(1.5)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=WAIT_S)
    t1 = time.monotonic()
    assert proc.returncode == 0, err
    (line,) = [json.loads(x) for x in out.splitlines() if x.startswith('{"nvml_call_times"')]
    slow = [s for s in line["slow_samples"]
            if any(c[0] == "nvmlDeviceGetMemoryInfo" and c[1] >= 15.0 for c in s["calls"])]
    assert len(slow) >= 3
    for sample in line["slow_samples"]:
        assert t0 <= sample["start_s"] <= t1
        for name, wall, cpu, start in sample["calls"]:
            assert sample["start_s"] <= start <= sample["start_s"] + sample["wall_ms"] / 1e3
            assert 0 <= cpu and wall <= sample["wall_ms"]


def test_stall_timeline_puts_both_processes_on_one_clock():
    # Phase 14's read-out on made-up samples: 8 CPUs, 100 ticks a second.
    import os

    import chip_smoke

    tick = os.sysconf("SC_CLK_TCK")
    # (monotonic s, /proc/stat busy, total, load1, tasks, every process's ticks)
    readings = [(100.0 + i / 10, 0, 0, 0.0, "0/0", i * 0.4 * tick / 10 * 8) for i in range(11)]
    exporter = [{"start_s": 100.25, "wall_ms": 30.0, "cpu_ms": 20.0,
                 "calls": [["nvmlDeviceGetCount_v2", 0.1, 0.0, 100.25],
                           ["nvmlDeviceGetMemoryInfo", 29.0, 20.0, 100.2502]]},
                {"start_s": 100.75, "wall_ms": 12.0, "cpu_ms": 10.0, "calls": []}]
    probe = {"over_limit": 1, "slow_calls_total": 2,
             "slow_samples": [{"start_s": 100.251, "wall_ms": 29.5, "cpu_ms": 20.0}],
             "slow_calls": [{"call": "nvmlDeviceGetMemoryInfo", "start_s": 100.251,
                             "wall_ms": 29.0, "cpu_ms": 20.0},
                            {"call": "nvmlDeviceGetUUID", "start_s": 100.5, "wall_ms": 3.0,
                             "cpu_ms": 0.0}]}
    line = chip_smoke.stall_timeline(exporter, {"probe_10ms": probe}, readings, 100.0, 8)
    assert [(e["who"], round(e["t_s"], 3)) for e in line["events"]] == [
        ("exporter", 0.25), ("probe_10ms", 0.251), ("exporter", 0.75)]
    first, probe_event, last = line["events"]
    assert first["held_by"] == ["nvmlDeviceGetMemoryInfo", 29.0]
    assert first["probe_calls_over_slow"] == [
        ["probe_10ms", "nvmlDeviceGetMemoryInfo", pytest.approx(0.251), 29.0]]
    assert probe_event["probe_calls_over_slow"] == []  # its own calls are not listed
    assert last["probe_calls_over_slow"] == [] and "held_by" not in last
    assert first["process_busy_share"] == pytest.approx(0.4)
    assert first["stat_busy_share"] is None  # gVisor's /proc/stat: all zeros
    assert line["exporter_slow"] == 2 and line["exporter_slow_beside_probe_call"] == 1
    assert line["probe_slow"] == {"probe_10ms": 1}
    assert line["process_busy_share"]["median"] == pytest.approx(0.4)
    assert line["cpus"] == 8 and line["readings"] == 11


def test_host_cpu_reads_the_proc_files_on_a_clock():
    import chip_smoke

    host = chip_smoke.HostCpu()
    host.start()
    time.sleep(0.35)
    host.close()
    host.close()  # closing twice is harmless
    assert len(host.readings) >= 3
    times = [r[0] for r in host.readings]
    assert times == sorted(times)
    for t, busy, total, load1, tasks, processes in host.readings:
        assert 0 <= busy <= total and load1 >= 0 and "/" in tasks and processes > 0
