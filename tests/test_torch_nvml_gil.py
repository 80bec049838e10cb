"""The port's NVML binding releases the interpreter lock through each NVML call.

A stub ``libnvidia-ml`` built here with the C compiler exports the ten
symbols the binding binds (``_SIGNATURES`` and the ``_v3`` process table);
each call sleeps 50 us, as a driver call does, and the memory read can be
wedged until the test lets it go, as a driver or card fault wedges it.
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
int nvmlDeviceGetMemoryInfo(void *h, mem_t *m) {
  CALL();
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
