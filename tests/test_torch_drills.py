"""The drills, the libtpu backend, the NVML probe and the liveness watch.

The scenario DSL, the fuzzer's generator and one named drill go through
both packages from one seed and must agree. Both packages' libtpu backends
read one fake gRPC metrics service and must give equal samples, and both
exporters on ``--backend libtpu`` the same /metrics lines outside the
exporter's own families. The port keys libtpu chips by the TPU host's
accel/vfio/sysfs scan, never by ``/dev/nvidia*``, and keeps the tpu
family's wiring. ``probe_nvml`` runs against the simulated NVML driver and
the ctypes binding over a stand-in library.
"""

import dataclasses
import inspect
import json
import random
import subprocess
import sys
import threading
import time
import pytest

from test_torch_backend_libtpu import link_response, metric_server  # noqa: F401 — fixture
from test_torch_exporter import _get, _split
from test_torch_nvml import GIB, FakeNvmlLib
from tpu_pod_exporter import fuzz as jax_fuzz
from tpu_pod_exporter import scenario as jax_scenario
from tpu_pod_exporter.app import ExporterApp as JaxExporterApp
from tpu_pod_exporter.backend import discovery as jax_discovery
from tpu_pod_exporter.backend.libtpu import LibtpuMetricsBackend as JaxLibtpuBackend
from tpu_pod_exporter.config import ExporterConfig as JaxExporterConfig
from tpu_pod_exporter_torch import app as tapp
from tpu_pod_exporter_torch import fuzz, hwcheck, probe, scenario
from tpu_pod_exporter_torch.backend import discovery
from tpu_pod_exporter_torch.backend import libtpu
from tpu_pod_exporter_torch.backend.nvml import GpuScript, SimulatedNvmlDriver
from tpu_pod_exporter_torch.backend.nvml_ctypes import CtypesNvmlDriver
from tpu_pod_exporter_torch.config import ExporterConfig
from tpu_pod_exporter_torch.procscan import DEFAULT_DEVICE_PREFIXES


@pytest.fixture
def quiet_logs():
    import logging

    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


# ----------------------------------------------------------- scenario DSL


@pytest.mark.parametrize("name", sorted(scenario.SCENARIOS))
def test_named_timelines_parse_to_the_same_events(name):
    assert sorted(jax_scenario.SCENARIOS) == sorted(scenario.SCENARIOS)
    want = jax_scenario.SCENARIOS[name]
    got = scenario.SCENARIOS[name]
    assert got.timeline == want.timeline
    assert ([dataclasses.asdict(e) for e in got.events()]
            == [dataclasses.asdict(e) for e in want.events()])


@pytest.mark.parametrize("seed", range(8))
def test_generated_timelines_are_the_same_from_one_seed(seed):
    want = jax_scenario.generate_timeline(random.Random(seed), max_events=6)
    got = scenario.generate_timeline(random.Random(seed), max_events=6)
    assert got == want
    assert ([dataclasses.asdict(e) for e in scenario.parse_scenario(got)]
            == [dataclasses.asdict(e) for e in jax_scenario.parse_scenario(want)])


@pytest.mark.parametrize("seed, trial", [(5, 0), (5, 3), (11, 1), (42, 7)])
def test_fuzz_trials_are_the_same_from_one_seed(seed, trial):
    assert fuzz.timeline_for_trial(seed, trial) == jax_fuzz.timeline_for_trial(seed, trial)


def test_named_drill_gives_the_same_verdict(tmp_path, quiet_logs):
    """preempt_slice at 24 targets and 2 shards: the same verdict, armed
    invariants, ticks, egress ledger and pressure counts in both."""
    from tpu_pod_exporter.loadgen.scenario import run_scenarios as jax_run
    from tpu_pod_exporter_torch.loadgen.scenario import run_scenarios

    results = []
    for name, run in (("jax", jax_run), ("torch", run_scenarios)):
        summary = run(["preempt_slice"], 24, 2, 2, str(tmp_path / name), seed=7)
        result = summary["scenarios"]["preempt_slice"]
        for volatile in ("wall_s", "rss_growth_mb"):
            result.pop(volatile)
        results.append(result)
    assert results[1] == results[0]
    assert results[1]["ok"] is True
    assert results[1]["egress"]["duplicate_seqs"] == 0


class _Plane:
    """The store_continuity check's query plane: ``pts`` as one row."""

    def __init__(self, pts):
        self.pts = pts

    def query_range(self, metric, start, end, step):
        return {"data": {"result": [{"values": [[t, 1.0] for t in self.pts]}]}}


# Round ends of a store_continuity run on an 8-core host (rounds of about
# 0.9 s, 0.9 s of checks and pause between them): the root is killed at
# the start of round 4 and restarted before round 6. The store's points
# fall just before each round's end; round 3's sample sat in the open
# bucket the kill loses.
ROUND_ENDS = [483.878, 485.431, 486.738, 488.579, 490.520, 491.785, 493.494,
              495.573, 496.873]
KILL, RESTART = 489.496, 492.454


def _continuity_problems(run_cls, pts, rounds=ROUND_ENDS):
    run = run_cls.__new__(run_cls)
    run.plane, run.store, run.problems = _Plane(pts), None, []
    run.start_wall, run.kill_wall, run.restart_wall = 480.0, KILL, RESTART
    run.round_end_walls = list(rounds)
    run._check_store_continuity()
    return run.problems


@pytest.mark.parametrize("lost", [(3,), (2, 3), (3, 6)])
def test_store_continuity_slack_is_one_lost_round_each_side(lost):
    """The port's continuity check allows the hole from the last durable
    round before the kill to the first round after the restart (the open
    bucket is the documented SIGKILL loss), measured from the run's own
    rounds; one more missing round on either side is a hole. The JAX
    package's fixed 2.5 s slack fails the intact boundary on a host this
    slow."""
    from tpu_pod_exporter.loadgen.scenario import _Run as JaxRun
    from tpu_pod_exporter_torch.loadgen.scenario import _Run

    pts = [t - 0.03 for i, t in enumerate(ROUND_ENDS) if i not in (4, 5, *lost)]
    holes = [p for p in _continuity_problems(_Run, pts) if "hole" in p]
    assert bool(holes) == (lost != (3,)), holes
    if lost == (3,):
        (jax_hole,) = [p for p in _continuity_problems(JaxRun, pts) if "hole" in p]
        assert "6.8s hole" in jax_hole and "allowed 5.5s" in jax_hole


QUERY_POOLS = ("tpu-root-query", "tpu-fleet-query")


@pytest.mark.parametrize("name", ["mem_pressure", "store_continuity"])
def test_rss_baseline_holds_the_query_pools_workers(name, tmp_path, quiet_logs, monkeypatch):
    """The leak bound's baseline is read once the query pools have started
    their workers. A pool keeps every worker its first fan-out starts:
    where that fan-out came after the baseline (mem_pressure's dashboard
    traffic, store_continuity's boundary query), the workers' stacks
    counted as growth, 136 threads at 120 targets and 4 shards. At the
    baseline read the root's pool and every leaf's have workers; at the
    end read they hold no more than the pools' caps."""
    from tpu_pod_exporter_torch import utils
    from tpu_pod_exporter_torch.fleet import FleetQueryPlane
    from tpu_pod_exporter_torch.loadgen.scenario import run_scenarios

    reads = []
    rss = utils.process_rss_bytes

    def counting_rss():
        if sys._getframe(1).f_code.co_name in ("_check_tick", "_finish"):
            names = [t.name for t in threading.enumerate()]
            reads.append({pool: sum(n.startswith(pool + "_") for n in names)
                          for pool in QUERY_POOLS})
        return rss()

    monkeypatch.setattr(utils, "process_rss_bytes", counting_rss)
    summary = run_scenarios([name], 8, 2, 1, str(tmp_path), seed=7)
    assert summary["ok"], summary["scenarios"][name]
    baseline, end = reads[0], reads[-1]
    leaves = 4  # 2 shards, a leaf and its twin each
    cap = inspect.signature(FleetQueryPlane).parameters["max_workers"].default
    assert baseline["tpu-root-query"] >= 1 and baseline["tpu-fleet-query"] >= leaves, reads
    assert end["tpu-root-query"] <= leaves and end["tpu-fleet-query"] <= leaves * cap, reads


def test_memory_bootstrap_prints_the_leak_bounds_two_reads(tmp_path):
    """Phase 15's memory wrapper prints, beside its start and exit lines,
    the threads and RSS at the scenario's baseline read and its end read."""
    import chip_smoke

    proc = subprocess.run(
        [sys.executable, "-c", chip_smoke.DRILL_MEMORY_BOOTSTRAP, "loadgen.scenario",
         "--scenarios", "store_continuity", "--targets", "8", "--shards", "1",
         "--state-root", str(tmp_path / "state")],
        cwd=chip_smoke.REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = {doc["memory"]: doc for doc in map(json.loads, (
        ln for ln in proc.stdout.splitlines() if ln.startswith('{"memory"')))}
    assert set(lines) == {"start", "exit", "leak_reads"}
    baseline, end = lines["leak_reads"]["reads"]
    assert baseline["threads"] > 1 and baseline["rss_bytes"] > 0
    assert end["threads"] > 1 and end["rss_bytes"] > 0


def test_thread_rss_bootstrap_measures_idle_threads():
    import chip_smoke

    proc = subprocess.run([sys.executable, "-c", chip_smoke.THREAD_RSS_BOOTSTRAP, "8"],
                          capture_output=True, text=True, timeout=60, check=True)
    doc = json.loads(proc.stdout)
    assert doc["threads"] == 8 and doc["rss_bytes_before"] > 0
    assert doc["bytes_a_thread"] == (doc["rss_bytes_after"] - doc["rss_bytes_before"]) / 8


def test_storm_child_reports_the_in_process_storm_stats():
    """The drill's storm runs in a child process and reports the same
    stats document as an in-process ScrapeStorm."""
    from tpu_pod_exporter_torch.chaos import ScrapeStorm
    from tpu_pod_exporter_torch.metrics import SnapshotStore
    from tpu_pod_exporter_torch.pressure_demo import _ProcessStorm
    from tpu_pod_exporter_torch.server import MetricsServer

    store = SnapshotStore()
    server = MetricsServer(store, host="127.0.0.1", port=0)
    server.start()
    try:
        storm = _ProcessStorm("127.0.0.1", server.port, conns=4, pause_s=0.05,
                              reject_pause_s=0.1)
        storm.start()
        time.sleep(1.0)
        storm.stop()
        storm.stop()  # idempotent, as the drill's finally calls it again
        stats = storm.stats()
    finally:
        server.stop()
    assert set(stats) == set(ScrapeStorm("127.0.0.1", 1).stats())
    assert stats["served"] + stats["rejected"] > 0 and stats["errors"] == 0


# ------------------------------------------------------------ libtpu


TABLES = {
    libtpu.HBM_USAGE: [(0, 10 * GIB), (1, 21 * GIB), (2, 0), (3, 7 * GIB)],
    libtpu.HBM_TOTAL: [(d, 32 * GIB) for d in range(4)],
    libtpu.DUTY_CYCLE: [(0, 55.5), (1, 0.0), (2, 99.0), (3, 12.25)],
}
ICI_ROWS = [(d, link, 1000 * d + link) for d in range(4) for link in range(4)]


@pytest.fixture(params=["enumerated", "probed"])
def libtpu_addr(request, metric_server):
    """The fake RuntimeMetricService serving four chips with per-link ICI:
    with the enumeration RPC, or an old runtime without it."""
    service, addr = metric_server
    for name, rows in TABLES.items():
        service.set(name, rows)
    service.tables[libtpu.ICI_CANDIDATES[0]] = link_response(ICI_ROWS)
    service.supported = ([*TABLES, libtpu.ICI_CANDIDATES[0]]
                         if request.param == "enumerated" else None)
    return addr


def _plain(sample):
    """A HostSample as plain data, whichever package built it."""
    def conv(v):
        if hasattr(v, "_asdict"):
            return {k: conv(x) for k, x in v._asdict().items()}
        if dataclasses.is_dataclass(v):
            return {f.name: conv(getattr(v, f.name)) for f in dataclasses.fields(v)}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return v
    return conv(sample)


def test_both_backends_give_equal_samples(libtpu_addr):
    paths = {d: f"/dev/accel{d}" for d in range(4)}
    samples = []
    for cls in (JaxLibtpuBackend, libtpu.LibtpuMetricsBackend):
        backend = cls(addr=libtpu_addr, device_paths=paths)
        try:
            samples.append([_plain(backend.sample()) for _ in range(2)])
        finally:
            backend.close()
    assert samples[1] == samples[0]
    first = samples[1][0]
    assert [c["info"]["device_path"] for c in first["chips"]] == list(paths.values())
    assert first["chips"][1]["hbm_used_bytes"] == 21 * GIB
    assert len(first["chips"][3]["ici_links"]) == 4
    assert first["partial_errors"] == []


def test_both_exporters_serve_the_same_libtpu_lines(libtpu_addr):
    """--backend libtpu through both ExporterApps: the same /metrics lines,
    with equal values, outside the exporter's own families."""
    bodies = []
    for app_cls, cfg_cls in ((JaxExporterApp, JaxExporterConfig),
                             (tapp.ExporterApp, ExporterConfig)):
        app = app_cls(cfg_cls(port=0, host="127.0.0.1", backend="libtpu",
                              libtpu_metrics_addr=libtpu_addr,
                              attribution="none", accelerator="v4-8"))
        try:
            assert app.backend.name == "libtpu"
            app.collector.poll_once()
            app.server.start()
            status, body = _get(f"http://127.0.0.1:{app.port}", "/metrics")
            assert status == 200
            bodies.append([line for line in body.decode().splitlines()
                           if "tpu_exporter_" not in line])
        finally:
            app.stop()
    assert len(bodies[1]) == len(bodies[0]) > 20
    for want, got in zip(*bodies):
        assert _split(got) == _split(want)
    text = "\n".join(bodies[1])
    assert 'tpu_hbm_used_bytes{' in text and "tpu_tensorcore_duty_cycle_percent{" in text
    assert "gpu_hbm_used_bytes" not in text


# The TPU host's device trees, and the GPU node's: (files under root, the
# libtpu scan's answer).
TPU_TREES = [
    (["dev/accel0", "dev/accel1", "dev/accel3"],
     ["/dev/accel0", "/dev/accel1", "/dev/accel3"]),
    (["dev/accel10", "dev/accel2", "dev/accelX", "dev/vfio/7"],
     ["/dev/accel2", "/dev/accel10"]),
    (["dev/vfio/12", "dev/vfio/3", "dev/vfio/vfio"], ["/dev/vfio/3", "/dev/vfio/12"]),
    (["sys/class/accel/accel1", "sys/class/accel/accel0"], ["/dev/accel0", "/dev/accel1"]),
    (["dev/nvidia0", "dev/nvidia3", "dev/nvidiactl", "dev/nvidia-uvm"], []),
    (["dev/nvidia3", "dev/accel0"], ["/dev/accel0"]),
    ([], []),
]


def _tree(root, files):
    for rel in files:
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.touch()
    return str(root)


@pytest.mark.parametrize("files, want", TPU_TREES)
def test_tpu_scan_is_the_reference_scan(tmp_path, files, want):
    root = _tree(tmp_path, files)
    assert discovery.list_tpu_device_paths(root) == want
    assert jax_discovery.list_device_paths(root) == want
    # The GPU scan never reads accel or vfio nodes.
    assert all(p.startswith("/dev/nvidia") for p in discovery.list_device_paths(root))


@pytest.mark.parametrize("files, want", [
    (["dev/accel0", "dev/accel2", "dev/nvidia3"], {0: "/dev/accel0", 2: "/dev/accel2"}),
    (["dev/vfio/12", "dev/vfio/3"], {0: "/dev/vfio/3", 1: "/dev/vfio/12"}),
    (["dev/nvidia0", "dev/nvidia3", "dev/nvidiactl"], {}),
])
def test_libtpu_chips_are_keyed_by_the_tpu_scan(tmp_path, monkeypatch, libtpu_addr,
                                                files, want):
    root = _tree(tmp_path, files)
    real = discovery.list_tpu_device_paths
    monkeypatch.setattr(discovery, "list_tpu_device_paths", lambda: real(root))
    monkeypatch.setattr(discovery, "list_device_paths",
                        lambda *a: pytest.fail("libtpu read the GPU scan"))
    backend = libtpu.LibtpuMetricsBackend(addr=libtpu_addr)
    try:
        assert backend._device_paths == want
        chips = backend.sample().chips
    finally:
        backend.close()
    assert {c.info.chip_id: c.info.device_path for c in chips if c.info.device_path} == want
    assert not any("nvidia" in c.info.device_path for c in chips)


def test_libtpu_app_keeps_the_tpu_family_wiring(libtpu_addr):
    """A libtpu backend is the tpu family: attribution joins on the TPU
    resource name and the process scan walks the accel/vfio prefixes."""
    cfg = ExporterConfig(port=0, backend="libtpu", libtpu_metrics_addr=libtpu_addr,
                         attribution="none", process_metrics=True)
    app = tapp.ExporterApp(cfg)
    try:
        assert (app.backend.name, app.backend.family) == ("libtpu", "tpu")
        assert app.resource_name == cfg.resource_name == "google.com/tpu"
        assert app.process_scanner._prefixes == DEFAULT_DEVICE_PREFIXES
        assert not any("nvidia" in p for p in DEFAULT_DEVICE_PREFIXES)
    finally:
        app.stop()


def test_auto_keeps_the_nvml_preference(monkeypatch):
    """``auto`` on a node with device nodes builds NVML, never libtpu (the
    JAX package tries libtpu first)."""
    tried = []

    def build(choice, cfg):
        tried.append(choice)
        raise tapp.BackendError("no driver here")

    monkeypatch.setattr(discovery, "local_chip_count", lambda root="/": 1)
    monkeypatch.setattr(tapp, "_build_named_backend", build)
    backend = tapp.build_backend(ExporterConfig(backend="auto"))
    assert tried == ["nvml"]
    assert backend.name == "fake"


def test_jax_backend_stays_refused():
    assert tapp.UNPORTED_BACKENDS == ("jax",)
    with pytest.raises(ValueError, match="not yet ported"):
        tapp.build_backend(ExporterConfig(backend="jax"))


def test_libtpu_without_grpc_exits_loudly():
    """Where grpc does not import, --backend libtpu fails with grpc named
    on stderr: never a 0-chip surface."""
    code = ("import sys\n"
            "sys.modules['grpc'] = None\n"
            "from tpu_pod_exporter_torch.app import main\n"
            "sys.exit(main(['--backend', 'libtpu', '--attribution', 'none',\n"
            "               '--port', '0', '--host', '127.0.0.1']))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode != 0
    assert "grpc" in proc.stderr


# ------------------------------------------------------------- probe


def _sim(scripts):
    return SimulatedNvmlDriver(scripts)


def test_probe_nvml_reports_every_device():
    driver = _sim([
        GpuScript(mem_used_bytes=21 * GIB, utilization_percent=87.0, name="H100",
                  uuid="GPU-aaaa", processes=[(4242, 12 * GIB, "train"),
                                              (4243, 8 * GIB, "eval"), (4244, 1, "x")]),
        GpuScript(mem_total_bytes=40 * GIB, mem_used_bytes=GIB),
    ])
    report = probe.probe_nvml(driver, max_rows=2)
    assert report["reachable"] is True and report["count"] == 2
    d0, d1 = report["devices"]
    assert d0 == {"index": 0, "name": "H100", "uuid": "GPU-aaaa",
                  "minor": "FUNCTION_NOT_FOUND",
                  "memory_total_bytes": 80 * GIB, "memory_used_bytes": 21 * GIB,
                  "utilization_percent": 87.0, "process_rows": 3,
                  "processes": [[4242, 12 * GIB], [4243, 8 * GIB]]}
    assert (d1["uuid"], d1["memory_total_bytes"], d1["process_rows"]) == ("GPU-sim-1", 40 * GIB, 0)
    assert "DeviceGetMemoryInfo" in report["supported"]
    # The simulated driver has no minor call: recorded, not fatal.
    assert report["errors"] == {
        "DeviceGetMinorNumber(0)": "NVML_ERROR_FUNCTION_NOT_FOUND (13)",
        "DeviceGetMinorNumber(1)": "NVML_ERROR_FUNCTION_NOT_FOUND (13)"}
    assert driver.shutdown_calls == 1
    json.loads(json.dumps(report, allow_nan=False))  # strict JSON


def test_probe_nvml_names_not_supported_utilization():
    report = probe.probe_nvml(_sim([GpuScript(utilization_percent=None)]))
    (dev,) = report["devices"]
    assert dev["utilization_percent"] == "NOT_SUPPORTED"
    assert report["errors"]["DeviceGetUtilizationRates(0)"] == "NVML_ERROR_NOT_SUPPORTED (3)"
    assert "DeviceGetUtilizationRates" not in report["supported"]
    assert report["reachable"] is True


@pytest.mark.parametrize("call, code, field", [
    ("DeviceGetMemoryInfo", "gpu_is_lost", "memory_used_bytes"),
    ("DeviceGetComputeRunningProcesses", "no_permission", "process_rows"),
    ("DeviceGetHandleByIndex", "gpu_is_lost", "handle"),
])
def test_probe_nvml_names_a_failed_call(call, code, field):
    driver = _sim([GpuScript()])
    driver.inject(call, code)
    report = probe.probe_nvml(driver)
    (dev,) = report["devices"]
    assert dev[field] == code.upper()
    assert report["errors"][f"{call}(0)"].startswith(f"NVML_ERROR_{code.upper()} (")


def test_probe_nvml_unreachable_when_init_fails():
    driver = _sim([GpuScript()])
    driver.inject("Init", "driver_not_loaded")
    report = probe.probe_nvml(driver)
    assert (report["reachable"], report["count"], report["devices"]) == (False, None, [])
    assert report["errors"] == {"Init": "NVML_ERROR_DRIVER_NOT_LOADED (9)"}


def test_probe_nvml_through_the_ctypes_binding():
    """The card's binding over a stand-in library: the minor number names
    the card's node, and the process table's rows come through."""
    driver = CtypesNvmlDriver(lib=FakeNvmlLib(procs=[(118, 17 * GIB)], minor=3))
    report = probe.probe_nvml(driver)
    (dev,) = report["devices"]
    assert (dev["name"], dev["minor"], dev["utilization_percent"]) == (
        "NVIDIA H100 80GB HBM3", 3, 93.0)
    assert (dev["memory_total_bytes"], dev["memory_used_bytes"]) == (80 * GIB, 20 * GIB)
    assert dev["processes"] == [[118, 17 * GIB]] and report["errors"] == {}


def test_probe_main_without_the_library_exits_2(monkeypatch, capsys):
    from tpu_pod_exporter_torch.backend import nvml_ctypes

    monkeypatch.setattr(nvml_ctypes, "LIBRARY", "libnvidia-ml-absent.so.1")
    assert probe.main([]) == 2
    out, err = capsys.readouterr()
    doc = json.loads(out)
    assert (doc["runtime"], doc["reachable"], doc["devices"]) == ("nvml", False, [])
    assert "could not be loaded" in doc["errors"]["<load>"]
    assert "Traceback" not in err


def test_probe_cli_without_the_library_prints_no_traceback(tmp_path):
    code = ("import sys\n"
            "from tpu_pod_exporter_torch.backend import nvml_ctypes\n"
            "nvml_ctypes.LIBRARY = 'libnvidia-ml-absent.so.1'\n"
            "from tpu_pod_exporter_torch.probe import main\n"
            f"sys.exit(main(['--runtime', 'nvml', '--out', {str(tmp_path / 'p.json')!r}]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 2
    assert proc.stderr == ""
    assert json.loads(proc.stdout) == json.loads((tmp_path / "p.json").read_text())


def test_hwcheck_records_the_probe(monkeypatch):
    fixed = probe.probe_nvml(_sim([GpuScript(uuid="GPU-x")]))
    monkeypatch.setattr(probe, "probe_nvml", lambda: fixed)
    report = hwcheck.run_check(backend="fake", idle_s=0.3, load_s=0.4)
    assert report["probe"] == fixed


def test_hwcheck_survives_a_failing_probe(monkeypatch):
    keys = set(probe.probe_nvml(_sim([GpuScript()])))

    def boom():
        raise RuntimeError("probe exploded")

    monkeypatch.setattr(probe, "probe_nvml", boom)
    report = hwcheck.run_check(backend="fake", idle_s=0.3, load_s=0.4)
    assert report["ok"] is True
    assert report["probe"]["reachable"] is False
    assert report["probe"]["errors"] == {"<probe>": "probe exploded"}
    assert set(report["probe"]) == keys  # the artifact's shape never forks


# ------------------------------------------------------- demos on the CPU


def test_store_query_budget_demo_runs(tmp_path, quiet_logs):
    """The store demo's second drill imports loadgen.fleet: it runs."""
    from tpu_pod_exporter_torch.store import run_query_budget_demo

    assert run_query_budget_demo(str(tmp_path), targets=16, shards=2, iterations=5,
                                 verbose=False) == 0


@pytest.mark.parametrize("drill", ["disk", "memory", "storm"])
def test_pressure_demo_drills_run(drill):
    """``pressure --demo`` reaches its drills (the port carries
    pressure_demo)."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_pod_exporter_torch.pressure", "--demo",
         "--drill", drill], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"{drill} drill OK" in proc.stdout
