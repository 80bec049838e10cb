"""The port stands alone: no module of ``tpu_pod_exporter_torch`` (nor
``chip_smoke.py``) imports ``jax`` or the JAX package, and the exporter
core it copies stays the JAX package's code with only the package renamed,
apart from the lines listed here (and in CHANGES.md)."""

import ast
import difflib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tpu_pod_exporter_torch"
REFERENCE = REPO / "tpu_pod_exporter"

# Copied modules whose text equals the JAX package's after the rename.
VERBATIM = (
    "__main__.py", "analysis/diagnostics.py",
    "analysis/engine.py", "attribution/__init__.py",
    "attribution/fake.py",
    "attribution/checkpoint.py", "attribution/podresources.py",
    "attribution/proto/__init__.py", "attribution/proto/podresources_pb2.py",
    "attribution/proto/podresources.proto",
    "attribution/uidmap.py",
    "backend/__init__.py", "backend/fake.py", "backend/recorded.py",
    "backend/proto/__init__.py", "backend/proto/tpu_metric_service_pb2.py",
    "chaos.py",
    "fuzz.py", "history.py",
    "metrics/__init__.py", "metrics/native.py", "metrics/parse.py",
    "shard.py",
    "supervisor.py", "topology.py", "utils.py", "version.py",
)
# Copied modules with a few lines changed beyond the rename:
# (reference lines replaced, port lines in their place).
EDITED = {
    "config.py": (2, 2),           # the --backend choices, the NVML binding comments
    # /dev/nvidia<minor> nodes, sorted by minor, no native scan; the
    # reference's accel -> vfio -> sysfs scan kept as list_tpu_device_paths
    # for the libtpu backend.
    "backend/discovery.py": (31, 40),
    # Chips keyed by list_tpu_device_paths; comments: no history reference.
    "backend/libtpu.py": (6, 6),
    "backend/proto/tpu_metric_service.proto": (1, 1),  # comment: no history reference
    # The ctypes driver is the default; the device node is named by minor;
    # IRQ_ISSUE and FUNCTION_NOT_FOUND carry nvml.h's codes.
    "backend/nvml.py": (4, 21),
    # GPU prefixes match /dev/nvidia<minor> only, in both /proc walks.
    "procscan.py": (7, 18),
    # The library is this package's own build of native/tpumon.cc, compiled
    # with g++ at first use into _build/, never the JAX package's .so.
    "nativelib.py": (4, 48),
    # --backend torch|nvml (jax refused), auto prefers NVML; the GPU scan
    # prefixes; the server's timing families reach the collector's snapshot.
    "app.py": (12, 33),
    # The libtpu probe verbatim, beside probe_nvml and --runtime.
    "probe.py": (11, 127),
    # sample() reads the card's device nodes, not the tunnel's ports.
    "tunnelwatch.py": (28, 31),
    # TorchStimulus in place of the JAX burn; the NVML probe in the artifact.
    "hwcheck.py": (107, 160),
    # The disk-pressure rung's segment seal runs on the writer thread (the
    # reference seals from the governor's thread, racing an append in
    # flight: a batch lost after its seq was issued, or indexed into a
    # segment that never holds it).
    "egress.py": (2, 27),
    # Comments: no history reference.
    "scenario.py": (3, 3),
    # Docstring: no history reference; store_continuity's hole allowance
    # runs from the last durable round before the kill to the first round
    # after the restart, measured from the run's round ends (the reference
    # allows a fixed 2.5 s, which a slower host's rounds exceed); a root
    # restart drops the run's plane and store before the fresh root starts;
    # one query before round 0 starts the query pools' workers, so the RSS
    # baseline holds them.
    "loadgen/scenario.py": (4, 36),
    # restart_root releases the killed root before building the fresh one.
    "loadgen/fleet.py": (1, 4),
    # The scrape storm runs in a child process (_ProcessStorm): in the
    # drill's own process its threads contend with the server and the
    # polite scraper for the interpreter lock.
    "pressure_demo.py": (3, 57),
    # The WAL restore names GPU series' labels (the reference restores them
    # label-less from the WAL: it looks only in ALL_SPECS); docstring: no
    # history reference.
    "persist.py": (3, 3),
    "metrics/registry.py": (1, 1),  # comment: no history reference
    "pressure.py": (1, 1),          # docstring: no history reference
    "trace.py": (1, 1),             # docstring: no history reference
    # Docstring and comment: no history reference; the loop's timer lag with
    # a 100 ms probe timer, emit_timings.
    "server.py": (5, 25),
    # The poll's device-read instants, published beside its stamp; the
    # server's timing families emitted into the snapshot.
    "collector.py": (2, 20),
    # default_fetch's stages on a thread-local record; the round's phases
    # (fetch, parse, fold, publish), observed by _publish, and the fetch
    # stages as histograms and as round-span attributes; a round on
    # default_fetch over http targets fetched from loop_fetch's selectors
    # loop in the round's thread, not the pool (names looked up on the
    # pool, off the loop), counted by transport; a loop aggregator keeps a
    # round's freed memory mapped (glibc's mallopt).
    "aggregate.py": (15, 476),
    # The port's instrumentation families: loop lag, device-read instants,
    # round phases, fetch stages, rounds by fetch transport.
    "metrics/schema.py": (0, 51),
    # --process-metrics scans /dev/nvidia<minor> for a GPU backend, as app.py
    # does (the reference walks /dev/accel and /dev/vfio whatever the backend);
    # the node's pods are joined under the GPU resource name for a GPU backend
    # (the reference joins under the TPU resource name whatever the backend).
    "status.py": (2, 16),
    # Docstrings: no history reference.
    "stream.py": (1, 1),
    "fleet.py": (1, 1),
    "store.py": (4, 4),
    "alerting.py": (5, 5),
    # exporter-lint. Docstring: the port's baseline, reviewed artifacts and
    # witness plugin; no history reference.
    "analysis/__init__.py": (7, 8),
    # The port's own baseline (analysis/baseline.json, never the repo
    # root's), the reviewed artifacts under analysis/reviewed/, the witness
    # variables TPE_TORCH_*; --demo skips _build/; no history reference.
    "analysis/__main__.py": (15, 16),
    # An unannotated constructor parameter stored on self (or a local alias
    # of that attribute) resolves to the classes constructed into it: its
    # lazily imported default and the package's construction sites
    # (NvmlBackend._driver: the ctypes driver and the simulated one); the
    # dataclass lock comment; no history reference.
    "analysis/concurrency.py": (10, 82),
    # A lambda inside a lambda (the stream route's writer) maps onto the
    # model by its line; the reviewed inventory's path; the witness
    # variable; --demo wording.
    "analysis/execcontext.py": (11, 25),
    # Messages: no history reference; the reviewed inventory's path.
    "analysis/rules.py": (2, 2),
    # The witness variables TPE_TORCH_* and the pytest plugin; a dataclass
    # field's default_factory lock keyed by the field's declaration line.
    "analysis/witness.py": (20, 70),
}
# The port's own files: modules written for it (rewrites of the JAX
# package's module at the same path, or modules the JAX package has none
# of), its kernel sources, and the lint's own baseline and reviewed
# artifacts.
PORT_OWN = (
    "__init__.py", "analysis/baseline.json", "analysis/pytest_witness.py",
    "analysis/reviewed/fork-inventory.json", "analysis/reviewed/lock-graph.dot",
    "analysis/reviewed/lock-graph.json", "backend/nvml_ctypes.py",
    "backend/torchdev.py", "cudaenv.py", "entry.py", "kernels/__init__.py",
    "kernels/csrc/online_softmax.cu", "kernels/csrc/sgd_update.cu",
    "kernels/csrc/stage_rows.cu", "kernels/csrc/tanh_matmul.cu",
    "kernels/csrc/tanh_matmul_sm90.cu",
    "kernels/online_softmax.py", "kernels/sgd.py", "kernels/tanh_matmul.py",
    "loadgen/__init__.py", "loadgen/__main__.py", "loadgen/parallel.py",
    "loadgen/selftest.py", "loadgen/sharded.py", "loadgen/workload.py",
    "native/tpumon.cc",
)


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib") or top == "tpu_pod_exporter"


def _port_sources() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_entry_modules_load_no_jax():
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "import tpu_pod_exporter_torch.app, tpu_pod_exporter_torch.hwcheck\n"
        "import tpu_pod_exporter_torch.loadgen.workload\n"
        "import tpu_pod_exporter_torch.backend.torchdev\n"
        "import tpu_pod_exporter_torch.kernels.tanh_matmul\n"
        "import tpu_pod_exporter_torch.kernels.sgd, tpu_pod_exporter_torch.entry\n"
        "import tpu_pod_exporter_torch.loadgen.sharded\n"
        "import tpu_pod_exporter_torch.loadgen.__main__\n"
        "import tpu_pod_exporter_torch.kernels.online_softmax\n"
        "import tpu_pod_exporter_torch.loadgen.parallel\n"
        "import tpu_pod_exporter_torch.loadgen.selftest\n"
        "import tpu_pod_exporter_torch.backend.nvml\n"
        "import tpu_pod_exporter_torch.backend.nvml_ctypes\n"
        "import tpu_pod_exporter_torch.backend.discovery\n"
        "import tpu_pod_exporter_torch.backend.recorded\n"
        "import tpu_pod_exporter_torch.procscan\n"
        "import tpu_pod_exporter_torch.nativelib, tpu_pod_exporter_torch.metrics.native\n"
        "import tpu_pod_exporter_torch.persist, tpu_pod_exporter_torch.egress\n"
        "import tpu_pod_exporter_torch.chaos\n"
        "import tpu_pod_exporter_torch.stream, tpu_pod_exporter_torch.fleet\n"
        "import tpu_pod_exporter_torch.store, tpu_pod_exporter_torch.aggregate\n"
        "import tpu_pod_exporter_torch.alerting, tpu_pod_exporter_torch.shard\n"
        "import tpu_pod_exporter_torch.status\n"
        "import tpu_pod_exporter_torch.scenario, tpu_pod_exporter_torch.fuzz\n"
        "import tpu_pod_exporter_torch.pressure_demo\n"
        "import tpu_pod_exporter_torch.loadgen.fleet, tpu_pod_exporter_torch.loadgen.scenario\n"
        "import tpu_pod_exporter_torch.backend.libtpu, tpu_pod_exporter_torch.probe\n"
        "import tpu_pod_exporter_torch.tunnelwatch\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    added = json.loads(proc.stdout)
    assert "tpu_pod_exporter_torch.app" in added
    assert "tpu_pod_exporter_torch.loadgen.selftest" in added
    assert "tpu_pod_exporter_torch.backend.nvml_ctypes" in added
    assert "tpu_pod_exporter_torch.chaos" in added
    for tier in ("stream", "fleet", "store", "aggregate", "alerting", "shard",
                 "status", "scenario", "fuzz", "pressure_demo", "loadgen.fleet",
                 "loadgen.scenario", "backend.libtpu", "probe", "tunnelwatch"):
        assert f"tpu_pod_exporter_torch.{tier}" in added
    assert [m for m in added if _forbidden(m)] == []
    # The card's path needs neither gRPC nor protobuf nor pynvml: the
    # kubelet podresources client and the libtpu backend load them only
    # when they are selected.
    assert [m for m in added
            if m.split(".")[0] in ("grpc", "pynvml") or m.startswith("google.protobuf")] == []


def _diff_counts(rel: str) -> tuple[int, int]:
    ref = re.sub(r"\btpu_pod_exporter\b", "tpu_pod_exporter_torch",
                 (REFERENCE / rel).read_text()).splitlines()
    port = (PORT / rel).read_text().splitlines()
    ops = difflib.SequenceMatcher(a=ref, b=port, autojunk=False).get_opcodes()
    changed = [op for op in ops if op[0] != "equal"]
    return (sum(i2 - i1 for _, i1, i2, _, _ in changed),
            sum(j2 - j1 for _, _, _, j1, j2 in changed))


@pytest.mark.parametrize("rel", ["backend/proto/tpu_metric_service_pb2.py",
                                 "attribution/proto/podresources_pb2.py",
                                 "attribution/proto/podresources.proto"])
def test_wire_definitions_are_the_reference_byte_for_byte(rel):
    """The generated modules keep the reference's serialized descriptors
    (package and file names included), so both packages speak one wire."""
    assert (PORT / rel).read_bytes() == (REFERENCE / rel).read_bytes()


def test_every_reference_module_has_a_counterpart():
    """Every file of the JAX package has a file at the same path in the
    port, except the two JAX runtime modules, which have counterparts under
    other names."""
    renamed = {"backend/jaxdev.py": "backend/torchdev.py", "jaxenv.py": "cudaenv.py"}
    missing = []
    for path in sorted(REFERENCE.rglob("*")):
        rel = path.relative_to(REFERENCE).as_posix()
        if not path.is_file() or "__pycache__" in rel or path.suffix == ".pyc":
            continue
        if not (PORT / renamed.get(rel, rel)).is_file():
            missing.append(rel)
    assert missing == []


def test_every_port_file_is_accounted_for():
    """Each file of the port is a copy (VERBATIM or EDITED) or the port's
    own (PORT_OWN): nothing lands in it unlisted."""
    unlisted = []
    for path in sorted(PORT.rglob("*")):
        rel = path.relative_to(PORT).as_posix()
        if (not path.is_file() or "__pycache__" in rel or rel.startswith("_build/")
                or path.suffix == ".pyc"):
            continue
        if rel not in VERBATIM and rel not in EDITED and rel not in PORT_OWN:
            unlisted.append(rel)
    assert unlisted == []


def test_native_source_is_the_reference_byte_for_byte():
    assert ((PORT / "native" / "tpumon.cc").read_bytes()
            == (REPO / "native" / "tpumon.cc").read_bytes())


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy(rel):
    assert _diff_counts(rel) == (0, 0)


@pytest.mark.parametrize("rel", sorted(EDITED))
def test_edited_copy_changes_only_listed_lines(rel):
    assert _diff_counts(rel) == EDITED[rel]


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)  # only the script's own directory is on the path
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_without_cuda_fails_with_no_result():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_alone_fails_with_no_result(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "No module named 'tpu_pod_exporter_torch'" in proc.stderr
