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
    "__main__.py", "aggregate.py", "attribution/__init__.py",
    "attribution/fake.py",
    "attribution/checkpoint.py", "attribution/podresources.py",
    "attribution/proto/__init__.py", "attribution/proto/podresources_pb2.py",
    "attribution/uidmap.py",
    "backend/__init__.py", "backend/fake.py", "chaos.py", "collector.py",
    "egress.py", "history.py",
    "metrics/__init__.py", "metrics/native.py", "metrics/parse.py",
    "metrics/schema.py", "shard.py",
    "supervisor.py", "topology.py", "utils.py", "version.py",
)
# Copied modules with a few lines changed beyond the rename:
# (reference lines replaced, port lines in their place).
EDITED = {
    "config.py": (2, 2),           # the --backend choices, the NVML binding comments
    # The ctypes driver is the default; the device node is named by minor;
    # IRQ_ISSUE and FUNCTION_NOT_FOUND carry nvml.h's codes.
    "backend/nvml.py": (4, 21),
    # /dev/nvidia<minor> nodes only, sorted by minor; no native scan.
    "backend/discovery.py": (57, 26),
    # Its own _link_sort_key in place of the import from backend/libtpu.
    "backend/recorded.py": (3, 9),
    # GPU prefixes match /dev/nvidia<minor> only, in both /proc walks.
    "procscan.py": (7, 18),
    # The library is this package's own build of native/tpumon.cc, compiled
    # with g++ at first use into _build/, never the JAX package's .so.
    "nativelib.py": (4, 48),
    # --backend torch|nvml (jax and libtpu refused); the GPU scan prefixes.
    "app.py": (16, 32),
    # The WAL restore names GPU series' labels (the reference restores them
    # label-less from the WAL: it looks only in ALL_SPECS); docstring: no
    # history reference.
    "persist.py": (3, 3),
    "metrics/registry.py": (1, 1),  # comment: no history reference
    "pressure.py": (1, 1),          # docstring: no history reference
    "trace.py": (1, 1),             # docstring: no history reference
    "server.py": (3, 3),            # docstring and comment: no history reference
    # --process-metrics scans /dev/nvidia<minor> for a GPU backend, as app.py
    # does (the reference walks /dev/accel and /dev/vfio whatever the backend).
    "status.py": (1, 11),
    # Docstrings: no history reference.
    "stream.py": (1, 1),
    "fleet.py": (1, 1),
    "store.py": (4, 4),
    "alerting.py": (5, 5),
}


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
                 "status"):
        assert f"tpu_pod_exporter_torch.{tier}" in added
    assert [m for m in added if _forbidden(m)] == []
    # The card's path needs neither gRPC nor protobuf nor pynvml: the
    # kubelet podresources client loads them only when it is selected.
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
