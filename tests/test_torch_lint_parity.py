"""The port's exporter-lint against the JAX package's, on the same inputs.

- One synthetic source per rule family goes through both packages'
  engines: the same findings come out (rule, line, severity, and the
  message with the package renamed and the port's two message edits
  applied, :data:`PORT_TEXT`).
- The two packages' real-tree models: the port's holds every lock, every
  order edge (``backend.nvml._InitState.lock ->
  backend.nvml.SimulatedNvmlDriver._lock`` included) and every function's
  thread roles of the reference's, and the committed graphs hold the same
  edges.
- A witnessed run: ``tests/test_torch_nvml.py`` under the port's pytest
  plugin and witness variables, then ``--check-witness`` and
  ``--check-loop-witness`` on its dumps: both exit 0 and the NVML edge is
  among the witnessed ones.
"""

import ast
import json
import os
import re
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest

from tests import torch_lint_shared as shared
from tpu_pod_exporter import analysis as ref_analysis
from tpu_pod_exporter.analysis import concurrency as ref_concurrency
from tpu_pod_exporter.analysis import engine as ref_engine
from tpu_pod_exporter.analysis import execcontext as ref_exec
from tpu_pod_exporter_torch import analysis as port_analysis
from tpu_pod_exporter_torch.analysis import concurrency as port_concurrency
from tpu_pod_exporter_torch.analysis import engine as port_engine
from tpu_pod_exporter_torch.analysis import execcontext as port_exec

REPO_ROOT = shared.REPO_ROOT
NVML_EDGE = ("backend.nvml._InitState.lock", "backend.nvml.SimulatedNvmlDriver._lock")
# The port's messages that differ from the reference's beyond the rename
# (patterns over the reference's text): the lock-io message names no
# change history, and the fork inventory is the port's reviewed copy.
PORT_TEXT = (
    (r"\([A-Z]+ [\d/]+ copy-then-serialize discipline\)", "(the copy-then-serialize discipline)"),
    (r"deploy/fork-inventory\.json", "analysis/reviewed/fork-inventory.json"),
)


def renamed(text: str) -> str:
    text = re.sub(r"\btpu_pod_exporter\b", "tpu_pod_exporter_torch", text)
    for ref, port in PORT_TEXT:
        text = re.sub(ref, port, text)
    return text


def shape(diagnostics, port: bool) -> list[tuple]:
    return sorted((d.rule, d.path if port else renamed(d.path), d.line, d.severity,
                   d.message if port else renamed(d.message))
                  for d in diagnostics)


# ------------------------------------------------------- per-file families

_REGISTRY = dict(
    schema_names={"TPU_HBM_USED_BYTES", "ALL_SPECS", "MetricSpec"},
    metric_names={"tpu_hbm_used_bytes", "tpu_exporter_up"},
)

# (family, module path under the package, source)
PER_FILE = (
    ("lock-io", "mod.py", """
        import json
        def f(self):
            with self._lock:
                return json.dumps({"a": 1})
    """),
    ("metric-name", "mod.py", """
        from tpu_pod_exporter.metrics import schema
        from tpu_pod_exporter.metrics.registry import MetricSpec
        EXTRA = MetricSpec(name="tpu_hbm_used_bytes", help="h")
        def f(counters, b):
            counters.inc("tpu_bogus_total", ())
            b.add(schema.TPU_TYPO_SPEC, 1.0)
    """),
    ("wall-clock", "collector.py", """
        import time
        from datetime import datetime
        def f():
            return time.time(), datetime.now()
    """),
    ("join-timeout", "mod.py", """
        def f(t):
            t.join()
            t.join(timeout=None)
    """),
    ("thread-discipline", "mod.py", """
        import threading
        def f():
            threading.Thread(target=f, daemon=True).start()
            threading.Thread(target=f, name="tpu-x").start()
    """),
    ("bare-except", "mod.py", """
        def f():
            try:
                g()
            except:
                pass
            try:
                g()
            except BaseException:
                pass
    """),
    ("debug-gate", "server.py", """
        def route(self, path):
            if path == "/debug/secrets":
                return self.serve()
    """),
    ("unused-import", "mod.py", """
        import os
        import sys
        print(sys.argv)  # lint: disable=wall-clock(not this rule)
    """),
)


def _per_file(pkg: str, analysis, engine, path: str, src: str) -> list:
    ctx = analysis.LintContext(registry=engine.SchemaRegistry(**_REGISTRY))
    src = re.sub(r"\btpu_pod_exporter\b", pkg, textwrap.dedent(src))
    return analysis.lint_source(src, f"{pkg}/{path}", ctx)


@pytest.mark.parametrize("family,path,src", PER_FILE, ids=[c[0] for c in PER_FILE])
def test_per_file_family_same_findings(family, path, src):
    ref = _per_file("tpu_pod_exporter", ref_analysis, ref_engine, path, src)
    port = _per_file("tpu_pod_exporter_torch", port_analysis, port_engine, path, src)
    assert {d.rule for d in ref} == {family}
    assert shape(port, True) == shape(ref, False)


def _flag_ctx(pkg: str, analysis, engine):
    config = textwrap.dedent("""
        from dataclasses import dataclass

        @dataclass
        class ExporterConfig:
            interval_s: float = 1.0
            dead_knob: int = 0
            undocumented_knob: int = 0
    """)
    trees = {f"{pkg}/config.py": ast.parse(config),
             f"{pkg}/app.py": ast.parse("def f(cfg):\n    return cfg.interval_s, "
                                        "cfg.undocumented_knob\n")}
    return analysis.LintContext(
        registry=engine.SchemaRegistry(), package_trees=trees,
        config_fields=engine._config_fields(config),
        config_relpath=f"{pkg}/config.py",
        docs_text="--interval-s and TPE_DEAD_KNOB")


@pytest.mark.parametrize("family", ["flag-read", "flag-doc"])
def test_flag_family_same_findings(family):
    from tpu_pod_exporter.analysis.rules import RULES_BY_NAME as ref_rules
    from tpu_pod_exporter_torch.analysis.rules import RULES_BY_NAME as port_rules

    ref = ref_rules[family].check_tree(_flag_ctx("tpu_pod_exporter", ref_analysis, ref_engine))
    port = port_rules[family].check_tree(
        _flag_ctx("tpu_pod_exporter_torch", port_analysis, port_engine))
    assert len(ref) == 1 and ref[0].rule == family
    assert shape(port, True) == shape(ref, False)


# ------------------------------------------------- whole-tree model families

_MODEL_SRC = {
    "lock-order": """
import threading

_a = threading.Lock()
_b = threading.Lock()


def one():
    with _a:
        with _b:
            pass


def two():
    with _b:
        with _a:
            pass


class C:
    def __init__(self):
        self._lock = threading.Lock()

    def outer(self):
        with self._lock:
            self.helper()

    def helper(self):
        with self._lock:
            pass
""",
    "lock-io-chain": """
import json
import threading


class C:
    def __init__(self):
        self._lock = threading.Lock()

    def serialize(self, doc):
        return json.dumps(doc)

    def bad(self, doc):
        with self._lock:
            return self.serialize(doc)
""",
    "lock-ownership": """
import threading


class Buf:
    def advance(self):
        pass


class Cache:
    def __init__(self):
        self._lock = threading.Lock()
        self._enabled = True

    def put(self, k, v):
        if not self._enabled:
            return
        with self._lock:
            pass


class Governor:
    def __init__(self, buf: Buf):
        self._buf = buf
        self._thread = threading.Thread(
            target=self._run, name="governor-thread", daemon=True)

    def _run(self):
        self._buf.advance()
""",
}


def _ownership(mod):
    return (mod.OwnershipRule("a.Buf.advance", ("sender-thread",), "single cursor mover"),
            mod.OwnershipRule("a.Cache.put", ("*",), "re-check under lock",
                              guarded_flag="_enabled"),
            mod.OwnershipRule("a.Gone.f", ("x",), "gone"))


def _model_findings(pkg: str, mod, src: str, family: str) -> list:
    m = mod.build_model({f"{pkg}/a.py": ast.parse(src)}, ownership=_ownership(mod))
    return [d for d in m.findings if d.rule == family]


@pytest.mark.parametrize("family", sorted(_MODEL_SRC))
def test_concurrency_family_same_findings(family):
    src = _MODEL_SRC[family]
    ref = _model_findings("tpu_pod_exporter", ref_concurrency, src, family)
    port = _model_findings("tpu_pod_exporter_torch", port_concurrency, src, family)
    assert ref
    assert shape(port, True) == shape(ref, False)


_LOOP_SRC = """
import os
import threading
import time


class _EventLoopServer:
    def call_soon(self, fn):
        self._pending.append(fn)


def _cb():
    time.sleep(0.5)


def _register(loop):
    loop.call_soon(_cb)


def bad(root):
    with open(root + '/cursor.json', 'w') as f:
        f.write('{}')
    os.fork()


class Buf:
    CURSOR_NAME = 'cursor.json'

    def ack(self):
        self._pos += 1
"""
_EXEC_FAMILIES = {"loop-blocking": "check_loop_blocking",
                  "durability-ordering": "check_durability_ordering",
                  "fork-safety": "check_fork_safety"}


@pytest.mark.parametrize("family", sorted(_EXEC_FAMILIES))
def test_exec_family_same_findings(family, monkeypatch):
    out = {}
    for pkg, mod in (("tpu_pod_exporter", ref_exec), ("tpu_pod_exporter_torch", port_exec)):
        monkeypatch.setattr(mod, "CURSOR_MOVERS", ())
        ctx = SimpleNamespace(package_trees={f"{pkg}/server.py": ast.parse(_LOOP_SRC)})
        out[pkg] = getattr(mod, _EXEC_FAMILIES[family])(ctx)
    assert {d.rule for d in out["tpu_pod_exporter"]} == {family}
    assert shape(out["tpu_pod_exporter_torch"], True) == shape(out["tpu_pod_exporter"], False)


# ------------------------------------------------------------- lock graphs


def test_port_lock_graph_holds_every_reference_edge():
    ref = ref_concurrency.get_model(ref_engine.build_context(str(REPO_ROOT)))
    port = shared.model()
    assert set(ref.locks) <= set(port.locks)
    assert set(ref.edges) <= set(port.edges)
    assert NVML_EDGE in ref.edges and NVML_EDGE in port.edges
    assert port.edges[NVML_EDGE].func == "backend.nvml.SimulatedNvmlDriver._maybe_fault"
    # Every function both packages have runs on at least the reference's
    # thread roles in the port's model (the simulated driver's calls under
    # the poll thread included).
    lost = {fq: sorted(set(roles) - set(port.roles[fq]))
            for fq, roles in ref.roles.items()
            if fq in port.roles and set(roles) - set(port.roles[fq])}
    assert lost == {}


def test_committed_port_graph_holds_every_committed_reference_edge():
    def edges(path):
        return {(e["from"], e["to"]) for e in json.loads(path.read_text())["edges"]}

    ref = edges(REPO_ROOT / "deploy" / "lock-graph.json")
    port = edges(shared.REVIEWED / "lock-graph.json")
    assert NVML_EDGE in ref
    assert ref <= port


# -------------------------------------------------------- witnessed run


def test_witnessed_nvml_tests_check_against_the_static_model(tmp_path):
    lock_dump, loop_dump = tmp_path / "lock.json", tmp_path / "loop.json"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPE_LOCK_WITNESS", "TPE_LOOP_WITNESS", "TPE_TORCH_"))}
    env.update(JAX_PLATFORMS="cpu", TPE_TORCH_LOCK_WITNESS="1", TPE_TORCH_LOOP_WITNESS="1",
               TPE_TORCH_LOCK_WITNESS_OUT=str(lock_dump),
               TPE_TORCH_LOOP_WITNESS_OUT=str(loop_dump))
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "tpu_pod_exporter_torch.analysis.pytest_witness", "tests/test_torch_nvml.py"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert "lock witness (tpu_pod_exporter_torch)" in run.stdout
    checks = [subprocess.Popen(
        [sys.executable, "-m", "tpu_pod_exporter_torch.analysis", flag, str(dump)],
        cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for flag, dump in (("--check-witness", lock_dump),
                           ("--check-loop-witness", loop_dump))]
    for proc in checks:
        out, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, out
    doc = json.loads(lock_dump.read_text())
    assert doc["inversions"] == []
    model = shared.model()
    key = {lk["site"]: model.lock_at(lk["path"], lk["line"]).key for lk in doc["locks"]}
    witnessed = {(key[e["from"]], key[e["to"]]) for e in doc["edges"]}
    assert NVML_EDGE in witnessed
    assert json.loads(loop_dump.read_text())["stalls"] == []
