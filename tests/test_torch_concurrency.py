"""The port's static concurrency contract analyzer
(``tpu_pod_exporter_torch/analysis/concurrency.py``): the oracle cases of
the JAX package's concurrency tests, pointed at the port.

Synthetic mini-packages exercise each capability in isolation (lock
discovery, interprocedural edges, cycles, ownership, guarded flags,
witness cross-check); the real-tree tests pin the port's model and its
reviewed artifacts in ``analysis/reviewed/`` — the empty-baseline
acceptance criterion lives here. The real tree is analyzed once
(``torch_lint_shared``).
"""

import ast
import importlib.util
import json
import sys

from tests import torch_lint_shared as shared
from tpu_pod_exporter_torch.analysis import concurrency
from tpu_pod_exporter_torch.analysis.concurrency import (
    ModeledEdge,
    OwnershipRule,
    build_model,
    cross_check,
)


def _trees(**modules: str) -> dict:
    """{"server": src} -> {"tpu_pod_exporter_torch/server.py": ast}."""
    return {
        f"tpu_pod_exporter_torch/{name.replace('.', '/')}.py": ast.parse(src)
        for name, src in modules.items()
    }


def _model(ownership=(), **modules: str):
    return build_model(_trees(**modules), ownership=ownership)


class TestLockDiscovery:
    def test_instance_class_module_and_local_locks(self):
        m = _model(a="""
import threading

_glock = threading.Lock()


class C:
    _clslock = threading.RLock()

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(threading.Lock())

    def f(self):
        tmp = threading.Lock()
        with tmp:
            pass
""")
        keys = set(m.locks)
        assert keys == {
            "a._glock", "a.C._clslock", "a.C._lock", "a.C._cv",
            "a.C.f.<tmp>",
        }
        assert m.locks["a.C._clslock"].kind == "rlock"
        assert m.locks["a.C._cv"].kind == "condition"
        # Creation-site lookup (the witness join key).
        glock = m.locks["a._glock"]
        assert m.lock_at("tpu_pod_exporter_torch/a.py", glock.line) is glock

    def test_dataclass_field_lock_discovered(self):
        m = _model(a="""
import threading
from dataclasses import dataclass, field


@dataclass
class S:
    lock: threading.Lock = field(default_factory=threading.Lock)
""")
        assert "a.S.lock" in m.locks


class TestOrderGraph:
    def test_interprocedural_edge_and_no_false_cycle(self):
        m = _model(a="""
import threading


class Outer:
    def __init__(self):
        self._lock = threading.Lock()
        self._inner = Inner()

    def f(self):
        with self._lock:
            self._inner.g()


class Inner:
    def __init__(self):
        self._lock = threading.Lock()

    def g(self):
        with self._lock:
            pass
""")
        assert set(m.edges) == {("a.Outer._lock", "a.Inner._lock")}
        assert [d for d in m.findings if d.rule == "lock-order"] == []

    def test_opposite_orders_cycle(self):
        m = _model(a="""
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
""")
        cycles = [d for d in m.findings if d.rule == "lock-order"]
        assert len(cycles) == 1
        assert "a._a" in cycles[0].message and "a._b" in cycles[0].message

    def test_self_reacquire_through_call_chain_flagged(self):
        m = _model(a="""
import threading


class C:
    def __init__(self):
        self._lock = threading.Lock()

    def outer(self):
        with self._lock:
            self.helper()

    def helper(self):
        with self._lock:
            pass
""")
        finds = [d for d in m.findings if d.rule == "lock-order"]
        assert len(finds) == 1
        assert "re-acquisition" in finds[0].message

    def test_rlock_self_reacquire_not_flagged(self):
        m = _model(a="""
import threading


class C:
    def __init__(self):
        self._lock = threading.RLock()

    def outer(self):
        with self._lock:
            self.helper()

    def helper(self):
        with self._lock:
            pass
""")
        assert [d for d in m.findings if d.rule == "lock-order"] == []

    def test_cross_module_edge_via_import(self):
        m = _model(
            a="""
import threading
from tpu_pod_exporter_torch.b import Buf


class Store:
    def __init__(self):
        self._lock = threading.Lock()
        self._buf = Buf()

    def replay(self):
        with self._lock:
            self._buf.scan()
""",
            b="""
import threading


class Buf:
    def __init__(self):
        self._lock = threading.Lock()

    def scan(self):
        with self._lock:
            pass
""")
        assert set(m.edges) == {("a.Store._lock", "b.Buf._lock")}


class TestIoChain:
    def test_transitive_io_under_lock_flagged(self):
        m = _model(a="""
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

    def good(self, doc):
        with self._lock:
            snapshot = dict(doc)
        return self.serialize(snapshot)
""")
        finds = [d for d in m.findings if d.rule == "lock-io-chain"]
        assert len(finds) == 1
        assert "a.C.serialize" in finds[0].message
        # Anchored at the call site inside `bad`, not in `good`.
        assert finds[0].line == 15

    def test_call_after_release_not_flagged(self):
        m = _model(a="""
import os
import threading

_lock = threading.Lock()


def flush(f):
    os.fsync(f)


def fine(f):
    with _lock:
        pending = True
    if pending:
        flush(f)
""")
        assert [d for d in m.findings if d.rule == "lock-io-chain"] == []


class TestOwnership:
    _OWN = (OwnershipRule(
        "a.Buf.advance", ("sender-thread",), "single cursor mover"),)

    def test_wrong_thread_reach_flagged(self):
        m = _model(ownership=self._OWN, a="""
import threading


class Buf:
    def advance(self):
        pass


class Governor:
    def __init__(self, buf: Buf):
        self._buf = buf
        self._thread = threading.Thread(
            target=self._run, name="governor-thread", daemon=True)

    def _run(self):
        self._buf.advance()
""")
        finds = [d for d in m.findings if d.rule == "lock-ownership"]
        assert len(finds) == 1
        assert "governor-thread" in finds[0].message
        assert "single cursor mover" in finds[0].message

    def test_owner_thread_clean(self):
        m = _model(ownership=self._OWN, a="""
import threading


class Buf:
    def advance(self):
        pass


class Sender:
    def __init__(self, buf: Buf):
        self._buf = buf
        self._thread = threading.Thread(
            target=self._run, name="sender-thread", daemon=True)

    def _run(self):
        self._buf.advance()
""")
        assert [d for d in m.findings if d.rule == "lock-ownership"] == []

    def test_rotted_table_entry_is_a_finding(self):
        m = _model(
            ownership=(OwnershipRule("a.Gone.f", ("x",), "gone"),),
            a="import threading\n")
        finds = [d for d in m.findings if d.rule == "lock-ownership"]
        assert len(finds) == 1
        assert "table rotted" in finds[0].message

    def test_guarded_flag_read_outside_lock_flagged(self):
        own = (OwnershipRule("a.Cache.put", ("*",), "re-check under lock",
                             guarded_flag="_enabled"),)
        m = _model(ownership=own, a="""
import threading


class Cache:
    def __init__(self):
        self._lock = threading.Lock()
        self._enabled = True

    def put(self, k, v):
        if not self._enabled:
            return
        with self._lock:
            pass
""")
        finds = [d for d in m.findings if d.rule == "lock-ownership"]
        assert len(finds) == 1
        assert "outside the instance lock" in finds[0].message

    def test_guarded_flag_read_inside_lock_clean(self):
        own = (OwnershipRule("a.Cache.put", ("*",), "re-check under lock",
                             guarded_flag="_enabled"),)
        m = _model(ownership=own, a="""
import threading


class Cache:
    def __init__(self):
        self._lock = threading.Lock()
        self._enabled = True

    def put(self, k, v):
        with self._lock:
            if not self._enabled:
                return
""")
        assert [d for d in m.findings if d.rule == "lock-ownership"] == []


class TestThreadRoots:
    def test_roles_from_thread_names_and_closures(self):
        m = _model(a="""
import threading


def work():
    pass


def spawn():
    def closure():
        work()
    t = threading.Thread(target=closure, name="my-worker", daemon=True)
    t.start()
""")
        roots = {(r.role, r.func) for r in m.roots}
        assert ("my-worker", "a.spawn.<closure>") in roots
        # Role propagates through the call graph.
        assert "my-worker" in m.roles["a.work"]


class TestCrossCheck:
    def _real_model(self):
        return shared.model()

    def test_real_witnessed_edge_ok(self):
        m = self._real_model()
        store = next(k for k in m.locks.values()
                     if k.key == "store.FleetStore._lock")
        wal = next(k for k in m.locks.values()
                   if k.key == "persist.WalBuffer._lock")
        dump = {
            "locks": [
                {"site": f"{store.path}:{store.line}", "path": store.path,
                 "line": store.line},
                {"site": f"{wal.path}:{wal.line}", "path": wal.path,
                 "line": wal.line},
            ],
            "edges": [{"from": f"{store.path}:{store.line}",
                       "to": f"{wal.path}:{wal.line}",
                       "example": "test"}],
            "inversions": [],
        }
        assert cross_check(m, dump) == []

    def test_unknown_lock_fails(self):
        m = self._real_model()
        dump = {"locks": [{"site": "tpu_pod_exporter_torch/server.py:1",
                           "path": "tpu_pod_exporter_torch/server.py",
                           "line": 1}],
                "edges": [], "inversions": []}
        problems = cross_check(m, dump)
        assert len(problems) == 1
        assert "no static identity" in problems[0]

    def test_unexplained_edge_fails(self):
        m = self._real_model()
        store = m.locks["store.FleetStore._lock"]
        wal = m.locks["persist.WalBuffer._lock"]
        dump = {
            "locks": [
                {"site": f"{store.path}:{store.line}", "path": store.path,
                 "line": store.line},
                {"site": f"{wal.path}:{wal.line}", "path": wal.path,
                 "line": wal.line},
            ],
            # Reverse of the static edge: never derivable.
            "edges": [{"from": f"{wal.path}:{wal.line}",
                       "to": f"{store.path}:{store.line}",
                       "example": "test"}],
            "inversions": [],
        }
        problems = cross_check(m, dump)
        assert len(problems) == 1
        assert "absent from the static order graph" in problems[0]

    def test_witness_inversion_fails(self):
        m = self._real_model()
        dump = {"locks": [], "edges": [],
                "inversions": [{"kind": "order-inversion",
                                "detail": "A -> B inverts B -> A"}]}
        problems = cross_check(m, dump)
        assert len(problems) == 1
        assert "inversion" in problems[0]

    def test_modeled_edges_explain_witnessed_edges(self):
        m = self._real_model()
        store = m.locks["store.FleetStore._lock"]
        wal = m.locks["persist.WalBuffer._lock"]
        dump = {
            "locks": [
                {"site": f"{store.path}:{store.line}", "path": store.path,
                 "line": store.line},
                {"site": f"{wal.path}:{wal.line}", "path": wal.path,
                 "line": wal.line},
            ],
            "edges": [{"from": f"{wal.path}:{wal.line}",
                       "to": f"{store.path}:{store.line}",
                       "example": "test"}],
            "inversions": [],
        }
        saved = concurrency.MODELED_EDGES
        concurrency.MODELED_EDGES = (ModeledEdge(
            "persist.WalBuffer._lock", "store.FleetStore._lock",
            "test declaration"),)
        try:
            assert cross_check(m, dump) == []
        finally:
            concurrency.MODELED_EDGES = saved


class TestWitnessSites:
    def test_dataclass_field_lock_keyed_by_its_declaration(self, tmp_path):
        """A ``default_factory=threading.Lock`` lock is created by the
        dataclass's generated ``__init__`` (no source file); the witness
        keys it by the field's line, the static pass's key too."""
        from tpu_pod_exporter_torch.analysis import witness
        src = ("import threading\n"
               "from dataclasses import dataclass, field\n\n\n"
               "@dataclass\n"
               "class S:\n"
               "    flag: bool = False\n"
               "    lock: threading.Lock = field(default_factory=threading.Lock)\n")
        path = tmp_path / "dc.py"
        path.write_text(src)
        w = witness.LockWitness(include=(str(tmp_path),), root=str(tmp_path))
        spec = importlib.util.spec_from_file_location("torch_witness_dc", path)
        mod = importlib.util.module_from_spec(spec)
        # The generated __init__ runs in its module's globals, which
        # dataclasses finds through sys.modules.
        sys.modules[spec.name] = mod
        try:
            with w:
                spec.loader.exec_module(mod)
                inst = mod.S()
                with inst.lock:
                    pass
        finally:
            del sys.modules[spec.name]
        assert list(w.lock_sites) == ["dc.py:8"]
        assert w.lock_sites["dc.py:8"]["acquired"] == 1
        m = build_model({"tpu_pod_exporter_torch/dc.py": ast.parse(src)})
        assert m.lock_at("tpu_pod_exporter_torch/dc.py", 8).key == "dc.S.lock"


class TestRealTree:
    """The acceptance criteria: empty baseline on the live package."""

    def test_no_concurrency_findings_on_real_tree(self):
        findings = [
            d for d in shared.findings()
            if d.rule in ("lock-order", "lock-ownership", "lock-io-chain")
        ]
        assert findings == [], "\n".join(d.format() for d in findings)

    def test_real_tree_model_shape(self):
        """Pins the load-bearing facts of the committed lock graph: the
        known edges exist, every lock resolves, the contract threads are
        rooted. If this breaks, analysis/reviewed/lock-graph.json needs
        review (and regeneration via --lock-graph)."""
        m = shared.model()
        assert len(m.locks) >= 35
        assert m.unresolved_acquires == []
        assert ("store.FleetStore._lock", "persist.WalBuffer._lock") \
            in m.edges
        roles = {r.role for r in m.roots}
        for expected in ("tpu-exporter-poll", "tpu-egress-sender",
                         "tpu-egress-writer", "tpu-exporter-pressure",
                         "tpu-exporter-persist",
                         "tpu-exporter-http-worker-*"):
            assert expected in roles, expected
        # Ownership table functions all exist (no rot).
        for rule in concurrency.OWNERSHIP:
            assert rule.func in m.functions, rule.func

    def test_sender_owns_enforce_caps(self):
        """The egress cap-enforcement path is reachable ONLY from the
        sender thread — the single-consumer discipline the prose in
        egress.py promises."""
        m = shared.model()
        roles = set(m.roles["egress.RemoteWriteShipper._enforce_caps"])
        assert roles == {"tpu-egress-sender"}

    def test_committed_lock_graph_matches_model(self):
        """analysis/reviewed/lock-graph.json is a REVIEWED artifact:
        regenerating it must be a no-op against the committed copy, the
        JSON and the DOT rendering alike."""
        committed = shared.REVIEWED / "lock-graph.json"
        m = shared.model()
        regen = ("python -m tpu_pod_exporter_torch.analysis --lock-graph "
                 "tpu_pod_exporter_torch/analysis/reviewed/lock-graph.json "
                 "--lock-graph-dot "
                 "tpu_pod_exporter_torch/analysis/reviewed/lock-graph.dot")
        assert committed.exists(), f"run: {regen}"
        assert json.loads(committed.read_text()) == json.loads(
            json.dumps(m.graph_json(), sort_keys=True)), \
            f"stale analysis/reviewed/lock-graph.json — run: {regen}"
        assert (shared.REVIEWED / "lock-graph.dot").read_text() == \
            m.graph_dot(), f"stale analysis/reviewed/lock-graph.dot — run: {regen}"
