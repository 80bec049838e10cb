"""The port's execution-context contracts
(``tpu_pod_exporter_torch/analysis/execcontext.py``): the oracle cases of
the JAX package's execcontext tests, pointed at the port.

Synthetic mini-packages exercise each rule family in isolation
(loop-blocking role propagation + laundering, durability state-write /
fsync-reach / single-mover legs, fork-safety + inventory); the runtime
LoopWitness and the static<->witness cross-check get unit coverage; the
real-tree tests pin the contracts CI actually enforces — the scrape fast
path stays loop-legal, ``_WorkerPool.submit`` launders the blocking set,
cursor movers are sender-thread-only, and the committed fork inventory
(``analysis/reviewed/fork-inventory.json``) is fresh. The real tree is
analyzed once (``torch_lint_shared``).
"""

import ast
import functools
import json
from types import SimpleNamespace

from tests import torch_lint_shared as shared
from tpu_pod_exporter_torch.analysis import execcontext, witness
from tpu_pod_exporter_torch.analysis.concurrency import build_model
from tpu_pod_exporter_torch.analysis.execcontext import (
    CursorMoverRule,
    LoopAllowance,
    check_durability_ordering,
    check_fork_safety,
    check_loop_blocking,
    cross_check_loop,
    fork_inventory,
)


def _trees(**modules: str) -> dict:
    """{"server": src} -> {"tpu_pod_exporter_torch/server.py": ast}."""
    return {
        f"tpu_pod_exporter_torch/{name.replace('.', '/')}.py": ast.parse(src)
        for name, src in modules.items()
    }


def _ctx(**modules: str):
    """Minimal LintContext stand-in: the exec rules only touch
    ``package_trees`` plus the memo attributes get_model/get_exec_model
    hang on the context."""
    return SimpleNamespace(package_trees=_trees(**modules))


# A synthetic event-loop server: the class/method names are what
# CALLBACK_ROLES keys role seeding on, so callbacks registered through
# call_soon get the tpu-exporter-http role exactly like the real tree.
_LOOP_SRC = """
import threading
import time


class _EventLoopServer:
    def call_soon(self, fn):
        self._pending.append(fn)

    def call_later(self, delay, fn):
        self._timers.append((delay, fn))
"""


class TestLoopBlocking:
    def test_inline_sleep_on_loop_flagged(self):
        diags = check_loop_blocking(_ctx(server=_LOOP_SRC + """

def _cb():
    time.sleep(0.5)


def _register(loop):
    loop.call_soon(_cb)
"""))
        assert len(diags) == 1
        assert diags[0].rule == "loop-blocking"
        assert "time.sleep" in diags[0].message
        assert "_cb" in diags[0].message

    def test_transitive_blocking_through_helper_flagged(self):
        # The helper is not registered anywhere — but the role fixpoint
        # tags it through the call edge, so its direct open() is caught.
        diags = check_loop_blocking(_ctx(server=_LOOP_SRC + """

def _helper(path):
    with open(path) as f:
        return f.read()


def _cb():
    return _helper('/etc/hostname')


def _register(loop):
    loop.call_soon(_cb)
"""))
        assert any("_helper" in d.message and "open()" in d.message
                   for d in diags)

    def test_clean_callback_not_flagged(self):
        diags = check_loop_blocking(_ctx(server=_LOOP_SRC + """

def _cb():
    return 1 + 1


def _register(loop):
    loop.call_soon(_cb)
"""))
        assert diags == []

    def test_worker_pool_submit_launders(self):
        # The closure handed to pool.submit runs on a worker, not the
        # loop — its blocking work must NOT be a loop finding.
        diags = check_loop_blocking(_ctx(server=_LOOP_SRC + """

def _cb(pool):
    def run():
        time.sleep(1.0)
    pool.submit(run)


def _register(loop, pool):
    loop.call_soon(_cb)
"""))
        assert diags == []

    def test_lock_with_blocking_holder_flagged(self):
        # The loop only increments under the lock, but another thread
        # holds the same lock across file I/O — acquiring it on the loop
        # can park the loop for that I/O.
        diags = check_loop_blocking(_ctx(server=_LOOP_SRC + """

_lock = threading.Lock()


def _cb():
    with _lock:
        pass


def _register(loop):
    loop.call_soon(_cb)


def _writer_main():
    with _lock:
        with open('/tmp/x', 'w') as f:
            f.write('x')


def _start():
    threading.Thread(target=_writer_main, name='tpu-writer',
                     daemon=True).start()
"""))
        assert any("server._lock" in d.message
                   and "_writer_main" in d.message for d in diags)

    def test_lock_without_blocking_holder_clean(self):
        diags = check_loop_blocking(_ctx(server=_LOOP_SRC + """

_lock = threading.Lock()


def _cb():
    with _lock:
        pass


def _register(loop):
    loop.call_soon(_cb)


def _writer_main():
    with _lock:
        pass


def _start():
    threading.Thread(target=_writer_main, name='tpu-writer',
                     daemon=True).start()
"""))
        assert diags == []

    def test_allowance_exempts_and_rots(self, monkeypatch):
        src = _LOOP_SRC + """

def _cb():
    time.sleep(0.5)


def _register(loop):
    loop.call_soon(_cb)
"""
        monkeypatch.setattr(execcontext, "LOOP_ALLOWED", (
            LoopAllowance("server._cb", "test exemption"),))
        assert check_loop_blocking(_ctx(server=src)) == []
        # A stale allowance (no such function) is itself a finding.
        monkeypatch.setattr(execcontext, "LOOP_ALLOWED", (
            LoopAllowance("server._gone", "rotted"),))
        diags = check_loop_blocking(_ctx(server=src))
        assert any("LOOP_ALLOWED" in d.message and "_gone" in d.message
                   for d in diags)


class TestDurabilityOrdering:
    def test_raw_open_on_state_path_flagged(self, monkeypatch):
        monkeypatch.setattr(execcontext, "CURSOR_MOVERS", ())
        diags = check_durability_ordering(_ctx(a="""
def bad(root):
    with open(root + '/cursor.json', 'w') as f:
        f.write('{}')
"""))
        assert len(diags) == 1
        assert "atomic_write" in diags[0].message

    def test_read_open_and_non_state_path_clean(self, monkeypatch):
        monkeypatch.setattr(execcontext, "CURSOR_MOVERS", ())
        assert check_durability_ordering(_ctx(a="""
def ok(root):
    with open(root + '/cursor.json') as f:
        data = f.read()
    with open(root + '/notes.txt', 'w') as f:
        f.write(data)
""")) == []

    def test_named_constant_resolved_cross_module(self, monkeypatch):
        # The basename literal lives in module a; module b writes
        # through the imported name — still a finding.
        monkeypatch.setattr(execcontext, "CURSOR_MOVERS", ())
        diags = check_durability_ordering(_ctx(
            a="STATUS_NAME = 'egress-status.json'\n",
            b="""
import os

from tpu_pod_exporter_torch.a import STATUS_NAME


def bad(root):
    with open(os.path.join(root, STATUS_NAME), 'w') as f:
        f.write('{}')
"""))
        assert len(diags) == 1
        assert "b.bad" in diags[0].message

    def test_mover_without_fsync_reach_flagged(self, monkeypatch):
        monkeypatch.setattr(execcontext, "CURSOR_MOVERS", ())
        diags = check_durability_ordering(_ctx(a="""
class Buf:
    CURSOR_NAME = 'cursor.json'

    def ack(self):
        self._pos += 1
"""))
        assert any("a.Buf.ack" in d.message
                   and "fsync-reachable" in d.message for d in diags)

    def test_mover_reaching_atomic_write_clean(self, monkeypatch):
        monkeypatch.setattr(execcontext, "CURSOR_MOVERS", ())
        assert check_durability_ordering(_ctx(a="""
import json
import os


def atomic_write(path, data):
    with open(path + '.tmp', 'wb') as f:
        f.write(data)
        os.fsync(f.fileno())
    os.replace(path + '.tmp', path)


class Buf:
    CURSOR_NAME = 'cursor.json'

    def ack(self):
        self._advance(1)

    def _advance(self, n):
        self._pos += n
        atomic_write(self._cursor, json.dumps({'pos': self._pos}).encode())
""")) == []

    def test_undeclared_buffer_flagged(self, monkeypatch):
        monkeypatch.setattr(execcontext, "CURSOR_MOVERS", ())
        diags = check_durability_ordering(_ctx(m="""
from tpu_pod_exporter_torch.persist import WalBuffer


class Sub:
    def __init__(self):
        self.buf = WalBuffer('/tmp/x')
"""))
        assert any("m.Sub.buf" in d.message
                   and "no declared mover role" in d.message for d in diags)

    def test_second_mover_thread_flagged(self, monkeypatch):
        monkeypatch.setattr(execcontext, "CURSOR_MOVERS", (
            CursorMoverRule("m.Sub.buf", "tpu-mover-a", "test"),))
        diags = check_durability_ordering(_ctx(m="""
import threading

from tpu_pod_exporter_torch.persist import WalBuffer


class Sub:
    def __init__(self):
        self.buf = WalBuffer('/tmp/x')
        self._ta = threading.Thread(target=self._move_a,
                                    name='tpu-mover-a', daemon=True)
        self._tb = threading.Thread(target=self._move_b,
                                    name='tpu-mover-b', daemon=True)

    def _move_a(self):
        self.buf.ack()

    def _move_b(self):
        self.buf.trim_to_bytes(0)
"""))
        offenders = [d for d in diags if "tpu-mover-b" in d.message]
        assert len(offenders) == 1
        assert "tpu-mover-a" in offenders[0].message  # names the owner
        assert not any("tpu-mover-a'," in d.message for d in diags
                       if d not in offenders)

    def test_declaration_rot_flagged_demo_exempt(self, monkeypatch):
        monkeypatch.setattr(execcontext, "CURSOR_MOVERS", (
            CursorMoverRule("m.Gone.buf", "tpu-x", "stale"),))
        diags = check_durability_ordering(_ctx(m="x = 1\n"))
        assert any("m.Gone.buf" in d.message and "rotted" in d.message
                   for d in diags)
        monkeypatch.setattr(execcontext, "CURSOR_MOVERS", (
            CursorMoverRule("m.Gone.buf", "tpu-x", "seed", demo=True),))
        assert check_durability_ordering(_ctx(m="x = 1\n")) == []


class TestForkSafety:
    def test_os_fork_flagged(self):
        diags = check_fork_safety(_ctx(a="""
import os


def f():
    os.fork()
"""))
        assert len(diags) == 1
        assert "os.fork" in diags[0].message

    def test_multiprocessing_flagged(self):
        diags = check_fork_safety(_ctx(a="""
import multiprocessing


def f():
    return multiprocessing.Process(target=print)
"""))
        assert any("multiprocessing.Process" in d.message for d in diags)

    def test_import_time_thread_and_fd_flagged(self):
        diags = check_fork_safety(_ctx(a="""
import socket
import threading

_t = threading.Thread(target=print, name='tpu-x', daemon=True)
_s = socket.socket()
"""))
        assert any("thread created at import time" in d.message
                   for d in diags)
        assert any("socket created at import time" in d.message
                   for d in diags)

    def test_function_scoped_creation_clean(self):
        assert check_fork_safety(_ctx(a="""
import socket
import threading


def start():
    t = threading.Thread(target=print, name='tpu-x', daemon=True)
    s = socket.socket()
    return t, s
""")) == []

    def test_inventory_shape_and_retention(self):
        m = build_model(_trees(a="""
import mmap
import socket
import threading

_lock = threading.Lock()


class S:
    def __init__(self):
        self._sock = socket.socket()
        self._r, self._w = socket.socketpair()
        transient = socket.socket()
        transient.close()

    def start(self):
        self._t = threading.Thread(target=self._run, name='tpu-s',
                                   daemon=True)
        self._t.start()

    def _run(self):
        pass
"""))
        inv = fork_inventory(m)
        assert [t["role"] for t in inv["threads"]] == ["tpu-s"]
        assert inv["threads"][0]["entry"] == "a.S._run"
        assert [lk["key"] for lk in inv["locks"]] == ["a._lock"]
        by_retained = {k["retained_as"]: k for k in inv["kernel_objects"]}
        assert by_retained["self._sock"]["kind"] == "socket"
        assert by_retained["self._r, self._w"]["kind"] == "socketpair"
        assert "<transient>" in by_retained
        # Stable identities only — no line numbers anywhere.
        assert all("line" not in rec
                   for section in ("threads", "locks", "kernel_objects")
                   for rec in inv[section])


class TestLoopWitness:
    def test_install_swaps_and_uninstall_restores_probe(self):
        from tpu_pod_exporter_torch import server
        before = server.LOOP_PROBE
        lw = witness.LoopWitness(stall_ms=100)
        with lw:
            assert server.LOOP_PROBE == lw._observe
        assert server.LOOP_PROBE is before
        # Idempotent uninstall.
        lw.uninstall()
        assert server.LOOP_PROBE is before

    def test_threshold_splits_stalls_from_aggregates(self):
        lw = witness.LoopWitness(stall_ms=50)

        def cb():
            pass

        lw._observe("pending", cb, 0.010)   # 10 ms: aggregate only
        lw._observe("pending", cb, 0.200)   # 200 ms: stall
        doc = lw.report()
        assert doc["meta"]["callbacks"] == 1
        [rec] = doc["callbacks"]
        assert rec["count"] == 2
        assert rec["max_ms"] == 200.0
        assert rec["kinds"] == ["pending"]
        [stall] = doc["stalls"]
        assert stall["ms"] == 200.0
        assert stall["qualname"].endswith("cb")

    def test_identity_unwraps_partials_and_bound_methods(self):
        lw = witness.LoopWitness(stall_ms=1000)

        class C:
            def m(self):
                pass

        bound = C().m
        lw._observe("timer", functools.partial(bound), 0.001)
        [(module, qualname, line)] = list(lw.callbacks)
        assert qualname.endswith("C.m")
        assert line == C.m.__code__.co_firstlineno
        assert module == __name__

    def test_dump_round_trips_through_loader(self, tmp_path):
        lw = witness.LoopWitness(stall_ms=10)
        lw._observe("read", len, 0.5)
        out = tmp_path / "loop-witness.json"
        lw.dump(str(out))
        doc = witness.load_dump(str(out))
        assert doc["meta"]["kind"] == "loop-witness"
        assert doc["meta"]["stalls"] == 1

    def test_real_dispatch_is_timed_through_probe(self):
        # End to end through the real server seam: _invoke must route
        # every callback through LOOP_PROBE while installed.
        from tpu_pod_exporter_torch import server
        loop = server._EventLoopServer.__new__(server._EventLoopServer)
        ran = []
        with witness.LoopWitness(stall_ms=1000) as lw:
            server._EventLoopServer._invoke(
                loop, "pending", lambda: ran.append(1))
        assert ran == [1]
        assert len(lw.callbacks) == 1


class TestCrossCheckLoop:
    def _loop_model(self):
        return build_model(_trees(server=_LOOP_SRC + """

def _cb():
    return 1


def _register(loop):
    loop.call_soon(_cb)
"""))

    def test_clean_dump_passes(self):
        m = self._loop_model()
        dump = {"meta": {}, "stalls": [], "callbacks": [{
            "module": "tpu_pod_exporter_torch.server", "qualname": "_cb",
            "line": 1, "count": 3,
        }]}
        assert cross_check_loop(m, dump) == []

    def test_stall_is_a_problem(self):
        problems = cross_check_loop(self._loop_model(), {
            "meta": {"threshold_ms": 500}, "callbacks": [],
            "stalls": [{"qualname": "_cb", "kind": "timer", "ms": 900}],
        })
        assert len(problems) == 1
        assert "stall" in problems[0]

    def test_unknown_callback_is_model_rot(self):
        problems = cross_check_loop(self._loop_model(), {
            "meta": {}, "stalls": [], "callbacks": [{
                "module": "tpu_pod_exporter_torch.server",
                "qualname": "_ghost", "line": 1,
            }]})
        assert len(problems) == 1
        assert "no static identity" in problems[0]

    def test_unroled_callback_is_propagation_rot(self):
        # _orphan exists in the tree but nothing loop-registers it.
        m = build_model(_trees(server=_LOOP_SRC + """

def _orphan():
    return 1
"""))
        problems = cross_check_loop(m, {
            "meta": {}, "stalls": [], "callbacks": [{
                "module": "tpu_pod_exporter_torch.server",
                "qualname": "_orphan", "line": 1,
            }]})
        assert len(problems) == 1
        assert "not loop-role-tagged" in problems[0]

    def test_out_of_package_callbacks_skipped(self):
        assert cross_check_loop(self._loop_model(), {
            "meta": {}, "stalls": [], "callbacks": [
                {"module": "selectors", "qualname": "x", "line": 1},
                {"module": "tests.test_server", "qualname": "y", "line": 1},
            ]}) == []

    def test_lambda_inside_lambda_resolves_by_its_line(self):
        # A writer lambda posting a lambda to the loop (the stream route's
        # shape): the runtime qualname drops the outer lambda's line, the
        # model names both lambdas by line.
        src = _LOOP_SRC + """

def _cb():
    return 1


def _register(loop, hub):
    hub.subscribe(writer=lambda payload: loop.call_soon(
        lambda: _cb()))
"""
        line = src.splitlines().index("        lambda: _cb()))") + 1
        m = build_model(_trees(server=src))
        assert cross_check_loop(m, {"meta": {}, "stalls": [], "callbacks": [{
            "module": "tpu_pod_exporter_torch.server",
            "qualname": "_register.<locals>.<lambda>.<locals>.<lambda>",
            "line": line,
        }]}) == []

    def test_runtime_qualname_mapping(self):
        fn = execcontext._static_qualname
        assert fn("tpu_pod_exporter_torch.server",
                  "A.f.<locals>.g.<locals>.<lambda>", 42) \
            == "server.A.f.<g>.<lambda@42>"
        assert fn("tpu_pod_exporter_torch", "top", 1) == "top"
        assert fn("othermod", "x", 1) is None


class TestRealTree:
    def test_real_tree_clean_under_exec_families(self):
        findings = [
            d for d in shared.findings()
            if d.rule in ("loop-blocking", "durability-ordering",
                          "fork-safety")
        ]
        assert findings == []

    def test_scrape_fast_path_is_inspected_and_loop_legal(self):
        em = shared.exec_model()
        # The inline fast path IS under the loop role (so the rule covers
        # it) — and it survives the rule (previous test): cached bytes
        # only, encode/gzip happen off-loop.
        assert "server._EventLoopServer._metrics_response" in em.loop_funcs
        assert "server._EventLoopServer._try_write" in em.loop_funcs

    def test_worker_pool_submit_launders_real_defer(self):
        em = shared.exec_model()
        m = em.model
        # The deferred closure runs on a worker, never the loop...
        run = "server._EventLoopServer._defer.<run>"
        assert run not in em.loop_funcs
        assert any("worker" in role for role in m.roles.get(run, {}))
        # ...while its completion callback posts BACK to the loop.
        assert f"{run}.<fail>" in em.loop_funcs

    def test_cursor_movers_are_sender_thread_only(self):
        em = shared.exec_model()
        assert set(em.buffers) == {
            "egress.RemoteWriteShipper.buffer",
            "alerting.AlertNotifier.buffer",
            "store.FleetStore.*",
        }
        declared = {r.buffer: r.role for r in execcontext.CURSOR_MOVERS}
        for ident, sites in em.mover_sites.items():
            for fq, _line, _path, roles in sites:
                for role in roles:
                    assert role == declared[ident], (ident, fq, role)

    def test_committed_fork_inventory_matches_model(self):
        em = shared.exec_model()
        committed = json.loads(
            (shared.REVIEWED / "fork-inventory.json").read_text())
        assert committed == fork_inventory(em.model), (
            "analysis/reviewed/fork-inventory.json is stale — run `python "
            "-m tpu_pod_exporter_torch.analysis --fork-inventory "
            "tpu_pod_exporter_torch/analysis/reviewed/fork-inventory.json` "
            "and review the pre-fork surface change")

    def test_loop_witness_dump_cross_checks_against_real_model(self):
        # Drive the real dispatch seam once and cross-check the witness's
        # record against the real tree's static model — the same join CI
        # performs on the full tier-1 replay.
        import socket

        from tpu_pod_exporter_torch import server
        em = shared.exec_model()
        loop = server._EventLoopServer.__new__(server._EventLoopServer)
        r, w = socket.socketpair()
        r.setblocking(False)
        loop._wake_r = r
        try:
            with witness.LoopWitness(stall_ms=10_000) as lw:
                loop._invoke("wake", loop._drain_wake)
        finally:
            r.close()
            w.close()
        problems = cross_check_loop(em.model, lw.report())
        assert problems == []
