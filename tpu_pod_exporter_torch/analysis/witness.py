"""Runtime lock witness — the dynamic half of the concurrency contract.

Wraps ``threading.Lock``/``threading.RLock`` (factory patch, scoped to
locks *created by package code*: the creating frame's file must sit under
one of the configured include paths, so stdlib ``queue``/``logging``
locks stay untouched) and records, per thread:

* the **acquisition-order edges** actually exercised — acquiring B while
  holding A records edge ``A -> B``, keyed by each lock's creation site,
  which is exactly the identity the static pass in
  :mod:`.concurrency` assigns. CI replays the tier-1 suite under the
  witness and cross-checks every observed edge against the static order
  graph: an edge the model cannot explain fails the build.
* **order inversions**, lockdep-style: recording ``A -> B`` when a path
  ``B -> ... -> A`` was already witnessed is a deadlock candidate *even
  if no deadlock happened on this run* — two threads interleaving those
  two paths can deadlock. Same-instance blocking re-acquisition of a
  non-reentrant lock is recorded as a self-deadlock. RLock re-entry by
  the owning thread is NOT an edge and NOT an inversion.
  A dataclass field's ``default_factory=threading.Lock`` runs inside the
  generated ``__init__``, which has no source file: such a lock is keyed
  by the field's declaration line, where the static pass keys it too.
* **held wall-time** per lock class, with a warn list for holds past a
  threshold (``TPE_TORCH_LOCK_WITNESS_HOLD_MS``, default 250 ms) — long holds
  are reported in the dump for review, never a hard failure (CI runners
  stall arbitrarily; a wall-time gate would flake).

Installed by the pytest plugin ``analysis/pytest_witness.py`` under
``TPE_TORCH_LOCK_WITNESS=1``; the edge dump lands at
``TPE_TORCH_LOCK_WITNESS_OUT`` (default ``torch-lock-witness.json``) and
``python -m tpu_pod_exporter_torch.analysis
--check-witness <dump>`` performs the static/dynamic cross-check.

The witness's own bookkeeping uses a raw ``_thread`` lock allocated
before any patching, so it can never observe (or deadlock) itself.

This module also hosts :class:`LoopWitness` — the runtime half of the
loop-blocking contract (``TPE_TORCH_LOOP_WITNESS=1``): it hooks the event
loop's dispatch choke point (``server.LOOP_PROBE``) and times every
callback the loop runs inline, failing the session on stalls.
"""

from __future__ import annotations

import _thread
import ast
import functools
import json
import os
import sys
import threading
import time
from typing import Any, Callable

# Captured at import time — the real factories, never the patched ones.
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

_MAX_LONG_HOLDS = 200
_MAX_INVERSIONS = 200
_DATACLASS_DEFAULT = "__dataclass_dflt_"


@functools.lru_cache(maxsize=None)
def _field_line(path: str, cls_name: str, field_name: str) -> int | None:
    """Line of ``field_name: ...`` in class ``cls_name`` of ``path``."""
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError):
        return None
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            for stmt in node.body:
                if (isinstance(stmt, ast.AnnAssign)
                        and isinstance(stmt.target, ast.Name)
                        and stmt.target.id == field_name):
                    return stmt.lineno
    return None


def _creation_site(frame: Any, factory: Callable) -> tuple[str, int] | None:
    """(file, line) that created a lock: the calling frame, or for a
    dataclass ``default_factory`` (called from the generated ``__init__``,
    file ``<string>``) the field's declaration in the class's module."""
    code = frame.f_code
    if code.co_filename != "<string>":
        return os.path.abspath(code.co_filename), frame.f_lineno
    if code.co_name != "__init__":
        return None
    local = frame.f_locals
    inst = local.get("self")
    path = frame.f_globals.get("__file__")
    field_name = next((k[len(_DATACLASS_DEFAULT):-2] for k, v in local.items()
                       if v is factory and k.startswith(_DATACLASS_DEFAULT)),
                      None)
    if inst is None or not path or not field_name:
        return None
    path = os.path.abspath(path)
    line = _field_line(path, type(inst).__name__, field_name)
    return None if line is None else (path, line)


class _WitnessLock:
    """Delegating wrapper around a real lock. Supports the full
    Lock/RLock surface (context manager, acquire/release/locked);
    anything exotic falls through to the inner lock."""

    __slots__ = ("_witness", "_inner", "site", "kind")

    def __init__(self, witness: "LockWitness", inner: Any,
                 site: str, kind: str) -> None:
        self._witness = witness
        self._inner = inner
        self.site = site
        self.kind = kind

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking and self.kind == "lock":
            # About to block on a lock this thread already holds: record
            # the self-deadlock BEFORE parking forever on it.
            self._witness._note_self_deadlock_if_held(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._witness._on_acquired(self)
        return ok

    def release(self) -> None:
        self._witness._on_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "_WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def __getattr__(self, name: str) -> Any:
        return getattr(object.__getattribute__(self, "_inner"), name)


class LockWitness:
    """Factory-patching lock witness. One instance per process; install/
    uninstall are idempotent and restore the real factories."""

    def __init__(
        self,
        include: tuple[str, ...] = (),
        root: str | None = None,
        hold_warn_ms: float | None = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        # Default scope: the tpu_pod_exporter_torch package, minus analysis/
        # (the witness's own home must not observe itself).
        pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        self.root = os.path.abspath(root or os.path.dirname(pkg_dir))
        self.include = tuple(os.path.abspath(p) for p in include) or (pkg_dir,)
        self.exclude = (os.path.join(pkg_dir, "analysis"),)
        if hold_warn_ms is None:
            hold_warn_ms = float(
                os.environ.get("TPE_TORCH_LOCK_WITNESS_HOLD_MS", "250"))
        self.hold_warn_ms = hold_warn_ms
        self._clock = clock
        self._mutex = _thread.allocate_lock()
        self._tls = threading.local()
        self._installed = False
        self._saved: tuple = (_REAL_LOCK, _REAL_RLOCK)
        # site -> {"path","line","kind","created","acquired"}
        self.lock_sites: dict[str, dict] = {}
        # (src_site, dst_site) -> {"count", "example"}
        self.edges: dict[tuple[str, str], dict] = {}
        self._adj: dict[str, set[str]] = {}
        self.inversions: list[dict] = []
        self.long_holds: list[dict] = []
        self.max_hold_ms: dict[str, float] = {}
        self.acquisitions = 0

    # ------------------------------------------------------------ patching

    def install(self) -> "LockWitness":
        if not self._installed:
            # Save whatever factories are live (possibly another witness,
            # e.g. the env-installed one while a test drives its own) and
            # wrap the RAW primitives — witnesses never stack.
            self._saved = (threading.Lock, threading.RLock)
            threading.Lock = self._factory("lock", _REAL_LOCK)  # type: ignore[misc]
            threading.RLock = self._factory("rlock", _REAL_RLOCK)  # type: ignore[misc]
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            threading.Lock, threading.RLock = self._saved  # type: ignore[misc]
            self._installed = False

    def __enter__(self) -> "LockWitness":
        return self.install()

    def __exit__(self, *exc: object) -> None:
        self.uninstall()

    def _factory(self, kind: str, real: Callable[[], Any]) -> Callable:
        def make() -> Any:
            inner = real()
            created = _creation_site(sys._getframe(1), make)
            if created is None:
                return inner
            fn, line = created
            if not any(fn.startswith(p + os.sep) or fn == p
                       for p in self.include):
                return inner
            if any(fn.startswith(p + os.sep) for p in self.exclude):
                return inner
            rel = os.path.relpath(fn, self.root).replace(os.sep, "/")
            site = f"{rel}:{line}"
            with self._mutex:
                rec = self.lock_sites.setdefault(site, {
                    "site": site, "path": rel, "line": line,
                    "kind": kind, "created": 0, "acquired": 0,
                })
                rec["created"] += 1
            return _WitnessLock(self, inner, site, kind)

        make.__name__ = f"witness_{kind}_factory"
        return make

    # ----------------------------------------------------------- recording

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _note_self_deadlock_if_held(self, lk: _WitnessLock) -> None:
        for held, _t0, _re in self._stack():
            if held is lk:
                with self._mutex:
                    if len(self.inversions) < _MAX_INVERSIONS:
                        self.inversions.append({
                            "kind": "self-deadlock",
                            "detail": (
                                f"thread {threading.current_thread().name!r} "
                                f"blocking-acquires non-reentrant lock "
                                f"{lk.site} it already holds "
                                f"(at {self._caller_site()})"
                            ),
                        })
                return

    def _on_acquired(self, lk: _WitnessLock) -> None:
        stack = self._stack()
        reenter = any(held is lk for held, _t0, _re in stack)
        if not reenter:
            held_sites = [held.site for held, _t0, _re in stack
                          if not _re and held.site != lk.site]
            if held_sites:
                self._record_edges(held_sites, lk.site)
            with self._mutex:
                self.acquisitions += 1
                rec = self.lock_sites.get(lk.site)
                if rec is not None:
                    rec["acquired"] += 1
        stack.append((lk, self._clock(), reenter))

    def _on_release(self, lk: _WitnessLock) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is lk:
                _held, t0, reenter = stack.pop(i)
                if not reenter:
                    held_ms = (self._clock() - t0) * 1000.0
                    with self._mutex:
                        prev = self.max_hold_ms.get(lk.site, 0.0)
                        if held_ms > prev:
                            self.max_hold_ms[lk.site] = held_ms
                        if (held_ms > self.hold_warn_ms
                                and len(self.long_holds) < _MAX_LONG_HOLDS):
                            self.long_holds.append({
                                "site": lk.site,
                                "held_ms": round(held_ms, 3),
                                "thread": threading.current_thread().name,
                            })
                return
        # Release of a lock this thread never acquired (ownership handed
        # across threads — Condition internals do this legitimately
        # during wait()); nothing to unwind.

    def _record_edges(self, held_sites: list[str], dst: str) -> None:
        thread = threading.current_thread().name
        with self._mutex:
            for src in held_sites:
                key = (src, dst)
                rec = self.edges.get(key)
                if rec is not None:
                    rec["count"] += 1
                    continue
                example = (f"thread {thread!r} at {self._caller_site()}")
                self.edges[key] = {"count": 1, "example": example}
                self._adj.setdefault(src, set()).add(dst)
                # Inversion: a path dst -> ... -> src already witnessed.
                path = self._find_path(dst, src)
                if path is not None and len(self.inversions) < _MAX_INVERSIONS:
                    self.inversions.append({
                        "kind": "order-inversion",
                        "detail": (
                            f"edge {src} -> {dst} ({example}) inverts the "
                            f"already-witnessed order "
                            f"{' -> '.join(path)}"
                        ),
                    })

    def _find_path(self, start: str, goal: str) -> list[str] | None:
        if start not in self._adj:
            return None
        prev: dict[str, str] = {}
        work = [start]
        seen = {start}
        while work:
            cur = work.pop()
            for nxt in self._adj.get(cur, ()):
                if nxt in seen:
                    continue
                prev[nxt] = cur
                if nxt == goal:
                    path = [goal]
                    while path[-1] != start:
                        path.append(prev[path[-1]])
                    path.reverse()
                    return path
                seen.add(nxt)
                work.append(nxt)
        return None

    @staticmethod
    def _caller_site() -> str:
        """First stack frame outside this module — where the acquire
        physically happened (diagnostics only; edge identity is the
        creation site)."""
        f = sys._getframe(2)
        here = os.path.abspath(__file__)
        while f is not None:
            fn = os.path.abspath(f.f_code.co_filename)
            if fn != here:
                return f"{fn}:{f.f_lineno}"
            back = f.f_back
            if back is None:
                break
            f = back
        return "<unknown>"

    # ----------------------------------------------------------- reporting

    def report(self) -> dict:
        with self._mutex:
            return {
                "meta": {
                    "acquisitions": self.acquisitions,
                    "hold_warn_ms": self.hold_warn_ms,
                    "locks": len(self.lock_sites),
                    "edges": len(self.edges),
                },
                "locks": [
                    dict(rec) for _, rec in sorted(self.lock_sites.items())
                ],
                "edges": [
                    {"from": src, "to": dst, **rec}
                    for (src, dst), rec in sorted(self.edges.items())
                ],
                "inversions": list(self.inversions),
                "long_holds": list(self.long_holds),
                "max_hold_ms": {
                    site: round(ms, 3)
                    for site, ms in sorted(self.max_hold_ms.items())
                },
            }

    def dump(self, path: str) -> dict:
        doc = self.report()
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return doc


def load_dump(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: witness dump must be a JSON object")
    return doc


# --------------------------------------------------------- loop witness


class LoopWitness:
    """Runtime loop-stall witness — the dynamic half of the loop-blocking
    contract (static half: analysis/execcontext.py).

    Hooks ``server.LOOP_PROBE``, the dispatch choke point every callback
    the event loop runs inline passes through (``_invoke``: selector
    events, ``call_soon`` posts, timers). Per callback it aggregates
    count / max / total wall time keyed by the function's STATIC identity
    (module, ``__qualname__``, first line — the same identity
    :func:`execcontext.cross_check_loop` maps onto the model), and
    records a **stall** for any inline callback exceeding the threshold
    (``TPE_TORCH_LOOP_WITNESS_STALL_MS``, default 500 ms — inline work is
    microseconds-scale; half a second inline means the contract is
    broken, not that the runner is slow). Unlike the lock witness's
    long-hold warn list, stalls FAIL the session: a stalled loop is
    user-visible (every connection parks), so CI treats it like an
    inversion.

    Installed by ``analysis/pytest_witness.py`` under
    ``TPE_TORCH_LOOP_WITNESS=1``; the dump lands at
    ``TPE_TORCH_LOOP_WITNESS_OUT`` (default ``torch-loop-witness.json``) and
    ``python -m tpu_pod_exporter_torch.analysis
    --check-loop-witness <dump>`` cross-checks every witnessed callback
    against the static model's loop-role tags."""

    def __init__(self, stall_ms: float | None = None) -> None:
        if stall_ms is None:
            stall_ms = float(
                os.environ.get("TPE_TORCH_LOOP_WITNESS_STALL_MS", "500"))
        self.stall_ms = stall_ms
        self._mutex = _thread.allocate_lock()
        self._installed = False
        self._saved: Any = None
        # (module, qualname, line) -> {"kinds", "count", "max_ms", "total_ms"}
        self.callbacks: dict[tuple[str, str, int], dict] = {}
        self.stalls: list[dict] = []

    def install(self) -> "LoopWitness":
        if not self._installed:
            # Deferred import: the analyzer side of this module must stay
            # importable without pulling the server in (exporter-lint
            # never imports checked code — only the RUNTIME witness does).
            from tpu_pod_exporter_torch import server
            self._saved = server.LOOP_PROBE
            server.LOOP_PROBE = self._observe
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            from tpu_pod_exporter_torch import server
            server.LOOP_PROBE = self._saved
            self._installed = False

    def __enter__(self) -> "LoopWitness":
        return self.install()

    def __exit__(self, *exc: object) -> None:
        self.uninstall()

    @staticmethod
    def _identity(fn: Any) -> tuple[str, str, int]:
        """Static identity of a dispatched callable: unwrap partials and
        bound methods down to the code object the model parsed."""
        seen = 0
        while hasattr(fn, "func") and seen < 8:  # functools.partial chain
            fn = fn.func
            seen += 1
        fn = getattr(fn, "__func__", fn)  # bound method -> function
        code = getattr(fn, "__code__", None)
        module = getattr(fn, "__module__", "") or ""
        qualname = getattr(fn, "__qualname__", repr(fn))
        line = code.co_firstlineno if code is not None else 0
        return (module, qualname, line)

    def _observe(self, kind: str, fn: Any, dur_s: float) -> None:
        module, qualname, line = self._identity(fn)
        ms = dur_s * 1000.0
        with self._mutex:
            rec = self.callbacks.setdefault((module, qualname, line), {
                "kinds": set(), "count": 0, "max_ms": 0.0, "total_ms": 0.0,
            })
            rec["kinds"].add(kind)
            rec["count"] += 1
            rec["total_ms"] += ms
            if ms > rec["max_ms"]:
                rec["max_ms"] = ms
            if ms > self.stall_ms and len(self.stalls) < _MAX_LONG_HOLDS:
                self.stalls.append({
                    "module": module, "qualname": qualname, "line": line,
                    "kind": kind, "ms": round(ms, 3),
                })

    def report(self) -> dict:
        with self._mutex:
            return {
                "meta": {
                    "kind": "loop-witness",
                    "threshold_ms": self.stall_ms,
                    "callbacks": len(self.callbacks),
                    "stalls": len(self.stalls),
                },
                "callbacks": [
                    {
                        "module": module, "qualname": qualname, "line": line,
                        "kinds": sorted(rec["kinds"]),
                        "count": rec["count"],
                        "max_ms": round(rec["max_ms"], 3),
                        "total_ms": round(rec["total_ms"], 3),
                    }
                    for (module, qualname, line), rec
                    in sorted(self.callbacks.items())
                ],
                "stalls": list(self.stalls),
            }

    def dump(self, path: str) -> dict:
        doc = self.report()
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return doc


# Process-global instance management for the pytest plugin.
_active: LockWitness | None = None
_active_loop: LoopWitness | None = None


def install_from_env() -> LockWitness | None:
    """Install the witness when ``TPE_TORCH_LOCK_WITNESS=1`` (idempotent).
    Returns the active witness, or None when disabled."""
    global _active
    if os.environ.get("TPE_TORCH_LOCK_WITNESS", "") not in ("1", "true", "yes"):
        return None
    if _active is None:
        _active = LockWitness().install()
    return _active


def active() -> LockWitness | None:
    return _active


def install_loop_from_env() -> LoopWitness | None:
    """Install the loop witness when ``TPE_TORCH_LOOP_WITNESS=1`` (idempotent).
    Unlike :func:`install_from_env` this imports the server module, so it
    must run AFTER the lock witness is live (lock wrapping happens at
    lock-creation time; probe hooking is just a module-global swap)."""
    global _active_loop
    if os.environ.get("TPE_TORCH_LOOP_WITNESS", "") not in ("1", "true", "yes"):
        return None
    if _active_loop is None:
        _active_loop = LoopWitness().install()
    return _active_loop


def loop_active() -> LoopWitness | None:
    return _active_loop
