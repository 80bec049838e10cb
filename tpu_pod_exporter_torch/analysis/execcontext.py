"""Execution-context contracts — where code is ALLOWED to run and in what
order it must touch the disk, as whole-tree checkable rules.

Three rule families built on the concurrency model (analysis/concurrency.py:
lock discovery, conservative call graph, thread-role fixpoint):

``loop-blocking``
    The selectors loop (server._EventLoopServer.run, thread role
    ``tpu-exporter-http``) may never block: every callback it dispatches
    inline — the scrape fast path, loop timers, streaming writes,
    ``call_soon``/``call_later`` posts — is tagged with the loop role by
    the role fixpoint, and any blocking operation (file I/O, ``time.sleep``,
    compression, serialization above the splice seam, blocking subprocess
    or network calls, or acquiring a lock whose OTHER holders may block)
    reachable under that tag is a finding. Work routed through
    ``_WorkerPool.submit`` or the ``StreamPump`` is laundered naturally:
    submitted closures carry the worker role, not the loop role.

``durability-ordering``
    The WAL contract shared by persist/egress/store/alerting as dataflow
    rules: (a) state files (``*-status.json``, ``cursor.json``, ``seq``,
    breaker/shard-map documents) must be written through the atomic
    write-temp -> fsync -> rename helper (``persist.atomic_write``) — a
    raw ``open(path, "w")`` on a state path is a finding; (b) cursor
    movers (``ack``/``_advance``/``trim_to_bytes``/``drop_oldest``) on a
    cursor-owning class must be fsync-reachable before return; (c) each
    ``WalBuffer`` instance has exactly ONE declared mover role
    (``CURSOR_MOVERS`` below) — a new subsystem wiring a second mover
    thread fails lint, not review.

``fork-safety``
    Forward-looking audit for the multi-core (pre-fork ``SO_REUSEPORT``)
    serving plane: direct ``os.fork``/multiprocessing use and import-time
    thread/fd creation are findings today; the full inventory of
    thread-spawn, lock, mmap, and retained-fd creation sites that would be
    live at a pre-fork point is exported as the committed
    ``analysis/reviewed/fork-inventory.json`` artifact (``--fork-inventory``,
    freshness-gated in the tests like the lock graph).

The runtime half lives in analysis/witness.py (``LoopWitness``, gated on
``TPE_TORCH_LOOP_WITNESS=1``): it times every loop-dispatched callback through
``server.LOOP_PROBE`` and :func:`cross_check_loop` verifies that each
witnessed callback is loop-role-tagged in the static model — neither side
can rot. Like the rest of exporter-lint, this module never imports the
code it checks.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from fnmatch import fnmatchcase
from typing import TYPE_CHECKING

from tpu_pod_exporter_torch.analysis.concurrency import (
    ConcurrencyModel,
    _FuncInfo,
    _terminal,
    get_model,
)
from tpu_pod_exporter_torch.analysis.diagnostics import ERROR, Diagnostic

if TYPE_CHECKING:
    from tpu_pod_exporter_torch.analysis.engine import LintContext

_PKG = "tpu_pod_exporter_torch"

# Thread roles that ARE the event loop. The selectors loop runs on the
# thread MetricsServer.start names "tpu-exporter-http"; call_soon /
# call_later / _invoke callbacks inherit the role via CALLBACK_ROLES.
LOOP_ROLES: tuple[str, ...] = ("tpu-exporter-http",)

# Basenames that are durability STATE: files whose loss or torn write
# changes replay/restart behavior. Writes must go through
# persist.atomic_write (write temp, fsync, rename, fsync dir).
STATE_FILE_PATTERNS: tuple[str, ...] = (
    "*-status.json",   # pressure/egress/store/alert sidecars
    "cursor.json",     # WalBuffer ack cursor
    "seq",             # bare sequence stamp files
    "breaker-*.json",  # aggregator breaker state (persist.BreakerStateFile)
    "shard-map*.json",  # shard-map documents (persist.ShardMapFile)
)

# Named constants that hold state-file basenames (STATUS_NAME = "...")
# are resolved tree-wide by name, so `open(join(dir, STATUS_NAME), "w")`
# is caught even though the literal lives in another module.


@dataclass(frozen=True)
class LoopAllowance:
    """A declared inline-blocking exemption: ``func`` (exact qualname) may
    perform the named blocking operation on the loop, with the reason
    reviewed here instead of at every call site. Prefer inline
    ``# lint: disable=loop-blocking(reason)`` for one-off sites; use an
    allowance when a helper is legitimately called from many loop paths."""

    func: str
    reason: str


LOOP_ALLOWED: tuple[LoopAllowance, ...] = ()


@dataclass(frozen=True)
class CursorMoverRule:
    """The ONE thread role allowed to move a WalBuffer cursor. ``buffer``
    is an fnmatch pattern over buffer identities (``mod.Class.attr`` for
    ``self.attr = WalBuffer(...)`` construction sites, ``mod.Class.*`` for
    buffers a class keeps in containers). ``demo`` rules exist only for
    the seeded ``--demo`` tree — they are exempt from the
    declaration-rot check because the real tree has no such buffer."""

    buffer: str
    role: str
    reason: str
    demo: bool = False


CURSOR_MOVERS: tuple[CursorMoverRule, ...] = (
    CursorMoverRule(
        "egress.RemoteWriteShipper.buffer", "tpu-egress-sender",
        "the egress sender thread is the single consumer: it acks after "
        "2xx, drops on caps, trims on backlog — a second mover could "
        "regress the on-disk cursor and resurrect shed batches at boot",
    ),
    CursorMoverRule(
        "alerting.AlertNotifier.buffer", "tpu-alert-sender",
        "the alert sender owns the notification cursor (same "
        "single-consumer seat as the egress shipper, one subsystem over)",
    ),
    CursorMoverRule(
        "store.FleetStore.*", "tpu-exporter-poll",
        "the root round (appender) thread is the tier buffers' only "
        "cursor-mover: append + retention trim + thin-shed all happen on "
        "its pass; the governor only flips flags the appender acts on",
    ),
    CursorMoverRule(
        "persist._LintDemoDualMover._wal", "tpu-demo-mover-a",
        "--demo seed: the demo's dual-mover class declares "
        "mover-a so its second thread (mover-b) exercises the "
        "second-mover finding end to end",
        demo=True,
    ),
)

# Methods that move a WAL cursor. `_advance` is the primitive; the public
# three delegate to it.
_MOVER_NAMES = ("ack", "_advance", "trim_to_bytes", "drop_oldest")


# ----------------------------------------------------------- blocking set


_COMPRESS_MODULES = ("gzip", "zlib", "bz2", "lzma")
_SERIALIZE_MODULES = ("json", "pickle", "marshal")
_OS_BLOCKING = (
    "makedirs", "mkdir", "replace", "rename", "unlink", "remove",
    "rmdir", "listdir", "scandir", "truncate", "fsync", "fdatasync",
)
_SUBPROCESS_BLOCKING = (
    "run", "check_output", "check_call", "call", "communicate", "wait",
)
_PATH_IO = ("write_text", "write_bytes", "read_text", "read_bytes")
# File-handle-ish receiver names for `.write()` / `.read()` — mirrors the
# lock-io rule's heuristic.
_FILEY_RECEIVERS = ("f", "fh", "fp", "file", "out", "outf", "stream")


def _blocking_offence(call: ast.Call) -> str | None:
    """Why this call can block the event loop, or None.

    Deliberately NOT in the set: ``send``/``recv`` (every socket the loop
    touches is non-blocking by construction — ``sendall`` IS flagged,
    its retry loop blocks regardless), ``selector.select`` (the idle
    wait), and logging (exception paths only on the loop; the lock-io
    family polices logging under locks)."""
    fn = call.func
    if isinstance(fn, ast.Name):
        if fn.id == "open":
            return "open() (file I/O)"
        if fn.id == "print":
            return "print() (stream I/O)"
        if fn.id == "urlopen":
            return "urlopen() (network I/O)"
        return None
    if not isinstance(fn, ast.Attribute):
        return None
    attr = fn.attr
    recv = _terminal(fn.value)
    if attr == "sleep" and recv == "time":
        return "time.sleep() (blocking)"
    if attr in ("dumps", "dump") and recv in _SERIALIZE_MODULES:
        return f"{recv}.{attr}() (serialization)"
    if attr in ("compress", "decompress") and recv in _COMPRESS_MODULES:
        return f"{recv}.{attr}() (compression)"
    if attr == "sendall":
        return "socket sendall() (blocking network I/O)"
    if attr in ("create_connection", "getaddrinfo") and recv == "socket":
        return f"socket.{attr}() (network I/O)"
    if attr == "urlopen":
        return "urlopen() (network I/O)"
    if attr in _OS_BLOCKING and recv in ("os", "path", "shutil"):
        return f"{recv}.{attr}() (file-system I/O)"
    if attr in _SUBPROCESS_BLOCKING and (
            recv == "subprocess" or "proc" in recv.lower()):
        return f"{recv}.{attr}() (subprocess)"
    if attr in _PATH_IO:
        return f".{attr}() (file I/O)"
    if attr == "join" and "thread" in recv.lower():
        return f"{recv}.join() (thread join)"
    if attr in ("write", "read") and recv in _FILEY_RECEIVERS:
        return f"{recv}.{attr}() (stream I/O)"
    return None


# ------------------------------------------------------------- exec model


@dataclass
class _BufferSite:
    identity: str         # "egress.RemoteWriteShipper.buffer" | "store.FleetStore.*"
    path: str
    line: int


@dataclass
class ExecContextModel:
    """Derived execution-context state, memoized per lint context."""

    model: ConcurrencyModel
    # fq -> (line, why) direct blocking operations
    direct_blocking: dict[str, list[tuple[int, str]]] = field(
        default_factory=dict)
    # fq -> (why, via-callee | None) transitive blocking reach
    reaches_blocking: dict[str, tuple[str, str | None]] = field(
        default_factory=dict)
    # lock key -> (holder fq, why) — some holder may block while holding
    blocking_holders: dict[str, tuple[str, str]] = field(
        default_factory=dict)
    loop_funcs: set[str] = field(default_factory=set)
    buffers: dict[str, _BufferSite] = field(default_factory=dict)
    # buffer identity -> [(mover fq, call line, path, roles)]
    mover_sites: dict[str, list[tuple[str, int, str, tuple[str, ...]]]] = \
        field(default_factory=dict)

    def loop_role_of(self, fq: str) -> str | None:
        for role in self.model.roles.get(fq, {}):
            if role in LOOP_ROLES:
                return role
        return None

    def blocking_chain(self, start: str) -> list[str]:
        chain = [start]
        cur: str | None = start
        while cur is not None and cur in self.reaches_blocking:
            nxt = self.reaches_blocking[cur][1]
            if nxt is None:
                break
            chain.append(nxt)
            cur = nxt
        return chain


def build_exec_model(model: ConcurrencyModel) -> ExecContextModel:
    em = ExecContextModel(model=model)
    _scan_direct_blocking(em)
    _propagate_blocking(em)
    _find_blocking_holders(em)
    em.loop_funcs = {
        fq for fq, roles in model.roles.items()
        if any(r in LOOP_ROLES for r in roles)
    }
    _discover_buffers(em)
    _collect_mover_sites(em)
    return em


def get_exec_model(ctx: "LintContext") -> ExecContextModel:
    """Memoized on the context: the three execution-context rules share
    one derived pass over the (also memoized) concurrency model."""
    cached = getattr(ctx, "_execcontext_model", None)
    if cached is None:
        cached = build_exec_model(get_model(ctx))
        ctx._execcontext_model = cached  # type: ignore[attr-defined]
    return cached


def _scan_direct_blocking(em: ExecContextModel) -> None:
    for fq, fi in em.model.functions.items():
        hits: list[tuple[int, str]] = []
        for cs in fi.calls:
            why = _blocking_offence(cs.node)
            if why is not None:
                hits.append((cs.line, why))
        if hits:
            em.direct_blocking[fq] = hits


def _propagate_blocking(em: ExecContextModel) -> None:
    reaches = em.reaches_blocking
    for fq, hits in em.direct_blocking.items():
        reaches[fq] = (hits[0][1], None)
    changed = True
    while changed:
        changed = False
        for fq, fi in em.model.functions.items():
            if fq in reaches:
                continue
            for cs in fi.calls:
                hit = next((c for c in cs.callees if c in reaches), None)
                if hit is not None:
                    reaches[fq] = (reaches[hit][0], hit)
                    changed = True
                    break


def _find_blocking_holders(em: ExecContextModel) -> None:
    """Locks under which SOME holder performs (or transitively reaches)
    blocking work. Acquiring such a lock on the loop can park the loop
    for the holder's blocking operation."""
    m = em.model
    for fq, fi in m.functions.items():
        entry = frozenset(m.entry_held.get(fq, ()))
        for cs in fi.calls:
            held = entry | cs.held
            if not held:
                continue
            why = _blocking_offence(cs.node)
            if why is None:
                hit = next(
                    (c for c in cs.callees if c in em.reaches_blocking),
                    None)
                if hit is None:
                    continue
                why = em.reaches_blocking[hit][0]
            for key in held:
                em.blocking_holders.setdefault(key, (fq, why))


def _discover_buffers(em: ExecContextModel) -> None:
    """WalBuffer construction sites. ``self.X = WalBuffer(...)`` yields
    identity ``mod.Class.X``; construction into a local/container inside a
    class method yields the class bucket ``mod.Class.*``."""
    for fq, fi in em.model.functions.items():
        if isinstance(fi.node, ast.Lambda):
            continue
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Assign):
                continue
            if not (isinstance(node.value, ast.Call)
                    and _terminal(node.value.func) == "WalBuffer"):
                continue
            ident: str | None = None
            for tgt in node.targets:
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self" and fi.cls is not None):
                    ident = f"{fi.mod}.{fi.cls}.{tgt.attr}"
                    break
            if ident is None and fi.cls is not None:
                ident = f"{fi.mod}.{fi.cls}.*"
            if ident is None:
                ident = f"{fi.mod}.{fq.rsplit('.', 1)[-1]}.*"
            em.buffers.setdefault(
                ident, _BufferSite(ident, fi.relpath, node.lineno))


def _collect_mover_sites(em: ExecContextModel) -> None:
    m = em.model
    # class (mod, cls) -> identities owned by it
    by_class: dict[tuple[str, str], list[str]] = {}
    for ident in em.buffers:
        parts = ident.split(".")
        mod, cls = ".".join(parts[:-2]), parts[-2]
        by_class.setdefault((mod, cls), []).append(ident)
    for fq, fi in m.functions.items():
        for cs in fi.calls:
            fn = cs.node.func
            if not (isinstance(fn, ast.Attribute)
                    and fn.attr in _MOVER_NAMES):
                continue
            recv = fn.value
            # `self._advance(...)` inside the buffer class itself is the
            # internal delegation chain, not an external mover.
            if isinstance(recv, ast.Name) and recv.id == "self":
                continue
            ident = None
            if (isinstance(recv, ast.Attribute)
                    and isinstance(recv.value, ast.Name)
                    and recv.value.id == "self" and fi.cls is not None):
                cand = f"{fi.mod}.{fi.cls}.{recv.attr}"
                if cand in em.buffers:
                    ident = cand
            if ident is None and fi.cls is not None:
                owned = by_class.get((fi.mod, fi.cls), [])
                if len(owned) == 1:
                    ident = owned[0]
            if ident is None:
                continue
            roles = tuple(sorted(m.roles.get(fq, {})))
            em.mover_sites.setdefault(ident, []).append(
                (fq, cs.line, fi.relpath, roles))


# ----------------------------------------------------- rule: loop-blocking


def check_loop_blocking(ctx: "LintContext") -> list[Diagnostic]:
    em = get_exec_model(ctx)
    m = em.model
    out: list[Diagnostic] = []
    allowed = {a.func for a in LOOP_ALLOWED}
    for a in LOOP_ALLOWED:
        if a.func not in m.functions:
            out.append(Diagnostic(
                "loop-blocking", ERROR,
                f"{_PKG}/analysis/execcontext.py", 1,
                f"LOOP_ALLOWED names {a.func}() but no such function "
                f"exists — the allowance table rotted; update it",
            ))
    seen: set[tuple[str, int]] = set()
    for fq in sorted(em.loop_funcs):
        if fq in allowed:
            continue
        fi = m.functions[fq]
        role = em.loop_role_of(fq) or LOOP_ROLES[0]
        chain = m.role_chain(fq, role)
        via = " -> ".join(q for q, _, _ in chain) or fq
        for line, why in em.direct_blocking.get(fq, ()):
            key = (fi.relpath, line)
            if key in seen:
                continue
            seen.add(key)
            out.append(Diagnostic(
                "loop-blocking", ERROR, fi.relpath, line,
                f"{why} in {fq}(), which runs inline on the event loop "
                f"(role '{role}' via {via}) — one stalled callback stalls "
                f"every connection; defer through _WorkerPool.submit or "
                f"the StreamPump, or pre-render off-loop",
            ))
        for acq in fi.acquires:
            holder = em.blocking_holders.get(acq.key)
            if holder is None:
                continue
            hfq, hwhy = holder
            if hfq == fq:
                continue  # the direct finding above already names it
            key = (fi.relpath, acq.line)
            if key in seen:
                continue
            seen.add(key)
            out.append(Diagnostic(
                "loop-blocking", ERROR, fi.relpath, acq.line,
                f"{fq}() acquires {acq.key} on the event loop (role "
                f"'{role}'), but {hfq}() performs {hwhy} while holding "
                f"it — the loop can park for the holder's I/O; shrink "
                f"the holder's critical section or hand the read to a "
                f"worker",
            ))
    return out


# ------------------------------------------------ rule: durability-ordering


def _state_name_constants(ctx: "LintContext") -> dict[str, str]:
    """Named constants (module- or class-level ``NAME = "literal"``) whose
    value is a state-file basename, tree-wide — so a write through
    ``STATUS_NAME`` imported from another module still resolves."""
    consts: dict[str, str] = {}

    def scan(body: list[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, ast.ClassDef):
                scan(stmt.body)
                continue
            if not isinstance(stmt, ast.Assign):
                continue
            if not (isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, str)):
                continue
            if not _is_state_basename(stmt.value.value):
                continue
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    consts[tgt.id] = stmt.value.value
    for tree in ctx.package_trees.values():
        scan(tree.body)
    return consts


def _is_state_basename(value: str) -> bool:
    base = value.rsplit("/", 1)[-1]
    return any(fnmatchcase(base, pat) for pat in STATE_FILE_PATTERNS)


def _mentions_state_path(expr: ast.expr, consts: dict[str, str]) -> bool:
    for n in ast.walk(expr):
        if (isinstance(n, ast.Constant) and isinstance(n.value, str)
                and _is_state_basename(n.value)):
            return True
        if isinstance(n, ast.Name) and n.id in consts:
            return True
        if isinstance(n, ast.Attribute) and n.attr in consts:
            return True
    return False


def _write_mode(call: ast.Call) -> bool:
    mode: ast.expr | None = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return False
    return (isinstance(mode, ast.Constant) and isinstance(mode.value, str)
            and any(c in mode.value for c in "wax+"))


def check_durability_ordering(ctx: "LintContext") -> list[Diagnostic]:
    em = get_exec_model(ctx)
    out: list[Diagnostic] = []
    out.extend(_check_state_writes(ctx, em))
    out.extend(_check_mover_fsync_reach(em))
    out.extend(_check_single_mover(em))
    return out


def _check_state_writes(
    ctx: "LintContext", em: ExecContextModel
) -> list[Diagnostic]:
    """Leg (a): raw writes to state paths bypass the crash discipline —
    a torn ``cursor.json`` replays acked records (or worse, loses the
    clean prefix). Everything must route through persist.atomic_write."""
    consts = _state_name_constants(ctx)
    out: list[Diagnostic] = []
    seen: set[tuple[str, int]] = set()
    for fq, fi in em.model.functions.items():
        for cs in fi.calls:
            call = cs.node
            fn = call.func
            target: ast.expr | None = None
            how = ""
            if (isinstance(fn, ast.Name) and fn.id == "open"
                    and call.args and _write_mode(call)):
                target, how = call.args[0], "open(.., 'w')"
            elif (isinstance(fn, ast.Attribute)
                    and fn.attr in ("write_text", "write_bytes")):
                target, how = fn.value, f".{fn.attr}()"
            elif (isinstance(fn, ast.Attribute)
                    and fn.attr in ("replace", "rename")
                    and _terminal(fn.value) == "os"
                    and len(call.args) >= 2
                    and "atomic_write" not in fq):
                target, how = call.args[1], f"os.{fn.attr}()"
            if target is None:
                continue
            if not _mentions_state_path(target, consts):
                continue
            key = (fi.relpath, cs.line)
            if key in seen:
                continue
            seen.add(key)
            out.append(Diagnostic(
                "durability-ordering", ERROR, fi.relpath, cs.line,
                f"raw {how} on a durability state path in {fq}() — a "
                f"crash mid-write tears the file and corrupts replay; "
                f"route it through persist.atomic_write (write temp, "
                f"fsync, rename, fsync dir)",
            ))
    return out


def _check_mover_fsync_reach(em: ExecContextModel) -> list[Diagnostic]:
    """Leg (b): a cursor mover that returns without the new cursor being
    fsync-reachable lets a crash resurrect acked records. ``_advance``'s
    atomic_write IS the sink; delegating movers reach it transitively."""
    m = em.model
    # Sink: direct os.fsync/fdatasync, or a call resolving to a function
    # whose name ends in "atomic_write" (persist.atomic_write and any
    # same-contract helper a fixture stubs in).
    sinks: set[str] = set()
    for fq, fi in m.functions.items():
        if fq.endswith("atomic_write"):
            sinks.add(fq)
            continue
        for cs in fi.calls:
            fn = cs.node.func
            if (isinstance(fn, ast.Attribute)
                    and fn.attr in ("fsync", "fdatasync")):
                sinks.add(fq)
                break
    reach_sink: set[str] = set(sinks)
    changed = True
    while changed:
        changed = False
        for fq, fi in m.functions.items():
            if fq in reach_sink:
                continue
            for cs in fi.calls:
                if any(c in reach_sink for c in cs.callees):
                    reach_sink.add(fq)
                    changed = True
                    break
    out: list[Diagnostic] = []
    for (mod, cls), ci in sorted(m.classes.items()):
        if not _is_cursor_class(ci.node):
            continue
        for name in _MOVER_NAMES:
            fq = ci.methods.get(name)
            if fq is None or fq not in m.functions:
                continue
            if fq in reach_sink:
                continue
            fi = m.functions[fq]
            out.append(Diagnostic(
                "durability-ordering", ERROR, fi.relpath,
                fi.node.lineno,
                f"cursor mover {fq}() returns without an fsync-reachable "
                f"cursor write (no path reaches persist.atomic_write or "
                f"os.fsync) — a crash after the move re-delivers or "
                f"resurrects records; persist the cursor through "
                f"atomic_write before returning",
            ))
    return out


def _is_cursor_class(node: ast.ClassDef) -> bool:
    """A class that owns an on-disk cursor: declares CURSOR_NAME (or any
    cursor-named attribute/method) in its body."""
    for stmt in node.body:
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name) and "CURSOR" in tgt.id.upper():
                    return True
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and "cursor" in stmt.name.lower():
            return True
    return False


def _check_single_mover(em: ExecContextModel) -> list[Diagnostic]:
    """Leg (c): exactly one DECLARED mover role per WalBuffer cursor."""
    m = em.model
    out: list[Diagnostic] = []
    matched_rules: set[str] = set()
    for ident, site in sorted(em.buffers.items()):
        rule = next(
            (r for r in CURSOR_MOVERS if fnmatchcase(ident, r.buffer)),
            None)
        if rule is None:
            out.append(Diagnostic(
                "durability-ordering", ERROR, site.path, site.line,
                f"WalBuffer cursor '{ident}' has no declared mover role — "
                f"every cursor has exactly ONE moving thread; add a "
                f"CursorMoverRule for it in analysis/execcontext.py "
                f"naming that thread (and why)",
            ))
            continue
        matched_rules.add(rule.buffer)
        for fq, line, path, roles in em.mover_sites.get(ident, ()):
            for role in roles:
                if fnmatchcase(role, rule.role):
                    continue
                out.append(Diagnostic(
                    "durability-ordering", ERROR, path, line,
                    f"{fq}() moves the '{ident}' cursor from thread "
                    f"'{role}', but its declared single mover is "
                    f"'{rule.role}' — {rule.reason}",
                ))
    for rule in CURSOR_MOVERS:
        if rule.demo:
            continue
        if rule.buffer not in matched_rules:
            out.append(Diagnostic(
                "durability-ordering", ERROR,
                f"{_PKG}/analysis/execcontext.py", 1,
                f"CURSOR_MOVERS declares buffer pattern '{rule.buffer}' "
                f"but no such WalBuffer construction site exists — the "
                f"table rotted; update it",
            ))
    return out


# ------------------------------------------------------- rule: fork-safety


_FD_FACTORIES: dict[tuple[str, str], str] = {
    ("socket", "socket"): "socket",
    ("socket", "socketpair"): "socketpair",
    ("socket", "create_connection"): "socket",
    ("os", "pipe"): "pipe",
    ("mmap", "mmap"): "mmap",
    ("selectors", "DefaultSelector"): "selector",
}


def _fd_kind(call: ast.Call) -> str | None:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return _FD_FACTORIES.get((_terminal(fn.value), fn.attr))
    if isinstance(fn, ast.Name):
        # `from socket import socketpair` style — match by bare name.
        for (_mod, name), kind in _FD_FACTORIES.items():
            if fn.id == name and name != "socket":
                return kind
    return None


def check_fork_safety(ctx: "LintContext") -> list[Diagnostic]:
    """Direct fork/multiprocessing use and import-time thread/fd creation.

    The coming multi-core plane forks AFTER config load and BEFORE the
    serving threads start; anything spawned or opened at import time is
    silently duplicated into every worker (locks held by a thread that
    does not exist post-fork, double-owned fds, re-delivered WAL
    records). Until the sanctioned pre-fork entry point lands, direct
    fork primitives are findings; the full pre-fork resource inventory
    is the committed analysis/reviewed/fork-inventory.json artifact."""
    em = get_exec_model(ctx)
    out: list[Diagnostic] = []
    for fq, fi in em.model.functions.items():
        for cs in fi.calls:
            fn = cs.node.func
            if isinstance(fn, ast.Attribute):
                recv = _terminal(fn.value)
                if fn.attr in ("fork", "forkpty") and recv == "os":
                    out.append(Diagnostic(
                        "fork-safety", ERROR, fi.relpath, cs.line,
                        f"os.{fn.attr}() in {fq}() — there is no "
                        f"sanctioned pre-fork point yet; the multi-core "
                        f"plane must fork through a reviewed entry that "
                        f"replays analysis/reviewed/fork-inventory.json",
                    ))
                elif (recv == "multiprocessing"
                        and fn.attr in ("Process", "Pool")):
                    out.append(Diagnostic(
                        "fork-safety", ERROR, fi.relpath, cs.line,
                        f"multiprocessing.{fn.attr} in {fq}() — fork-based "
                        f"workers duplicate every live lock/fd/thread "
                        f"invisibly; the serving plane's pre-fork design "
                        f"owns process fan-out",
                    ))
    # Import-time hazards: module top-level statements run before ANY
    # pre-fork point can exist.
    for relpath, tree in ctx.package_trees.items():
        for stmt in tree.body:
            for node in ast.walk(stmt):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    break
                if not isinstance(node, ast.Call):
                    continue
                if (_terminal(node.func) == "Thread"
                        or (isinstance(node.func, ast.Attribute)
                            and node.func.attr == "start"
                            and _terminal(node.func.value) == "Thread")):
                    out.append(Diagnostic(
                        "fork-safety", ERROR, relpath, node.lineno,
                        "thread created at import time — it exists before "
                        "any pre-fork point and silently dies in forked "
                        "workers; spawn from an explicit start() path",
                    ))
                elif _fd_kind(node) is not None:
                    out.append(Diagnostic(
                        "fork-safety", ERROR, relpath, node.lineno,
                        f"{_fd_kind(node)} created at import time — the "
                        f"fd would be shared by every forked worker "
                        f"(cross-process double reads/writes); create it "
                        f"inside an explicit start() path",
                    ))
    return out


def fork_inventory(model: ConcurrencyModel) -> dict:
    """The committed analysis/reviewed/fork-inventory.json artifact: every resource
    that would be live at a pre-fork point, keyed by STABLE identities
    (qualnames + paths, no line numbers — lock-graph discipline, so the
    artifact churns only on structural change)."""
    threads = sorted({
        (r.role, r.func, r.via, r.path) for r in model.roots
    })
    fds: set[tuple[str, str, str, str]] = set()
    for fq, fi in model.functions.items():
        for cs in fi.calls:
            kind = _fd_kind(cs.node)
            if kind is None:
                continue
            retained = _retained_target(fi, cs.node)
            fds.add((kind, fq, retained or "<transient>", fi.relpath))
    return {
        "comment": (
            "Rendered by `python -m tpu_pod_exporter_torch.analysis "
            "--fork-inventory`. Reviewed artifact "
            "for the multi-core pre-fork plane: every thread, lock, and "
            "kernel-object creation site that may be live when the "
            "process forks. CI diffs it; a change means the pre-fork "
            "surface changed and must be re-reviewed."
        ),
        "threads": [
            {"role": role, "entry": func, "via": via, "site": path}
            for role, func, via, path in threads
        ],
        "locks": [
            {"key": lk.key, "kind": lk.kind, "path": lk.path}
            for lk in sorted(model.locks.values(), key=lambda k: k.key)
        ],
        "kernel_objects": [
            {"kind": kind, "creator": fq, "retained_as": tgt, "path": path}
            for kind, fq, tgt, path in sorted(fds)
        ],
    }


def _retained_target(fi: _FuncInfo, call: ast.Call) -> str | None:
    """If the creation call's result is stored (``self.X = ...`` or a
    module global), the attribute/global name — retained kernel objects
    are the ones a fork duplicates."""
    if isinstance(fi.node, ast.Lambda):
        return None
    for node in ast.walk(fi.node):
        if not isinstance(node, ast.Assign):
            continue
        found = any(n is call for n in ast.walk(node.value))
        if not found:
            continue
        for tgt in node.targets:
            name = _target_name(tgt)
            if name is not None:
                return name
    return None


def _target_name(tgt: ast.expr) -> str | None:
    """Only ``self.X`` targets count as retained — a bare local name dies
    with the call (module-level creations never appear here: top-level
    code is not in model.functions, the import-time check owns it)."""
    if (isinstance(tgt, ast.Attribute)
            and isinstance(tgt.value, ast.Name) and tgt.value.id == "self"):
        return f"self.{tgt.attr}"
    if isinstance(tgt, ast.Tuple):  # self._r, self._w = socketpair()
        names = [_target_name(e) for e in tgt.elts]
        if any(n is not None for n in names):
            return ", ".join(n or "_" for n in names)
    return None


# ------------------------------------------------- loop-witness cross-check


def _static_qualname(module: str, qualname: str, line: int) -> str | None:
    """Map a runtime (module, __qualname__, firstlineno) identity onto the
    static model's naming scheme: ``a.<locals>.b`` -> ``a.<b>``, a final
    ``<lambda>`` -> ``<lambda@LINE>``."""
    if module == _PKG:
        mod = ""
    elif module.startswith(_PKG + "."):
        mod = module[len(_PKG) + 1:]
    else:
        return None
    parts = qualname.split(".<locals>.")
    mapped = [parts[0]]
    for part in parts[1:]:
        mapped.append(f"<{part}>")
    if mapped[-1] in ("<lambda>", "<<lambda>>"):
        mapped[-1] = f"<lambda@{line}>"
    inner = ".".join(mapped)
    return f"{mod}.{inner}" if mod else inner


def _model_identity(
    model: ConcurrencyModel, module: str, qualname: str, line: int
) -> str | None:
    """:func:`_static_qualname`, with a lambda inside a lambda found in the
    model: the runtime qualname drops the outer lambda's line, which the
    model's name for it (``<lambda@LINE>``) carries."""
    fq = _static_qualname(module, qualname, line)
    if fq is None or fq in model.functions or "<<lambda>>." not in fq:
        return fq
    pattern = fq.replace("<<lambda>>.", "<lambda@*>.")
    hits = [name for name in model.functions if fnmatchcase(name, pattern)]
    return hits[0] if len(hits) == 1 else fq


def cross_check_loop(model: ConcurrencyModel, dump: dict) -> list[str]:
    """Loop-witness dump vs static model. Empty list = every callback the
    loop actually executed is loop-role-tagged statically and no inline
    stall crossed the threshold.

    Failure classes:
      * a witnessed stall — an inline callback over the threshold (the
        loop-blocking contract violated at runtime);
      * a witnessed package callback the static model has no function
        for (discovery/materialization rotted);
      * a witnessed package callback the model knows but does NOT tag
        with the loop role (role propagation rotted — the static half
        would never check it against the blocking set)."""
    problems: list[str] = []
    for stall in dump.get("stalls", []):
        problems.append(
            f"loop stall: {stall.get('qualname', '?')} "
            f"({stall.get('kind', '?')}) ran "
            f"{stall.get('ms', '?')} ms inline on the loop "
            f"(threshold {dump.get('meta', {}).get('threshold_ms', '?')} "
            f"ms)")
    for cb in dump.get("callbacks", []):
        module = cb.get("module", "")
        if not isinstance(module, str) or not module.startswith(_PKG):
            continue  # stdlib/test callables cannot be in the model
        fq = _model_identity(
            model, module, cb.get("qualname", ""), int(cb.get("line", 0)))
        if fq is None:
            continue
        if fq not in model.functions:
            problems.append(
                f"loop-executed callback {module}.{cb.get('qualname')} "
                f"has no static identity ({fq} not in the model) — the "
                f"call-graph materialization in analysis/concurrency.py "
                f"missed it")
            continue
        roles = model.roles.get(fq, {})
        if not any(r in LOOP_ROLES for r in roles):
            problems.append(
                f"loop-executed callback {fq} is not loop-role-tagged in "
                f"the static model (roles: "
                f"{sorted(roles) or ['<none>']}) — the loop-blocking "
                f"rule would never inspect it; extend CALLBACK_ROLES or "
                f"the role fixpoint")
    return problems
