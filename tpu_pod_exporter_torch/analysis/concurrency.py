"""Whole-tree concurrency contract analysis (lockdep/TSan-style, static).

Three passes over the package AST (never imports the code it checks, same
as the rest of ``exporter-lint``):

1. **Lock discovery** — every ``threading.Lock/RLock/Condition`` creation
   site in the package becomes a named lock identity: instance attributes
   (``persist.WalBuffer._lock``), class attributes
   (``supervisor._Worker._seq_lock``), module globals (``nativelib._lock``)
   and function locals. The creation site (file + statement line range) is
   the join key the runtime witness (:mod:`.witness`) maps its observed
   locks back onto.

2. **Call graph + held-set propagation** — a conservative package call
   graph rooted at thread entry points (``threading.Thread(target=...)``,
   ``ThreadPoolExecutor.submit`` sites, and the declared callback
   registrars in :data:`CALLBACK_ROLES`). Receiver types come from
   constructor assignments, parameter annotations, the classes the
   package constructs into an unannotated constructor parameter and a
   unique-method-name fallback; anything unresolvable stays unresolved —
   a lint that guesses cries wolf. A fixpoint propagates (a) the set of
   locks that may be held on entry to each function and (b) the set of
   thread roles that may execute it.

3. **Contract checks** —

   * ``lock-order``: the derived acquisition-order graph (edge A -> B =
     some path acquires B while holding A). Cycles are deadlock
     candidates; re-acquiring a non-reentrant lock already held is a
     self-deadlock.
   * ``lock-io-chain``: the ``lock-io`` rule deepened from single
     statements to whole call chains — a call made while a lock is held
     whose callee *transitively* performs I/O/serialization/logging.
   * ``lock-ownership``: the declared thread-ownership table
     (:data:`OWNERSHIP`) — "one cursor-mover per buffer" and friends as
     machine-checked rules instead of prose. Entries may also
     declare a flag that must only ever be read under the instance lock
     (the ``_QueryCache.put`` re-check-under-lock discipline).

The static model is also the reference the runtime witness is checked
against in CI (:func:`cross_check`): an acquisition-order edge observed
while running the test suite that the static graph cannot explain fails
the build, so the model cannot silently rot. Declared-but-dynamic edges
(callback indirection the AST cannot follow) live in
:data:`MODELED_EDGES`, each with its justification.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from fnmatch import fnmatchcase
from typing import TYPE_CHECKING, Iterator

from tpu_pod_exporter_torch.analysis.diagnostics import ERROR, Diagnostic

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, types only
    from tpu_pod_exporter_torch.analysis.engine import LintContext

_PKG = "tpu_pod_exporter_torch"

# threading factory -> lock kind. Condition wraps a lock and acquires it
# via ``with cv:`` — the Condition object IS the modeled lock.
_LOCK_FACTORIES = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}

# Method names too generic for the unique-definition fallback: a receiver
# of unknown type calling one of these could just as well be a dict, file,
# queue or socket — resolving them by name would fabricate call edges.
_COMMON_METHODS = frozenset({
    "get", "put", "set", "add", "pop", "read", "write", "close", "open",
    "run", "start", "stop", "send", "recv", "join", "clear", "copy",
    "keys", "values", "items", "update", "append", "extend", "insert",
    "remove", "acquire", "release", "wait", "notify", "notify_all",
    "submit", "result", "cancel", "flush", "seek", "tell", "readline",
    "fileno", "locked", "empty", "full", "qsize", "info", "debug",
    "warning", "error", "exception", "main", "tick", "emit", "format",
    "match", "search", "sub", "split", "strip", "encode", "decode",
    "sort", "index", "count", "exists", "name", "is_set", "popleft",
    "popitem", "setdefault", "discard", "replace", "lower", "upper",
})


# --------------------------------------------------------------- declarations


@dataclass(frozen=True)
class CallbackRole:
    """A registration method whose callable argument later runs on a
    specific thread — flow the AST cannot follow, declared instead."""

    method: str               # qualname of the registrar
    arg_indices: tuple[int, ...]
    roles: tuple[str, ...]    # thread role(s) the callable runs on
    reason: str


CALLBACK_ROLES: tuple[CallbackRole, ...] = (
    CallbackRole(
        "pressure.PressureGovernor.add_disk_rung", (1, 2),
        ("tpu-exporter-pressure",),
        "ladder rung apply/recover callables run on the governor check "
        "thread (pressure.PressureGovernor._run -> tick)",
    ),
    CallbackRole(
        "pressure.PressureGovernor.add_memory_rung", (1, 2),
        ("tpu-exporter-pressure",),
        "memory-ladder rungs run on the governor check thread",
    ),
    CallbackRole(
        "pressure.PressureGovernor.register_memory_component", (1,),
        ("tpu-exporter-pressure",),
        "component byte accounting is read each governor tick",
    ),
    CallbackRole(
        "server._WorkerPool.submit", (0,),
        ("tpu-exporter-http-worker-*",),
        "submitted task closures execute on an elastic pool worker "
        "(server._WorkerPool._run)",
    ),
    CallbackRole(
        "server._EventLoopServer.call_soon", (0,),
        ("tpu-exporter-http",),
        "posted callbacks run inline on the selectors-loop thread "
        "(server._EventLoopServer._run_pending) — the loop-blocking "
        "rule's role seed for worker->loop handoffs",
    ),
    CallbackRole(
        "server._EventLoopServer.call_later", (1,),
        ("tpu-exporter-http",),
        "timer callbacks fire inline on the loop thread "
        "(server._EventLoopServer._run_timers)",
    ),
    CallbackRole(
        "server._EventLoopServer._invoke", (1,),
        ("tpu-exporter-http",),
        "the loop-dispatch choke point: everything handed to it runs "
        "inline on the loop thread (the loop-stall witness times the "
        "same seam at runtime)",
    ),
    CallbackRole(
        "supervisor.SourceSupervisor._submit", (0,),
        ("tpu-sup-*",),
        "supervised phase callables execute on the per-source fenced "
        "worker (supervisor._Worker._run)",
    ),
)


@dataclass(frozen=True)
class OwnershipRule:
    """Which thread roles may execute a function. ``allowed`` entries are
    fnmatch patterns over thread-role names; ``("*",)`` means any thread,
    used when the entry exists only for its ``guarded_flag`` check."""

    func: str                      # qualname, e.g. "persist.WalBuffer._advance"
    allowed: tuple[str, ...]
    reason: str
    # Attribute that must ONLY be read inside a ``with self.<lock>:`` block
    # within this function (the flag-checked-under-lock discipline).
    guarded_flag: str | None = None


# The thread-ownership table: prose contracts as checkable
# rules. Roles are thread names (thread-discipline guarantees every spawn
# is named); "pool:*" roles come from ThreadPoolExecutor submit sites.
OWNERSHIP: tuple[OwnershipRule, ...] = (
    # WalBuffer has exactly ONE cursor-mover per instance. The egress
    # buffer's mover is the sender thread; the alert notification
    # buffer's mover is the alert sender thread (alerting.AlertNotifier,
    # same seat one subsystem over); the fleet store's tier buffers
    # are moved by the root round (appender) thread — which is the poll
    # thread driving SliceAggregator.poll_once. A governor-thread move
    # racing the appender is a known bug class; the governor may only
    # flip flags (set_thin / _disk_pressure) that the owning thread acts
    # on at its next pass.
    OwnershipRule(
        "persist.WalBuffer._advance",
        ("tpu-egress-sender", "tpu-alert-sender", "tpu-exporter-poll"),
        "single cursor-mover per buffer: the egress sender owns the "
        "egress buffer cursor, the alert sender the alert notification "
        "cursor, the root round thread the store tier cursors; a "
        "governor/HTTP-thread advance racing the owner could regress "
        "the on-disk cursor and resurrect shed records at boot",
    ),
    OwnershipRule(
        "persist.WalBuffer.trim_to_bytes",
        ("tpu-egress-sender", "tpu-alert-sender", "tpu-exporter-poll"),
        "cap trims are cursor moves (see WalBuffer._advance)",
    ),
    OwnershipRule(
        "persist.WalBuffer.ack",
        ("tpu-egress-sender", "tpu-alert-sender", "tpu-exporter-poll"),
        "acks are cursor moves (see WalBuffer._advance)",
    ),
    OwnershipRule(
        "persist.WalBuffer.drop_oldest",
        ("tpu-egress-sender", "tpu-alert-sender", "tpu-exporter-poll"),
        "age/byte-cap drops are cursor moves (see WalBuffer._advance)",
    ),
    OwnershipRule(
        "egress.RemoteWriteShipper._enforce_caps",
        ("tpu-egress-sender",),
        "backlog caps shed via the cursor; only the one thread that "
        "moves the ack cursor may run them (egress.py single-consumer "
        "discipline)",
    ),
    OwnershipRule(
        "history.HistoryStore.append_snapshot",
        ("tpu-exporter-poll",),
        "node history has one appender: the poll thread. HTTP readers "
        "copy under the lock; a second appender would interleave ring "
        "writes between tiers",
    ),
    OwnershipRule(
        "store.FleetStore.append_snapshot",
        ("tpu-exporter-poll",),
        "the root store's appender is the round thread (store.py thread "
        "contract); queries copy out under the lock",
    ),
    OwnershipRule(
        "store.FleetStore.append_samples",
        ("tpu-exporter-poll",),
        "see FleetStore.append_snapshot",
    ),
    OwnershipRule(
        "fleet._QueryCache.put",
        ("*",),
        "any thread may put, but the enabled flag must be re-checked "
        "inside the lock: a put racing the memory ladder's "
        "set_enabled(False)+clear must not resurrect a stale entry in a "
        "disabled cache (a known regression class)",
        guarded_flag="_enabled",
    ),
)


@dataclass(frozen=True)
class ModeledEdge:
    """A declared lock-order edge the AST cannot derive (callback or
    data-driven indirection) but the runtime witness may observe."""

    src: str
    dst: str
    reason: str


MODELED_EDGES: tuple[ModeledEdge, ...] = ()


# -------------------------------------------------------------------- model


@dataclass(frozen=True)
class LockInfo:
    key: str        # "persist.WalBuffer._lock", "nativelib._lock", ...
    kind: str       # lock | rlock | condition
    path: str       # repo-relative
    line: int       # creation statement first line
    end_line: int


@dataclass
class _Acquire:
    key: str
    line: int
    held: frozenset[str]    # locks locally held at this acquire


@dataclass
class _CallSite:
    node: ast.Call
    line: int
    held: frozenset[str]
    callees: tuple[str, ...] = ()


@dataclass
class _FuncInfo:
    qualname: str
    relpath: str
    mod: str
    cls: str | None
    node: ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda
    acquires: list[_Acquire] = field(default_factory=list)
    calls: list[_CallSite] = field(default_factory=list)
    # (line, why) direct I/O offences — used transitively for chains.
    io: list[tuple[int, str]] = field(default_factory=list)
    local_types: dict[str, tuple[str, str]] = field(default_factory=dict)
    local_funcs: dict[str, str] = field(default_factory=dict)
    local_locks: dict[str, str] = field(default_factory=dict)
    # ``d = self.X`` where X's classes are known only by flow: d -> X.
    local_aliases: dict[str, str] = field(default_factory=dict)


@dataclass
class _ClassInfo:
    mod: str
    name: str
    node: ast.ClassDef
    relpath: str
    base_exprs: list[ast.expr] = field(default_factory=list)
    bases: list[tuple[str, str]] = field(default_factory=list)
    methods: dict[str, str] = field(default_factory=dict)   # name -> qualname
    locks: dict[str, str] = field(default_factory=dict)     # attr -> lock key
    attr_types: dict[str, tuple[str, str]] = field(default_factory=dict)
    # Unannotated __init__ parameter -> the attribute it is stored in, and
    # attribute -> the classes constructed into that parameter (its own
    # default, the package's construction sites); ("?", name) entries
    # resolve late.
    param_attrs: dict[str, str] = field(default_factory=dict)
    attr_flow: dict[str, list[tuple[str, str]]] = field(default_factory=dict)


@dataclass
class _ModuleInfo:
    mod: str
    relpath: str
    tree: ast.Module
    # local name -> ("module", mod) | ("member", (mod, name))
    imports: dict[str, tuple[str, object]] = field(default_factory=dict)
    functions: dict[str, str] = field(default_factory=dict)  # name -> qualname
    classes: dict[str, str] = field(default_factory=dict)
    locks: dict[str, str] = field(default_factory=dict)      # global -> key


@dataclass(frozen=True)
class OrderEdge:
    src: str
    dst: str
    func: str      # function whose acquire created the edge
    path: str
    line: int


@dataclass
class ThreadRoot:
    role: str
    func: str      # entry function qualname
    path: str
    line: int
    via: str       # "thread" | "pool" | "callback"


class ConcurrencyModel:
    """The analyzed whole-package concurrency state."""

    def __init__(self) -> None:
        self.locks: dict[str, LockInfo] = {}
        self.functions: dict[str, _FuncInfo] = {}
        self.classes: dict[tuple[str, str], _ClassInfo] = {}
        self.modules: dict[str, _ModuleInfo] = {}
        self.roots: list[ThreadRoot] = []
        self.edges: dict[tuple[str, str], OrderEdge] = {}
        self.entry_held: dict[str, set[str]] = {}
        # func -> role -> (caller qualname | None, path, line)
        self.roles: dict[str, dict[str, tuple[str | None, str, int]]] = {}
        self.findings: list[Diagnostic] = []
        self.unresolved_acquires: list[tuple[str, str, int]] = []
        self.subclasses: dict[tuple[str, str], list[tuple[str, str]]] = {}

    # ------------------------------------------------------------- queries

    def lock_at(self, path: str, line: int) -> LockInfo | None:
        """Creation-site lookup for the witness cross-check: the witness
        records the frame of the ``threading.Lock()`` call, which sits
        inside the assignment statement the static pass recorded."""
        for lk in self.locks.values():
            if lk.path == path and lk.line <= line <= lk.end_line:
                return lk
        return None

    def role_chain(self, func: str, role: str) -> list[tuple[str, str, int]]:
        """Call chain (qualname, path, line) from the thread root of
        ``role`` down to ``func``, for diagnostics."""
        chain: list[tuple[str, str, int]] = []
        cur: str | None = func
        seen = set()
        while cur is not None and cur not in seen:
            seen.add(cur)
            prov = self.roles.get(cur, {}).get(role)
            if prov is None:
                break
            caller, path, line = prov
            chain.append((cur, path, line))
            cur = caller
        chain.reverse()
        return chain

    # ------------------------------------------------------------- exports

    def graph_json(self) -> dict:
        """The reviewable lock-graph artifact. Node/edge identity is the
        stable lock NAME, and via/site carry qualnames + paths WITHOUT
        line numbers, so the committed artifact churns only when the
        concurrency structure actually changes — never on unrelated line
        drift. Diagnostics (the lint findings) keep exact file:line."""
        roles_by_func: dict[str, list[str]] = {
            fq: sorted(r) for fq, r in self.roles.items() if r
        }
        return {
            "comment": (
                "Rendered by `python -m tpu_pod_exporter_torch.analysis "
                "--lock-graph`. Reviewed artifact: an edge A->B means "
                "some path acquires B while holding A; cycles would be "
                "deadlock candidates and fail exporter-lint."
            ),
            "locks": [
                {"key": k.key, "kind": k.kind, "path": k.path}
                for k in sorted(self.locks.values(), key=lambda k: k.key)
            ],
            "edges": [
                {
                    "from": e.src, "to": e.dst,
                    "via": f"{e.func} ({e.path})",
                }
                for _, e in sorted(self.edges.items())
            ],
            "modeled_edges": [
                {"from": m.src, "to": m.dst, "reason": m.reason}
                for m in MODELED_EDGES
            ],
            "thread_roots": [
                dict(t) for t in sorted({
                    (("role", r.role), ("entry", r.func),
                     ("via", r.via), ("site", r.path))
                    for r in self.roots
                })
            ],
            "ownership": [
                {
                    "func": o.func, "allowed": list(o.allowed),
                    "reason": o.reason,
                    **({"guarded_flag": o.guarded_flag}
                       if o.guarded_flag else {}),
                }
                for o in OWNERSHIP
            ],
            "function_roles": {
                fq: roles_by_func[fq] for fq in sorted(roles_by_func)
            },
        }

    def graph_dot(self) -> str:
        lines = [
            "// Lock-acquisition order graph "
            "(exporter-lint --lock-graph-dot)",
            "digraph lock_order {",
            "  rankdir=LR;",
            '  node [shape=box, fontname="monospace", fontsize=10];',
        ]
        used = {e.src for e in self.edges.values()}
        used |= {e.dst for e in self.edges.values()}
        for key in sorted(used):
            kind = self.locks[key].kind if key in self.locks else "?"
            lines.append(f'  "{key}" [label="{key}\\n({kind})"];')
        # Labels carry the path only: the .dot is committed and
        # freshness-gated alongside the JSON, so line numbers would make
        # it churn on unrelated line drift (exact file:line lives in the
        # lint diagnostics, not the reviewed artifact).
        for (src, dst), e in sorted(self.edges.items()):
            lines.append(
                f'  "{src}" -> "{dst}" [label="{e.path}"];'
            )
        for m in MODELED_EDGES:
            lines.append(
                f'  "{m.src}" -> "{m.dst}" '
                f'[style=dashed, label="declared"];'
            )
        lines.append("}")
        return "\n".join(lines) + "\n"


# --------------------------------------------------------------- AST helpers


def _mod_name(relpath: str) -> str:
    """tpu_pod_exporter_torch/metrics/registry.py -> "metrics.registry"."""
    parts = relpath.split("/")
    if parts and parts[0] == _PKG:
        parts = parts[1:]
    if parts and parts[-1] == "__init__.py":
        parts = parts[:-1]
    elif parts:
        parts[-1] = parts[-1][:-3]
    return ".".join(parts) if parts else _PKG


def _terminal(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _lock_factory_kind(call: ast.Call) -> str | None:
    """"lock"/"rlock"/"condition" when ``call`` constructs a threading
    primitive (``threading.Lock()`` or a bare imported ``Lock()``)."""
    fn = call.func
    name = _terminal(fn)
    if name not in _LOCK_FACTORIES:
        return None
    if isinstance(fn, ast.Attribute):
        if not (isinstance(fn.value, ast.Name)
                and fn.value.id == "threading"):
            return None
    return _LOCK_FACTORIES[name]


def _annotation_class(node: ast.expr | None) -> str | None:
    """Best-effort class name out of an annotation: ``WalBuffer``,
    ``"WalBuffer"``, ``Optional[WalBuffer]``, ``WalBuffer | None``."""
    if node is None:
        return None
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        text = node.value.split("|")[0].strip()
        text = text.split("[")[-1].rstrip("]").strip()
        return text.split(".")[-1] or None
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):
        return _annotation_class(node.slice)
    if isinstance(node, ast.BinOp):        # X | None
        return _annotation_class(node.left)
    return None


_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)


def _iter_no_defs(node: ast.AST) -> Iterator[ast.AST]:
    """``node`` plus descendants, never descending into defs/lambdas —
    their bodies run elsewhere and are analyzed as their own
    functions."""
    stack: list[ast.AST] = [node]
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, _DEFS):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _stmt_parts(
    stmt: ast.stmt,
) -> tuple[list[ast.expr], list[list[ast.stmt]]]:
    """One level of a statement: its expression operands and its nested
    statement lists (if/for/while/try bodies, match cases)."""
    exprs: list[ast.expr] = []
    lists: list[list[ast.stmt]] = []
    for _, value in ast.iter_fields(stmt):
        if isinstance(value, list):
            if not value:
                continue
            head = value[0]
            if isinstance(head, ast.stmt):
                lists.append(value)
            elif isinstance(head, ast.ExceptHandler):
                for h in value:
                    lists.append(h.body)
            elif isinstance(head, ast.expr):
                exprs.extend(value)
            elif hasattr(ast, "match_case") and isinstance(
                    head, ast.match_case):
                for mc in value:
                    lists.append(mc.body)
                    if mc.guard is not None:
                        exprs.append(mc.guard)
        elif isinstance(value, ast.expr):
            exprs.append(value)
    return exprs, lists


def _io_offence(call: ast.Call) -> str | None:
    # Shared predicate with the statement-level lock-io rule; imported
    # lazily to keep the rules <-> concurrency import acyclic.
    from tpu_pod_exporter_torch.analysis.rules import _lock_io_offence
    return _lock_io_offence(call)


# ----------------------------------------------------------------- builder


class _Builder:
    def __init__(
        self,
        package_trees: dict[str, ast.Module],
        ownership: tuple[OwnershipRule, ...] | None = None,
    ) -> None:
        self.m = ConcurrencyModel()
        self.trees = package_trees
        self.ownership = OWNERSHIP if ownership is None else ownership
        # method name -> [(mod, Class)] for the unique-definition fallback
        self._method_index: dict[str, list[tuple[str, str]]] = {}

    def build(self) -> ConcurrencyModel:
        for relpath, tree in sorted(self.trees.items()):
            self._index_module(relpath, tree)
        self._resolve_bases()
        for fq in list(self.m.functions):
            self._summarize(self.m.functions[fq])
        self._flow_ctor_args()
        self._resolve_calls()
        self._discover_roots()
        self._propagate()
        self._derive_edges()
        self._check_order_cycles()
        self._check_io_chains()
        self._check_ownership()
        self.m.findings.sort(key=lambda d: (d.path, d.line, d.rule))
        return self.m

    # ------------------------------------------------------ pass 1: index

    def _index_module(self, relpath: str, tree: ast.Module) -> None:
        mod = _mod_name(relpath)
        mi = _ModuleInfo(mod=mod, relpath=relpath, tree=tree)
        self.m.modules[mod] = mi
        for stmt in tree.body:
            self._index_top_stmt(mi, stmt)
            # Imports inside ``if TYPE_CHECKING:`` / try blocks still bind
            # names the annotations and calls refer to.
            if isinstance(stmt, (ast.If, ast.Try)):
                for _, sub in ast.iter_fields(stmt):
                    if isinstance(sub, list):
                        for s in sub:
                            if isinstance(s, (ast.Import, ast.ImportFrom)):
                                self._index_top_stmt(mi, s)
                            elif isinstance(s, ast.ExceptHandler):
                                for hs in s.body:
                                    if isinstance(hs, (ast.Import,
                                                       ast.ImportFrom)):
                                        self._index_top_stmt(mi, hs)

    def _index_top_stmt(self, mi: _ModuleInfo, stmt: ast.stmt) -> None:
        mod = mi.mod
        if isinstance(stmt, ast.Import):
            for alias in stmt.names:
                if alias.name.startswith(_PKG + "."):
                    sub = alias.name[len(_PKG) + 1:]
                    local = alias.asname or alias.name.split(".")[0]
                    mi.imports[local] = ("module", sub)
        elif isinstance(stmt, ast.ImportFrom):
            src = stmt.module or ""
            if src == _PKG:
                for alias in stmt.names:
                    mi.imports[alias.asname or alias.name] = \
                        ("module", alias.name)
            elif src.startswith(_PKG + "."):
                sub = src[len(_PKG) + 1:]
                for alias in stmt.names:
                    mi.imports[alias.asname or alias.name] = \
                        ("member", (sub, alias.name))
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fq = f"{mod}.{stmt.name}"
            mi.functions[stmt.name] = fq
            self.m.functions[fq] = _FuncInfo(
                qualname=fq, relpath=mi.relpath, mod=mod, cls=None,
                node=stmt)
        elif isinstance(stmt, ast.ClassDef):
            self._index_class(mi, stmt)
        elif isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            value = stmt.value
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            if isinstance(value, ast.Call):
                kind = _lock_factory_kind(value)
                if kind is not None:
                    for t in targets:
                        if isinstance(t, ast.Name):
                            key = f"{mod}.{t.id}"
                            self.m.locks[key] = LockInfo(
                                key, kind, mi.relpath, stmt.lineno,
                                getattr(stmt, "end_lineno", stmt.lineno)
                                or stmt.lineno)
                            mi.locks[t.id] = key

    def _index_class(self, mi: _ModuleInfo, node: ast.ClassDef) -> None:
        mod = mi.mod
        ci = _ClassInfo(mod=mod, name=node.name, node=node,
                        relpath=mi.relpath)
        self.m.classes[(mod, node.name)] = ci
        mi.classes[node.name] = node.name
        ci.base_exprs = list(node.bases)
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fq = f"{mod}.{node.name}.{stmt.name}"
                ci.methods[stmt.name] = fq
                self.m.functions[fq] = _FuncInfo(
                    qualname=fq, relpath=mi.relpath, mod=mod,
                    cls=node.name, node=stmt)
                self._method_index.setdefault(stmt.name, []).append(
                    (mod, node.name))
                self._index_attr_sites(ci, stmt)
            elif isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                value = stmt.value
                if isinstance(value, ast.Call):
                    kind = _lock_factory_kind(value)
                    if kind is not None:
                        for t in targets:
                            if isinstance(t, ast.Name):
                                key = f"{mod}.{node.name}.{t.id}"
                                self.m.locks[key] = LockInfo(
                                    key, kind, mi.relpath, stmt.lineno,
                                    getattr(stmt, "end_lineno",
                                            stmt.lineno) or stmt.lineno)
                                ci.locks[t.id] = key
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                        stmt.target, ast.Name):
                    cls_name = _annotation_class(stmt.annotation)
                    # Dataclass-style lock fields:
                    # ``lock: threading.Lock = field(default_factory=
                    # threading.Lock)`` — created at instantiation time
                    # by the generated __init__; the runtime witness keys
                    # it by this declaration line too.
                    if cls_name in _LOCK_FACTORIES:
                        key = f"{mod}.{node.name}.{stmt.target.id}"
                        self.m.locks[key] = LockInfo(
                            key, _LOCK_FACTORIES[cls_name], mi.relpath,
                            stmt.lineno,
                            getattr(stmt, "end_lineno", stmt.lineno)
                            or stmt.lineno)
                        ci.locks[stmt.target.id] = key
                    elif cls_name:
                        ci.attr_types.setdefault(
                            stmt.target.id, ("?", cls_name))

    def _index_attr_sites(
        self, ci: _ClassInfo,
        fn: ast.FunctionDef | ast.AsyncFunctionDef,
    ) -> None:
        """``self.X = <lock factory>()`` / ``self.X = C(...)`` / annotated
        params assigned to attributes — lock identities and attr types."""
        param_types: dict[str, str] = {}
        args = fn.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            cls_name = _annotation_class(a.annotation)
            if cls_name:
                param_types[a.arg] = cls_name
        for stmt in ast.walk(fn):
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            value = stmt.value
            for t in targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                attr = t.attr
                if isinstance(stmt, ast.AnnAssign):
                    cls_name = _annotation_class(stmt.annotation)
                    if cls_name:
                        ci.attr_types.setdefault(attr, ("?", cls_name))
                if isinstance(value, ast.Call):
                    kind = _lock_factory_kind(value)
                    if kind is not None:
                        if attr not in ci.locks:
                            key = f"{ci.mod}.{ci.name}.{attr}"
                            self.m.locks[key] = LockInfo(
                                key, kind, ci.relpath, stmt.lineno,
                                getattr(stmt, "end_lineno", stmt.lineno)
                                or stmt.lineno)
                            ci.locks[attr] = key
                    else:
                        ctor = self._class_of_call(ci.mod, value)
                        if ctor is not None:
                            ci.attr_types[attr] = ctor
                elif (isinstance(value, ast.Name)
                        and value.id in param_types):
                    resolved = self._resolve_class_name(
                        ci.mod, param_types[value.id])
                    if resolved is not None:
                        ci.attr_types[attr] = resolved
                elif (isinstance(value, ast.Name) and fn.name == "__init__"
                        and value.id in {a.arg for a in args.args[1:]
                                         + args.kwonlyargs}):
                    ci.param_attrs[value.id] = attr
        # ``if driver is None: driver = Default()`` before ``self.X =
        # driver``: the default (often imported lazily, inside the
        # function) is one of the classes the attribute holds.
        for stmt in ast.walk(fn):
            if (ci.param_attrs and isinstance(stmt, ast.Assign)
                    and isinstance(stmt.value, ast.Call)):
                for t in stmt.targets:
                    if isinstance(t, ast.Name) and t.id in ci.param_attrs:
                        ci.attr_flow.setdefault(
                            ci.param_attrs[t.id], []).append(
                            ("?", _terminal(stmt.value.func)))

    # --------------------------------------------------- name resolution

    def _class_of_call(
        self, mod: str, call: ast.Call
    ) -> tuple[str, str] | None:
        """(mod, Class) when ``call`` constructs a package class."""
        fn = call.func
        if isinstance(fn, ast.Name):
            return self._resolve_class_name(mod, fn.id)
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
            target = self._resolve_name(mod, fn.value.id)
            if target is not None and target[0] == "module":
                other = self.m.modules.get(str(target[1]))
                if other is not None and fn.attr in other.classes:
                    return (other.mod, fn.attr)
        return None

    def _resolve_name(
        self, mod: str, name: str
    ) -> tuple[str, object] | None:
        mi = self.m.modules.get(mod)
        if mi is None:
            return None
        if name in mi.classes:
            return ("class", (mod, name))
        if name in mi.functions:
            return ("func", mi.functions[name])
        imp = mi.imports.get(name)
        if imp is None:
            return None
        tag, payload = imp
        if tag == "module":
            return ("module", payload)
        src_mod, member = payload  # type: ignore[misc]
        other = self.m.modules.get(src_mod)
        if other is None:
            return None
        if member in other.classes:
            return ("class", (src_mod, member))
        if member in other.functions:
            return ("func", other.functions[member])
        if member in other.locks:
            return ("lock", other.locks[member])
        return None

    def _resolve_class_name(
        self, mod: str, name: str
    ) -> tuple[str, str] | None:
        r = self._resolve_name(mod, name)
        if r is not None and r[0] == "class":
            return r[1]  # type: ignore[return-value]
        # Unique class name across the package (covers TYPE_CHECKING-only
        # imports and string annotations).
        hits = [k for k in self.m.classes if k[1] == name]
        return hits[0] if len(hits) == 1 else None

    def _resolve_bases(self) -> None:
        for ci in self.m.classes.values():
            for b in ci.base_exprs:
                resolved: tuple[str, str] | None = None
                if isinstance(b, ast.Name):
                    resolved = self._resolve_class_name(ci.mod, b.id)
                elif isinstance(b, ast.Attribute):
                    fake = ast.Call(func=b, args=[], keywords=[])
                    resolved = self._class_of_call(ci.mod, fake)
                if resolved is not None:
                    ci.bases.append(resolved)
                    self.m.subclasses.setdefault(resolved, []).append(
                        (ci.mod, ci.name))

    def _mro(self, key: tuple[str, str]) -> list[_ClassInfo]:
        out: list[_ClassInfo] = []
        seen: set[tuple[str, str]] = set()
        stack = [key]
        while stack:
            k = stack.pop(0)
            if k in seen:
                continue
            seen.add(k)
            ci = self.m.classes.get(k)
            if ci is None:
                continue
            out.append(ci)
            stack.extend(ci.bases)
        return out

    def _descendants(self, key: tuple[str, str]) -> list[tuple[str, str]]:
        out: list[tuple[str, str]] = []
        stack = list(self.m.subclasses.get(key, ()))
        seen: set[tuple[str, str]] = set()
        while stack:
            k = stack.pop()
            if k in seen:
                continue
            seen.add(k)
            out.append(k)
            stack.extend(self.m.subclasses.get(k, ()))
        return out

    # --------------------------------------- pass 2: function summaries

    def _summarize(self, fi: _FuncInfo) -> None:
        node = fi.node
        if isinstance(node, ast.Lambda):
            body: list[ast.stmt] = [ast.Expr(value=node.body)]
        else:
            body = node.body
            for a in (node.args.posonlyargs + node.args.args
                      + node.args.kwonlyargs):
                cls_name = _annotation_class(a.annotation)
                if cls_name:
                    resolved = self._resolve_class_name(fi.mod, cls_name)
                    if resolved is not None:
                        fi.local_types[a.arg] = resolved
        self._register_nested(fi, body)
        self._walk_events(fi, body, frozenset())

    def _register_nested(self, fi: _FuncInfo, body: list[ast.stmt]) -> None:
        """Nested defs become their own functions, callable via local
        name (closures handed to Thread targets / submit)."""
        stack: list[ast.AST] = list(body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fq = f"{fi.qualname}.<{n.name}>"
                child = _FuncInfo(
                    qualname=fq, relpath=fi.relpath, mod=fi.mod,
                    cls=fi.cls, node=n)
                # Closures read the enclosing frame's bindings.
                child.local_types = dict(fi.local_types)
                child.local_locks = dict(fi.local_locks)
                child.local_funcs = fi.local_funcs
                self.m.functions[fq] = child
                fi.local_funcs[n.name] = fq
                self._register_nested(child, n.body)
                self._walk_events(child, n.body, frozenset())
                continue
            if isinstance(n, ast.Lambda):
                # Lambdas are functions too: a ``lambda: self._respond(..)``
                # handed through an UNRESOLVED registrar (hub.subscribe's
                # writer=) still contains call_soon registrations whose
                # callbacks the loop runs — skipping the body here would
                # leave those callbacks role-less, and the loop-stall
                # witness would observe functions the static model cannot
                # explain. Same identity scheme as _callable_arg_targets.
                fq = f"{fi.qualname}.<lambda@{n.lineno}>"
                if fq not in self.m.functions:
                    child = _FuncInfo(
                        qualname=fq, relpath=fi.relpath, mod=fi.mod,
                        cls=fi.cls, node=n)
                    child.local_types = dict(fi.local_types)
                    child.local_locks = dict(fi.local_locks)
                    child.local_funcs = fi.local_funcs
                    self.m.functions[fq] = child
                    body_stmt: list[ast.stmt] = [ast.Expr(value=n.body)]
                    self._register_nested(child, body_stmt)
                    self._walk_events(child, body_stmt, frozenset())
                continue
            if isinstance(n, ast.ClassDef):
                continue
            stack.extend(ast.iter_child_nodes(n))

    def _walk_events(
        self, fi: _FuncInfo, body: list[ast.stmt], held: frozenset[str]
    ) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                new_held = held
                for item in stmt.items:
                    self._scan_expr(fi, item.context_expr, held)
                    key = self._lock_expr_key(fi, item.context_expr)
                    if key is not None:
                        fi.acquires.append(_Acquire(
                            key, item.context_expr.lineno, new_held))
                        new_held = new_held | {key}
                    else:
                        name = _terminal(item.context_expr)
                        if ("lock" in name.lower()
                                or name.lstrip("_") in ("cv", "cond")):
                            self.m.unresolved_acquires.append(
                                (fi.qualname, fi.relpath,
                                 item.context_expr.lineno))
                self._walk_events(fi, stmt.body, new_held)
                continue
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                self._index_local_assign(fi, stmt)
            exprs, stmt_lists = _stmt_parts(stmt)
            for e in exprs:
                self._scan_expr(fi, e, held)
            for sub in stmt_lists:
                self._walk_events(fi, sub, held)

    def _index_local_assign(
        self, fi: _FuncInfo, stmt: ast.Assign | ast.AnnAssign
    ) -> None:
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        value = stmt.value
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        if not names:
            return
        if isinstance(value, ast.Call):
            kind = _lock_factory_kind(value)
            if kind is not None:
                for name in names:
                    key = f"{fi.qualname}.<{name}>"
                    if key not in self.m.locks:
                        self.m.locks[key] = LockInfo(
                            key, kind, fi.relpath, stmt.lineno,
                            getattr(stmt, "end_lineno", stmt.lineno)
                            or stmt.lineno)
                    fi.local_locks[name] = key
                return
            ctor = self._class_of_call(fi.mod, value)
            if ctor is not None:
                for name in names:
                    fi.local_types[name] = ctor
        elif (isinstance(value, ast.Attribute)
                and isinstance(value.value, ast.Name)
                and value.value.id in ("self", "cls")
                and fi.cls is not None):
            # ``st = self.state`` — the typed-attribute alias idiom the
            # server request paths use.
            t = self._attr_type((fi.mod, fi.cls), value.attr)
            for name in names:
                if t is not None:
                    fi.local_types[name] = t
                else:
                    fi.local_aliases[name] = value.attr
        if isinstance(stmt, ast.AnnAssign):
            cls_name = _annotation_class(stmt.annotation)
            if cls_name:
                resolved = self._resolve_class_name(fi.mod, cls_name)
                if resolved:
                    for name in names:
                        fi.local_types.setdefault(name, resolved)

    def _scan_expr(
        self, fi: _FuncInfo, expr: ast.expr, held: frozenset[str]
    ) -> None:
        for n in _iter_no_defs(expr):
            if isinstance(n, ast.Call):
                fi.calls.append(_CallSite(node=n, line=n.lineno, held=held))
                why = _io_offence(n)
                if why is not None:
                    fi.io.append((n.lineno, why))

    def _lock_expr_key(self, fi: _FuncInfo, expr: ast.expr) -> str | None:
        """Resolve a ``with`` context expression to a lock key."""
        if isinstance(expr, ast.Name):
            if expr.id in fi.local_locks:
                return fi.local_locks[expr.id]
            mi = self.m.modules.get(fi.mod)
            if mi is not None and expr.id in mi.locks:
                return mi.locks[expr.id]
            r = self._resolve_name(fi.mod, expr.id)
            if r is not None and r[0] == "lock":
                return str(r[1])
            return None
        if not isinstance(expr, ast.Attribute):
            return None
        base = expr.value
        if isinstance(base, ast.Name) and base.id in ("self", "cls"):
            if fi.cls is None:
                return None
            for ci in self._mro((fi.mod, fi.cls)):
                if expr.attr in ci.locks:
                    return ci.locks[expr.attr]
            return None
        if isinstance(base, ast.Name):
            t = fi.local_types.get(base.id)
            if t is not None:
                for ci in self._mro(t):
                    if expr.attr in ci.locks:
                        return ci.locks[expr.attr]
                return None
            r = self._resolve_name(fi.mod, base.id)
            if r is None:
                return None
            if r[0] == "class":
                for ci in self._mro(r[1]):  # type: ignore[arg-type]
                    if expr.attr in ci.locks:
                        return ci.locks[expr.attr]
            elif r[0] == "module":
                other = self.m.modules.get(str(r[1]))
                if other is not None and expr.attr in other.locks:
                    return other.locks[expr.attr]
            return None
        if (isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self" and fi.cls is not None):
            # self.X.Y — lock attribute of a typed instance attribute.
            t = self._attr_type((fi.mod, fi.cls), base.attr)
            if t is not None:
                for tci in self._mro(t):
                    if expr.attr in tci.locks:
                        return tci.locks[expr.attr]
        return None

    def _attr_type(
        self, cls_key: tuple[str, str], attr: str
    ) -> tuple[str, str] | None:
        for ci in self._mro(cls_key):
            t = ci.attr_types.get(attr)
            if t is None:
                continue
            if t[0] != "?":
                return t
            resolved = self._resolve_class_name(ci.mod, t[1])
            if resolved is not None:
                return resolved
        return None

    # ------------------------------------------- pass 3: call resolution

    def _flow_ctor_args(self) -> None:
        """Each construction site ``C(p=expr)`` of a package class whose
        ``__init__`` stores the unannotated ``p`` on self adds the type of
        ``expr`` (a constructor call or a typed local) to what the
        attribute may hold — an injected driver beside the default."""
        for fi in list(self.m.functions.values()):
            for cs in fi.calls:
                key = self._class_of_call(fi.mod, cs.node)
                ci = self.m.classes.get(key) if key is not None else None
                if ci is None or not ci.param_attrs:
                    continue
                init = self.m.functions.get(ci.methods.get("__init__", ""))
                params = ([a.arg for a in init.node.args.args[1:]]
                          if init is not None else [])
                bound = list(zip(params, cs.node.args))
                bound += [(kw.arg, kw.value) for kw in cs.node.keywords]
                for param, expr in bound:
                    attr = ci.param_attrs.get(param or "")
                    t = self._receiver_type(fi, expr) if attr else None
                    if t is not None:
                        ci.attr_flow.setdefault(attr, []).append(t)

    def _attr_flow(
        self, cls_key: tuple[str, str], attr: str
    ) -> list[tuple[str, str]]:
        out: list[tuple[str, str]] = []
        for ci in self._mro(cls_key):
            for t in ci.attr_flow.get(attr, ()):
                if t[0] == "?":
                    t = self._resolve_class_name(ci.mod, t[1])
                if t is not None and t not in out:
                    out.append(t)
        return out

    def _resolve_calls(self) -> None:
        for fi in list(self.m.functions.values()):
            for cs in fi.calls:
                cs.callees = tuple(self._callees_of(fi, cs.node))

    def _method_on(
        self, cls_key: tuple[str, str], name: str, virtual: bool = True
    ) -> list[str]:
        out = []
        for ci in self._mro(cls_key):
            if name in ci.methods:
                out.append(ci.methods[name])
                break
        if virtual:
            # Dynamic dispatch: a subclass override may run instead (the
            # leaf/root aggregator hooks) — include them for completeness.
            for sub in self._descendants(cls_key):
                sci = self.m.classes.get(sub)
                if sci is not None and name in sci.methods:
                    out.append(sci.methods[name])
        return out

    def _ctor_of(self, cls_key: tuple[str, str]) -> list[str]:
        return self._method_on(cls_key, "__init__", virtual=False)

    def _receiver_type(
        self, fi: _FuncInfo, base: ast.expr
    ) -> tuple[str, str] | None:
        if isinstance(base, ast.Name):
            if base.id in ("self", "cls") and fi.cls is not None:
                return (fi.mod, fi.cls)
            if base.id in fi.local_types:
                return fi.local_types[base.id]
            r = self._resolve_name(fi.mod, base.id)
            if r is not None and r[0] == "class":
                return r[1]  # type: ignore[return-value]
            return None
        if (isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id in ("self", "cls")
                and fi.cls is not None):
            return self._attr_type((fi.mod, fi.cls), base.attr)
        if isinstance(base, ast.Call):
            return self._class_of_call(fi.mod, base)
        return None

    def _callees_of(self, fi: _FuncInfo, call: ast.Call) -> list[str]:
        fn = call.func
        if isinstance(fn, ast.Name):
            name = fn.id
            if name in fi.local_funcs:
                return [fi.local_funcs[name]]
            if name == "len" and call.args:
                t = self._receiver_type(fi, call.args[0])
                if t is not None:
                    return self._method_on(t, "__len__", virtual=False)
            r = self._resolve_name(fi.mod, name)
            if r is None:
                return []
            if r[0] == "func":
                return [str(r[1])]
            if r[0] == "class":
                return self._ctor_of(r[1])  # type: ignore[arg-type]
            return []
        if not isinstance(fn, ast.Attribute):
            return []
        mname = fn.attr
        base = fn.value
        if isinstance(base, ast.Name):
            r = self._resolve_name(fi.mod, base.id)
            if (r is not None and r[0] == "module"
                    and base.id not in fi.local_types):
                other = self.m.modules.get(str(r[1]))
                if other is None:
                    return []
                if mname in other.functions:
                    return [other.functions[mname]]
                if mname in other.classes:
                    return self._ctor_of((other.mod, mname))
                return []
        t = self._receiver_type(fi, base)
        if t is not None:
            return self._method_on(t, mname)
        attr = None
        if isinstance(base, ast.Name):
            attr = fi.local_aliases.get(base.id)
        elif (isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id in ("self", "cls")):
            attr = base.attr
        flow = (self._attr_flow((fi.mod, fi.cls), attr)
                if attr is not None and fi.cls is not None else [])
        if flow:
            return [fq for t in flow for fq in self._method_on(t, mname)]
        # Unique-definition fallback for distinctive method names.
        if mname in _COMMON_METHODS or mname.startswith("__"):
            return []
        defs = self._method_index.get(mname, ())
        if len(defs) == 1:
            return self._method_on(defs[0], mname)
        return []

    # ------------------------------------------------- pass 4: roots

    def _discover_roots(self) -> None:
        for fi in list(self.m.functions.values()):
            for cs in list(fi.calls):
                self._root_from_call(fi, cs.node)

    def _callable_arg_targets(
        self, fi: _FuncInfo, arg: ast.expr
    ) -> list[str]:
        """Resolve a callable expression handed to Thread/submit/a
        registrar to the function(s) it would invoke."""
        if isinstance(arg, ast.Lambda):
            fq = f"{fi.qualname}.<lambda@{arg.lineno}>"
            if fq not in self.m.functions:
                child = _FuncInfo(
                    qualname=fq, relpath=fi.relpath, mod=fi.mod,
                    cls=fi.cls, node=arg)
                child.local_types = dict(fi.local_types)
                child.local_locks = dict(fi.local_locks)
                child.local_funcs = fi.local_funcs
                self.m.functions[fq] = child
                self.m.entry_held.setdefault(fq, set())
                self.m.roles.setdefault(fq, {})
                self._walk_events(
                    child, [ast.Expr(value=arg.body)], frozenset())
                for cs in child.calls:
                    cs.callees = tuple(self._callees_of(child, cs.node))
            return [fq]
        if isinstance(arg, ast.Name):
            if arg.id in fi.local_funcs:
                return [fi.local_funcs[arg.id]]
            r = self._resolve_name(fi.mod, arg.id)
            if r is not None and r[0] == "func":
                return [str(r[1])]
            return []
        if isinstance(arg, ast.Attribute):
            t = self._receiver_type(fi, arg.value)
            if t is not None:
                return self._method_on(t, arg.attr)
            if (arg.attr not in _COMMON_METHODS
                    and not arg.attr.startswith("__")
                    and len(self._method_index.get(arg.attr, ())) == 1):
                return self._method_on(
                    self._method_index[arg.attr][0], arg.attr)
        return []

    @staticmethod
    def _thread_name_literal(call: ast.Call) -> str:
        for kw in call.keywords:
            if kw.arg != "name":
                continue
            v = kw.value
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                return v.value
            if isinstance(v, ast.JoinedStr):
                parts = []
                for piece in v.values:
                    if isinstance(piece, ast.Constant):
                        parts.append(str(piece.value))
                    else:
                        parts.append("*")
                return "".join(parts)
        return "<unnamed>"

    def _root_from_call(self, fi: _FuncInfo, call: ast.Call) -> None:
        fn = call.func
        is_thread = (_terminal(fn) == "Thread" and (
            not isinstance(fn, ast.Attribute)
            or _terminal(fn.value) == "threading"))
        if is_thread:
            target = None
            for kw in call.keywords:
                if kw.arg == "target":
                    target = kw.value
            if target is None:
                return
            role = self._thread_name_literal(call)
            for fq in self._callable_arg_targets(fi, target):
                self.m.roots.append(ThreadRoot(
                    role=role, func=fq, path=fi.relpath,
                    line=call.lineno, via="thread"))
            return
        # ThreadPoolExecutor fan-out: submit(fn, ...) / map(fn, ...) on a
        # receiver that is NOT a package class (package pools declare
        # their worker role via CALLBACK_ROLES instead).
        if (isinstance(fn, ast.Attribute) and fn.attr in ("submit", "map")
                and call.args):
            t = self._receiver_type(fi, fn.value)
            recv = _terminal(fn.value).lstrip("_").lower()
            if t is None and ("pool" in recv or "executor" in recv):
                owner = fi.cls or fi.qualname.rsplit(".", 1)[-1]
                role = f"pool:{fi.mod}.{owner}"
                for fq in self._callable_arg_targets(fi, call.args[0]):
                    self.m.roots.append(ThreadRoot(
                        role=role, func=fq, path=fi.relpath,
                        line=call.lineno, via="pool"))
        callees = self._callees_of(fi, call)
        for cb in CALLBACK_ROLES:
            if cb.method not in callees:
                continue
            for idx in cb.arg_indices:
                if idx >= len(call.args):
                    continue
                for fq in self._callable_arg_targets(fi, call.args[idx]):
                    for role in cb.roles:
                        self.m.roots.append(ThreadRoot(
                            role=role, func=fq, path=fi.relpath,
                            line=call.lineno, via="callback"))

    # --------------------------------------------- pass 5: propagation

    def _propagate(self) -> None:
        m = self.m
        for fq in m.functions:
            m.entry_held.setdefault(fq, set())
            m.roles.setdefault(fq, {})
        for root in m.roots:
            if root.func in m.roles and root.role not in m.roles[root.func]:
                m.roles[root.func][root.role] = (
                    None, root.path, root.line)
        work = list(m.functions)
        in_work = set(work)
        while work:
            fq = work.pop()
            in_work.discard(fq)
            fi = m.functions[fq]
            entry = m.entry_held[fq]
            roles = m.roles[fq]
            for cs in fi.calls:
                for callee in cs.callees:
                    if callee not in m.functions:
                        continue
                    changed = False
                    target_held = m.entry_held[callee]
                    add = (entry | cs.held) - target_held
                    if add:
                        target_held |= add
                        changed = True
                    target_roles = m.roles[callee]
                    for role in roles:
                        if role not in target_roles:
                            target_roles[role] = (fq, fi.relpath, cs.line)
                            changed = True
                    if changed and callee not in in_work:
                        work.append(callee)
                        in_work.add(callee)

    # ------------------------------------------------ pass 6: contracts

    def _derive_edges(self) -> None:
        m = self.m
        for fq, fi in m.functions.items():
            entry = frozenset(m.entry_held[fq])
            for acq in fi.acquires:
                held = entry | acq.held
                for src in held:
                    if src == acq.key:
                        info = m.locks.get(acq.key)
                        if info is not None and info.kind != "rlock":
                            m.findings.append(Diagnostic(
                                "lock-order", ERROR, fi.relpath, acq.line,
                                f"re-acquisition of non-reentrant lock "
                                f"{acq.key} while already held on some "
                                f"path through {fq}() — self-deadlock "
                                f"(split the critical section, or use "
                                f"RLock with a written justification)",
                            ))
                        continue
                    edge = (src, acq.key)
                    if edge not in m.edges:
                        m.edges[edge] = OrderEdge(
                            src=src, dst=acq.key, func=fq,
                            path=fi.relpath, line=acq.line)

    def _check_order_cycles(self) -> None:
        m = self.m
        adj: dict[str, list[str]] = {}
        for (src, dst) in m.edges:
            adj.setdefault(src, []).append(dst)
        for me in MODELED_EDGES:
            adj.setdefault(me.src, []).append(me.dst)
        sccs = _tarjan_sccs(adj)
        for comp in sccs:
            comp_set = set(comp)
            cycle = self._cycle_path(comp_set, adj)
            anchor = None
            for i in range(len(cycle) - 1):
                e = m.edges.get((cycle[i], cycle[i + 1]))
                if e is not None:
                    anchor = e
                    break
            path = anchor.path if anchor else f"{_PKG}/__init__.py"
            line = anchor.line if anchor else 1
            via = " -> ".join(cycle)
            m.findings.append(Diagnostic(
                "lock-order", ERROR, path, line,
                f"lock-order cycle (deadlock candidate): {via}. Two "
                f"paths acquire these locks in opposite orders; impose "
                f"a single global order (acquire the earlier lock first "
                f"everywhere) or collapse the critical sections",
            ))

    @staticmethod
    def _cycle_path(comp: set[str], adj: dict[str, list[str]]) -> list[str]:
        start = sorted(comp)[0]
        path = [start]
        seen = {start}
        cur = start
        while True:
            nxt = None
            for w in sorted(adj.get(cur, ())):
                if w in comp:
                    if w == start:
                        return path + [start]
                    if w not in seen:
                        nxt = w
                        break
            if nxt is None:
                return path + [start]
            path.append(nxt)
            seen.add(nxt)
            cur = nxt

    def _check_io_chains(self) -> None:
        m = self.m
        # fq -> (why, via-callee | None, chain depth)
        reaches: dict[str, tuple[str, str | None, int]] = {}
        for fq, fi in m.functions.items():
            if fi.io:
                reaches[fq] = (fi.io[0][1], None, 0)
        changed = True
        while changed:
            changed = False
            for fq, fi in m.functions.items():
                if fq in reaches:
                    continue
                for cs in fi.calls:
                    hit = next(
                        (c for c in cs.callees if c in reaches), None)
                    if hit is not None:
                        reaches[fq] = (
                            reaches[hit][0], hit, reaches[hit][2] + 1)
                        changed = True
                        break
        reported: set[tuple[str, int]] = set()
        for fq, fi in m.functions.items():
            for cs in fi.calls:
                if not cs.held:
                    continue
                for callee in cs.callees:
                    if callee not in reaches:
                        continue
                    key = (fi.relpath, cs.line)
                    if key in reported:
                        break
                    reported.add(key)
                    why, _, _depth = reaches[callee]
                    chain = self._io_chain(callee, reaches)
                    held = ", ".join(sorted(cs.held))
                    m.findings.append(Diagnostic(
                        "lock-io-chain", ERROR, fi.relpath, cs.line,
                        f"call under lock ({held}) transitively performs "
                        f"{why} via {' -> '.join(chain)} — the lock-io "
                        f"rule, interprocedural: move the call outside "
                        f"the critical section or make the callee "
                        f"lock-free",
                    ))
                    break

    @staticmethod
    def _io_chain(
        start: str, reaches: dict[str, tuple[str, str | None, int]]
    ) -> list[str]:
        chain = [start]
        cur: str | None = start
        while cur is not None and cur in reaches:
            nxt = reaches[cur][1]
            if nxt is None:
                break
            chain.append(nxt)
            cur = nxt
        return chain

    def _check_ownership(self) -> None:
        m = self.m
        for rule in self.ownership:
            fi = m.functions.get(rule.func)
            if fi is None:
                m.findings.append(Diagnostic(
                    "lock-ownership", ERROR,
                    f"{_PKG}/analysis/concurrency.py", 1,
                    f"ownership table names {rule.func}() but no such "
                    f"function exists — the table rotted; update "
                    f"OWNERSHIP in analysis/concurrency.py",
                ))
                continue
            if rule.allowed != ("*",):
                for role, prov in sorted(
                        m.roles.get(rule.func, {}).items()):
                    if any(fnmatchcase(role, pat)
                           for pat in rule.allowed):
                        continue
                    chain = m.role_chain(rule.func, role)
                    via = " -> ".join(fq for fq, _, _ in chain) \
                        or rule.func
                    _caller, path, line = prov
                    m.findings.append(Diagnostic(
                        "lock-ownership", ERROR, path, line,
                        f"{rule.func}() may run on thread '{role}' "
                        f"(via {via}) but is owned by "
                        f"{'/'.join(rule.allowed)} — {rule.reason}",
                    ))
            if rule.guarded_flag is not None:
                self._check_guarded_flag(fi, rule)

    def _check_guarded_flag(
        self, fi: _FuncInfo, rule: OwnershipRule
    ) -> None:
        """Every ``self.<flag>`` READ in the function must sit inside a
        ``with self.<lock>:`` block of the same class."""
        if isinstance(fi.node, ast.Lambda):
            return
        flag = rule.guarded_flag
        offenders: list[int] = []

        def check_exprs(exprs: list[ast.expr], guarded: bool) -> None:
            if guarded:
                return
            for e in exprs:
                for n in _iter_no_defs(e):
                    if (isinstance(n, ast.Attribute) and n.attr == flag
                            and isinstance(n.value, ast.Name)
                            and n.value.id == "self"
                            and isinstance(n.ctx, ast.Load)):
                        offenders.append(n.lineno)

        def scan(body: list[ast.stmt], guarded: bool) -> None:
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.ClassDef)):
                    continue
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    inner = guarded
                    for item in stmt.items:
                        check_exprs([item.context_expr], guarded)
                        if self._lock_expr_key(fi, item.context_expr):
                            inner = True
                    scan(stmt.body, inner)
                    continue
                exprs, stmt_lists = _stmt_parts(stmt)
                check_exprs(exprs, guarded)
                for sub in stmt_lists:
                    scan(sub, guarded)

        scan(fi.node.body, False)
        for line in sorted(set(offenders)):
            self.m.findings.append(Diagnostic(
                "lock-ownership", ERROR, fi.relpath, line,
                f"{rule.func}() reads self.{flag} outside the instance "
                f"lock — the flag must be (re)checked INSIDE the lock: "
                f"{rule.reason}",
            ))


def _tarjan_sccs(adj: dict[str, list[str]]) -> list[list[str]]:
    """Strongly-connected components with >1 node, iteratively."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    counter = [0]
    sccs: list[list[str]] = []

    nodes = set(adj)
    for outs in adj.values():
        nodes.update(outs)

    for v in sorted(nodes):
        if v in index:
            continue
        call_stack: list[tuple[str, Iterator[str]]] = [
            (v, iter(sorted(adj.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while call_stack:
            node, it = call_stack[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    call_stack.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            call_stack.pop()
            if call_stack:
                parent = call_stack[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))
    return sccs


# ------------------------------------------------------------------- facade


def build_model(
    package_trees: dict[str, ast.Module],
    ownership: tuple[OwnershipRule, ...] | None = None,
) -> ConcurrencyModel:
    return _Builder(package_trees, ownership=ownership).build()


def get_model(ctx: "LintContext") -> ConcurrencyModel:
    """Memoized concurrency model for a lint context (the three
    concurrency rules share one whole-tree pass)."""
    cached = getattr(ctx, "_concurrency_model", None)
    if cached is None:
        cached = build_model(ctx.package_trees)
        ctx._concurrency_model = cached  # type: ignore[attr-defined]
    return cached


def check_lock_order(ctx: "LintContext") -> list[Diagnostic]:
    return [d for d in get_model(ctx).findings if d.rule == "lock-order"]


def check_lock_ownership(ctx: "LintContext") -> list[Diagnostic]:
    return [d for d in get_model(ctx).findings
            if d.rule == "lock-ownership"]


def check_lock_io_chain(ctx: "LintContext") -> list[Diagnostic]:
    return [d for d in get_model(ctx).findings
            if d.rule == "lock-io-chain"]


# -------------------------------------------------------------- cross-check


def cross_check(model: ConcurrencyModel, dump: dict) -> list[str]:
    """Witness dump vs static model. Returns human-readable problems
    (empty = the static graph explains everything the tests witnessed).

    Two failure classes:
      * a witnessed lock whose creation site the static pass never
        discovered (the discovery pass rotted);
      * a witnessed acquisition-order edge absent from the static order
        graph and from MODELED_EDGES (the call-graph model rotted).
    """
    problems: list[str] = []
    site_to_key: dict[str, str] = {}
    for wl in dump.get("locks", []):
        path, line = wl.get("path", ""), int(wl.get("line", 0))
        site = wl.get("site", f"{path}:{line}")
        info = model.lock_at(path, line)
        if info is None:
            problems.append(
                f"witnessed lock at {site} has no static identity — "
                f"the discovery pass in analysis/concurrency.py missed "
                f"it")
            continue
        site_to_key[site] = info.key
    static_edges = set(model.edges)
    static_edges.update((m.src, m.dst) for m in MODELED_EDGES)
    for we in dump.get("edges", []):
        src = site_to_key.get(we.get("from", ""))
        dst = site_to_key.get(we.get("to", ""))
        if src is None or dst is None:
            continue  # unknown locks already reported above
        if src == dst:
            # Sibling-instance nesting of one lock class: the static
            # graph keys locks by creation site, so instance-level
            # ordering is invisible to it. Genuine same-instance
            # re-acquisition is flagged by the witness as an inversion.
            continue
        if (src, dst) not in static_edges:
            problems.append(
                f"witnessed order edge {src} -> {dst} "
                f"(observed {we.get('example', 'at runtime')}) is "
                f"absent from the static order graph — the call-graph "
                f"model can no longer explain runtime behavior; extend "
                f"the analysis or declare it in MODELED_EDGES with a "
                f"reason")
    for inv in dump.get("inversions", []):
        problems.append(
            f"witnessed lock-order inversion: "
            f"{inv.get('detail', inv)}")
    return problems
