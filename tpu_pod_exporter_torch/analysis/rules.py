"""The invariant rules, one AST checker per convention.

Each rule is a :class:`Rule` with a kebab-case name (the token used in
``# lint: disable=NAME(reason)``), a severity, a one-line contract, and a
checker. Per-file checkers receive the parsed module plus a
:class:`~tpu_pod_exporter_torch.analysis.engine.LintContext` (the schema registry
and friends); whole-tree rules (flag coverage) run once over the context.

The rules encode THIS codebase's real conventions — they are deliberately
narrow. A rule that cannot decide statically stays silent rather than
guessing: a lint gate that cries wolf gets disabled wholesale, which is
worse than a gap.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Iterator

from tpu_pod_exporter_torch.analysis.diagnostics import ERROR, WARNING, Diagnostic

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, types only
    from tpu_pod_exporter_torch.analysis.engine import LintContext


@dataclass(frozen=True)
class Rule:
    name: str
    severity: str
    summary: str
    # (tree, src_lines, relpath, ctx) -> findings; None for tree-wide rules.
    check_file: Callable | None = None
    # (ctx) -> findings; None for per-file rules.
    check_tree: Callable | None = None


# --------------------------------------------------------------- shared AST


def _terminal_name(node: ast.AST) -> str:
    """Last identifier of a Name/Attribute chain (``self._gzip_lock`` ->
    ``_gzip_lock``; ``os.fsync`` -> ``fsync``); "" when not name-like."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _receiver_name(node: ast.AST) -> str:
    """Terminal name of a call's receiver (``json`` in ``json.dumps``)."""
    if isinstance(node, ast.Attribute):
        return _terminal_name(node.value)
    return ""


def _walk_stop_at_defs(body: list[ast.stmt]) -> Iterator[ast.AST]:
    """Walk statements without descending into nested function/class
    definitions — code inside a nested ``def`` does not run where it is
    written (e.g. a callback defined under a lock runs after release)."""
    defs = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)
    for stmt in body:
        stack: list[ast.AST] = [stmt]
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, defs):
                continue
            stack.extend(ast.iter_child_nodes(node))


def _functions(tree: ast.Module) -> Iterator[ast.FunctionDef | ast.AsyncFunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


# ------------------------------------------------------------------ lock-io

# Receivers whose ``.write(...)`` means bytes leaving the process (files,
# sockets, the WAL) rather than a dict/list mutation.
_WRITEY_RECEIVERS = {
    "f", "fh", "fp", "file", "wfile", "rfile", "sock", "socket",
    "stdout", "stderr", "wal", "_wal", "conn", "connection",
}
_LOG_METHODS = {
    "debug", "info", "warning", "warn", "error", "exception", "critical",
    "log", "recovery",
}


def _lock_io_offence(call: ast.Call) -> str | None:
    """Why this call is I/O/serialization/logging, or None if it is fine."""
    fn = call.func
    if isinstance(fn, ast.Name):
        if fn.id == "open":
            return "open() (file I/O)"
        if fn.id == "print":
            return "print() (stream I/O)"
        return None
    if not isinstance(fn, ast.Attribute):
        return None
    attr = fn.attr
    recv = _receiver_name(fn)
    if attr in ("dumps", "dump") and recv in ("json", "pickle", "marshal"):
        return f"{recv}.{attr}() (serialization)"
    if attr in ("fsync", "fdatasync"):
        return f"{attr}() (disk flush)"
    if attr == "compress" and recv in ("gzip", "zlib", "bz2", "lzma"):
        return f"{recv}.compress() (compression)"
    if attr == "sendall":
        return "socket sendall() (network I/O)"
    if attr == "sleep" and recv == "time":
        return "time.sleep() (blocking)"
    if attr in _LOG_METHODS and "log" in recv.lower():
        return f"{recv}.{attr}() (logging)"
    if attr == "write" and recv in _WRITEY_RECEIVERS:
        return f"{recv}.write() (stream I/O)"
    return None


def _check_lock_io(tree: ast.Module, src_lines: list[str], relpath: str, ctx: "LintContext") -> list[Diagnostic]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        lock_expr = None
        for item in node.items:
            if "lock" in _terminal_name(item.context_expr).lower():
                lock_expr = item.context_expr
                break
        if lock_expr is None:
            continue
        held = _terminal_name(lock_expr)
        for inner in _walk_stop_at_defs(node.body):
            if isinstance(inner, ast.Call):
                why = _lock_io_offence(inner)
                if why is not None:
                    out.append(Diagnostic(
                        "lock-io", ERROR, relpath, inner.lineno,
                        f"{why} inside `with {held}:` — copy under the lock, "
                        f"serialize/log/flush outside it (the "
                        f"copy-then-serialize discipline)",
                    ))
    return out


# -------------------------------------------------------------- metric-name

# A string literal shaped like one of our metric families. The package name
# itself matches the pattern; it (and module paths) are not metrics.
# gpu_ is the GPU device family's node namespace (backend/nvml.py) — it
# resolves against metrics/schema.py exactly like tpu_; the pod_gpu/
# docker_gpu alternatives (the reference's legacy alias names) sort before
# gpu_ so they match whole.
_METRIC_SHAPED = re.compile(r"(?:tpu|pod_gpu|docker_gpu|gpu)_[a-z0-9_]+")
# Non-metric identifiers that happen to match the shape: the package name,
# and gpu_-prefixed config/kwarg names (flags, result-dict keys).
_METRIC_STRING_ALLOWED = {
    "tpu_pod_exporter_torch", "gpu_slices", "gpu_resource_name",
}
# Module-ish strings that happen to match the metric shape.
_METRIC_STRING_ALLOWED_SUFFIXES = ("_pb2", "_pb2_grpc")

# Definition sites: the schema itself and the metrics framework (which
# derives child families for histograms) may construct specs.
_SPEC_DEFINITION_FILES = (
    "tpu_pod_exporter_torch/metrics/schema.py",
    "tpu_pod_exporter_torch/metrics/registry.py",
)


def _check_metric_name(tree: ast.Module, src_lines: list[str], relpath: str, ctx: "LintContext") -> list[Diagnostic]:
    reg = ctx.registry
    out = []
    is_definition_site = relpath in _SPEC_DEFINITION_FILES

    def _check_name_literal(node: ast.Constant) -> None:
        val = node.value
        if (
            _METRIC_SHAPED.fullmatch(val)
            and val not in reg.metric_names
            and val not in _METRIC_STRING_ALLOWED
            and not val.endswith(_METRIC_STRING_ALLOWED_SUFFIXES)
        ):
            out.append(Diagnostic(
                "metric-name", ERROR, relpath, node.lineno,
                f"metric name {val!r} is not registered in "
                f"metrics/schema.py (ALL_SPECS / conditional spec lists) — "
                f"add a MetricSpec there or fix the name",
            ))

    def _check_schema_attr(node: ast.Attribute) -> None:
        # schema.X — X must be a name schema.py actually defines.
        if (
            isinstance(node.value, ast.Name)
            and node.value.id == "schema"
            and node.attr not in reg.schema_names
        ):
            out.append(Diagnostic(
                "metric-name", ERROR, relpath, node.lineno,
                f"schema.{node.attr} does not exist in metrics/schema.py",
            ))

    # Docstrings mention metric names legitimately; skip Expr-statement
    # constants wholesale (they are never a publish argument).
    docstring_lines = {
        s.value.lineno
        for s in ast.walk(tree)
        if isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant)
    }

    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            _check_schema_attr(node)
            continue
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and node.lineno not in docstring_lines
            and not is_definition_site
        ):
            _check_name_literal(node)
            continue
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not is_definition_site and isinstance(fn, ast.Name) and fn.id in (
            "MetricSpec", "HistogramSpec",
        ):
            out.append(Diagnostic(
                "metric-name", ERROR, relpath, node.lineno,
                f"inline {fn.id}(...) outside metrics/schema.py — every "
                f"family must live in the schema so the exposition surface "
                f"stays reviewable in one place",
            ))
    return out


# --------------------------------------------------------------- wall-clock

# Modules on the monotonic poll path: durations and schedules there must
# come from time.monotonic (or the injected ``clock``); wall time is only
# for stamping (the injected ``wallclock``) at explicitly-marked sites.
_MONOTONIC_MODULES = (
    "tpu_pod_exporter_torch/collector.py",
    "tpu_pod_exporter_torch/supervisor.py",
    "tpu_pod_exporter_torch/history.py",
    "tpu_pod_exporter_torch/trace.py",
)

_WALL_CALLS = {
    ("time", "time"),
    ("datetime", "now"),
    ("datetime", "utcnow"),
    ("datetime", "today"),
    ("date", "today"),
}


def _check_wall_clock(tree: ast.Module, src_lines: list[str], relpath: str, ctx: "LintContext") -> list[Diagnostic]:
    if relpath not in _MONOTONIC_MODULES:
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not isinstance(fn, ast.Attribute):
            continue
        if (_receiver_name(fn), fn.attr) in _WALL_CALLS:
            out.append(Diagnostic(
                "wall-clock", ERROR, relpath, node.lineno,
                f"{_receiver_name(fn)}.{fn.attr}() on the monotonic poll "
                f"path — use the injected clock/wallclock, or mark a "
                f"deliberate wall-stamp site with a disable comment",
            ))
    return out


# ------------------------------------------------------------- join-timeout


def _check_join_timeout(tree: ast.Module, src_lines: list[str], relpath: str, ctx: "LintContext") -> list[Diagnostic]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not isinstance(fn, ast.Attribute) or fn.attr != "join":
            continue
        # str.join / os.path.join always take exactly one (non-None)
        # argument, so a zero-arg join can only be Thread/Queue.join —
        # a blocking wait with no deadline.
        blocking = not node.args and not node.keywords
        for kw in node.keywords:
            if kw.arg == "timeout" and (
                isinstance(kw.value, ast.Constant) and kw.value.value is None
            ):
                blocking = True
        if len(node.args) == 1 and (
            isinstance(node.args[0], ast.Constant) and node.args[0].value is None
        ):
            blocking = True
        if blocking:
            out.append(Diagnostic(
                "join-timeout", ERROR, relpath, node.lineno,
                "blocking .join() without a timeout — an abandoned/fenced "
                "worker may never return; pass an explicit timeout "
                "(supervisor.py fences, never joins-on-blocking)",
            ))
    return out


# --------------------------------------------------------- thread-discipline


def _check_thread_discipline(tree: ast.Module, src_lines: list[str], relpath: str, ctx: "LintContext") -> list[Diagnostic]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        is_thread = (
            isinstance(fn, ast.Attribute)
            and fn.attr == "Thread"
            and _receiver_name(fn) == "threading"
        ) or (isinstance(fn, ast.Name) and fn.id == "Thread")
        if not is_thread:
            continue
        kwargs = {kw.arg for kw in node.keywords if kw.arg}
        missing = []
        if "name" not in kwargs:
            missing.append("name= (tpu-* convention; /debug/stacks and the "
                           "slow-poll profiler identify threads by name)")
        if "daemon" not in kwargs:
            missing.append("daemon=True (a non-daemon thread blocks "
                           "interpreter exit during SIGTERM drain)")
        if missing:
            out.append(Diagnostic(
                "thread-discipline", ERROR, relpath, node.lineno,
                "threading.Thread(...) missing " + " and ".join(missing),
            ))
    return out


# -------------------------------------------------------------- bare-except


def _handler_reraises(handler: ast.ExceptHandler) -> bool:
    for node in _walk_stop_at_defs(handler.body):
        if isinstance(node, ast.Raise) and node.exc is None:
            return True
    return False


def _names_base_exception(type_node: ast.expr | None) -> bool:
    if type_node is None:
        return False
    nodes = type_node.elts if isinstance(type_node, ast.Tuple) else [type_node]
    return any(_terminal_name(n) == "BaseException" for n in nodes)


def _check_bare_except(tree: ast.Module, src_lines: list[str], relpath: str, ctx: "LintContext") -> list[Diagnostic]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            out.append(Diagnostic(
                "bare-except", ERROR, relpath, node.lineno,
                "bare `except:` swallows KeyboardInterrupt/SystemExit — "
                "catch Exception (or narrower)",
            ))
        elif _names_base_exception(node.type) and not _handler_reraises(node):
            out.append(Diagnostic(
                "bare-except", ERROR, relpath, node.lineno,
                "except BaseException without re-raise — only the "
                "sanctioned poll-restart path may swallow these; re-raise "
                "or record the exception with a disable comment",
            ))
    return out


# --------------------------------------------------------------- debug-gate


def _compares_debug_path(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> int:
    """Line of the first /debug/ route comparison in this function, or 0.

    Only *routing* shapes count — ``x == "/debug/..."`` comparisons and
    ``.startswith("/debug/")`` calls — so log messages that merely mention
    a debug URL never trip the rule."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare):
            operands = [node.left, *node.comparators]
            for op in operands:
                if (
                    isinstance(op, ast.Constant)
                    and isinstance(op.value, str)
                    and op.value.startswith("/debug/")
                ):
                    return node.lineno
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "startswith"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
            and node.args[0].value.startswith("/debug/")
        ):
            return node.lineno
    return 0


def _check_debug_gate(tree: ast.Module, src_lines: list[str], relpath: str, ctx: "LintContext") -> list[Diagnostic]:
    if relpath.startswith("tpu_pod_exporter_torch/analysis/"):
        return []  # this rule's own "/debug/" pattern literals are data
    out = []
    for fn in _functions(tree):
        if fn.name == "debug_client_allowed":
            continue
        line = _compares_debug_path(fn)
        if not line:
            continue
        gated = any(
            _terminal_name(n) == "debug_client_allowed"
            for n in ast.walk(fn)
            if isinstance(n, (ast.Name, ast.Attribute))
        )
        if not gated:
            out.append(Diagnostic(
                "debug-gate", ERROR, relpath, line,
                f"{fn.name}() routes a /debug/* path without calling "
                f"debug_client_allowed() — debug endpoints are "
                f"loopback-only by default (server.py policy)",
            ))
    return out


# ------------------------------------------------------------ unused-import


def _check_unused_import(tree: ast.Module, src_lines: list[str], relpath: str, ctx: "LintContext") -> list[Diagnostic]:
    if relpath.endswith("__init__.py"):
        return []  # re-export surface: unused-looking imports are the API
    bound: list[tuple[str, int]] = []  # (bound name, line)
    for stmt in tree.body:  # module level only: lazy in-function imports are a
        # deliberate pattern here (gzip, numpy) and always locally used
        if isinstance(stmt, ast.Import):
            for alias in stmt.names:
                name = alias.asname or alias.name.split(".")[0]
                bound.append((name, stmt.lineno))
        elif isinstance(stmt, ast.ImportFrom):
            if stmt.module == "__future__":
                continue
            for alias in stmt.names:
                if alias.name == "*":
                    continue
                bound.append((alias.asname or alias.name, stmt.lineno))
    if not bound:
        return []
    used: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            used.add(node.value)  # __all__ entries / string annotations
    return [
        Diagnostic(
            "unused-import", WARNING, relpath, line,
            f"imported name {name!r} is never used in this module",
        )
        for name, line in bound
        if name not in used
    ]


# ------------------------------------------------- flag-read / flag-doc


def _check_flag_read(ctx: "LintContext") -> list[Diagnostic]:
    read_attrs: set[str] = set()
    for relpath, tree in ctx.package_trees.items():
        if relpath.endswith("config.py"):
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                read_attrs.add(node.attr)
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                # getattr(cfg, "name") / field-name strings count as reads.
                read_attrs.add(node.value)
    return [
        Diagnostic(
            "flag-read", WARNING, ctx.config_relpath, line,
            f"config flag {name!r} is never read anywhere in the package — "
            f"dead knobs mislead operators; wire it up or delete it",
        )
        for name, line in ctx.config_fields
        if name not in read_attrs
    ]


def _check_flag_doc(ctx: "LintContext") -> list[Diagnostic]:
    if not ctx.docs_text:
        return []  # no README/RUNBOOK beside the package (installed wheel)
    out = []
    for name, line in ctx.config_fields:
        flag = "--" + name.replace("_", "-")
        env = "TPE_" + name.upper()
        if flag not in ctx.docs_text and env not in ctx.docs_text:
            out.append(Diagnostic(
                "flag-doc", WARNING, ctx.config_relpath, line,
                f"config flag {flag} (env {env}) is documented in neither "
                f"README.md nor deploy/RUNBOOK.md — add it to the flags "
                f"reference",
            ))
    return out


# ------------------------------------------------ concurrency contracts

# The three whole-tree concurrency rules live in analysis/concurrency.py
# (lock discovery, call graph, held-set propagation — too much machinery
# for this file). Imported lazily so `concurrency` can borrow
# _lock_io_offence from here without a cycle.


def _check_lock_order(ctx: "LintContext") -> list[Diagnostic]:
    from tpu_pod_exporter_torch.analysis import concurrency
    return concurrency.check_lock_order(ctx)


def _check_lock_ownership(ctx: "LintContext") -> list[Diagnostic]:
    from tpu_pod_exporter_torch.analysis import concurrency
    return concurrency.check_lock_ownership(ctx)


def _check_lock_io_chain(ctx: "LintContext") -> list[Diagnostic]:
    from tpu_pod_exporter_torch.analysis import concurrency
    return concurrency.check_lock_io_chain(ctx)


# The three execution-context rule families (loop-blocking,
# durability-ordering, fork-safety) build a derived pass over the same
# concurrency model; same lazy-import discipline.


def _check_loop_blocking(ctx: "LintContext") -> list[Diagnostic]:
    from tpu_pod_exporter_torch.analysis import execcontext
    return execcontext.check_loop_blocking(ctx)


def _check_durability_ordering(ctx: "LintContext") -> list[Diagnostic]:
    from tpu_pod_exporter_torch.analysis import execcontext
    return execcontext.check_durability_ordering(ctx)


def _check_fork_safety(ctx: "LintContext") -> list[Diagnostic]:
    from tpu_pod_exporter_torch.analysis import execcontext
    return execcontext.check_fork_safety(ctx)


# ------------------------------------------------------------------- registry

ALL_RULES: tuple[Rule, ...] = (
    Rule(
        "lock-io", ERROR,
        "No I/O, serialization, compression, or logging inside a "
        "`with <lock>:` block (copy under the lock, work outside it).",
        check_file=_check_lock_io,
    ),
    Rule(
        "metric-name", ERROR,
        "Every metric name reaching registry/publish helpers must be "
        "registered in metrics/schema.py; no inline MetricSpec elsewhere.",
        check_file=_check_metric_name,
    ),
    Rule(
        "wall-clock", ERROR,
        "No time.time()/datetime.now() in monotonic poll-path modules "
        "(collector, supervisor, history, trace) outside marked wall-stamp "
        "sites.",
        check_file=_check_wall_clock,
    ),
    Rule(
        "join-timeout", ERROR,
        "No blocking Thread/Queue .join() without a timeout.",
        check_file=_check_join_timeout,
    ),
    Rule(
        "thread-discipline", ERROR,
        "Every threading.Thread must be named (tpu-* convention) and "
        "daemonized.",
        check_file=_check_thread_discipline,
    ),
    Rule(
        "bare-except", ERROR,
        "No bare `except:`; `except BaseException` must re-raise unless "
        "explicitly sanctioned (poll-restart / worker-relay paths).",
        check_file=_check_bare_except,
    ),
    Rule(
        "debug-gate", ERROR,
        "Any function routing a /debug/* path must call "
        "debug_client_allowed() (loopback-only policy).",
        check_file=_check_debug_gate,
    ),
    Rule(
        "unused-import", WARNING,
        "Module-level imports must be used (ruff F401 equivalent, enforced "
        "even where ruff is unavailable).",
        check_file=_check_unused_import,
    ),
    Rule(
        "flag-read", WARNING,
        "Every flag defined in config.py must be read somewhere in the "
        "package.",
        check_tree=_check_flag_read,
    ),
    Rule(
        "flag-doc", WARNING,
        "Every flag defined in config.py must be documented in README.md "
        "or deploy/RUNBOOK.md.",
        check_tree=_check_flag_doc,
    ),
    Rule(
        "lock-order", ERROR,
        "The whole-tree lock-acquisition order graph must be acyclic, "
        "and no non-reentrant lock may be re-acquired while held "
        "(deadlock candidates; analysis/concurrency.py).",
        check_tree=_check_lock_order,
    ),
    Rule(
        "lock-ownership", ERROR,
        "Declared thread-ownership contracts (one cursor-mover per "
        "buffer, one history appender, flag-checked-under-lock) hold "
        "over the thread-rooted call graph.",
        check_tree=_check_lock_ownership,
    ),
    Rule(
        "lock-io-chain", ERROR,
        "No call chain reachable under a held lock may perform I/O, "
        "serialization, compression, or logging (lock-io, "
        "interprocedural).",
        check_tree=_check_lock_io_chain,
    ),
    Rule(
        "loop-blocking", ERROR,
        "No function running inline on the event loop (role "
        "tpu-exporter-http, propagated through call_soon/call_later/"
        "_invoke) may block: file I/O, time.sleep, compression, "
        "serialization, or locks whose holders block "
        "(analysis/execcontext.py).",
        check_tree=_check_loop_blocking,
    ),
    Rule(
        "durability-ordering", ERROR,
        "State files go through persist.atomic_write; cursor movers are "
        "fsync-reachable before return; each WalBuffer cursor has "
        "exactly one declared mover role (analysis/execcontext.py).",
        check_tree=_check_durability_ordering,
    ),
    Rule(
        "fork-safety", ERROR,
        "No os.fork/multiprocessing outside a sanctioned pre-fork entry; "
        "no import-time thread/fd creation; the pre-fork resource "
        "inventory is committed as analysis/reviewed/fork-inventory.json "
        "(analysis/execcontext.py).",
        check_tree=_check_fork_safety,
    ),
)

RULES_BY_NAME = {r.name: r for r in ALL_RULES}
