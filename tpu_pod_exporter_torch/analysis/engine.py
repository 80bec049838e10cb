"""Lint engine: schema extraction, file walking, disables, baseline.

Everything is plain ``ast`` over source text — the linter never imports the
modules it checks (so it lints cleanly on hosts missing optional deps like
numpy or grpc, and a syntax error is a diagnostic, not a crash).
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field

from tpu_pod_exporter_torch.analysis.diagnostics import Diagnostic, parse_disables
from tpu_pod_exporter_torch.analysis.rules import ALL_RULES

# Files never linted: vendored protobuf output and the native build tree.
_EXCLUDED_SUFFIXES = ("_pb2.py", "_pb2_grpc.py")

_SCHEMA_RELPATH = "tpu_pod_exporter_torch/metrics/schema.py"
_CONFIG_RELPATH = "tpu_pod_exporter_torch/config.py"
_DOC_RELPATHS = ("README.md", "deploy/RUNBOOK.md")


@dataclass
class SchemaRegistry:
    """What metrics/schema.py defines, extracted statically."""

    # Every module-level name schema.py binds (specs, label tuples, lists,
    # helpers) — the legal right-hand sides of ``schema.X``.
    schema_names: set[str] = field(default_factory=set)
    # Every legal exposition family name, including histogram children.
    metric_names: set[str] = field(default_factory=set)


def _spec_name_from_call(call: ast.Call) -> str | None:
    """The ``name=...`` of a MetricSpec/HistogramSpec constructor literal."""
    fn = call.func
    ctor = fn.id if isinstance(fn, ast.Name) else getattr(fn, "attr", "")
    if ctor not in ("MetricSpec", "HistogramSpec"):
        return None
    for kw in call.keywords:
        if kw.arg == "name" and isinstance(kw.value, ast.Constant):
            return str(kw.value.value)
    if call.args and isinstance(call.args[0], ast.Constant):
        return str(call.args[0].value)
    return None


def build_registry(schema_src: str) -> SchemaRegistry:
    reg = SchemaRegistry()
    tree = ast.parse(schema_src)
    for stmt in tree.body:
        targets: list[ast.expr] = []
        value: ast.expr | None = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.target is not None:
            targets, value = [stmt.target], stmt.value
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            reg.schema_names.add(stmt.name)
            continue
        elif isinstance(stmt, (ast.Import, ast.ImportFrom)):
            for alias in stmt.names:
                reg.schema_names.add(alias.asname or alias.name.split(".")[0])
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                reg.schema_names.add(t.id)
        if isinstance(value, ast.Call):
            name = _spec_name_from_call(value)
            if name:
                ctor = value.func
                reg.metric_names.add(name)
                is_hist = (
                    isinstance(ctor, ast.Name) and ctor.id == "HistogramSpec"
                )
                if is_hist:
                    # HistogramSpec renders one parent family plus derived
                    # _bucket/_count/_sum lines (and the internal _lines
                    # family key) — all legal references.
                    for suffix in ("_bucket", "_count", "_sum", "_lines"):
                        reg.metric_names.add(name + suffix)
    return reg


@dataclass
class LintContext:
    """Cross-file facts the rules consume."""

    registry: SchemaRegistry
    # relpath -> parsed module, for whole-tree rules.
    package_trees: dict[str, ast.Module] = field(default_factory=dict)
    # (field name, lineno in config.py) for the flag rules.
    config_fields: list[tuple[str, int]] = field(default_factory=list)
    config_relpath: str = _CONFIG_RELPATH
    docs_text: str = ""


def _config_fields(config_src: str) -> list[tuple[str, int]]:
    tree = ast.parse(config_src)
    out: list[tuple[str, int]] = []
    for stmt in tree.body:
        if isinstance(stmt, ast.ClassDef) and stmt.name == "ExporterConfig":
            for s in stmt.body:
                if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name):
                    out.append((s.target.id, s.lineno))
    return out


def _apply_disables(
    findings: list[Diagnostic], src_lines: list[str]
) -> list[Diagnostic]:
    kept = []
    for d in findings:
        line = src_lines[d.line - 1] if 0 < d.line <= len(src_lines) else ""
        if d.rule not in parse_disables(line):
            kept.append(d)
    return kept


def lint_source(
    src: str, relpath: str, ctx: LintContext, tree: ast.Module | None = None
) -> list[Diagnostic]:
    """Run every per-file rule over one module's source text. ``tree``
    reuses an already-parsed module (lint_package passes the one
    build_context parsed — the second parse was pure waste)."""
    if tree is None:
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            return [Diagnostic(
                "syntax", "error", relpath, e.lineno or 0,
                f"cannot parse: {e.msg}",
            )]
    src_lines = src.splitlines()
    findings: list[Diagnostic] = []
    for rule in ALL_RULES:
        if rule.check_file is not None:
            findings.extend(rule.check_file(tree, src_lines, relpath, ctx))
    return _apply_disables(findings, src_lines)


def _iter_package_files(root: str, package: str) -> list[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(root, package)):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if not fn.endswith(".py") or fn.endswith(_EXCLUDED_SUFFIXES):
                continue
            out.append(os.path.join(dirpath, fn))
    return out


def build_context(root: str, package: str = "tpu_pod_exporter_torch") -> LintContext:
    schema_path = os.path.join(root, *_SCHEMA_RELPATH.split("/"))
    with open(schema_path) as f:
        registry = build_registry(f.read())
    docs = []
    for rel in _DOC_RELPATHS:
        path = os.path.join(root, *rel.split("/"))
        if os.path.exists(path):
            with open(path) as f:
                docs.append(f.read())
    ctx = LintContext(registry=registry, docs_text="\n".join(docs))
    for path in _iter_package_files(root, package):
        relpath = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path) as f:
            src = f.read()
        try:
            ctx.package_trees[relpath] = ast.parse(src)
        except SyntaxError:
            continue  # reported by lint_source
        if relpath == _CONFIG_RELPATH:
            ctx.config_fields = _config_fields(src)
    return ctx


def lint_package(
    root: str, package: str = "tpu_pod_exporter_torch"
) -> list[Diagnostic]:
    """Lint the whole package under ``root``; returns ordered findings
    (disable comments applied, baseline NOT applied — that's the CLI's
    job, so tests can inspect raw findings)."""
    ctx = build_context(root, package)
    findings: list[Diagnostic] = []
    for path in _iter_package_files(root, package):
        relpath = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path) as f:
            findings.extend(lint_source(
                f.read(), relpath, ctx, tree=ctx.package_trees.get(relpath)
            ))
    for rule in ALL_RULES:
        if rule.check_tree is not None:
            tree_findings = rule.check_tree(ctx)
            # Tree-wide findings honor disable comments on their target
            # line too (e.g. a config field annotated as intentionally
            # undocumented).
            by_file: dict[str, list[Diagnostic]] = {}
            for d in tree_findings:
                by_file.setdefault(d.path, []).append(d)
            for relpath, ds in by_file.items():
                path = os.path.join(root, *relpath.split("/"))
                try:
                    with open(path) as f:
                        src_lines = f.read().splitlines()
                except OSError:
                    src_lines = []
                findings.extend(_apply_disables(ds, src_lines))
    findings.sort(key=lambda d: (d.path, d.line, d.rule))
    return findings


# ------------------------------------------------------------------ baseline


def load_baseline(path: str) -> list[dict]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return []
    entries = doc.get("findings", []) if isinstance(doc, dict) else []
    return [e for e in entries if isinstance(e, dict)]


def finding_fingerprint(
    d: Diagnostic, root: str,
    lines_cache: dict[str, list[str]] | None = None,
) -> str:
    lines = lines_cache.get(d.path) if lines_cache is not None else None
    if lines is None:
        try:
            with open(os.path.join(root, *d.path.split("/"))) as f:
                lines = f.read().splitlines()
        except OSError:
            lines = []
        if lines_cache is not None:
            lines_cache[d.path] = lines
    text = lines[d.line - 1] if 0 < d.line <= len(lines) else ""
    return d.fingerprint(text)


def apply_baseline(
    findings: list[Diagnostic], baseline: list[dict], root: str
) -> tuple[list[Diagnostic], int]:
    """Drop findings present in the baseline (multiset semantics: N
    grandfathered instances excuse at most N live ones). Returns (new
    findings, how many were suppressed by the baseline)."""
    budget: dict[str, int] = {}
    for e in baseline:
        fp = e.get("fingerprint", "")
        budget[fp] = budget.get(fp, 0) + 1
    fresh = []
    suppressed = 0
    cache: dict[str, list[str]] = {}
    for d in findings:
        fp = finding_fingerprint(d, root, cache)
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
            suppressed += 1
        else:
            fresh.append(d)
    return fresh, suppressed


def baseline_document(findings: list[Diagnostic], root: str) -> dict:
    cache: dict[str, list[str]] = {}
    return {
        "comment": (
            "Grandfathered exporter-lint findings. Entries are matched by "
            "fingerprint (rule + file + offending line text), so fixing a "
            "line retires its entry and shifting line numbers does not. "
            "Update with: python -m tpu_pod_exporter_torch.analysis "
            "--update-baseline"
        ),
        "findings": [
            {
                "rule": d.rule,
                "path": d.path,
                "line": d.line,
                "message": d.message,
                "fingerprint": finding_fingerprint(d, root, cache),
            }
            for d in findings
        ],
    }
