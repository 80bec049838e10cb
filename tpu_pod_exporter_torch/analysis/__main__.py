"""``exporter-lint`` CLI — the port's invariant gate.

Exit status: 0 when the tree is clean against the committed baseline,
1 when any new finding exists (each printed as ``file:line: severity:
rule: message``), 2 on operational errors (missing schema, bad root).

``--demo`` seeds deliberate violations into a temp copy of the package —
a lock-scoped ``json.dumps``, an unregistered metric name, a lock-order
inversion pair, a wrong-thread WAL cursor move, an inline ``time.sleep``
on the event loop, a raw ``open("w")`` on a cursor path plus a second
cursor-mover thread, and a stray ``os.fork`` — and exits 0 only if ALL
seven rule families catch their seed (the lint analog of ``make
chaos-demo``).

``--lock-graph``/``--lock-graph-dot`` render the concurrency model's
acquisition-order graph (the committed ``analysis/reviewed/lock-graph.json``
artifact); ``--fork-inventory`` renders the pre-fork resource inventory
(the committed ``analysis/reviewed/fork-inventory.json`` artifact);
``--check-witness``/``--check-loop-witness`` cross-check runtime witness
dumps (``analysis/pytest_witness.py`` under ``TPE_TORCH_LOCK_WITNESS=1`` /
``TPE_TORCH_LOOP_WITNESS=1``) against the static model.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from tpu_pod_exporter_torch.analysis.diagnostics import ERROR, to_sarif
from tpu_pod_exporter_torch.analysis.engine import (
    apply_baseline,
    baseline_document,
    build_context,
    lint_package,
    load_baseline,
)
from tpu_pod_exporter_torch.analysis.rules import ALL_RULES

# The port's own baseline: the repo root's belongs to the JAX package.
BASELINE_RELPATH = "tpu_pod_exporter_torch/analysis/baseline.json"

# (rule that must fire, what was seeded) — the --demo contract.
_DEMO_EXPECTED = (
    ("lock-io", "json.dumps(...) inside `with demo_lock:`"),
    ("metric-name", "unregistered name 'tpu_exporter_demo_bogus_total'"),
    ("lock-order", "two functions acquiring _demo_lock_a/_demo_lock_b "
                   "in opposite orders"),
    ("lock-ownership", "a 'tpu-demo-wrong-thread' thread calling "
                       "WalBuffer.ack() (cursor move off the owner "
                       "thread)"),
    ("loop-blocking", "a call_soon()-posted callback doing time.sleep() "
                      "inline on the event loop"),
    ("durability-ordering", "raw open(.., 'w') on a cursor.json path, "
                            "plus a second cursor-mover thread on a "
                            "WalBuffer"),
    ("fork-safety", "an os.fork() outside any sanctioned pre-fork "
                    "entry point"),
)


def _default_root() -> str:
    # analysis/__main__.py -> analysis -> tpu_pod_exporter_torch -> repo root.
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def _run_demo(root: str) -> int:
    """Copy the package aside, seed one violation per rule family, and
    require the linter to catch every one of them."""
    import shutil
    import tempfile

    with tempfile.TemporaryDirectory(prefix="exporter-lint-demo-") as tmp:
        pkg = os.path.join(tmp, "tpu_pod_exporter_torch")
        shutil.copytree(
            os.path.join(root, "tpu_pod_exporter_torch"), pkg,
            ignore=shutil.ignore_patterns("__pycache__", "_build"),
        )
        with open(os.path.join(pkg, "collector.py"), "a") as f:
            f.write(
                "\n\n"
                "def _lint_demo_seeded(snapshot, counters):\n"
                "    # Seeded by `exporter-lint --demo`: BOTH lines below\n"
                "    # violate an invariant rule on purpose.\n"
                "    import json\n"
                "    demo_lock = threading.Lock()\n"
                "    with demo_lock:\n"
                "        body = json.dumps({'seeded': True})\n"
                "    counters.inc('tpu_exporter_demo_bogus_total', ())\n"
                "    return body\n"
                "\n\n"
                "# Seeded lock-order inversion: two paths, opposite order.\n"
                "_demo_lock_a = threading.Lock()\n"
                "_demo_lock_b = threading.Lock()\n"
                "\n\n"
                "def _lint_demo_order_one():\n"
                "    with _demo_lock_a:\n"
                "        with _demo_lock_b:\n"
                "            pass\n"
                "\n\n"
                "def _lint_demo_order_two():\n"
                "    with _demo_lock_b:\n"
                "        with _demo_lock_a:\n"
                "            pass\n"
            )
        with open(os.path.join(pkg, "persist.py"), "a") as f:
            f.write(
                "\n\n"
                "class _LintDemoWrongThreadMover:\n"
                "    # Seeded by `exporter-lint --demo`: a thread outside\n"
                "    # the declared WalBuffer cursor-owner set moving the\n"
                "    # cursor (the governor-race bug class).\n"
                "    def __init__(self) -> None:\n"
                "        self._buf = WalBuffer('/tmp/lint-demo-wal')\n"
                "        self._thread = threading.Thread(\n"
                "            target=self._move,\n"
                "            name='tpu-demo-wrong-thread', daemon=True,\n"
                "        )\n"
                "\n"
                "    def _move(self) -> None:\n"
                "        self._buf.ack()\n"
                "\n\n"
                "def _lint_demo_raw_cursor_write(root: str) -> None:\n"
                "    # Seeded by `exporter-lint --demo`: a raw open('w')\n"
                "    # on a durability state path — bypasses the atomic\n"
                "    # write-temp/fsync/rename discipline.\n"
                "    with open(root + '/cursor.json', 'w') as f:\n"
                "        f.write('{}')\n"
                "\n\n"
                "def _lint_demo_fork() -> None:\n"
                "    # Seeded by `exporter-lint --demo`: fork outside any\n"
                "    # sanctioned pre-fork entry point.\n"
                "    os.fork()\n"
                "\n\n"
                "class _LintDemoDualMover:\n"
                "    # Seeded by `exporter-lint --demo`: TWO threads moving\n"
                "    # one WalBuffer cursor. mover-a is the declared owner\n"
                "    # (demo CursorMoverRule in analysis/execcontext.py);\n"
                "    # mover-b is the second-mover violation.\n"
                "    def __init__(self) -> None:\n"
                "        self._wal = WalBuffer('/tmp/lint-demo-dual-wal')\n"
                "        self._ta = threading.Thread(\n"
                "            target=self._move_a,\n"
                "            name='tpu-demo-mover-a', daemon=True,\n"
                "        )\n"
                "        self._tb = threading.Thread(\n"
                "            target=self._move_b,\n"
                "            name='tpu-demo-mover-b', daemon=True,\n"
                "        )\n"
                "\n"
                "    def _move_a(self) -> None:\n"
                "        self._wal.ack()\n"
                "\n"
                "    def _move_b(self) -> None:\n"
                "        self._wal.trim_to_bytes(0)\n"
            )
        with open(os.path.join(pkg, "server.py"), "a") as f:
            f.write(
                "\n\n"
                "def _lint_demo_loop_blocking() -> None:\n"
                "    # Seeded by `exporter-lint --demo`: time.sleep inline\n"
                "    # on the event loop (posted via call_soon below) —\n"
                "    # one stalled callback parks every connection.\n"
                "    time.sleep(0.5)\n"
                "\n\n"
                "def _lint_demo_register(loop) -> None:\n"
                "    loop.call_soon(_lint_demo_loop_blocking)\n"
            )
        print("seeded into a temp copy of the package:")
        for rule, what in _DEMO_EXPECTED:
            print(f"  - {what}   (rule {rule})")
        print()
        findings = [
            d for d in lint_package(tmp)
            if d.path in ("tpu_pod_exporter_torch/collector.py",
                          "tpu_pod_exporter_torch/persist.py",
                          "tpu_pod_exporter_torch/server.py")
        ]
        caught = set()
        for d in findings:
            print(d.format())
            caught.add(d.rule)
        missing = [r for r, _ in _DEMO_EXPECTED if r not in caught]
        print()
        if missing:
            print(f"demo: FAIL — seeded violation(s) NOT caught: "
                  f"{', '.join(missing)}")
            return 1
        print("demo: PASS — all seeded violations caught "
              f"({', '.join(r for r, _ in _DEMO_EXPECTED)})")
        return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="exporter-lint",
        description="AST-enforced invariant lint for tpu-pod-exporter.",
    )
    p.add_argument("--root", default=_default_root(),
                   help="repo root containing tpu_pod_exporter_torch/ (default: "
                        "auto-detected from this file's location)")
    p.add_argument("--baseline", default=None,
                   help=f"baseline JSON path (default: <root>/{BASELINE_RELPATH})")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignoring the baseline")
    p.add_argument("--update-baseline", action="store_true",
                   help="write all current findings to the baseline and exit 0")
    p.add_argument("--format", choices=("text", "json", "sarif"),
                   default="text",
                   help="sarif emits SARIF 2.1.0 for inline PR "
                        "annotations; json is the CI artifact shape")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule reference and exit")
    p.add_argument("--demo", action="store_true",
                   help="seed one violation per rule family into a temp "
                        "copy and require the linter to catch all of "
                        "them")
    p.add_argument("--lock-graph", metavar="PATH", default=None,
                   help="write the lock-acquisition order graph (JSON, "
                        "the reviewed analysis/reviewed/lock-graph.json artifact) "
                        "and exit")
    p.add_argument("--lock-graph-dot", metavar="PATH", default=None,
                   help="write the order graph as Graphviz DOT and exit")
    p.add_argument("--check-witness", metavar="DUMP", default=None,
                   help="cross-check a runtime lock-witness edge dump "
                        "(tier-1 under TPE_TORCH_LOCK_WITNESS=1) against the "
                        "static model; non-zero on any unexplained edge")
    p.add_argument("--fork-inventory", metavar="PATH", default=None,
                   help="write the pre-fork resource inventory (threads/"
                        "locks/kernel objects; the reviewed "
                        "analysis/reviewed/fork-inventory.json artifact) and exit")
    p.add_argument("--check-loop-witness", metavar="DUMP", default=None,
                   help="cross-check a runtime loop-witness dump (tier-1 "
                        "under TPE_TORCH_LOOP_WITNESS=1) against the static "
                        "loop-role model; non-zero on any stall or any "
                        "loop-executed callback the model cannot explain")
    ns = p.parse_args(argv)

    if ns.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.name:18s} {rule.severity:8s} {rule.summary}")
        return 0

    root = os.path.abspath(ns.root)
    if not os.path.isdir(os.path.join(root, "tpu_pod_exporter_torch")):
        print(f"exporter-lint: no tpu_pod_exporter_torch/ under {root}",
              file=sys.stderr)
        return 2

    if ns.demo:
        return _run_demo(root)

    if (ns.lock_graph or ns.lock_graph_dot or ns.check_witness
            or ns.fork_inventory or ns.check_loop_witness):
        from tpu_pod_exporter_torch.analysis import concurrency
        model = concurrency.get_model(build_context(root))
        if ns.lock_graph:
            doc = model.graph_json()
            with open(ns.lock_graph, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.write("\n")
            print(f"wrote {len(doc['locks'])} lock(s), "
                  f"{len(doc['edges'])} edge(s) to {ns.lock_graph}")
        if ns.lock_graph_dot:
            with open(ns.lock_graph_dot, "w", encoding="utf-8") as f:
                f.write(model.graph_dot())
            print(f"wrote DOT graph to {ns.lock_graph_dot}")
        if ns.check_witness:
            from tpu_pod_exporter_torch.analysis import witness as witness_mod
            try:
                dump = witness_mod.load_dump(ns.check_witness)
            except (OSError, ValueError) as e:
                print(f"exporter-lint: cannot read witness dump: {e}",
                      file=sys.stderr)
                return 2
            problems = concurrency.cross_check(model, dump)
            meta = dump.get("meta", {})
            print(f"witness dump: {meta.get('locks', '?')} lock(s), "
                  f"{meta.get('acquisitions', '?')} acquisition(s), "
                  f"{meta.get('edges', '?')} order edge(s)")
            for prob in problems:
                print(f"CROSS-CHECK: {prob}")
            if problems:
                print(f"exporter-lint: witness cross-check FAILED "
                      f"({len(problems)} problem(s))")
                return 1
            print("exporter-lint: witness cross-check OK — every "
                  "witnessed edge is explained by the static model")
        if ns.fork_inventory:
            from tpu_pod_exporter_torch.analysis import execcontext
            doc = execcontext.fork_inventory(model)
            with open(ns.fork_inventory, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.write("\n")
            print(f"wrote {len(doc['threads'])} thread(s), "
                  f"{len(doc['locks'])} lock(s), "
                  f"{len(doc['kernel_objects'])} kernel object(s) to "
                  f"{ns.fork_inventory}")
        if ns.check_loop_witness:
            from tpu_pod_exporter_torch.analysis import execcontext
            from tpu_pod_exporter_torch.analysis import witness as witness_mod
            try:
                dump = witness_mod.load_dump(ns.check_loop_witness)
            except (OSError, ValueError) as e:
                print(f"exporter-lint: cannot read loop-witness dump: {e}",
                      file=sys.stderr)
                return 2
            problems = execcontext.cross_check_loop(model, dump)
            meta = dump.get("meta", {})
            print(f"loop-witness dump: {meta.get('callbacks', '?')} "
                  f"callback(s), {meta.get('stalls', '?')} stall(s) over "
                  f"{meta.get('threshold_ms', '?')} ms")
            for prob in problems:
                print(f"CROSS-CHECK: {prob}")
            if problems:
                print(f"exporter-lint: loop-witness cross-check FAILED "
                      f"({len(problems)} problem(s))")
                return 1
            print("exporter-lint: loop-witness cross-check OK — zero "
                  "stalls; every loop-executed callback is "
                  "loop-role-tagged in the static model")
        return 0

    findings = lint_package(root)
    baseline_path = ns.baseline or os.path.join(root, *BASELINE_RELPATH.split("/"))

    if ns.update_baseline:
        doc = baseline_document(findings, root)
        with open(baseline_path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    suppressed = 0
    if not ns.no_baseline:
        findings, suppressed = apply_baseline(
            findings, load_baseline(baseline_path), root
        )

    if ns.format == "sarif":
        print(json.dumps(to_sarif(findings, ALL_RULES), indent=1))
    elif ns.format == "json":
        print(json.dumps({
            "findings": [
                {
                    "rule": d.rule, "severity": d.severity, "path": d.path,
                    "line": d.line, "message": d.message,
                }
                for d in findings
            ],
            "baseline_suppressed": suppressed,
        }, indent=1))
    else:
        for d in findings:
            print(d.format())
        errors = sum(1 for d in findings if d.severity == ERROR)
        warnings = len(findings) - errors
        tail = f" ({suppressed} grandfathered in baseline)" if suppressed else ""
        if findings:
            print(f"exporter-lint: {errors} error(s), {warnings} warning(s)"
                  f"{tail}")
        else:
            print(f"exporter-lint: clean{tail}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
