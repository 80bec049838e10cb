"""The port's exporter-lint (``tpu_pod_exporter_torch.analysis``): the
oracle cases of the JAX package's lint tests — per-rule fixtures,
disable/baseline mechanics, and the real-tree self-check (seeding a
lock-scoped ``json.dumps`` or an unregistered metric name into the port's
``collector.py`` must fail the gate naming the rule, file, and line) —
pointed at the port's analyzer, package and baseline. The real tree is
linted once (``torch_lint_shared``); the CLI cases drive ``main()`` over
that lint, and the clean tree's ``--format json`` and ``--demo`` run as
the subprocesses a user would start."""

import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from tpu_pod_exporter_torch.analysis import (
    Diagnostic,
    LintContext,
    lint_source,
    parse_disables,
)
from tpu_pod_exporter_torch.analysis.engine import (
    SchemaRegistry,
    apply_baseline,
    baseline_document,
    build_registry,
    load_baseline,
)

from tests import torch_lint_shared as shared
from tpu_pod_exporter_torch.analysis import __main__ as cli

REPO_ROOT = shared.REPO_ROOT


def ctx_for(src_path: str = "tpu_pod_exporter_torch/mod.py") -> LintContext:
    """Minimal context: two registered gauges + one histogram family."""
    registry = SchemaRegistry(
        schema_names={"TPU_HBM_USED_BYTES", "ALL_SPECS", "MetricSpec"},
        metric_names={
            "tpu_hbm_used_bytes", "tpu_exporter_up",
            "tpu_exporter_poll_phase_duration_seconds",
            "tpu_exporter_poll_phase_duration_seconds_bucket",
        },
    )
    return LintContext(registry=registry)


def findings(src: str, path: str = "tpu_pod_exporter_torch/mod.py") -> list[Diagnostic]:
    return lint_source(textwrap.dedent(src), path, ctx_for())


def rules_of(ds: list[Diagnostic]) -> set[str]:
    return {d.rule for d in ds}


# ------------------------------------------------------------------ lock-io


class TestLockIo:
    def test_json_dumps_under_lock(self):
        ds = findings("""
            import json
            def f(self):
                with self._lock:
                    return json.dumps({"a": 1})
        """)
        assert rules_of(ds) == {"lock-io"}
        assert ds[0].line == 5
        assert "json.dumps" in ds[0].message

    def test_logging_fsync_gzip_sendall_under_lock(self):
        ds = findings("""
            import gzip, os
            def f(self, sock):
                with STATE_LOCK:
                    log.warning("x")
                    os.fsync(self.fd)
                    gzip.compress(b"x")
                    sock.sendall(b"x")
        """)
        assert [d.rule for d in ds] == ["lock-io"] * 4

    def test_clean_copy_under_lock(self):
        ds = findings("""
            def f(self):
                with self._lock:
                    snap = dict(self._data)
                return snap
        """)
        assert ds == []

    def test_serialize_outside_lock_ok(self):
        ds = findings("""
            import json
            def f(self):
                with self._lock:
                    snap = dict(self._data)
                return json.dumps(snap)
        """)
        assert ds == []

    def test_nested_def_under_lock_not_flagged(self):
        # A callback defined under the lock runs after release.
        ds = findings("""
            import json
            def f(self):
                with self._lock:
                    def cb():
                        return json.dumps({})
                    self._cb = cb
        """)
        assert ds == []

    def test_non_lock_with_ignored(self):
        ds = findings("""
            import json
            def f(self, path):
                with open(path) as fh:
                    return json.dumps({"a": 1})
        """)
        assert ds == []


# -------------------------------------------------------------- metric-name


class TestMetricName:
    def test_unregistered_literal(self):
        ds = findings("""
            def f(counters):
                counters.inc("tpu_bogus_total", ())
        """)
        assert rules_of(ds) == {"metric-name"}
        assert "tpu_bogus_total" in ds[0].message

    def test_registered_literal_ok(self):
        ds = findings("""
            def f(counters):
                counters.inc("tpu_hbm_used_bytes", ())
        """)
        assert ds == []

    def test_histogram_child_names_ok(self):
        ds = findings("""
            NAME = "tpu_exporter_poll_phase_duration_seconds_bucket"
        """)
        assert ds == []

    def test_docstring_mention_ok(self):
        ds = findings('''
            def f():
                """Feeds tpu_totally_invented_bytes downstream."""
                return 1
        ''')
        assert ds == []

    def test_unknown_schema_attr(self):
        ds = findings("""
            from tpu_pod_exporter_torch.metrics import schema
            def f(b):
                b.add(schema.TPU_TYPO_SPEC, 1.0)
        """)
        assert rules_of(ds) == {"metric-name"}
        assert "TPU_TYPO_SPEC" in ds[0].message

    def test_known_schema_attr_ok(self):
        ds = findings("""
            from tpu_pod_exporter_torch.metrics import schema
            def f(b):
                b.add(schema.TPU_HBM_USED_BYTES, 1.0)
        """)
        assert ds == []

    def test_inline_spec_outside_schema(self):
        ds = findings("""
            from tpu_pod_exporter_torch.metrics.registry import MetricSpec
            EXTRA = MetricSpec(name="tpu_hbm_used_bytes", help="h")
        """)
        assert "metric-name" in rules_of(ds)

    def test_pb2_module_string_ok(self):
        ds = findings("""
            MOD = "tpu_metric_service_pb2"
        """)
        assert ds == []


# --------------------------------------------------------------- wall-clock


class TestWallClock:
    def test_time_time_in_collector(self):
        ds = findings("""
            import time
            def f():
                return time.time()
        """, path="tpu_pod_exporter_torch/collector.py")
        assert rules_of(ds) == {"wall-clock"}

    def test_datetime_now_in_history(self):
        ds = findings("""
            from datetime import datetime
            def f():
                return datetime.now()
        """, path="tpu_pod_exporter_torch/history.py")
        assert rules_of(ds) == {"wall-clock"}

    def test_monotonic_ok(self):
        ds = findings("""
            import time
            def f():
                return time.monotonic()
        """, path="tpu_pod_exporter_torch/collector.py")
        assert ds == []

    def test_default_arg_reference_ok(self):
        # ``wallclock=time.time`` (no call) is the injection idiom.
        ds = findings("""
            import time
            def f(wallclock=time.time):
                return wallclock()
        """, path="tpu_pod_exporter_torch/supervisor.py")
        assert ds == []

    def test_other_modules_unrestricted(self):
        ds = findings("""
            import time
            def f():
                return time.time()
        """, path="tpu_pod_exporter_torch/server.py")
        assert ds == []


# ------------------------------------------------------------- join-timeout


class TestJoinTimeout:
    def test_zero_arg_join(self):
        ds = findings("""
            def f(t):
                t.join()
        """)
        assert rules_of(ds) == {"join-timeout"}

    def test_none_timeout(self):
        ds = findings("""
            def f(t):
                t.join(timeout=None)
        """)
        assert rules_of(ds) == {"join-timeout"}

    def test_timeout_ok(self):
        ds = findings("""
            def f(t, timeout):
                t.join(timeout)
                t.join(timeout=5.0)
        """)
        assert ds == []

    def test_str_join_ok(self):
        ds = findings("""
            def f(parts):
                return ",".join(parts)
        """)
        assert ds == []


# --------------------------------------------------------- thread-discipline


class TestThreadDiscipline:
    def test_unnamed_thread(self):
        ds = findings("""
            import threading
            def f():
                threading.Thread(target=f, daemon=True).start()
        """)
        assert rules_of(ds) == {"thread-discipline"}
        assert "name=" in ds[0].message

    def test_non_daemon_thread(self):
        ds = findings("""
            import threading
            def f():
                threading.Thread(target=f, name="tpu-x").start()
        """)
        assert rules_of(ds) == {"thread-discipline"}
        assert "daemon" in ds[0].message

    def test_named_daemon_ok(self):
        ds = findings("""
            import threading
            def f():
                threading.Thread(target=f, name="tpu-x", daemon=True).start()
        """)
        assert ds == []


# -------------------------------------------------------------- bare-except


class TestBareExcept:
    def test_bare(self):
        ds = findings("""
            def f():
                try:
                    g()
                except:
                    pass
        """)
        assert rules_of(ds) == {"bare-except"}

    def test_base_exception_swallowed(self):
        ds = findings("""
            def f():
                try:
                    g()
                except BaseException:
                    pass
        """)
        assert rules_of(ds) == {"bare-except"}

    def test_base_exception_reraised_ok(self):
        ds = findings("""
            def f():
                try:
                    g()
                except BaseException:
                    note()
                    raise
        """)
        assert ds == []

    def test_plain_exception_ok(self):
        ds = findings("""
            def f():
                try:
                    g()
                except Exception:
                    pass
        """)
        assert ds == []


# --------------------------------------------------------------- debug-gate


class TestDebugGate:
    def test_ungated_route(self):
        ds = findings("""
            def route(self, path):
                if path == "/debug/secrets":
                    return self.serve()
        """)
        assert rules_of(ds) == {"debug-gate"}

    def test_gated_route_ok(self):
        ds = findings("""
            def route(self, path):
                if path.startswith("/debug/") and not debug_client_allowed(
                    self.ip, self.addr
                ):
                    return self.deny()
                if path == "/debug/vars":
                    return self.serve()
        """)
        assert ds == []

    def test_log_mention_ok(self):
        ds = findings("""
            def f():
                log.warning("see GET /debug/trace for the profile")
        """)
        assert ds == []


# ------------------------------------------------------------ unused-import


class TestUnusedImport:
    def test_unused(self):
        ds = findings("""
            import os
            import sys
            print(sys.argv)
        """)
        assert rules_of(ds) == {"unused-import"}
        assert "'os'" in ds[0].message
        # Diagnostics must carry the severity their Rule declares —
        # unused-import/flag-read/flag-doc are the warning class.
        assert ds[0].severity == "warning"

    def test_all_used_ok(self):
        ds = findings("""
            import os
            print(os.getpid())
        """)
        assert ds == []

    def test_future_and_lazy_imports_ok(self):
        ds = findings("""
            from __future__ import annotations
            def f():
                import gzip
                return gzip
        """)
        assert ds == []


# ------------------------------------------------ disable comments


class TestDisable:
    def test_parse(self):
        got = parse_disables(
            "x = 1  # lint: disable=lock-io(lazy cache),wall-clock(stamp)"
        )
        assert got == {"lock-io": "lazy cache", "wall-clock": "stamp"}

    def test_reason_mandatory(self):
        assert parse_disables("x  # lint: disable=lock-io") == {}
        assert parse_disables("x  # lint: disable=lock-io()") == {}

    def test_reason_may_contain_parentheses(self):
        got = parse_disables(
            "x  # lint: disable=lock-io(lazy cache (cold path only))"
        )
        assert got == {"lock-io": "lazy cache (cold path only)"}

    def test_suppresses_on_line(self):
        ds = findings("""
            import json
            def f(self):
                with self._lock:
                    return json.dumps({})  # lint: disable=lock-io(test reason)
        """)
        assert ds == []

    def test_wrong_rule_does_not_suppress(self):
        ds = findings("""
            import json
            def f(self):
                with self._lock:
                    return json.dumps({})  # lint: disable=wall-clock(nope)
        """)
        assert rules_of(ds) == {"lock-io"}


# ---------------------------------------------------------- schema registry


class TestRegistryExtraction:
    def test_real_schema(self):
        src = (REPO_ROOT / "tpu_pod_exporter_torch/metrics/schema.py").read_text()
        reg = build_registry(src)
        assert "tpu_hbm_used_bytes" in reg.metric_names
        assert "tpu_exporter_up" in reg.metric_names
        # Histogram children derive from HistogramSpec declarations.
        assert "tpu_exporter_poll_phase_duration_seconds_bucket" in reg.metric_names
        assert "tpu_aggregator_round_seconds_sum" in reg.metric_names
        assert "TPU_HBM_USED_BYTES" in reg.schema_names
        assert "ALL_SPECS" in reg.schema_names
        assert "hbm_used_percent" in reg.schema_names


# ----------------------------------------------------------------- baseline


class TestBaseline:
    def test_roundtrip_and_multiset(self, tmp_path):
        root = tmp_path
        mod = root / "tpu_pod_exporter_torch" / "mod.py"
        mod.parent.mkdir(parents=True)
        mod.write_text("def f(t):\n    t.join()\n")
        d = Diagnostic("join-timeout", "error",
                       "tpu_pod_exporter_torch/mod.py", 2, "m")
        doc = baseline_document([d], str(root))
        path = root / "baseline.json"
        path.write_text(json.dumps(doc))
        entries = load_baseline(str(path))
        fresh, suppressed = apply_baseline([d], entries, str(root))
        assert fresh == [] and suppressed == 1
        # Multiset: a second live instance of the same fingerprint is NEW.
        fresh, suppressed = apply_baseline([d, d], entries, str(root))
        assert len(fresh) == 1 and suppressed == 1

    def test_committed_baseline_loads(self):
        # The port's own baseline, inside the port, and empty.
        entries = load_baseline(str(shared.BASELINE))
        assert entries == []
        assert json.loads(shared.BASELINE.read_text())["findings"] == []


# ------------------------------------------------------ real-tree self-check


class TestRealTree:
    def test_tree_clean_with_committed_baseline(self):
        findings = list(shared.findings())
        entries = load_baseline(str(shared.BASELINE))
        fresh, _ = apply_baseline(findings, entries, str(REPO_ROOT))
        assert fresh == [], "\n".join(d.format() for d in fresh)

    def test_real_context_flags_extracted(self):
        ctx = shared.context()
        names = {n for n, _ in ctx.config_fields}
        assert {"interval_s", "state_dir", "trace", "debug_addr"} <= names
        assert ctx.docs_text  # README + RUNBOOK loaded


# --------------------------------------- acceptance: seeded violations


@pytest.fixture(scope="module")
def seeded_tree(tmp_path_factory):
    """A copy of the real package with violations seeded into collector.py
    (the acceptance shape), linted once for every case that reads it."""
    tmp_path = tmp_path_factory.mktemp("seeded")
    pkg = tmp_path / "tpu_pod_exporter_torch"
    shutil.copytree(
        REPO_ROOT / "tpu_pod_exporter_torch", pkg,
        ignore=shutil.ignore_patterns("__pycache__", "_build"),
    )
    for doc in ("README.md",):
        shutil.copy(REPO_ROOT / doc, tmp_path / doc)
    (tmp_path / "deploy").mkdir()
    shutil.copy(REPO_ROOT / "deploy/RUNBOOK.md", tmp_path / "deploy/RUNBOOK.md")
    target = pkg / "collector.py"
    base_lines = target.read_text().count("\n")
    target.write_text(target.read_text() + textwrap.dedent("""

        def _seeded(self):
            import json
            with self._restart_lock:
                body = json.dumps({"seeded": True})
            self._counters.inc("tpu_exporter_seeded_bogus_total", ())
            return body
    """))
    return tmp_path, base_lines


@pytest.fixture()
def shared_lint(monkeypatch):
    """The CLI's lint_package answered from the one lint of each root."""
    monkeypatch.setattr(cli, "lint_package",
                        lambda root: list(shared.findings(str(root))))


def run_cli(capsys, *argv: str) -> tuple[int, str]:
    rc = cli.main(list(argv))
    return rc, capsys.readouterr().out


class TestSeededAcceptance:
    def test_lock_scoped_dumps_and_bogus_metric_fail_the_gate(self, seeded_tree):
        root, base_lines = seeded_tree
        findings = shared.findings(str(root))
        by_rule = {d.rule: d for d in findings}
        assert "lock-io" in by_rule and "metric-name" in by_rule
        for d in (by_rule["lock-io"], by_rule["metric-name"]):
            # Names the file and a line inside the seeded block.
            assert d.path == "tpu_pod_exporter_torch/collector.py"
            assert d.line > base_lines
        assert "json.dumps" in by_rule["lock-io"].message
        assert "tpu_exporter_seeded_bogus_total" in by_rule["metric-name"].message

    def test_cli_exits_nonzero_naming_rule_file_line(self, seeded_tree,
                                                     shared_lint, capsys):
        root, _ = seeded_tree
        rc, out = run_cli(capsys, "--root", str(root), "--no-baseline")
        assert rc == 1
        assert "lock-io" in out and "metric-name" in out
        assert "tpu_pod_exporter_torch/collector.py:" in out


class TestCli:
    def test_clean_tree_exits_zero(self, shared_lint, capsys):
        rc, out = run_cli(capsys)
        assert rc == 0, out
        assert "clean" in out

    def test_json_format(self):
        # The user's command, as a subprocess: the port's package, the
        # port's baseline, zero findings.
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_pod_exporter_torch.analysis",
             "--format", "json"],
            capture_output=True, text=True, cwd=str(REPO_ROOT),
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        doc = json.loads(proc.stdout)
        assert doc["findings"] == []
        assert doc["baseline_suppressed"] == 0

    def test_sarif_format_clean_tree(self, shared_lint, capsys):
        rc, out = run_cli(capsys, "--format", "sarif")
        assert rc == 0
        doc = json.loads(out)
        assert doc["version"] == "2.1.0"
        run = doc["runs"][0]
        assert run["results"] == []
        # Rule metadata rides the driver so annotations resolve ids.
        ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
        for rule in ("lock-io", "metric-name", "lock-order",
                     "lock-ownership", "lock-io-chain"):
            assert rule in ids

    def test_sarif_from_findings_list(self):
        """to_sarif renders the SAME findings list the text/JSON paths
        consume: severity maps to SARIF level, location carries the
        repo-relative path + 1-based line."""
        from tpu_pod_exporter_torch.analysis.diagnostics import (
            ERROR, WARNING, Diagnostic, to_sarif,
        )
        from tpu_pod_exporter_torch.analysis.rules import ALL_RULES
        findings = [
            Diagnostic("lock-io", ERROR,
                       "tpu_pod_exporter_torch/collector.py", 42, "bad"),
            Diagnostic("flag-doc", WARNING,
                       "tpu_pod_exporter_torch/config.py", 7, "undocumented"),
        ]
        doc = to_sarif(findings, ALL_RULES)
        results = doc["runs"][0]["results"]
        assert [r["level"] for r in results] == ["error", "warning"]
        loc = results[0]["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"] == \
            "tpu_pod_exporter_torch/collector.py"
        assert loc["region"]["startLine"] == 42
        assert results[0]["ruleId"] == "lock-io"

    def test_sarif_seeded_tree_carries_findings(self, seeded_tree,
                                                shared_lint, capsys):
        root, _ = seeded_tree
        rc, out = run_cli(capsys, "--root", str(root), "--no-baseline",
                          "--format", "sarif")
        assert rc == 1
        doc = json.loads(out)
        rules_hit = {r["ruleId"] for r in doc["runs"][0]["results"]}
        assert {"lock-io", "metric-name"} <= rules_hit

    def test_list_rules(self, capsys):
        rc, out = run_cli(capsys, "--list-rules")
        assert rc == 0
        for rule in ("lock-io", "metric-name", "wall-clock", "join-timeout",
                     "thread-discipline", "bare-except", "debug-gate",
                     "unused-import", "flag-read", "flag-doc"):
            assert rule in out

    def test_demo_catches_seeded_violations(self):
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_pod_exporter_torch.analysis", "--demo"],
            capture_output=True, text=True, cwd=str(REPO_ROOT),
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "PASS" in proc.stdout
        # The copy is the port's: every seeded finding names its files.
        assert "tpu_pod_exporter_torch/persist.py:" in proc.stdout
