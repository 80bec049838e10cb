"""The JAX package's Makefile checks, as ``chip_smoke.py`` runs them on the port.

Every ``python -m tpu_pod_exporter.<module>`` command of the ``Makefile``
(and its ``bench``, ``ruff`` and ``mypy`` lines) is either run by a phase of
``chip_smoke.py`` with the package renamed and the same flags (state and
output paths aside), or listed here with the reason it is not. The budgets
phase (19) reads each timing check's value and verdict from the check's own
output: here it reads the real output of both packages' checks, run at small
sizes, and the same flags give the same verdict from both.
"""

import ast
import os
import shlex
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke

REPO = Path(__file__).resolve().parent.parent
# Flags whose value is where a run keeps its state or writes its output.
PATH_FLAGS = {"--state-dir", "--state-root", "--trace-out", "--egress-dir", "--check-witness",
              "--check-loop-witness"}
# Makefile commands no phase runs with the same flags: target[n], the n-th
# python command of the target, and why.
LISTED = {
    "lint[0]": "phase 16 runs exporter-lint with --format json, to read its findings",
    "lint[1]": "ruff is not installed on either machine",
    "typecheck[0]": "mypy is not installed on either machine",
    "bench[0]": "bench.py over the port is the benchmark PR's",
    "lock-graph[0]": "phase 16 regenerates the port's own reviewed lock graph and fork "
                     "inventory (analysis/reviewed/) in one call",
    "fork-inventory[0]": "phase 16 regenerates it with the lock graph, in one call",
    "history-demo[0]": "phase 18 replays the card's own recording (h100-trace.jsonl)",
    "trace-demo[0]": "phase 18 replays the card's own recording (h100-trace.jsonl)",
    "store-demo[0]": "phase 15 passes the store demo's default sizes explicitly",
    "dashboard-demo[0]": "phase 15 runs it at the CI workflow's scale (48 targets, 600 "
                         "subscriptions): at 5000 the push p99 took 2.2-3.5 s in both "
                         "packages on 8-core hosts",
    "alert-demo[0]": "phase 15's scenario suite runs alert_partition at 120 targets and 4 shards",
}
STOP = {";", "&&", "||", "then", "else", "fi", "\\"}


def _makefile_commands() -> dict:
    """{target[n]: (module, args)} of every python command of the Makefile
    that runs the JAX package, bench.py, ruff or mypy."""
    text = (REPO / "Makefile").read_text().replace("\\\n", " ")
    commands, target, seen = {}, None, {}
    for line in text.splitlines():
        if line and not line[0].isspace() and ":" in line and not line.startswith((".", "#")):
            target = line.split(":", 1)[0].strip()
            continue
        if not line.startswith("\t"):
            continue
        tokens = shlex.split(line.strip().lstrip("@"))
        for i, token in enumerate(tokens):
            if token != "python":
                continue
            rest = tokens[i + 1:]
            if rest[:1] == ["-m"] and rest[1].startswith(("tpu_pod_exporter.", "ruff", "mypy")):
                module, args = rest[1], rest[2:]
            elif rest[:1] == ["bench.py"]:
                module, args = "bench.py", rest[1:]
            else:
                continue
            end = next((j for j, a in enumerate(args) if a in STOP or a.endswith(";")),
                       len(args))
            if end < len(args) and args[end].endswith(";") and args[end] != ";":
                args = [*args[:end], args[end][:-1]]
            else:
                args = args[:end]
            n = seen[target] = seen.get(target, -1) + 1
            commands[f"{target}[{n}]"] = (module.replace("tpu_pod_exporter.", "", 1),
                                          tuple(args))
    return commands


def _flags(args) -> frozenset:
    """The flags of an argument list and their values, order aside; the
    values of PATH_FLAGS and the log level dropped."""
    out, args = set(), list(args)
    while args:
        flag = args.pop(0)
        value = args.pop(0) if args and not args[0].startswith("--") else True
        if flag == "--log-level":
            continue
        out.add((flag, "<path>" if flag in PATH_FLAGS else value))
    return frozenset(out)


def _phase_commands() -> set:
    """(module, flags) of every port CLI a chip_smoke phase runs: the drills
    (phase 15), the budgets (19), and each ``run_lint``/``run_port`` call of
    the script (16, 18), whose non-literal arguments are paths."""
    out = set()
    for lanes in chip_smoke.DRILL_GROUPS:
        for drills in lanes:
            for _, module, args, *_ in drills:
                flag = chip_smoke.DRILL_STATE_FLAG.get(module)
                out.add((module, _flags([*args, *((flag, "<path>") if flag else ())])))
    for _, module, args, _ in chip_smoke.BUDGET_FUNCTIONAL:
        out.add((module, _flags(args)))
    for check in chip_smoke.BUDGET_TIMING:
        out.add((check["module"], _flags(check["args"])))
    for node in ast.walk(ast.parse((REPO / "chip_smoke.py").read_text())):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in ("run_lint", "run_port")):
            continue
        args = [a.value if isinstance(a, ast.Constant) else "<path>"
                for a in node.args if not isinstance(a, ast.Starred)]
        module = "analysis" if node.func.id == "run_lint" else args.pop(0)
        out.add((module, _flags(args)))
    return out


MAKEFILE = _makefile_commands()


def test_the_makefile_parse_finds_every_targets_commands():
    targets = {key.split("[")[0] for key in MAKEFILE}
    assert {"lint", "typecheck", "bench", "trace-overhead", "persist-fsync-check",
            "persist-overhead", "restart-demo", "fleet-query-demo", "gpu-demo", "chaos-demo",
            "egress-demo", "egress-drain-check", "shard-demo", "scenario-demo", "fuzz-smoke",
            "dashboard-demo", "alert-demo", "pressure-demo", "store-demo"} <= targets
    assert MAKEFILE["persist-overhead[0]"] == (
        "persist", ("--overhead-check", "--polls", "200", "--chips", "256", "--budget", "0.02"))
    assert MAKEFILE["lint[1]"] == ("ruff", ("check", "tpu_pod_exporter", "tests"))
    assert MAKEFILE["alert-demo[1]"][1][-2:] == ("--state-root", "alert-demo-state/negative")
    assert len(MAKEFILE) == 30


@pytest.mark.parametrize("key", sorted(MAKEFILE))
def test_each_makefile_command_runs_in_a_phase_or_is_listed(key):
    module, args = MAKEFILE[key]
    run = (module, _flags(args)) in _phase_commands()
    if key in LISTED:
        assert not run, f"{key} runs in a phase with the same flags: drop it from LISTED"
    else:
        assert run, f"no chip_smoke phase runs {module} {' '.join(args)}"


def test_the_budgets_phase_runs_the_nine_checks_at_the_makefiles_flags():
    functional = {target: (module, args)
                  for target, module, args, _ in chip_smoke.BUDGET_FUNCTIONAL}
    timing = {c["target"]: (c["module"], c["args"]) for c in chip_smoke.BUDGET_TIMING}
    assert set(functional) == {"restart-demo", "gpu-demo", "chaos-demo"}
    assert set(timing) == {"trace-overhead", "persist-fsync-check", "persist-overhead",
                           "fleet-query-demo", "egress-demo", "egress-drain-check"}
    for target, command in {**functional, **timing}.items():
        assert MAKEFILE[f"{target}[0]"] == command, target
    runs = {c["target"]: c["runs"] for c in chip_smoke.BUDGET_TIMING}
    assert runs == {**dict.fromkeys(timing, 3), "fleet-query-demo": 1}


# (small arguments, arguments of a run that meets its budget, of one that
# misses it) for each timing check; the egress demo's met run is its full
# length (about 15 s), so only its miss runs here.
SMALL = {
    "trace-overhead": (("--overhead-check", "--polls", "16", "--chips", "8"),
                       ("--budget", "1000"), ("--budget", "-100")),
    "persist-fsync-check": (("--fsync-check", "--records", "5"),
                            ("--budget-ms", "100000"), ("--budget-ms", "0")),
    "persist-overhead": (("--overhead-check", "--polls", "16", "--chips", "8"),
                         ("--budget", "1000"), ("--budget", "-100")),
    "fleet-query-demo": (("--targets", "4"), ("--budget-ms", "100000"), ("--budget-ms", "0")),
    "egress-demo": (("--demo", "--perf-samples", "5"), None, ("--perf-budget", "-100")),
    "egress-drain-check": (("--drain-check", "--outage-s", "10"), ("--budget-s", "60"),
                           ("--budget-s", "0")),
}
PACKAGES = ("tpu_pod_exporter", "tpu_pod_exporter_torch")
CHECKS = {c["target"]: c for c in chip_smoke.BUDGET_TIMING}


@pytest.fixture(scope="module")
def run_check(tmp_path_factory):
    """Runs ``python -m <package>.<module> args`` once per distinct command,
    with its state in a directory of its own: (exit code, output)."""
    done = {}

    def run(package: str, module: str, args: tuple) -> tuple:
        key = (package, module, args)
        if key not in done:
            tmp = tmp_path_factory.mktemp("check")
            proc = subprocess.run([sys.executable, "-m", f"{package}.{module}", *args],
                                  cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True, timeout=120,
                                  env={**os.environ, "TMPDIR": str(tmp), "JAX_PLATFORMS": "cpu"})
            done[key] = proc.returncode, proc.stdout
        return done[key]

    return run


CASES = [(package, target, verdict) for package in PACKAGES for target, (_, met, _) in SMALL.items()
         for verdict in (("ok", "timing miss") if met else ("timing miss",))]


@pytest.mark.parametrize("package,target,verdict", CASES)
def test_the_phase_reads_each_checks_value_and_verdict(run_check, package, target, verdict):
    small, met, missed = SMALL[target]
    rc, out = run_check(package, CHECKS[target]["module"],
                        small + (met if verdict == "ok" else missed))
    assert chip_smoke.budget_verdict(rc, out) == verdict, out[-2000:]
    value = chip_smoke.budget_value(CHECKS[target], out)
    assert value is not None, out[-2000:]
    if CHECKS[target]["unit"] != "%":
        assert value >= 0


@pytest.mark.parametrize("target,budget", [
    ("persist-fsync-check", 1), ("persist-fsync-check", 2),
    ("egress-drain-check", 1), ("egress-drain-check", 2)])
def test_both_packages_give_the_same_verdict(run_check, target, budget):
    small = SMALL[target][0] + SMALL[target][budget]
    verdicts = {package: chip_smoke.budget_verdict(*run_check(package, CHECKS[target]["module"],
                                                              small))
                for package in PACKAGES}
    assert verdicts == dict.fromkeys(PACKAGES, "ok" if budget == 1 else "timing miss")


def test_both_packages_replay_the_gpu_demo_alike(run_check):
    (_, module, args, ok_text), = [c for c in chip_smoke.BUDGET_FUNCTIONAL if c[0] == "gpu-demo"]
    lines = {}
    for package in PACKAGES:
        rc, out = run_check(package, module, args)
        assert rc == 0, out[-2000:]
        (lines[package],) = [ln for ln in out.splitlines() if ok_text in ln]
    assert lines["tpu_pod_exporter"] == lines["tpu_pod_exporter_torch"]


@pytest.mark.parametrize("text,rc,verdict", [
    ("OK: tracing overhead within budget", 0, "ok"),
    ("x\nFAIL: tracing overhead exceeds budget", 1, "timing miss"),
    ("FAIL: wedged-receiver p99 over budget (scrape 1 > 2ms)\negress dir kept", 1,
     "timing miss"),
    ("FAIL: backlog drain exceeded budget", 1, "timing miss"),
    ("FAIL: drain was not in-order exactly-once", 1, None),
    ("FAIL: backlog drain exceeded budget\nFAIL: egress breaker never opened", 1, None),
    ("Traceback (most recent call last):\n  ...\nOK: fsync latency within budget", 0, None),
    ("FAIL: fsync p99 exceeds budget", 2, None),
    ("killed", -9, None),
])
def test_only_a_checks_own_budget_line_is_a_timing_miss(text, rc, verdict):
    assert chip_smoke.budget_verdict(rc, text) == verdict


# What each check prints when it runs, for phase 19 driven without running
# them: (exit code, output) by Makefile target.
FAKE = {
    "restart-demo": (0, "restart-demo: OK (kill mid-poll)"),
    "gpu-demo": (0, "gpu-demo: replayed 8 polls: 2 GPUs"),
    "chaos-demo": (0, "recovered: breaker closed, backend reconnected, up=1"),
    "trace-overhead": (1, "trace-off 1.0s, trace-on 1.06s → overhead +6.0% (budget 5%)\n"
                          "FAIL: tracing overhead exceeds budget"),
    "persist-fsync-check": (0, "p50 0.20ms  p99 1.20ms  max 1.50ms  (budget p99 50ms)"),
    "persist-overhead": (0, "→ overhead +1.0% (budget 2%)\nOK: persistence poll-loop"),
    "fleet-query-demo": (0, '{\n "query_p99_ms": 400.0\n}\nfleet-query-demo OK'),
    "egress-demo": (0, "baseline: scrape p99 2.00ms, poll p99 4.00ms\n"
                       "during wedge: scrape p99 3.00ms, poll p99 4.00ms\negress-demo: OK"),
    "egress-drain-check": (0, "drained in 0.50s (budget 20s)\nOK: backlog drains"),
}


@pytest.fixture
def fake_checks(monkeypatch):
    by_command = {(module, args): target for target, module, args, _ in
                  chip_smoke.BUDGET_FUNCTIONAL}
    by_command.update({(c["module"], c["args"]): c["target"] for c in chip_smoke.BUDGET_TIMING})
    ran = []

    def run(tmp, module, args):
        target = by_command[(module, args)]
        ran.append(target)
        return (*FAKE[target], 5.0)

    monkeypatch.setattr(chip_smoke, "run_budget_check", run)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    return ran


def _lines(text: str) -> dict:
    import json

    out = {}
    for line in text.splitlines():
        doc = json.loads(line)
        out[doc.get("target", doc["phase"])] = doc
    return out


def test_the_budgets_phase_runs_each_check_and_prints_timing_misses(fake_checks, capsys):
    medians = chip_smoke.phase_budgets(1e6)
    lines = _lines(capsys.readouterr().out)
    assert medians == {"trace-overhead": 6.0, "persist-fsync-check": 1.2, "persist-overhead": 1.0,
                       "fleet-query-demo": 400.0, "egress-demo": -50.0,
                       "egress-drain-check": 0.5}
    for check in chip_smoke.BUDGET_TIMING:
        line = lines[check["target"]]
        assert len(line["runs"]) == line["runs_planned"] == check["runs"]
        assert line["budgets"] == check["budgets"]
    assert [r["verdict"] for r in lines["trace-overhead"]["runs"]] == ["timing miss"] * 3
    assert lines["trace-overhead"]["median_meets"] == {"makefile": False, "ci": True}
    assert lines["egress-demo"]["median_meets"] == {"makefile": True, "ci": True}
    assert lines["restart-demo"]["ok_line"] == "restart-demo: OK (kill mid-poll)"
    assert lines["budgets"]["timing_misses"] == 3 and lines["budgets"]["repeats_cut"] == []
    assert lines["budgets"]["checks"] == 9
    assert fake_checks.count("persist-overhead") == 3 and fake_checks.count("fleet-query-demo") == 1


def test_the_budgets_phase_cuts_the_repeats_that_do_not_fit(fake_checks, capsys):
    chip_smoke.phase_budgets(0.0)
    lines = _lines(capsys.readouterr().out)
    assert lines["budgets"]["repeats_cut"] == [
        c["target"] for c in chip_smoke.BUDGET_TIMING if c["runs"] > 1]
    assert all(len(lines[c["target"]]["runs"]) == 1 for c in chip_smoke.BUDGET_TIMING)
    assert len(fake_checks) == 9


@pytest.mark.parametrize("target,output", [
    ("chaos-demo", (0, "TIMEOUT: exporter did not recover")),
    ("restart-demo", (1, "restart-demo: OK (kill mid-poll)")),
    ("persist-overhead",
     (0, "Traceback (most recent call last):\n  ...\n→ overhead +1.0% (budget")),
    ("egress-drain-check", (1, "FAIL: drain was not in-order exactly-once")),
    ("fleet-query-demo", (0, "fleet-query-demo OK")),
])
def test_the_budgets_phase_fails_on_anything_but_a_timing_miss(fake_checks, monkeypatch,
                                                                target, output):
    monkeypatch.setitem(FAKE, target, output)
    with pytest.raises(AssertionError, match=f"budgets: {target}"):
        chip_smoke.phase_budgets(1e6)
