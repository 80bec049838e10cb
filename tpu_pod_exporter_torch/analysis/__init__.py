"""Static analysis — the exporter's invariants as machine-checked rules.

The codebase's correctness rests on conventions that no general-purpose
linter knows about: the copy-then-serialize lock discipline (review
caught serialization under a lock by eye, again and again), the frozen
``metrics/schema.py`` surface (a metric name not in ``ALL_SPECS`` silently
forks the exposition contract), the monotonic-clock rule on the poll path,
the ``tpu-sup-*``/named-daemon thread conventions, and the loopback gate on
``/debug/*``. ``exporter-lint`` encodes each as a named AST rule with
file:line diagnostics, a severity, an inline
``# lint: disable=RULE(reason)`` escape hatch, and a committed baseline for
grandfathered findings (``analysis/baseline.json``, empty) — so every
NEW violation fails the gate naming the rule, file, and line.

Usage::

    python -m tpu_pod_exporter_torch.analysis            # lint the package
    python -m tpu_pod_exporter_torch.analysis --demo     # seed + catch a violation
    exporter-lint --format json                    # CI artifact shape

See README.md "Static analysis" for the rule reference and the port's
section there for its commands: the reviewed artifacts live in
``analysis/reviewed/``, the witnesses run under the pytest plugin
``analysis/pytest_witness.py``.
"""

from __future__ import annotations

from tpu_pod_exporter_torch.analysis.diagnostics import (
    Diagnostic,
    parse_disables,
)
from tpu_pod_exporter_torch.analysis.engine import (
    LintContext,
    lint_package,
    lint_source,
)
from tpu_pod_exporter_torch.analysis.rules import ALL_RULES, Rule

__all__ = [
    "ALL_RULES",
    "Diagnostic",
    "LintContext",
    "Rule",
    "lint_package",
    "lint_source",
    "parse_disables",
]
