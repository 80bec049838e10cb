"""Diagnostic records + the inline disable-comment escape hatch.

A finding is suppressed by a comment ON ITS LINE of the form::

    something_flagged()  # lint: disable=RULE(reason why this is intentional)

Several rules may be disabled on one line, comma-separated::

    x = gzip.compress(b)  # lint: disable=lock-io(lazy cache),wall-clock(stamp)

The reason is MANDATORY — an empty ``disable=RULE()`` (or a bare
``disable=RULE``) does not suppress anything: the whole point of the escape
hatch is that every grandfathered exception carries its justification in
the diff where reviewers see it.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass

ERROR = "error"
WARNING = "warning"

# `# lint: disable=rule-a(reason), rule-b(other reason)`
_DISABLE_RE = re.compile(r"#\s*lint:\s*disable=(.+)$")
# Reason is lazy-matched to a ")" that closes the entry (followed by a
# comma or end-of-line), so reasons may themselves contain parentheses.
_ENTRY_RE = re.compile(r"\s*([a-z][a-z0-9-]*)\s*\((.+?)\)\s*(?:,|$)")


@dataclass(frozen=True)
class Diagnostic:
    """One finding: a rule, where it fired, and why."""

    rule: str
    severity: str  # ERROR | WARNING
    path: str      # repo-relative, e.g. tpu_pod_exporter_torch/collector.py
    line: int      # 1-based
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.severity}: {self.rule}: {self.message}"

    def fingerprint(self, line_text: str = "") -> str:
        """Stable baseline key: rule + path + the offending line's stripped
        text (so unrelated edits shifting line numbers don't churn the
        baseline, but changing the flagged line itself does)."""
        h = hashlib.sha1(
            f"{self.rule}\x00{self.path}\x00{line_text.strip()}".encode()
        )
        return h.hexdigest()[:16]


def to_sarif(findings: list[Diagnostic], rules: tuple = ()) -> dict:
    """SARIF 2.1.0 document from one findings list — the same list the
    text/JSON renderers consume, so CI can annotate PRs inline without a
    second lint pass. ``rules`` is the ALL_RULES tuple (passed in to keep
    this module import-light)."""
    level = {ERROR: "error", WARNING: "warning"}
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {
                "driver": {
                    "name": "exporter-lint",
                    "informationUri": (
                        "https://example.invalid/tpu-pod-exporter"
                        "#static-analysis"
                    ),
                    "rules": [
                        {
                            "id": r.name,
                            "shortDescription": {"text": r.summary},
                            "defaultConfiguration": {
                                "level": level.get(r.severity, "warning"),
                            },
                        }
                        for r in rules
                    ],
                },
            },
            "results": [
                {
                    "ruleId": d.rule,
                    "level": level.get(d.severity, "warning"),
                    "message": {"text": d.message},
                    "locations": [{
                        "physicalLocation": {
                            "artifactLocation": {
                                "uri": d.path,
                                "uriBaseId": "SRCROOT",
                            },
                            "region": {"startLine": max(d.line, 1)},
                        },
                    }],
                }
                for d in findings
            ],
        }],
    }


def parse_disables(line: str) -> dict[str, str]:
    """Extract ``{rule: reason}`` from one source line's disable comment.

    Returns an empty dict when the line has no (well-formed) disable —
    including ``disable=rule()`` with an empty reason, which is rejected by
    the regex on purpose (see module docstring).
    """
    m = _DISABLE_RE.search(line)
    if m is None:
        return {}
    out: dict[str, str] = {}
    for rule, reason in _ENTRY_RE.findall(m.group(1)):
        out[rule] = reason.strip()
    return out
