"""One whole-tree lint, context and model of the port, shared by its lint
tests (``test_torch_lint``, ``test_torch_concurrency``,
``test_torch_execcontext``, ``test_torch_lint_parity``): each whole-tree
case of the JAX package's lint tests re-lints the tree, seconds a lint.
The analysis is pure over the committed sources, so one run per session
answers every case that reads it."""

import functools
import os
from pathlib import Path

from tpu_pod_exporter_torch.analysis import concurrency, execcontext
from tpu_pod_exporter_torch.analysis.engine import build_context, lint_package

REPO_ROOT = Path(__file__).resolve().parent.parent
REVIEWED = REPO_ROOT / "tpu_pod_exporter_torch" / "analysis" / "reviewed"
BASELINE = REPO_ROOT / "tpu_pod_exporter_torch" / "analysis" / "baseline.json"


def findings(root: str | None = None) -> tuple:
    """``lint_package(root)`` (default: the repo), once per root."""
    return _lint(os.path.abspath(root or REPO_ROOT))


@functools.lru_cache(maxsize=None)
def _lint(root: str) -> tuple:
    return tuple(lint_package(root))


@functools.lru_cache(maxsize=None)
def context():
    """The port's real-tree LintContext; its concurrency and execution
    models are memoized on it by ``get_model``/``get_exec_model``."""
    return build_context(str(REPO_ROOT))


def model():
    return concurrency.get_model(context())


def exec_model():
    return execcontext.get_exec_model(context())
