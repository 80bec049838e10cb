"""Median host-clock duration of every aggregator round started in the
window, rounds back to back."""

from portbench.window import percentile


def read(window: dict) -> float | None:
    return percentile(window.get("rounds_ms", []), 50.0, float("inf"))
