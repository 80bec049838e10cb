"""Arithmetic the metric readers share.

A run hands every reader one ``window`` dict. Its keys, where the cell has
them: ``setup_s``; ``window_s`` (the measured window's length);
``latencies_ms`` (every request of an open loop, due to last byte, a
failed one as ``inf``) with ``attempted`` and ``failed``; ``cpu_s`` (the
program process's CPU seconds across the window); ``rounds_ms`` and, in a
traced run, ``fetch_wall_ms`` (one a round); ``self_start`` and
``self_end`` (the program's own self-metrics, parsed, at the window's two
ends).
"""

from __future__ import annotations

import math

from portbench.reference import expo


def percentile(values: list[float], q: float, cap: float) -> float | None:
    """Nearest-rank ``q`` percentile; a failure (``inf``) reads as ``cap``."""
    if not values:
        return None
    ordered = sorted(values)
    v = ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]
    return cap if math.isinf(v) else v


def hist_mean_ms(window: dict, name: str, match: dict[str, str] | None = None) -> float | None:
    """Mean of a histogram's observations in the window, in ms, from the
    change of its ``_sum`` and ``_count`` between the window's two ends."""
    start, end = window.get("self_start"), window.get("self_end")
    if start is None or end is None:
        return None
    counts = [expo.total(s, name + "_count", match) for s in (start, end)]
    sums = [expo.total(s, name + "_sum", match) for s in (start, end)]
    if None in counts or None in sums or counts[1] <= counts[0]:
        return None
    return (sums[1] - sums[0]) / (counts[1] - counts[0]) * 1000.0


def delta(window: dict, name: str, match: dict[str, str] | None = None) -> float | None:
    """Change of a counter (summed over its matching series) across the window."""
    start, end = window.get("self_start"), window.get("self_end")
    if start is None or end is None:
        return None
    vals = [expo.total(s, name, match) for s in (start, end)]
    return None if None in vals else vals[1] - vals[0]
