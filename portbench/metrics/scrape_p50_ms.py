"""Median of every /metrics request of the open loop, from its due instant
to its last byte, a rejected or failed request counting as the window's
whole length (it missed any limit)."""

from portbench.window import percentile


def read(window: dict) -> float | None:
    return percentile(window.get("latencies_ms", []), 50.0, window["window_s"] * 1000.0)
