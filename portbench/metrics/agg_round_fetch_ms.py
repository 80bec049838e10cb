"""Mean wall time of a round's scrape fan-out in the window
(tpu_aggregator_round_phase_seconds{phase="fetch"})."""

from portbench.window import hist_mean_ms


def read(window: dict) -> float | None:
    return hist_mean_ms(window, "tpu_aggregator_round_phase_seconds", {"phase": "fetch"})
