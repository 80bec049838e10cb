"""Mean time a round spends parsing the fetched bodies in the window
(tpu_aggregator_round_phase_seconds{phase="parse"})."""

from portbench.window import hist_mean_ms


def read(window: dict) -> float | None:
    return hist_mean_ms(window, "tpu_aggregator_round_phase_seconds", {"phase": "parse"})
