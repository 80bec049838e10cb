"""Mean time a round spends folding the parsed bodies and emitting the
rollups in the window (tpu_aggregator_round_phase_seconds{phase="fold"})."""

from portbench.window import hist_mean_ms


def read(window: dict) -> float | None:
    return hist_mean_ms(window, "tpu_aggregator_round_phase_seconds", {"phase": "fold"})
