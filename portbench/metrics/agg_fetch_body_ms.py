"""Mean time of one successful target fetch reading the response's body in
the window (tpu_aggregator_fetch_stage_seconds{stage="body"})."""

from portbench.window import hist_mean_ms


def read(window: dict) -> float | None:
    return hist_mean_ms(window, "tpu_aggregator_fetch_stage_seconds", {"stage": "body"})
