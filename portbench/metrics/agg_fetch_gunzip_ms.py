"""Mean time of one successful target fetch decompressing the body in the
window (tpu_aggregator_fetch_stage_seconds{stage="gunzip"})."""

from portbench.window import hist_mean_ms


def read(window: dict) -> float | None:
    return hist_mean_ms(window, "tpu_aggregator_fetch_stage_seconds", {"stage": "gunzip"})
