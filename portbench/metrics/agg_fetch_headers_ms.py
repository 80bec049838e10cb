"""Mean time of one successful target fetch up to the response's headers in
the window: connect, send, the target's serve and the first byte
(tpu_aggregator_fetch_stage_seconds{stage="headers"})."""

from portbench.window import hist_mean_ms


def read(window: dict) -> float | None:
    return hist_mean_ms(window, "tpu_aggregator_fetch_stage_seconds", {"stage": "headers"})
