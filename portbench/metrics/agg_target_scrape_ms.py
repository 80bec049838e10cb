"""Mean duration of one target's fetch in the aggregator's rounds of the
window (tpu_aggregator_target_scrape_seconds)."""

from portbench.window import hist_mean_ms


def read(window: dict) -> float | None:
    return hist_mean_ms(window, "tpu_aggregator_target_scrape_seconds")
