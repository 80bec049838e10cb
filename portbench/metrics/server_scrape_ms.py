"""Mean time the exporter's server spends on a scrape in the window
(tpu_exporter_scrape_duration_seconds)."""

from portbench.window import hist_mean_ms


def read(window: dict) -> float | None:
    return hist_mean_ms(window, "tpu_exporter_scrape_duration_seconds")
