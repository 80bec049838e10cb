"""Mean lateness of the exporter's server loop in running a due timer in the
window, a 100 ms probe timer among them
(tpu_exporter_server_loop_lag_seconds)."""

from portbench.window import hist_mean_ms


def read(window: dict) -> float | None:
    return hist_mean_ms(window, "tpu_exporter_server_loop_lag_seconds")
