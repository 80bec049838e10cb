"""Mean duration of a whole poll of the exporter in the window
(tpu_exporter_poll_phase_duration_seconds{phase="total"})."""

from portbench.window import hist_mean_ms


def read(window: dict) -> float | None:
    return hist_mean_ms(window, "tpu_exporter_poll_phase_duration_seconds", {"phase": "total"})
