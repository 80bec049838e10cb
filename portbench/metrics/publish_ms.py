"""Mean duration of a poll's render and snapshot swap in the window
(tpu_exporter_poll_phase_duration_seconds{phase="publish"})."""

from portbench.window import hist_mean_ms


def read(window: dict) -> float | None:
    return hist_mean_ms(window, "tpu_exporter_poll_phase_duration_seconds", {"phase": "publish"})
