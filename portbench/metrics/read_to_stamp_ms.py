"""How much later than the end of its device read a poll is stamped: the
poll's stamp (tpu_exporter_last_poll_timestamp_seconds) less the instant its
device read ended (tpu_exporter_last_device_read_timestamp_seconds{edge="end"}),
the mean over the polls published at the window's two ends."""

from portbench.reference import expo


def read(window: dict) -> float | None:
    gaps = []
    for body in (window.get("self_start"), window.get("self_end")):
        if body is None:
            continue
        stamp = expo.total(body, "tpu_exporter_last_poll_timestamp_seconds")
        end = expo.total(body, "tpu_exporter_last_device_read_timestamp_seconds", {"edge": "end"})
        if stamp is not None and end is not None:
            gaps.append((stamp - end) * 1000.0)
    return sum(gaps) / len(gaps) if gaps else None
