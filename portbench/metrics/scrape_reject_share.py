"""Scrapes the exporter refused in the window (tpu_exporter_scrape_rejects_total,
every cause), in per cent of the scrapes attempted."""

from portbench.window import delta


def read(window: dict) -> float | None:
    rejects = delta(window, "tpu_exporter_scrape_rejects_total")
    if rejects is None or not window.get("attempted"):
        return None
    return rejects / window["attempted"] * 100.0
