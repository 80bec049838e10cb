"""The cases of tests/test_multihost.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

Multi-host slice tests (SURVEY.md §4.4, baseline config 4).

N exporter instances — each with its own fake backends representing one host
of a v5p-64 slice — scraped by one Prometheus-style aggregator. Cross-host
rollups happen via labels only; the exporters never talk to each other
(SURVEY.md §2.8: ICI/DCN are measured quantities, not transports).
"""

import urllib.request
from collections import defaultdict

import pytest
from prometheus_client.parser import text_string_to_metric_families

from tpu_pod_exporter_torch.app import ExporterApp
from tpu_pod_exporter_torch.attribution.fake import FakeAttribution, simple_allocation
from tpu_pod_exporter_torch.backend.fake import FakeBackend, FakeChipScript
from tpu_pod_exporter_torch.config import ExporterConfig

GIB = 1024**3

# v5p-64: 32 chips over 8 hosts, 4 chips/host, 6 ICI links/chip (3D torus).
NUM_HOSTS = 8
CHIPS_PER_HOST = 4


def make_host(worker_id: int):
    backend = FakeBackend(
        chips=CHIPS_PER_HOST,
        script=FakeChipScript(
            hbm_total_bytes=96 * GIB,
            hbm_used_bytes=(worker_id + 1) * GIB,
            duty_cycle_percent=80.0,
            ici_link_count=6,
            ici_bytes_per_step=1_000_000.0,
        ),
    )
    # One training job spans the whole slice: same pod name on every host
    # (a multi-host JobSet replica), each host's 4 chips allocated to it.
    attr = FakeAttribution(
        [
            simple_allocation(
                "llm-train-0",
                [str(i) for i in range(CHIPS_PER_HOST)],
                namespace="ml",
            )
        ]
    )
    cfg = ExporterConfig(
        port=0,
        host="127.0.0.1",
        interval_s=0.05,
        accelerator="v5p-64",
        slice_name="slice-a",
        node_name=f"host-{worker_id}",
        worker_id=str(worker_id),
    )
    return ExporterApp(cfg, backend=backend, attribution=attr)


@pytest.fixture(scope="module")
def slice_apps():
    apps = [make_host(w) for w in range(NUM_HOSTS)]
    for app in apps:
        app.start()
    yield apps
    for app in apps:
        app.stop()


def scrape_all(apps):
    out = []
    for app in apps:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{app.port}/metrics", timeout=5
        ) as r:
            out.append(r.read().decode())
    return out


class TestSliceAggregation:
    def test_every_host_reports_its_chips(self, slice_apps):
        texts = scrape_all(slice_apps)
        for w, text in enumerate(texts):
            fams = {f.name: f for f in text_string_to_metric_families(text)}
            used = fams["tpu_hbm_used_bytes"].samples
            assert len(used) == CHIPS_PER_HOST
            for s in used:
                assert s.labels["worker_id"] == str(w)
                assert s.labels["host"] == f"host-{w}"
                assert s.labels["slice_name"] == "slice-a"
                assert s.labels["pod"] == "llm-train-0"
                assert s.value == (w + 1) * GIB

    def test_cross_host_rollup_by_labels(self, slice_apps):
        """The aggregation Prometheus would do: sum over the slice label."""
        texts = scrape_all(slice_apps)
        slice_hbm = 0.0
        slice_chips = 0
        per_pod_chips = defaultdict(int)
        for text in texts:
            for fam in text_string_to_metric_families(text):
                if fam.name == "tpu_hbm_used_bytes":
                    for s in fam.samples:
                        assert s.labels["slice_name"] == "slice-a"
                        slice_hbm += s.value
                        slice_chips += 1
                if fam.name == "tpu_pod_chip_count":
                    for s in fam.samples:
                        per_pod_chips[(s.labels["pod"], s.labels["namespace"])] += int(
                            s.value
                        )
        assert slice_chips == NUM_HOSTS * CHIPS_PER_HOST  # 32 chips on v5p-64
        assert slice_hbm == sum((w + 1) * GIB * CHIPS_PER_HOST for w in range(NUM_HOSTS))
        # the slice-wide job owns all 32 chips, summed across hosts by labels
        assert per_pod_chips[("llm-train-0", "ml")] == 32

    def test_ici_series_per_host(self, slice_apps):
        import time

        time.sleep(0.15)  # ≥2 polls so rates exist
        texts = scrape_all(slice_apps)
        for text in texts:
            fams = {f.name: f for f in text_string_to_metric_families(text)}
            counters = fams["tpu_ici_transferred_bytes"].samples
            assert len(counters) == CHIPS_PER_HOST * 6
            links = {s.labels["link"] for s in counters}
            assert links == {"0", "1", "2", "3", "4", "5"}
            rates = fams["tpu_ici_link_bandwidth_bytes_per_second"].samples
            assert len(rates) == CHIPS_PER_HOST * 6
            for s in rates:
                assert s.value >= 0

    def test_worker_ids_unique_across_slice(self, slice_apps):
        texts = scrape_all(slice_apps)
        workers = set()
        for text in texts:
            for fam in text_string_to_metric_families(text):
                if fam.name == "tpu_hbm_used_bytes":
                    workers.update(s.labels["worker_id"] for s in fam.samples)
        assert workers == {str(w) for w in range(NUM_HOSTS)}


# TestAggregatorAtSliceScale lives in test_aggregator_scale.py: its timing
# guards must not share a module with the live slice_apps exporters above —
# the module-scoped fixture keeps 8 collector loops polling at 20 Hz until
# module teardown, and that contention alone can triple the measured round.
