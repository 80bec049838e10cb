"""The cases of tests/test_collector.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

Collector unit/behavior tests: join, labels, GC, faults, rates.

Covers the reference-defect inversions (SURVEY.md §2.6): correct device-ID
join, per-chip labels, stale-series GC, error containment.
"""

import pytest

from tpu_pod_exporter_torch.attribution.fake import FakeAttribution, simple_allocation
from tpu_pod_exporter_torch.backend.fake import FakeBackend, FakeChipScript
from tpu_pod_exporter_torch.collector import Collector, PollStats
from tpu_pod_exporter_torch.metrics import SnapshotStore
from tpu_pod_exporter_torch.topology import HostTopology


def make_collector(backend, attribution, store, **kw):
    topo = HostTopology(
        accelerator="v4-8", slice_name="s0", host="host0", worker_id="0"
    )
    return Collector(backend, attribution, store, topology=topo, **kw)


def chip_labels(chip_id, pod="", namespace="", container="", device_path=None):
    return {
        "chip_id": str(chip_id),
        "device_path": device_path if device_path is not None else f"/dev/accel{chip_id}",
        "accelerator": "v4-8",
        "slice_name": "s0",
        "host": "host0",
        "worker_id": "0",
        "pod": pod,
        "namespace": namespace,
        "container": container,
    }


class TestJoin:
    def test_attributed_chip_carries_pod_labels(self, store, four_chip_backend, one_pod_attribution):
        c = make_collector(four_chip_backend, one_pod_attribution, store)
        c.poll_once()
        snap = store.current()
        labels = chip_labels(0, pod="train-job-0", namespace="ml", container="main")
        assert snap.value("tpu_hbm_used_bytes", labels) == 4 * 1024**3
        assert snap.value("tpu_hbm_total_bytes", labels) == 32 * 1024**3
        assert snap.value("tpu_hbm_used_percent", labels) == 12.5
        assert snap.value("tpu_tensorcore_duty_cycle_percent", labels) == 50.0

    def test_unallocated_chip_has_empty_pod_labels(self, store, four_chip_backend):
        c = make_collector(four_chip_backend, FakeAttribution(), store)
        c.poll_once()
        snap = store.current()
        assert snap.value("tpu_hbm_used_bytes", chip_labels(2)) == 4 * 1024**3

    def test_multi_pod_partition(self, store, four_chip_backend):
        attr = FakeAttribution(
            [
                simple_allocation("pod-a", ["0", "1"], namespace="ns1"),
                simple_allocation("pod-b", ["2", "3"], namespace="ns2", container="c2"),
            ]
        )
        c = make_collector(four_chip_backend, attr, store)
        c.poll_once()
        snap = store.current()
        assert (
            snap.value("tpu_hbm_used_bytes", chip_labels(1, "pod-a", "ns1", "main"))
            is not None
        )
        assert (
            snap.value("tpu_hbm_used_bytes", chip_labels(3, "pod-b", "ns2", "c2"))
            is not None
        )

    def test_same_pod_name_different_namespace_do_not_collide(self, store):
        # The reference keys by pod name only (main.go:113) — namespaces collide.
        backend = FakeBackend(chips=2)
        attr = FakeAttribution(
            [
                simple_allocation("job", ["0"], namespace="alpha"),
                simple_allocation("job", ["1"], namespace="beta"),
            ]
        )
        c = make_collector(backend, attr, store)
        c.poll_once()
        snap = store.current()
        assert snap.value("tpu_hbm_used_bytes", chip_labels(0, "job", "alpha", "main")) is not None
        assert snap.value("tpu_hbm_used_bytes", chip_labels(1, "job", "beta", "main")) is not None

    def test_pod_rollups(self, store, four_chip_backend, one_pod_attribution):
        c = make_collector(four_chip_backend, one_pod_attribution, store)
        c.poll_once()
        snap = store.current()
        rollup = {
            "pod": "train-job-0",
            "namespace": "ml",
            "accelerator": "v4-8",
            "slice_name": "s0",
            "host": "host0",
            "worker_id": "0",
        }
        assert snap.value("tpu_pod_chip_count", rollup) == 4
        assert snap.value("tpu_pod_hbm_used_bytes", rollup) == 4 * 4 * 1024**3


class TestKubeletInventory:
    def test_allocatable_and_allocated_gauges(self, store, four_chip_backend):
        attr = FakeAttribution(
            [simple_allocation("p", ["0", "1"])],
            allocatable=["0", "1", "2", "3"],
        )
        c = make_collector(four_chip_backend, attr, store)
        c.poll_once()
        snap = store.current()
        topo = ("v4-8", "s0", "host0", "0")
        assert snap.value("tpu_kubelet_allocatable_chips", topo) == 4
        assert snap.value("tpu_kubelet_allocated_chips", topo) == 2

    def test_idle_node_with_inventory_reports_zero_allocated(
        self, store, four_chip_backend
    ):
        attr = FakeAttribution([], allocatable=["0", "1", "2", "3"])
        c = make_collector(four_chip_backend, attr, store)
        c.poll_once()
        snap = store.current()
        topo = ("v4-8", "s0", "host0", "0")
        assert snap.value("tpu_kubelet_allocatable_chips", topo) == 4
        # 0 is real data (alertable), not absence
        assert snap.value("tpu_kubelet_allocated_chips", topo) == 0

    def test_inventory_survives_pod_churn(self, store, four_chip_backend):
        attr = FakeAttribution(
            [simple_allocation("p", ["0"])], allocatable=["0", "1", "2", "3"]
        )
        c = make_collector(four_chip_backend, attr, store)
        c.poll_once()
        attr.set_allocations([])  # pod exits; kubelet inventory unchanged
        c.poll_once()
        snap = store.current()
        topo = ("v4-8", "s0", "host0", "0")
        assert snap.value("tpu_kubelet_allocatable_chips", topo) == 4
        assert snap.value("tpu_kubelet_allocated_chips", topo) == 0

    def test_absent_when_source_cannot_report(self, store, four_chip_backend):
        c = make_collector(four_chip_backend, FakeAttribution(), store)
        c.poll_once()
        snap = store.current()
        assert snap.samples("tpu_kubelet_allocatable_chips") == {}
        assert snap.samples("tpu_kubelet_allocated_chips") == {}


class TestLegacyMetrics:
    def test_disabled_by_default(self, store, four_chip_backend, one_pod_attribution):
        c = make_collector(four_chip_backend, one_pod_attribution, store)
        c.poll_once()
        text = store.current().encode()
        assert b"pod_gpu_memory_usage" not in text

    def test_reference_names_emitted_when_enabled(
        self, store, four_chip_backend, one_pod_attribution
    ):
        c = make_collector(
            four_chip_backend, one_pod_attribution, store, legacy_metrics=True
        )
        c.poll_once()
        snap = store.current()
        # per-pod sum over 4 chips × 4 GiB, pid always ""
        assert snap.value("pod_gpu_memory_usage", ("", "train-job-0")) == 16 * 1024**3
        assert snap.value("docker_gpu_memory_perc_usage", ("", "train-job-0")) == 12.5
        assert b"DEPRECATED" in snap.encode()

    def test_same_name_pods_sum_across_namespaces(self, store):
        backend = FakeBackend(
            chips=2, script=FakeChipScript(hbm_total_bytes=100.0, hbm_used_bytes=10.0)
        )
        attr = FakeAttribution(
            [
                simple_allocation("job", ["0"], namespace="alpha"),
                simple_allocation("job", ["1"], namespace="beta"),
            ]
        )
        c = make_collector(backend, attr, store, legacy_metrics=True)
        c.poll_once()
        assert store.current().value("pod_gpu_memory_usage", ("", "job")) == 20.0


class TestSeriesLifecycle:
    def test_stale_series_gone_after_pod_exit(self, store, four_chip_backend):
        attr = FakeAttribution([simple_allocation("ephemeral", ["0", "1", "2", "3"])])
        c = make_collector(four_chip_backend, attr, store)
        c.poll_once()
        assert (
            store.current().value(
                "tpu_hbm_used_bytes", chip_labels(0, "ephemeral", "default", "main")
            )
            is not None
        )
        attr.set_allocations([])  # pod deleted
        c.poll_once()
        snap = store.current()
        assert (
            snap.value("tpu_hbm_used_bytes", chip_labels(0, "ephemeral", "default", "main"))
            is None
        )
        # chip series still exists, unattributed
        assert snap.value("tpu_hbm_used_bytes", chip_labels(0)) is not None

    def test_reassignment_single_owner_per_chip(self, store, four_chip_backend):
        attr = FakeAttribution([simple_allocation("a", ["0"])])
        c = make_collector(four_chip_backend, attr, store)
        c.poll_once()
        attr.set_allocations([simple_allocation("b", ["0"])])
        c.poll_once()
        snap = store.current()
        assert snap.value("tpu_hbm_used_bytes", chip_labels(0, "b", "default", "main")) is not None
        assert snap.value("tpu_hbm_used_bytes", chip_labels(0, "a", "default", "main")) is None
        # exactly 4 hbm_used series (one per chip)
        assert len(snap.samples("tpu_hbm_used_bytes")) == 4


class TestFaultContainment:
    def test_backend_failure_degrades_not_dies(self, store, four_chip_backend, one_pod_attribution):
        c = make_collector(four_chip_backend, one_pod_attribution, store)
        c.poll_once()
        four_chip_backend.fail_next(1)
        stats = c.poll_once()
        assert not stats.ok
        snap = store.current()
        assert snap.value("tpu_exporter_up") == 0
        assert snap.value("tpu_exporter_poll_errors_total", ("device_read",)) == 1
        # recovery
        stats = c.poll_once()
        assert stats.ok
        assert store.current().value("tpu_exporter_up") == 1

    def test_attribution_failure_uses_last_good_within_staleness(
        self, store, four_chip_backend, one_pod_attribution
    ):
        c = make_collector(
            four_chip_backend, one_pod_attribution, store, attribution_max_stale_s=1e9
        )
        c.poll_once()
        one_pod_attribution.fail_next(1)
        c.poll_once()
        snap = store.current()
        # stale-but-recent attribution still applied
        assert (
            snap.value(
                "tpu_hbm_used_bytes", chip_labels(0, "train-job-0", "ml", "main")
            )
            is not None
        )
        assert snap.value("tpu_exporter_poll_errors_total", ("attribution",)) == 1

    def test_attribution_failure_beyond_staleness_drops_labels(
        self, store, four_chip_backend, one_pod_attribution
    ):
        fake_now = [0.0]
        c = make_collector(
            four_chip_backend,
            one_pod_attribution,
            store,
            attribution_max_stale_s=5.0,
            clock=lambda: fake_now[0],
        )
        c.poll_once()
        fake_now[0] += 10.0
        one_pod_attribution.fail_next(1)
        c.poll_once()
        snap = store.current()
        assert snap.value("tpu_hbm_used_bytes", chip_labels(0)) is not None

    def test_unexpected_exception_contained(self, store):
        class ExplodingBackend(FakeBackend):
            def sample(self):
                raise RuntimeError("not a BackendError")

        c = make_collector(ExplodingBackend(chips=1), FakeAttribution(), store)
        stats = c.poll_once()
        assert not stats.ok
        assert store.current().value("tpu_exporter_up") == 0

    def test_partial_errors_counted(self, store, four_chip_backend):
        four_chip_backend.set_partial_errors(["chip 3 flaky"])
        c = make_collector(four_chip_backend, FakeAttribution(), store)
        stats = c.poll_once()
        assert stats.ok  # partial errors degrade, not fail
        assert (
            store.current().value("tpu_exporter_poll_errors_total", ("device_partial",))
            == 1
        )


class TestIciRates:
    def test_counter_monotonic_and_rate(self, store):
        script = FakeChipScript(ici_link_count=2, ici_bytes_per_step=500.0)
        backend = FakeBackend(chips=1, script=script)
        fake_now = [0.0]

        def clock():
            return fake_now[0]

        c = make_collector(backend, FakeAttribution(), store, clock=clock)
        c.poll_once()
        labels = {**chip_labels(0), "link": "0"}
        snap = store.current()
        assert snap.value("tpu_ici_transferred_bytes_total", labels) == 500.0
        # no rate on first poll (no dt)
        assert snap.value("tpu_ici_link_bandwidth_bytes_per_second", labels) is None
        fake_now[0] += 2.0
        c.poll_once()
        snap = store.current()
        assert snap.value("tpu_ici_transferred_bytes_total", labels) == 1000.0
        assert snap.value("tpu_ici_link_bandwidth_bytes_per_second", labels) == 250.0

    def test_dcn_counter_and_rate(self, store):
        # DCN (cross-slice fabric) rides the same fold semantics as ICI:
        # monotonic counter, rate only from the second sampled poll.
        script = FakeChipScript(
            ici_link_count=1, ici_bytes_per_step=500.0,
            dcn_link_count=2, dcn_bytes_per_step=100.0,
        )
        backend = FakeBackend(chips=1, script=script)
        fake_now = [0.0]
        c = make_collector(backend, FakeAttribution(), store,
                           clock=lambda: fake_now[0])
        c.poll_once()
        labels = {**chip_labels(0), "link": "dcn0"}
        snap = store.current()
        assert snap.value("tpu_dcn_transferred_bytes_total", labels) == 100.0
        assert snap.value("tpu_dcn_link_bandwidth_bytes_per_second", labels) is None
        fake_now[0] += 2.0
        c.poll_once()
        snap = store.current()
        assert snap.value("tpu_dcn_transferred_bytes_total", labels) == 200.0
        assert snap.value("tpu_dcn_link_bandwidth_bytes_per_second", labels) == 50.0
        # ICI and DCN coexist without cross-talk.
        assert snap.value(
            "tpu_ici_transferred_bytes_total", {**chip_labels(0), "link": "0"}
        ) == 1000.0

    def test_no_dcn_series_without_dcn_links(self, store, four_chip_backend):
        c = make_collector(four_chip_backend, FakeAttribution(), store)
        c.poll_once()
        c.poll_once()
        text = store.current().encode().decode()
        assert "tpu_dcn_transferred_bytes_total{" not in text

    def test_dcn_counter_monotonic_across_device_reset(self, store):
        steps = iter([1000.0, 2000.0, 50.0, 150.0])  # reset after poll 2

        class ResettingScript(FakeChipScript):
            def sample(self, info, step, link_cache=None):
                s = super().sample(info, step, link_cache)
                total = next(steps)
                from tpu_pod_exporter_torch.backend import IciLinkSample
                return s._replace(
                    dcn_links=(IciLinkSample("dcn0", total),)
                )

        backend = FakeBackend(chips=1, script=ResettingScript())
        c = make_collector(backend, FakeAttribution(), store)
        labels = {**chip_labels(0), "link": "dcn0"}
        vals = []
        for _ in range(4):
            c.poll_once()
            vals.append(
                store.current().value("tpu_dcn_transferred_bytes_total", labels)
            )
        assert vals == [1000.0, 2000.0, 2000.0, 2100.0]  # holds over the reset

    def test_counter_state_survives_failed_poll(self, store):
        """A transient device-read failure must not wipe ICI counter state —
        otherwise the exported counter regresses to the raw value on
        recovery (spurious rate() spike in Prometheus)."""
        script = FakeChipScript(ici_link_count=1, ici_bytes_per_step=100.0)
        backend = FakeBackend(chips=1, script=script)
        c = make_collector(backend, FakeAttribution(), store)
        labels = {**chip_labels(0), "link": "0"}
        c.poll_once()  # total=100 (step 0 → (0+1)*100)
        c.poll_once()  # total=200
        assert store.current().value("tpu_ici_transferred_bytes_total", labels) == 200.0
        backend.fail_next(1)
        c.poll_once()  # failed poll: no ICI series this snapshot
        assert store.current().value("tpu_ici_transferred_bytes_total", labels) is None
        c.poll_once()  # recovery: counter resumes monotonically, no regression
        assert store.current().value("tpu_ici_transferred_bytes_total", labels) >= 200.0

    def test_rate_survives_pod_relabel(self, store):
        # Chip moves pod-a -> pod-b between polls; counter state is keyed by
        # full label set, so the new series starts fresh but stays monotonic.
        script = FakeChipScript(ici_link_count=1, ici_bytes_per_step=100.0)
        backend = FakeBackend(chips=1, script=script)
        attr = FakeAttribution([simple_allocation("a", ["0"])])
        fake_now = [0.0]
        c = make_collector(backend, attr, store, clock=lambda: fake_now[0])
        c.poll_once()
        fake_now[0] += 1.0
        attr.set_allocations([simple_allocation("b", ["0"])])
        c.poll_once()
        labels_b = {**chip_labels(0, "b", "default", "main"), "link": "0"}
        assert store.current().value("tpu_ici_transferred_bytes_total", labels_b) == 200.0


class TestSelfMetrics:
    def test_poll_phases_and_counts(self, store, four_chip_backend, one_pod_attribution):
        c = make_collector(four_chip_backend, one_pod_attribution, store)
        c.poll_once()
        c.poll_once()
        snap = store.current()
        assert snap.value("tpu_exporter_polls_total") == 2
        assert snap.value("tpu_exporter_series") == snap.series_count
        for phase in ("device_read", "attribution", "join", "publish", "total"):
            assert snap.value("tpu_exporter_poll_duration_seconds", (phase,)) is not None
        info = snap.samples("tpu_exporter_info")
        assert len(info) == 1
        (values,) = info.keys()
        assert values[1] == "fake" and values[2] == "fake"

    def test_zero_devices_smoke(self, store):
        # Baseline config 1: no devices at all, exporter healthy.
        c = make_collector(FakeBackend(chips=0), FakeAttribution(), store)
        stats = c.poll_once()
        assert stats.ok
        snap = store.current()
        assert snap.value("tpu_exporter_up") == 1
        assert snap.samples("tpu_hbm_used_bytes") == {}
        # families still declared for a stable scrape surface
        assert b"# TYPE tpu_hbm_used_bytes gauge" in snap.encode()


class TestTelemetryDepth:
    def test_peak_hbm_and_chip_info(self, store):
        from tpu_pod_exporter_torch.backend import ChipInfo

        infos = [
            ChipInfo(chip_id=0, device_path="/dev/accel0",
                     device_kind="TPU v5p", coords="0,0,0"),
            ChipInfo(chip_id=1, device_path="/dev/accel1",
                     device_kind="TPU v5p", coords="1,0,0"),
        ]
        script = FakeChipScript(
            hbm_total_bytes=100.0, hbm_used_bytes=10.0, hbm_peak_bytes=55.0
        )
        c = make_collector(FakeBackend(chips=infos, script=script),
                           FakeAttribution(), store)
        c.poll_once()
        snap = store.current()
        assert snap.value("tpu_hbm_peak_bytes", chip_labels(0)) == 55.0
        info_labels = dict(chip_labels(1), device_kind="TPU v5p", coords="1,0,0")
        assert snap.value("tpu_chip_info", info_labels) == 1.0

    def test_peak_absent_when_unknown_but_info_always_present(
        self, store, four_chip_backend
    ):
        c = make_collector(four_chip_backend, FakeAttribution(), store)
        c.poll_once()
        text = store.current().encode().decode()
        # Peak family declared (stable surface) but no samples.
        assert "# TYPE tpu_hbm_peak_bytes gauge" in text
        assert "\ntpu_hbm_peak_bytes{" not in text
        # chip_info, by contrast, is the guaranteed per-chip presence
        # series (round 4: tpu_hbm_* became omissible, so the aggregator
        # counts chips from chip_info) — published even with empty
        # kind/coords labels.
        assert text.count("\ntpu_chip_info{") == 4
        assert 'device_kind="",coords=""' in text

    def test_self_usage_metrics(self, store, four_chip_backend):
        import sys

        c = make_collector(four_chip_backend, FakeAttribution(), store)
        c.poll_once()
        snap = store.current()
        cpu1 = snap.value("tpu_exporter_cpu_seconds_total")
        rss = snap.value("tpu_exporter_rss_bytes")
        if sys.platform == "linux":
            # Documented absence behavior applies only off-Linux.
            assert cpu1 is not None and cpu1 > 0
            assert rss is not None and rss > 1024 * 1024  # a real process RSS
        if cpu1 is not None:
            c.poll_once()
            assert store.current().value("tpu_exporter_cpu_seconds_total") >= cpu1

    def test_peak_round_trips_through_recording(self, tmp_path, store):
        from tpu_pod_exporter_torch.backend import ChipInfo
        from tpu_pod_exporter_torch.backend.recorded import RecordedBackend, RecordingBackend

        infos = [ChipInfo(chip_id=0, device_kind="TPU v4", coords="0,1,2")]
        script = FakeChipScript(hbm_total_bytes=10.0, hbm_used_bytes=2.0,
                                hbm_peak_bytes=7.0)
        path = str(tmp_path / "t.jsonl")
        rec = RecordingBackend(FakeBackend(chips=infos, script=script), path)
        rec.sample()
        rec.close()
        replay = RecordedBackend(path)
        chip = replay.sample().chips[0]
        assert chip.hbm_peak_bytes == 7.0
        assert chip.info.device_kind == "TPU v4"
        assert chip.info.coords == "0,1,2"


class TestSideChannelErrorNamespacing:
    def test_provider_source_names_cannot_clobber_phase_counters(self, store):
        """ADVICE r2 #3: side-channel error counters are published with
        b.add (overwrite); a provider returning a source named like a poll
        phase ("attribution") must not replace the phase series."""

        class CollidingAttribution(FakeAttribution):
            def error_counters(self):
                return {"attribution": 99.0}

        backend = FakeBackend(chips=1)
        attr = CollidingAttribution()
        attr.fail_next(1)  # one real attribution-phase error
        c = make_collector(backend, attr, store)
        c.poll_once()
        snap = store.current()
        # The phase counter survives with its own count...
        assert snap.value(
            "tpu_exporter_poll_errors_total", {"source": "attribution"}
        ) == 1.0
        # ...and the provider's counter appears under its namespaced name.
        assert snap.value(
            "tpu_exporter_poll_errors_total", {"source": "attribution.attribution"}
        ) == 99.0


class TestPodRollupHonesty:
    """Pod/legacy rollups must not fold unreadable (None)
    HBM as 0 — same absent-beats-fake-zero rule as the per-chip series."""

    def _none_hbm_backend(self, chips=2):
        from tpu_pod_exporter_torch.backend import ChipInfo, ChipSample, HostSample

        class NoHbmBackend(FakeBackend):
            def sample(self):
                return HostSample(chips=tuple(
                    ChipSample(
                        info=ChipInfo(chip_id=i, device_path=f"/dev/accel{i}",
                                      device_ids=(str(i),)),
                        hbm_used_bytes=None, hbm_total_bytes=None,
                    ) for i in range(chips)
                ))

        return NoHbmBackend(chips=0)

    def test_fully_unreadable_pod_omits_hbm_series_keeps_chip_count(self, store, one_pod_attribution):
        c = make_collector(self._none_hbm_backend(), one_pod_attribution, store)
        c.poll_once()
        text = store.current().encode().decode()
        assert "tpu_pod_chip_count{" in text
        assert "tpu_pod_hbm_used_bytes{" not in text

    def test_fully_unreadable_pod_emits_no_legacy_series(self, store, one_pod_attribution):
        c = make_collector(self._none_hbm_backend(), one_pod_attribution, store,
                           legacy_metrics=True)
        c.poll_once()
        text = store.current().encode().decode()
        assert "pod_gpu_memory_usage{" not in text
        assert "docker_gpu_memory_perc_usage{" not in text

    def test_chip_info_always_published(self, store):
        c = make_collector(self._none_hbm_backend(), FakeAttribution(), store)
        c.poll_once()
        # Even with empty device_kind/coords: chip presence is guaranteed.
        assert store.current().value(
            "tpu_chip_info",
            {**chip_labels(0), "device_kind": "", "coords": ""},
        ) == 1.0

    def _backend_with_totals(self, totals):
        from tpu_pod_exporter_torch.backend import ChipInfo, ChipSample, HostSample

        class TotalsBackend(FakeBackend):
            def sample(self):
                return HostSample(chips=tuple(
                    ChipSample(
                        info=ChipInfo(chip_id=i, device_path=f"/dev/accel{i}",
                                      device_ids=(str(i),)),
                        hbm_used_bytes=4 * 1024**3, hbm_total_bytes=t,
                    ) for i, t in enumerate(totals)
                ))

        return TotalsBackend(chips=0)

    def test_none_total_omits_total_and_percent_keeps_used(self, store):
        # VERDICT r4 weak #1 (collector half): total=None ⇒ no
        # tpu_hbm_total_bytes and no tpu_hbm_used_percent for that chip,
        # while used (which WAS read) still publishes.
        c = make_collector(
            self._backend_with_totals([32 * 1024**3, None]),
            FakeAttribution(), store,
        )
        c.poll_once()
        snap = store.current()
        assert snap.value("tpu_hbm_used_bytes", chip_labels(1)) == 4 * 1024**3
        assert snap.value("tpu_hbm_total_bytes", chip_labels(1)) is None
        assert snap.value("tpu_hbm_used_percent", chip_labels(1)) is None
        # The healthy chip is unaffected.
        assert snap.value("tpu_hbm_used_percent", chip_labels(0)) == 12.5

    def test_zero_total_publishes_total_but_omits_percent(self, store):
        # A genuinely-read 0 total is real data (publish it), but a percent
        # of a zero capacity is undefined — omit, don't publish 0.0.
        c = make_collector(
            self._backend_with_totals([0.0]), FakeAttribution(), store
        )
        c.poll_once()
        snap = store.current()
        assert snap.value("tpu_hbm_total_bytes", chip_labels(0)) == 0.0
        assert snap.value("tpu_hbm_used_percent", chip_labels(0)) is None


class TestOverrunsExported:
    def test_loop_overruns_reach_exposition(self, store):
        c = make_collector(
            FakeBackend(chips=1), FakeAttribution(), store,
            loop_overruns_fn=lambda: 7,
        )
        c.poll_once()
        assert store.current().value("tpu_exporter_poll_overruns_total") == 7.0

    def test_absent_without_a_loop(self, store):
        # One-shot tools (status, hwcheck) have no loop: no overruns series.
        c = make_collector(FakeBackend(chips=1), FakeAttribution(), store)
        c.poll_once()
        text = store.current().encode().decode()
        assert "\ntpu_exporter_poll_overruns_total " not in text
