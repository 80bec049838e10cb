"""The cases of tests/test_history.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

Flight-recorder history store + /api/v1 query surface.

Covers the ring-buffer mechanics (wraparound, eviction, retention GC), the
counter-aware window rate (reset tolerance — the ICI/DCN fold semantics),
the JSON endpoints' clean 4xx contract, and the full integration path:
fake backend → collector → history → HTTP query.
"""

import json
import urllib.error
import urllib.request

import pytest

from tpu_pod_exporter_torch.history import HISTORY_TRACKED_METRICS, HistoryStore
from tpu_pod_exporter_torch.metrics import SnapshotStore
from tpu_pod_exporter_torch.server import MetricsServer, debug_client_allowed


class FakeClock:
    def __init__(self, t0: float = 0.0) -> None:
        self.t = t0

    def __call__(self) -> float:
        return self.t


def make_store(capacity=4, max_series=8, retention_s=0.0, t0=0.0):
    clock = FakeClock(t0)
    store = HistoryStore(
        capacity=capacity, max_series=max_series, retention_s=retention_s,
        clock=clock, wallclock=lambda: 1000.0 + clock.t,
    )
    return store, clock


class TestRing:
    def test_wraparound_keeps_newest_capacity_samples(self):
        h, clock = make_store(capacity=4)
        for i in range(10):
            clock.t = float(i)
            h.append("m", {"x": "1"}, float(i * 100))
        [row] = h.query_range("m", {"x": "1"}, start=0.0, end=2000.0)
        # Only the last 4 survive, oldest first, timestamps intact.
        assert row["values"] == [
            [1006.0, 600.0], [1007.0, 700.0], [1008.0, 800.0], [1009.0, 900.0]
        ]
        assert h.stats()["samples"] == 4

    def test_append_is_preallocated_o1(self):
        # The ring never grows: stats' memory estimate is flat from sample 1.
        h, clock = make_store(capacity=8)
        h.append("m", {}, 1.0)
        before = h.stats()["memory_bytes"]
        for i in range(100):
            clock.t = float(i)
            h.append("m", {}, float(i))
        assert h.stats()["memory_bytes"] == before


class TestEviction:
    def test_capacity_eviction_drops_least_recently_fed_series(self):
        h, clock = make_store(max_series=2)
        h.append("m", {"s": "a"}, 1.0)
        clock.t = 1.0
        h.append("m", {"s": "b"}, 2.0)
        clock.t = 2.0
        h.append("m", {"s": "a"}, 3.0)  # refresh a: b is now least recent
        clock.t = 3.0
        h.append("m", {"s": "c"}, 4.0)  # evicts b
        labels = {tuple(s["labels"].items()) for s in h.series_list()}
        assert labels == {(("s", "a"),), (("s", "c"),)}
        assert h.stats()["evicted"]["capacity"] == 1
        assert h.query_range("m", {"s": "b"}, start=0, end=1e9) == []

    def test_retention_gc_expires_idle_series(self):
        h, clock = make_store(retention_s=10.0)
        h.append("m", {"s": "old"}, 1.0)
        clock.t = 20.0
        h.append("m", {"s": "new"}, 2.0)  # append triggers GC
        assert [s["labels"] for s in h.series_list()] == [{"s": "new"}]
        assert h.stats()["evicted"]["retention"] == 1

    def test_eviction_mid_snapshot_never_caches_ghost_series(self):
        # with max_series below one family's size, an
        # eviction can claim a series created earlier in the SAME
        # append_snapshot walk. Caching that walk's layout would let later
        # fast-path polls feed ghost series — samples silently lost while
        # the eviction counter sits still. Invariants: the sample gauge
        # matches what is actually queryable, and evictions keep counting.
        from tpu_pod_exporter_torch.metrics import SnapshotBuilder, schema

        def pod_snapshot(n):
            b = SnapshotBuilder()
            for i in range(n):
                b.add(schema.TPU_POD_CHIP_COUNT, 4.0,
                      (f"pod{i}", "ns", "acc", "s", "h", "0"))
            return b.build(timestamp=1000.0)

        h, clock = make_store(capacity=4, max_series=3)
        snap = pod_snapshot(5)
        for poll in range(3):
            clock.t = float(poll)
            h.append_snapshot(snap, now_mono=clock.t, now_wall=1000.0 + clock.t)
        st = h.stats()
        queryable = sum(s["samples"] for s in h.series_list())
        assert st["samples"] == queryable
        assert st["series"] == 3
        # every poll re-evicts (the cap is genuinely too small): the loss
        # stays visible in the counter instead of stopping after poll 1
        assert st["evicted"]["capacity"] >= 4

    def test_sample_accounting_survives_eviction(self):
        h, clock = make_store(capacity=4, max_series=1)
        for i in range(6):
            clock.t = float(i)
            h.append("m", {"s": "a"}, 1.0)
        h.append("m", {"s": "b"}, 1.0)  # evicts a (4 retained samples)
        st = h.stats()
        assert st["series"] == 1
        assert st["samples"] == 1


class TestWindowStats:
    def test_gauge_stats_and_null_rate(self):
        h, clock = make_store(capacity=8)
        for i, v in enumerate([5.0, 1.0, 3.0]):
            clock.t = float(i)
            h.append("tpu_hbm_used_bytes", {"chip_id": "0"}, v)
        [row] = h.window_stats("tpu_hbm_used_bytes", window_s=60.0)
        s = row["stats"]
        assert (s["min"], s["max"], s["first"], s["last"]) == (1.0, 5.0, 5.0, 3.0)
        assert s["mean"] == pytest.approx(3.0)
        assert s["samples"] == 3
        assert s["rate"] is None  # gauges never rate

    def test_counter_rate_tolerates_reset(self):
        # Raw counter resets mid-window (device reset): the negative delta
        # contributes nothing — same monotonic-fold semantics as the
        # collector's ICI/DCN counters.
        h, clock = make_store(capacity=8)
        for i, v in enumerate([0.0, 100.0, 200.0, 50.0, 150.0]):
            clock.t = float(i)
            h.append("tpu_ici_transferred_bytes_total",
                     {"link": "0"}, v)
        [row] = h.window_stats("tpu_ici_transferred_bytes_total", window_s=60.0)
        # positive deltas 100+100+100 over 4 s
        assert row["stats"]["rate"] == pytest.approx(300.0 / 4.0)

    def test_window_excludes_older_samples(self):
        h, clock = make_store(capacity=8)
        for i in range(5):
            clock.t = float(i) * 10.0
            h.append("m", {}, float(i))
        clock.t = 40.0
        [row] = h.window_stats("m", window_s=15.0)
        assert row["stats"]["samples"] == 2  # t=30 and t=40 only
        assert row["stats"]["first"] == 3.0

    def test_match_filters_series(self):
        h, _ = make_store()
        h.append("m", {"chip_id": "0"}, 1.0)
        h.append("m", {"chip_id": "1"}, 2.0)
        rows = h.window_stats("m", {"chip_id": "1"}, window_s=60.0)
        assert [r["labels"] for r in rows] == [{"chip_id": "1"}]


class TestQueryRange:
    def test_step_alignment_carries_last_sample_forward(self):
        h, clock = make_store(capacity=8)
        for i, v in enumerate([10.0, 20.0, 30.0]):
            clock.t = float(i)
            h.append("m", {}, v)  # wall times 1000, 1001, 1002
        [row] = h.query_range("m", start=1000.0, end=1004.0, step=1.0)
        # Each grid point takes the most recent sample at-or-before it;
        # the lookback (max(2*step, 10 s)) keeps 1003/1004 carrying 30.
        assert row["values"] == [
            [1000.0, 10.0], [1001.0, 20.0], [1002.0, 30.0],
            [1003.0, 30.0], [1004.0, 30.0],
        ]

    def test_left_edge_uses_sample_just_before_start(self):
        # a sample slightly OLDER than `start` must still
        # back the first grid points (it is the most recent sample at or
        # before them, within the lookback) — otherwise forensics queries
        # show a fake gap at the left edge of the incident window.
        h, clock = make_store(capacity=8)
        clock.t = -5.0
        h.append("m", {}, 42.0)  # wall time 995
        clock.t = 5.0
        h.append("m", {}, 43.0)  # wall time 1005
        [row] = h.query_range("m", start=1000.0, end=1010.0, step=5.0)
        assert row["values"] == [
            [1000.0, 42.0], [1005.0, 43.0], [1010.0, 43.0]
        ]

    def test_stale_series_does_not_project_past_lookback(self):
        h, _ = make_store(capacity=8)
        h.append("m", {}, 1.0)  # wall time 1000
        [row] = h.query_range("m", start=1000.0, end=1100.0, step=20.0)
        # lookback = 2*step = 40 s: grid points beyond 1040 are absent.
        assert [t for t, _v in row["values"]] == [1000.0, 1020.0, 1040.0]


@pytest.fixture
def history_server():
    h, clock = make_store(capacity=16)
    store = SnapshotStore()
    server = MetricsServer(store, host="127.0.0.1", port=0, history=h)
    server.start()
    yield h, clock, f"http://127.0.0.1:{server.port}"
    server.stop()


def get_json(url):
    try:
        resp = urllib.request.urlopen(url, timeout=5)
        return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestApiEndpoints:
    def test_series_lists_label_sets(self, history_server):
        h, _, base = history_server
        h.append("tpu_hbm_used_bytes", {"chip_id": "0"}, 1.0)
        status, doc = get_json(base + "/api/v1/series")
        assert status == 200 and doc["status"] == "ok"
        assert doc["data"] == [
            {"metric": "tpu_hbm_used_bytes", "labels": {"chip_id": "0"},
             "samples": 1}
        ]

    def test_unknown_metric_is_clean_404_json(self, history_server):
        _, _, base = history_server
        for path in (
            "/api/v1/query_range?metric=tpu_nope",
            "/api/v1/window_stats?metric=tpu_nope",
        ):
            status, doc = get_json(base + path)
            assert status == 404
            assert doc["status"] == "error"
            assert "tpu_nope" in doc["error"]

    def test_empty_match_is_clean_404_json(self, history_server):
        h, _, base = history_server
        h.append("m", {"chip_id": "0"}, 1.0)
        status, doc = get_json(
            base + "/api/v1/query_range?metric=m&match[chip_id]=9"
        )
        assert status == 404 and doc["status"] == "error"

    def test_malformed_params_are_400_json(self, history_server):
        _, _, base = history_server
        cases = (
            "/api/v1/query_range",                      # missing metric
            "/api/v1/query_range?metric=m&start=abc",   # non-numeric
            "/api/v1/query_range?metric=m&step=-1",     # negative step
            "/api/v1/query_range?metric=m&start=9&end=1",  # inverted range
            "/api/v1/window_stats",                     # missing metric
            "/api/v1/window_stats?metric=m&window=0",   # non-positive window
            # grid-walk DoS guards a billion-point or
            # infinite grid must be refused before the store walks it
            "/api/v1/query_range?metric=m&start=0&step=1",   # ~1.7e9 points
            "/api/v1/query_range?metric=m&end=inf&step=1",   # infinite loop
            "/api/v1/query_range?metric=m&start=-inf",
            "/api/v1/query_range?metric=m&step=nan",
        )
        for path in cases:
            status, doc = get_json(base + path)
            assert status == 400, path
            assert doc["status"] == "error"

    def test_unknown_api_path_404(self, history_server):
        _, _, base = history_server
        status, doc = get_json(base + "/api/v1/nope")
        assert status == 404 and doc["status"] == "error"

    def test_api_concurrency_fence_429s_excess_queries(self):
        # /api/v1 sits outside the scrape fences but has
        # its own small cap — a query flood must 429, not pile handler
        # threads onto the history lock against the poll thread.
        h, _ = make_store(capacity=16)
        h.append("m", {}, 1.0)
        server = MetricsServer(SnapshotStore(), host="127.0.0.1", port=0,
                               history=h)
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        handler = server._httpd.RequestHandlerClass
        assert handler.api_sem is not None
        assert handler.api_sem.acquire(timeout=1)
        assert handler.api_sem.acquire(timeout=1)  # both permits held
        try:
            status, doc = get_json(base + "/api/v1/series")
            assert status == 429
            assert "too many" in doc["error"]
            # the scrape/health surface is unaffected by the api fence
            assert urllib.request.urlopen(
                base + "/healthz", timeout=5
            ).status == 200
        finally:
            handler.api_sem.release()
            handler.api_sem.release()
            try:
                assert get_json(base + "/api/v1/series")[0] == 200
            finally:
                server.stop()

    def test_query_copies_are_outside_the_lock(self):
        # The under-lock phase of a query copies raw arrays only; the store
        # must remain appendable from another thread while a slow consumer
        # iterates the result (i.e. results don't alias live rings).
        h, clock = make_store(capacity=8)
        h.append("m", {}, 1.0)
        rows = h._rows_for("m", {})
        clock.t = 1.0
        h.append("m", {}, 2.0)  # mutates the live ring
        items = HistoryStore._row_items(rows[0])
        assert [v for (_tm, _tw, v) in items] == [1.0]  # snapshot, not alias

    def test_non_finite_samples_serialize_as_null(self, history_server):
        # backends can report NaN samples; bare NaN is not
        # JSON and breaks every strict parser mid-incident. The API maps
        # non-finite floats to null.
        h, clock, base = history_server
        h.append("m", {}, float("nan"))
        clock.t = 1.0
        h.append("m", {}, float("inf"))
        status, doc = get_json(base + "/api/v1/window_stats?metric=m&window=60")
        assert status == 200  # and json.loads above already proves validity
        s = doc["data"]["result"][0]["stats"]
        assert s["first"] is None and s["last"] is None
        assert s["samples"] == 2
        status, doc = get_json(
            base + "/api/v1/query_range?metric=m&start=0&end=2000"
        )
        assert status == 200
        assert [v for _t, v in doc["data"]["result"][0]["values"]] == [None, None]

    def test_api_404s_when_history_disabled(self):
        store = SnapshotStore()
        server = MetricsServer(store, host="127.0.0.1", port=0)  # no history
        server.start()
        try:
            status, doc = get_json(
                f"http://127.0.0.1:{server.port}/api/v1/series"
            )
            assert status == 404
            assert "history disabled" in doc["error"]
        finally:
            server.stop()


class TestCollectorIntegration:
    def _collector(self, history, chips=2):
        from tpu_pod_exporter_torch.attribution.fake import (
            FakeAttribution,
            simple_allocation,
        )
        from tpu_pod_exporter_torch.backend.fake import FakeBackend, FakeChipScript
        from tpu_pod_exporter_torch.collector import Collector

        backend = FakeBackend(
            chips=chips,
            script=FakeChipScript(
                hbm_total_bytes=8e9,
                hbm_used_bytes=lambda step: 1e9 + step * 1e8,
                duty_cycle_percent=50.0,
                ici_bytes_per_step=1000.0,
            ),
        )
        attr = FakeAttribution(
            [simple_allocation("train", ["0", "1"], namespace="ml")]
        )
        return Collector(backend, attr, SnapshotStore(), history=history)

    def test_collector_feeds_tracked_families(self):
        h, _ = make_store(capacity=16, max_series=256)
        c = self._collector(h)
        c.poll_once()
        c.poll_once()
        metrics = {s["metric"] for s in h.series_list()}
        assert "tpu_hbm_used_bytes" in metrics
        assert "tpu_chip_info" in metrics
        assert "tpu_ici_transferred_bytes_total" in metrics
        assert "tpu_pod_chip_count" in metrics
        assert metrics <= HISTORY_TRACKED_METRICS
        [row] = h.query_range(
            "tpu_hbm_used_bytes", {"chip_id": "0"}, start=0, end=1e12
        )
        assert [v for _t, v in row["values"]] == [1e9, 1.1e9]

    def test_history_self_metrics_reach_exposition(self):
        h, _ = make_store(capacity=16, max_series=256)
        c = self._collector(h)
        c.poll_once()
        c.poll_once()
        text = c._store.current().encode().decode()
        assert "tpu_exporter_history_series " in text
        assert 'tpu_exporter_history_evicted_series_total{reason="capacity"} 0' in text
        assert "tpu_exporter_history_append_seconds " in text
        # size gauges lag one poll (append runs after the swap) but after
        # two polls they must be nonzero
        line = next(
            l for l in text.splitlines()
            if l.startswith("tpu_exporter_history_samples ")
        )
        assert float(line.split()[-1]) > 0

    def test_query_range_over_http_after_two_polls(self):
        """Acceptance: >= 2 correctly timestamped samples for a chip HBM
        series after two fake-backend polls, via the real HTTP endpoint."""
        import time

        h = HistoryStore(capacity=16, max_series=256, retention_s=300.0)
        c = self._collector(h)
        t0 = time.time()
        c.poll_once()
        c.poll_once()
        t1 = time.time()
        server = MetricsServer(
            SnapshotStore(), host="127.0.0.1", port=0, history=h
        )
        server.start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            status, doc = get_json(
                base + "/api/v1/query_range?metric=tpu_hbm_used_bytes"
                f"&match[chip_id]=0&start={t0 - 1}&end={t1 + 1}"
            )
            assert status == 200
            [row] = doc["data"]["result"]
            assert row["labels"]["chip_id"] == "0"
            assert row["labels"]["pod"] == "train"
            values = row["values"]
            assert len(values) >= 2
            for ts, _v in values:
                assert t0 - 1 <= ts <= t1 + 1
            assert [v for _t, v in values] == [1e9, 1.1e9]
        finally:
            server.stop()

    def test_history_disabled_costs_nothing(self):
        c = self._collector(None)
        c.poll_once()
        text = c._store.current().encode().decode()
        assert "tpu_exporter_history_series" not in text


class TestExporterAppWiring:
    def test_app_builds_history_and_serves_api(self):
        from tpu_pod_exporter_torch.app import ExporterApp
        from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
        from tpu_pod_exporter_torch.backend.fake import FakeBackend
        from tpu_pod_exporter_torch.config import ExporterConfig

        app = ExporterApp(
            ExporterConfig(port=0, host="127.0.0.1", interval_s=30.0,
                           backend="fake", fake_chips=1, attribution="none"),
            backend=FakeBackend(chips=1), attribution=FakeAttribution(),
        )
        app.start()
        try:
            base = f"http://127.0.0.1:{app.port}"
            status, doc = get_json(base + "/api/v1/series")
            assert status == 200
            assert any(
                s["metric"] == "tpu_chip_info" for s in doc["data"]
            )
        finally:
            app.stop()

    def test_retention_zero_disables_history(self):
        from tpu_pod_exporter_torch.app import ExporterApp
        from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
        from tpu_pod_exporter_torch.backend.fake import FakeBackend
        from tpu_pod_exporter_torch.config import ExporterConfig

        app = ExporterApp(
            ExporterConfig(port=0, host="127.0.0.1", backend="fake",
                           attribution="none", history_retention_s=0.0),
            backend=FakeBackend(chips=0), attribution=FakeAttribution(),
        )
        assert app.history is None


class TestAggregatorFallback:
    HOST_BODY = (
        "# HELP tpu_chip_info x\n"
        "# TYPE tpu_chip_info gauge\n"
        'tpu_chip_info{chip_id="0",device_path="",accelerator="v5p-8",'
        'slice_name="s",host="h0",worker_id="0",pod="",namespace="",'
        'container="",device_kind="",coords=""} 1\n'
        'tpu_hbm_used_bytes{chip_id="0",device_path="",accelerator="v5p-8",'
        'slice_name="s",host="h0",worker_id="0",pod="",namespace="",'
        'container=""} 100\n'
    )

    @staticmethod
    def _hist_fetch(url, timeout_s):
        labels = {"chip_id": "0", "host": "h1", "slice_name": "s",
                  "accelerator": "v5p-8"}
        if "tpu_chip_info" in url:
            return {"data": {"result": [
                {"labels": labels, "stats": {"last": 1.0, "rate": None}}
            ]}}
        if "tpu_hbm_used_bytes" in url:
            return {"data": {"result": [
                {"labels": labels, "stats": {"last": 77.0, "rate": None}}
            ]}}
        if "tpu_ici_transferred_bytes_total" in url:
            return {"data": {"result": [
                {"labels": {**labels, "link": "0"},
                 "stats": {"last": 1e6, "rate": 1234.0}}
            ]}}
        if "tpu_pod_chip_count" in url:
            return {"data": {"result": [
                {"labels": {"pod": "train", "namespace": "ml",
                            "slice_name": "s", "host": "h1"},
                 "stats": {"last": 4.0, "rate": None}}
            ]}}
        raise urllib.error.HTTPError(url, 404, "no samples", None, None)

    def _aggregate(self, history_fetch, window=15.0):
        from tpu_pod_exporter_torch.aggregate import SliceAggregator

        def fetch(target, timeout_s):
            if target == "h1:8000":
                raise ConnectionError("down")
            return self.HOST_BODY

        store = SnapshotStore()
        agg = SliceAggregator(
            ("h0:8000", "h1:8000"), store, fetch=fetch,
            history_fallback_window_s=window, history_fetch=history_fetch,
        )
        try:
            agg.poll_once()
        finally:
            agg.close()
        return store.current()

    def test_missed_round_keeps_slice_continuity(self):
        snap = self._aggregate(self._hist_fetch)
        key = ("s", "v5p-8", "tpu")
        # h1's chips stay in the rollups via its flight recorder...
        assert snap.value("tpu_slice_hosts_reporting", key) == 2.0
        assert snap.value("tpu_slice_chip_count", key) == 2.0
        assert snap.value("tpu_slice_hbm_used_bytes", key) == 177.0
        # ...counter history contributes its window rate as bandwidth...
        assert snap.value("tpu_slice_ici_bytes_per_second", key) == 1234.0
        # ...and workload rollups stay continuous too, not just slice ones
        assert snap.value(
            "tpu_workload_chip_count", ("train", "ml", "s")
        ) == 4.0
        # ...but the target still honestly reports down, and the
        # substitution is counted.
        assert snap.value("tpu_aggregator_target_up", ("h1:8000",)) == 0.0
        assert snap.value(
            "tpu_aggregator_history_fallbacks_total", ("h1:8000",)
        ) == 1.0

    def test_fallback_failure_degrades_to_plain_miss(self):
        def dead(url, timeout_s):
            raise ConnectionError("history down too")

        snap = self._aggregate(dead)
        key = ("s", "v5p-8", "tpu")
        assert snap.value("tpu_slice_hosts_reporting", key) == 1.0
        assert snap.value("tpu_slice_chip_count", key) == 1.0
        assert snap.value(
            "tpu_aggregator_history_fallbacks_total", ("h1:8000",)
        ) is None

    def test_connection_failure_aborts_after_one_fetch(self):
        # a black-holed target must cost ONE history
        # timeout, not six — the fallback bails on the first
        # connection-level failure instead of probing every metric.
        calls = []

        def dead(url, timeout_s):
            calls.append(url)
            raise ConnectionError("black hole")

        self._aggregate(dead)
        assert len(calls) == 1

    def test_http_404_keeps_probing_remaining_metrics(self):
        # ...while an ANSWERED 404 (family has no samples) is cheap and the
        # loop keeps going: partial history beats none.
        calls = []

        def sparse(url, timeout_s):
            calls.append(url)
            if "tpu_hbm_used_bytes" in url:
                return self._hist_fetch(url, timeout_s)
            raise urllib.error.HTTPError(url, 404, "no samples", None, None)

        snap = self._aggregate(sparse)
        assert len(calls) == 8  # every TPU fallback metric probed (gpu_* probes are gated on the target having ever served a gpu_ family)
        key = ("s", "v5p-8", "tpu")
        assert snap.value("tpu_slice_hbm_used_bytes", key) == 177.0

    def test_disabled_by_default(self):
        from tpu_pod_exporter_torch.aggregate import SliceAggregator

        def fetch(target, timeout_s):
            raise ConnectionError("down")

        def exploding(url, timeout_s):  # must never be called when off
            raise AssertionError("history fetch called with window=0")

        store = SnapshotStore()
        agg = SliceAggregator(("h1:8000",), store, fetch=fetch,
                              history_fetch=exploding)
        try:
            agg.poll_once()
        finally:
            agg.close()
        assert store.current().value(
            "tpu_aggregator_target_up", ("h1:8000",)
        ) == 0.0

    def test_aggregator_cli_has_debug_addr_flag(self):
        # the loopback-only /debug/* default applies to
        # the aggregator's server too, so its CLI must expose the same
        # escape hatch as the exporter.
        import subprocess
        import sys

        out = subprocess.run(
            [sys.executable, "-m", "tpu_pod_exporter_torch.aggregate", "--help"],
            capture_output=True, text=True, timeout=60,
        )
        assert out.returncode == 0
        assert "--debug-addr" in out.stdout

    def test_target_base_url(self):
        from tpu_pod_exporter_torch.aggregate import target_base_url

        assert target_base_url("h0:8000") == "http://h0:8000"
        assert target_base_url("http://h0:8000/metrics") == "http://h0:8000"
        assert target_base_url("https://h0:9000") == "https://h0:9000"


class TestStatusWatchTrends:
    def test_trend_cell_arrows(self):
        from tpu_pod_exporter_torch.status import _fmt_delta_bytes, trend_cell

        h, clock = make_store(capacity=16)
        assert trend_cell(h, "tpu_hbm_used_bytes", 0, 60.0,
                          _fmt_delta_bytes, 1.0) == "-"
        h.append("tpu_hbm_used_bytes", {"chip_id": "0"}, 1024.0**3)
        assert trend_cell(h, "tpu_hbm_used_bytes", 0, 60.0,
                          _fmt_delta_bytes, 1.0) == "-"  # one sample: no delta
        clock.t = 1.0
        h.append("tpu_hbm_used_bytes", {"chip_id": "0"}, 3 * 1024.0**3)
        cell = trend_cell(h, "tpu_hbm_used_bytes", 0, 60.0,
                          _fmt_delta_bytes, 1024.0**2)
        assert cell == "↑+2.0GiB"
        clock.t = 2.0
        h.append("tpu_hbm_used_bytes", {"chip_id": "0"}, 1024.0**3)
        cell = trend_cell(h, "tpu_hbm_used_bytes", 0, 60.0,
                          _fmt_delta_bytes, 1024.0**2)
        assert cell.startswith("→")  # net zero over the window

    def test_watch_table_includes_delta_columns(self, capsys):
        from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
        from tpu_pod_exporter_torch.backend.fake import FakeBackend, FakeChipScript
        from tpu_pod_exporter_torch.config import ExporterConfig
        from tpu_pod_exporter_torch.status import _run
        from tpu_pod_exporter_torch.topology import detect_host_topology

        backend = FakeBackend(
            chips=1,
            script=FakeChipScript(
                hbm_total_bytes=8e9,
                hbm_used_bytes=lambda step: 1e9 * (step + 1),
                duty_cycle_percent=lambda step: 10.0 * (step + 1),
            ),
        )
        h, _ = make_store(capacity=16)
        cfg = ExporterConfig()
        topo = detect_host_topology()
        for _ in range(2):
            rc = _run(cfg, topo, backend, FakeAttribution(),
                      history=h, trend_window_s=60.0)
            assert rc == 0
        out = capsys.readouterr().out
        assert "Δhbm" in out and "Δduty" in out
        assert "↑" in out


class TestDebugLoopbackPolicy:
    def test_policy_function(self):
        assert debug_client_allowed("127.0.0.1", "127.0.0.1")
        assert debug_client_allowed("::1", "127.0.0.1")
        assert debug_client_allowed("::ffff:127.0.0.1", "127.0.0.1")
        assert not debug_client_allowed("10.0.0.5", "127.0.0.1")
        assert not debug_client_allowed("10.0.0.5", "")
        # explicit opt-in restores remote debug reads
        assert debug_client_allowed("10.0.0.5", "0.0.0.0")
        assert debug_client_allowed("10.0.0.5", "*")
        # loopback can never lock itself out
        assert debug_client_allowed("127.0.0.1", "0.0.0.0")

    def test_loopback_client_still_served(self):
        store = SnapshotStore()
        server = MetricsServer(store, host="127.0.0.1", port=0,
                               debug_vars=lambda: {"ok": True})
        server.start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            status, doc = get_json(base + "/debug/vars")
            assert status == 200 and doc == {"ok": True}
            resp = urllib.request.urlopen(base + "/debug/stacks", timeout=5)
            assert resp.status == 200
        finally:
            server.stop()


class TestHistoryDemo:
    def test_replay_demo_runs_on_r5_fixture(self, capsys):
        from tpu_pod_exporter_torch.history import main

        rc = main(["--replay", "tests/fixtures/real-trace-r5.jsonl",
                   "--polls", "10"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "replayed 10 polls" in out
        # The r5 hardware serves no HBM (absent-beats-fake-zero), so chip
        # presence is the recorded story.
        assert "tpu_chip_info" in out
