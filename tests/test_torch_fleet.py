"""The cases of tests/test_fleet.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

Federated fleet query plane.

Covers the fan-out/merge mechanics with injected fetches (no sockets),
partial-result semantics (error / timeout / quarantine), the result cache
and its generation-bump invalidation, the aggregator exposition of the
plane's self-metrics, the HTTP routing through the shared /api/v1 fence,
traceparent propagation, the `status --fleet` renderer, and a small
end-to-end run of the fleet simulator acceptance harness.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from tpu_pod_exporter_torch.fleet import FleetQueryPlane
from tpu_pod_exporter_torch.metrics import SnapshotStore
from tpu_pod_exporter_torch.server import MetricsServer
from tpu_pod_exporter_torch.supervisor import CircuitBreaker


def node_rows(host, n_series=2, last_ts=1000.0):
    return [
        {
            "metric": "tpu_hbm_used_bytes",
            "labels": {"host": host, "chip_id": str(i)},
            "values": [[last_ts - 1, 1.0], [last_ts, 2.0]],
            "tier": 0.0,
            "last_sample_wall_ts": last_ts,
        }
        for i in range(n_series)
    ]


def make_fetch(behaviors):
    """fetch(url, timeout_s) whose behavior keys on the target host:port
    inside the url. A behavior is rows (answer), an Exception (raise), or
    a float (sleep that long, then answer)."""

    def fetch(url, timeout_s):
        for target, behavior in behaviors.items():
            if target in url:
                if isinstance(behavior, Exception):
                    raise behavior
                if isinstance(behavior, float):
                    time.sleep(behavior)
                    behavior = node_rows(target)
                return {"status": "ok",
                        "data": {"resultType": "matrix", "result": behavior}}
        raise ConnectionError(f"unknown target in {url}")

    return fetch


WALL = 1000.0


def make_plane(behaviors, **kw):
    kw.setdefault("timeout_s", 0.5)
    kw.setdefault("wallclock", lambda: WALL + 10.0)
    return FleetQueryPlane(
        tuple(behaviors), fetch=make_fetch(behaviors), **kw
    )


class TestFanOutMerge:
    def test_full_merge_not_partial(self):
        plane = make_plane({"h0:1": node_rows("h0:1"),
                            "h1:1": node_rows("h1:1")})
        env = plane.query_range("tpu_hbm_used_bytes", start=0.0, end=2000.0)
        assert env["status"] == "ok" and env["partial"] is False
        assert env["fleet"]["merged_series"] == 4
        assert env["fleet"]["ok"] == 2
        assert {t["state"] for t in env["targets"].values()} == {"ok"}
        plane.close()

    def test_staleness_per_target(self):
        plane = make_plane({
            "h0:1": node_rows("h0:1", last_ts=WALL + 9.0),   # 1 s stale
            "h1:1": node_rows("h1:1", last_ts=WALL - 110.0),  # 2 min stale
        })
        env = plane.query_range("tpu_hbm_used_bytes", start=0.0, end=2000.0)
        assert env["targets"]["h0:1"]["staleness_s"] == pytest.approx(1.0)
        assert env["targets"]["h1:1"]["staleness_s"] == pytest.approx(120.0)
        plane.close()

    def test_dead_target_is_partial_with_remainder_merged(self):
        plane = make_plane({
            "h0:1": node_rows("h0:1"),
            "h1:1": ConnectionRefusedError("refused"),
            "h2:1": node_rows("h2:1"),
        })
        env = plane.query_range("tpu_hbm_used_bytes", start=0.0, end=2000.0)
        assert env["partial"] is True
        assert env["fleet"]["ok"] == 2 and env["fleet"]["errors"] == 1
        assert env["fleet"]["merged_series"] == 4
        assert env["targets"]["h1:1"]["state"] == "error"
        assert "refused" in env["targets"]["h1:1"]["error"]
        plane.close()

    def test_slow_target_times_out_without_blocking(self):
        plane = make_plane({"h0:1": node_rows("h0:1"), "h1:1": 5.0},
                           timeout_s=0.1)
        t0 = time.monotonic()
        env = plane.query_range("tpu_hbm_used_bytes", start=0.0, end=2000.0)
        took = time.monotonic() - t0
        assert took < 2.0  # deadline, not the sleeping target, bounds us
        assert env["partial"] is True
        assert env["targets"]["h1:1"]["state"] == "timeout"
        assert env["fleet"]["merged_series"] == 2
        plane.close()

    def test_quarantined_target_skipped_not_probed(self):
        br = CircuitBreaker(failure_threshold=1, backoff_base_s=60.0,
                            backoff_max_s=120.0)
        br.record_failure()  # open
        probed = []

        def fetch(url, timeout_s):
            probed.append(url)
            return {"status": "ok",
                    "data": {"resultType": "matrix",
                             "result": node_rows("h0:1")}}

        plane = FleetQueryPlane(("h0:1", "h1:1"), fetch=fetch,
                                breakers={"h1:1": br})
        env = plane.query_range("tpu_hbm_used_bytes", start=0.0, end=2000.0)
        assert env["partial"] is True
        assert env["targets"]["h1:1"]["state"] == "quarantined"
        assert env["targets"]["h1:1"]["next_probe_in_s"] > 0
        assert all("h1:1" not in u for u in probed)  # never touched
        plane.close()

    def test_404_is_no_data_not_partial(self):
        def fetch(url, timeout_s):
            if "h1:1" in url:
                raise urllib.error.HTTPError(url, 404, "no samples", None, None)
            return {"status": "ok",
                    "data": {"resultType": "matrix",
                             "result": node_rows("h0:1")}}

        plane = FleetQueryPlane(("h0:1", "h1:1"), fetch=fetch)
        env = plane.query_range("tpu_hbm_used_bytes", start=0.0, end=2000.0)
        assert env["partial"] is False
        assert env["targets"]["h1:1"]["state"] == "no_data"
        plane.close()

    def test_colliding_series_disambiguated_by_target(self):
        # Label-less self-metrics (tpu_exporter_up) collide for EVERY
        # target pair; the merge must keep every host's answer under a
        # synthetic target label, not fold 63 hosts' outage data away.
        def up_row(v):
            return {"metric": "tpu_exporter_up", "labels": {},
                    "values": [[10.0, v]], "last_sample_wall_ts": 10.0}

        plane = make_plane({"h0:1": [up_row(1.0)], "h1:1": [up_row(0.0)]})
        env = plane.query_range("tpu_exporter_up", start=0.0, end=2000.0)
        assert env["fleet"]["merged_series"] == 2
        assert env["fleet"]["duplicate_series"] == 1
        by_target = {r["labels"]["target"]: r["values"][0][1]
                     for r in env["data"]["result"]}
        assert by_target == {"h0:1": 1.0, "h1:1": 0.0}
        plane.close()

    def test_grid_alignment_respects_node_resolution_cap(self):
        # Alignment widens start/end by up to 2·step; a request at the 11k
        # resolution edge must still produce a node-legal grid instead of
        # 400ing on every healthy target.
        seen = []

        def fetch(url, timeout_s):
            seen.append(url)
            return {"status": "ok",
                    "data": {"resultType": "matrix",
                             "result": node_rows("h0:1")}}

        plane = FleetQueryPlane(("h0:1",), fetch=fetch)
        env = plane.query_range("m", start=0.9, end=11000.2, step=1.0)
        assert env["fleet"]["ok"] == 1 and not env["partial"]
        assert (env["end"] - env["start"]) / 1.0 <= 11000
        plane.close()

    def test_window_stats_and_series_shapes(self):
        rows = [{"metric": "m", "labels": {"host": "h0"},
                 "stats": {"last": 1.0}, "last_sample_wall_ts": 5.0}]

        def fetch(url, timeout_s):
            if "/api/v1/series" in url:
                return {"status": "ok",
                        "data": [{"metric": "m", "labels": {"host": "h0"},
                                  "samples": 3}]}
            return {"status": "ok", "data": {"result": rows}}

        plane = FleetQueryPlane(("h0:1",), fetch=fetch)
        ws = plane.window_stats("m", window_s=60.0)
        assert ws["data"]["result"][0]["stats"]["last"] == 1.0
        sr = plane.series()
        assert sr["data"][0]["samples"] == 3
        plane.close()


class TestResultCache:
    def test_hit_within_generation_miss_after_bump(self):
        calls = {"n": 0}
        gen = {"g": 0}

        def fetch(url, timeout_s):
            calls["n"] += 1
            return {"status": "ok",
                    "data": {"resultType": "matrix",
                             "result": node_rows("h0:1")}}

        plane = FleetQueryPlane(("h0:1",), fetch=fetch,
                                generation_fn=lambda: gen["g"])
        e1 = plane.query_range("m", start=0.0, end=100.0, step=10.0)
        e2 = plane.query_range("m", start=0.0, end=100.0, step=10.0)
        assert calls["n"] == 1
        assert "cached" not in e1 and e2["cached"] is True
        # generation bump (new aggregator round / layout change) invalidates
        gen["g"] += 1
        e3 = plane.query_range("m", start=0.0, end=100.0, step=10.0)
        assert calls["n"] == 2 and "cached" not in e3
        plane.close()

    def test_grid_alignment_shares_cache_key(self):
        calls = {"n": 0}

        def fetch(url, timeout_s):
            calls["n"] += 1
            return {"status": "ok",
                    "data": {"resultType": "matrix",
                             "result": node_rows("h0:1")}}

        plane = FleetQueryPlane(("h0:1",), fetch=fetch,
                                generation_fn=lambda: 7)
        # A sliding dashboard window: starts differ by < step, same grid.
        plane.query_range("m", start=0.2, end=100.4, step=10.0)
        env = plane.query_range("m", start=3.9, end=101.7, step=10.0)
        assert calls["n"] == 1 and env["cached"] is True
        assert env["start"] == 0.0 and env["end"] == 110.0
        plane.close()

    def test_distinct_queries_distinct_entries(self):
        calls = {"n": 0}

        def fetch(url, timeout_s):
            calls["n"] += 1
            return {"status": "ok",
                    "data": {"resultType": "matrix",
                             "result": node_rows("h0:1")}}

        plane = FleetQueryPlane(("h0:1",), fetch=fetch,
                                generation_fn=lambda: 1)
        plane.query_range("m", start=0.0, end=100.0, step=10.0)
        plane.query_range("m", start=0.0, end=100.0, step=10.0, agg="min")
        plane.query_range("m", match={"host": "h0"}, start=0.0, end=100.0,
                          step=10.0)
        plane.window_stats("m", window_s=60.0)
        assert calls["n"] == 4
        plane.close()


class TestAggregatorExposition:
    def test_fleet_metrics_reach_aggregator_exposition(self):
        from tpu_pod_exporter_torch.aggregate import SliceAggregator

        store = SnapshotStore()
        plane = make_plane({"h0:1": node_rows("h0:1")})
        agg = SliceAggregator(
            ("h0:1",), store, fetch=lambda t, s: "", breaker_failures=0,
        )
        agg.set_fleet(plane)
        plane.query_range("m", start=0.0, end=100.0, step=10.0)
        plane.query_range("m", start=0.0, end=100.0, step=10.0)  # cache hit
        agg.poll_once()
        text = store.current().encode().decode()
        assert 'tpu_aggregator_fleet_queries_total{route="query_range"} 2' in text
        assert "tpu_aggregator_fleet_query_cache_hits_total 1" in text
        assert "tpu_aggregator_fleet_query_cache_misses_total 1" in text
        assert "tpu_aggregator_fleet_query_seconds_bucket" in text
        assert "tpu_aggregator_fleet_query_partial_total 0" in text
        # debug_vars exposes plane occupancy
        assert agg.debug_vars()["fleet_query"]["cache_entries"] == 1
        agg.close()
        plane.close()

    def test_partial_counter_rises(self):
        plane = make_plane({"h0:1": ConnectionRefusedError("down")})
        plane.query_range("m", start=0.0, end=100.0)
        from tpu_pod_exporter_torch.metrics import SnapshotBuilder

        b = SnapshotBuilder()
        plane.emit(b)
        snap = b.build()
        assert snap.samples(
            "tpu_aggregator_fleet_query_partial_total")[()] == 1.0
        assert snap.samples(
            "tpu_aggregator_fleet_query_target_errors_total")[("h0:1",)] == 1.0
        plane.close()


@pytest.fixture
def fleet_server():
    plane = make_plane({"h0:1": node_rows("h0:1"),
                        "h1:1": node_rows("h1:1")})
    server = MetricsServer(SnapshotStore(), host="127.0.0.1", port=0,
                           fleet=plane)
    server.start()
    yield plane, server, f"http://127.0.0.1:{server.port}"
    server.stop()
    plane.close()


def get_json(url):
    try:
        resp = urllib.request.urlopen(url, timeout=5)
        return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


class TestHttpRouting:
    def test_query_range_envelope_over_http(self, fleet_server):
        _plane, _server, base = fleet_server
        status, doc, _ = get_json(
            base + "/api/v1/query_range?metric=tpu_hbm_used_bytes"
                   "&start=0&end=2000"
        )
        assert status == 200
        assert doc["partial"] is False
        assert doc["fleet"]["merged_series"] == 4
        assert doc["data"]["resultType"] == "matrix"

    def test_param_validation_shared_with_node_path(self, fleet_server):
        _plane, _server, base = fleet_server
        for path in (
            "/api/v1/query_range",                         # missing metric
            "/api/v1/query_range?metric=m&start=abc",
            "/api/v1/query_range?metric=m&start=0&step=1",  # resolution cap
            "/api/v1/query_range?metric=m&agg=median",      # bad agg
            "/api/v1/window_stats?metric=m&window=0",
        ):
            status, doc, _ = get_json(base + path)
            assert status == 400, path
            assert doc["status"] == "error"

    def test_api_fence_shared_429_with_retry_after(self, fleet_server):
        _plane, server, base = fleet_server
        handler = server._httpd.RequestHandlerClass
        assert handler.api_sem is not None  # fence active with fleet only
        assert handler.api_sem.acquire(timeout=1)
        assert handler.api_sem.acquire(timeout=1)
        try:
            status, doc, headers = get_json(base + "/api/v1/series")
            assert status == 429
            assert "too many" in doc["error"]
            assert headers.get("Retry-After") == "1"
        finally:
            handler.api_sem.release()
            handler.api_sem.release()

    def test_agg_param_validated_on_node_local_path_too(self):
        from tpu_pod_exporter_torch.history import HistoryStore

        h = HistoryStore(capacity=8)
        h.append("m", {}, 1.0)
        server = MetricsServer(SnapshotStore(), host="127.0.0.1", port=0,
                               history=h)
        server.start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            status, doc, _ = get_json(
                base + "/api/v1/query_range?metric=m&agg=median")
            assert status == 400 and "agg" in doc["error"]
        finally:
            server.stop()


class TestTracePropagation:
    def test_fanout_stamps_traceparent_and_spans_recorded(self):
        from tpu_pod_exporter_torch.trace import Tracer, TraceStore

        seen = []

        def fetch(url, timeout_s, traceparent=None):
            seen.append(traceparent)
            return {"status": "ok",
                    "data": {"resultType": "matrix",
                             "result": node_rows("h0:1")}}

        ts = TraceStore(max_traces=8)
        plane = FleetQueryPlane(
            ("h0:1", "h1:1"), fetch=fetch,
            tracer=Tracer(ts, slow_poll_s=0.0, root_name="query"),
        )
        plane.query_range("m", start=0.0, end=100.0)
        assert len(seen) == 2 and all(tp for tp in seen)
        [trace] = ts.last(1)
        names = [s.name for s in trace.spans]
        assert "fanout" in names and "merge" in names
        assert trace.root.name == "query"
        plane.close()

    def test_plain_fetch_not_forced_traceparent(self):
        # A 2-arg injected fetch must keep working with tracing on.
        from tpu_pod_exporter_torch.trace import Tracer, TraceStore

        plane = FleetQueryPlane(
            ("h0:1",), fetch=make_fetch({"h0:1": node_rows("h0:1")}),
            tracer=Tracer(TraceStore(max_traces=8), slow_poll_s=0.0,
                          root_name="query"),
        )
        env = plane.query_range("m", start=0.0, end=100.0)
        assert env["fleet"]["ok"] == 1
        plane.close()

    def test_node_side_api_records_remote_span(self):
        from tpu_pod_exporter_torch.history import HistoryStore
        from tpu_pod_exporter_torch.trace import TraceStore, format_traceparent

        h = HistoryStore(capacity=8)
        h.append("m", {}, 1.0)
        ts = TraceStore(max_traces=8)
        server = MetricsServer(SnapshotStore(), host="127.0.0.1", port=0,
                               history=h, trace=ts)
        server.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/api/v1/series",
                headers={"traceparent": format_traceparent(
                    "ab" * 16, "cd" * 8)},
            )
            urllib.request.urlopen(req, timeout=5).read()
            # The span records just AFTER the response body is written —
            # poll briefly instead of racing the handler thread.
            deadline = time.monotonic() + 2.0
            spans = ts.scrapes(8)
            while not spans and time.monotonic() < deadline:
                time.sleep(0.01)
                spans = ts.scrapes(8)
            assert len(spans) == 1
            assert spans[0].trace_id == "ab" * 16
        finally:
            server.stop()


class TestStatusFleet:
    def _envelope(self, partial=False):
        return {
            "status": "ok", "partial": partial,
            "data": {"result": [
                {"metric": "tpu_hbm_used_bytes",
                 "labels": {"host": "host-a", "chip_id": "0"},
                 "stats": {"last": 2.0 * 2**30},
                 "last_sample_wall_ts": time.time() - 2.0},
            ]},
            "targets": {
                "t0:1": {"state": "ok", "staleness_s": 2.0},
                "t1:1": {"state": "error", "error": "refused"},
            },
        }

    def test_render_fleet_table_and_footer(self):
        from tpu_pod_exporter_torch.status import render_fleet

        out = render_fleet(
            {"tpu_hbm_used_bytes": self._envelope(partial=True)}, 60.0)
        assert "host-a" in out
        assert "1/2 ok" in out
        assert "PARTIAL" in out
        assert "t1:1 (error: refused)" in out

    def test_run_fleet_json_against_real_server(self, fleet_server, capsys):
        from tpu_pod_exporter_torch.status import main as status_main

        _plane, _server, base = fleet_server
        rc = status_main(["--fleet", base.removeprefix("http://"), "--json"])
        assert rc == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["envelopes"]  # at least one metric answered
        env = next(iter(doc["envelopes"].values()))
        assert "targets" in env and "partial" in env

    def test_run_fleet_unreachable_is_clean_error(self, capsys):
        from tpu_pod_exporter_torch.status import main as status_main

        rc = status_main(["--fleet", "127.0.0.1:1"])
        assert rc == 1
        assert "failed" in capsys.readouterr().err


class TestFleetSimAcceptance:
    def test_small_fleet_demo_end_to_end(self):
        # The make fleet-query-demo scenario at test scale: full merge,
        # staleness, traceparent join, kill→partial, p99 budget — with
        # tracing and persistence ON.
        from tpu_pod_exporter_torch.loadgen.fleet import run_demo

        result = run_demo(
            n_targets=4, chips=2, polls=4, interval_s=0.01,
            queries=6, budget_ms=5000.0, kill_one=True, persist=True,
        )
        assert result["ok"], result
        assert result["full_merge"]["merged_series"] == 8
        assert result["after_kill"]["partial"] is True
        assert result["after_kill"]["ok_targets"] == 3
        assert result["after_kill"]["merged_series"] == 6
        assert result["node_side_query_spans"] > 0
