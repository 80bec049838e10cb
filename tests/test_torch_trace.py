"""The cases of tests/test_trace.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

End-to-end poll tracing (tpu_pod_exporter_torch.trace).

Covers:

- a chaos-injected wedge produces a trace whose device span is
  ``abandoned`` with attached profiler stacks naming the hung frame;
- the aggregator's round trace links to the node-side scrape span via the
  propagated ``traceparent`` context;
- the slow-poll sampler attaches collapsed stacks and STOPS when the poll
  ends;
- ``/debug/trace`` output validates against the Chrome trace_event shape,
  is size-bounded, and is gated by the loopback-only /debug/* policy;
- JSON log lines and RateLimitedLogger suppression tallies carry trace ids.
"""

import json
import logging
import time
import urllib.request

import pytest

from tpu_pod_exporter_torch import trace as trace_mod
from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
from tpu_pod_exporter_torch.backend.fake import FakeBackend
from tpu_pod_exporter_torch.collector import Collector
from tpu_pod_exporter_torch.metrics import SnapshotStore
from tpu_pod_exporter_torch.trace import (
    StackSampler,
    Tracer,
    TraceStore,
    format_traceparent,
    parse_traceparent,
    render_trace,
    to_chrome_trace,
)


def get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        resp = urllib.request.urlopen(req, timeout=5)
        return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def wait_for(predicate, timeout_s=5.0):
    """Poll until the predicate returns truthy. The node-side scrape span
    is recorded by the handler thread AFTER the response body is on the
    wire, so a client that just read the body can observe it a beat later."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        out = predicate()
        if out:
            return out
        time.sleep(0.01)
    return predicate()


def traced_collector(chips=2, slow_poll_s=30.0, sampler=None, **kw):
    store = TraceStore()
    tracer = Tracer(store, slow_poll_s=slow_poll_s, sampler=sampler)
    collector = Collector(
        FakeBackend(chips=chips), FakeAttribution(), SnapshotStore(),
        tracer=tracer, **kw,
    )
    return collector, tracer, store


def validate_chrome_trace(doc):
    """The subset of the trace_event contract chrome://tracing/Perfetto
    require: every event is a complete ("X") event with name/ts/dur/pid/tid,
    and the whole document JSON-serializes cleanly."""
    json.dumps(doc)  # strict-parser safe (no NaN, no cycles)
    assert "traceEvents" in doc
    for ev in doc["traceEvents"]:
        for key in ("name", "ph", "ts", "dur", "pid", "tid"):
            assert key in ev, f"event missing {key}: {ev}"
        assert ev["ph"] == "X"
        assert isinstance(ev["ts"], (int, float))
        assert ev["dur"] >= 0
        assert ev["args"]["trace_id"]


class TestTraceparent:
    def test_round_trip(self):
        tid, sid = trace_mod.new_trace_id(), trace_mod.new_span_id()
        assert parse_traceparent(format_traceparent(tid, sid)) == (tid, sid)

    @pytest.mark.parametrize("bad", [
        "", "garbage", "00-short-short-01",
        "00-" + "0" * 32 + "-" + "1" * 16 + "-01",   # all-zero trace id
        "00-" + "1" * 32 + "-" + "0" * 16 + "-01",   # all-zero span id
        "00-" + "x" * 32 + "-" + "1" * 16 + "-01",   # non-hex
        "00-" + "1" * 31 + "-" + "1" * 16 + "-01",   # short trace id
        # int(s, 16) would happily parse all of these (signs, underscores,
        # whitespace) — strict hex must not:
        "00-+" + "a" * 31 + "-" + "b" * 16 + "-01",
        "00-" + "a" * 32 + "-+" + "b" * 15 + "-01",
        "00-" + "a_b" + "a" * 29 + "-" + "b" * 16 + "-01",
        "00- " + "a" * 30 + " -" + "b" * 16 + "-01",
    ])
    def test_malformed_rejected(self, bad):
        assert parse_traceparent(bad) is None

    def test_unknown_version_and_extra_fields_parse(self):
        tid, sid = "a" * 32, "b" * 16
        assert parse_traceparent(f"cc-{tid}-{sid}-01-extra") == (tid, sid)


class TestPollSpans:
    def test_every_phase_becomes_a_span(self):
        collector, tracer, store = traced_collector()
        stats = collector.poll_once()
        t = store.last(1)[0]
        names = [s.name for s in t.spans]
        assert names[0] == "poll"
        for phase in ("device_read", "attribution", "join", "publish"):
            assert phase in names
        assert stats.trace_id == t.trace_id
        root = t.root
        assert root.dur_s is not None and root.status == "ok"
        dev = next(s for s in t.spans if s.name == "device_read")
        assert dev.status == "ok"
        assert dev.attrs["chips"] == 2
        assert dev.parent_id == root.span_id
        pub = next(s for s in t.spans if s.name == "publish")
        assert pub.attrs["series"] > 0
        tracer.close()

    def test_untraced_collector_records_nothing(self):
        collector = Collector(FakeBackend(chips=1), FakeAttribution(),
                              SnapshotStore())
        stats = collector.poll_once()
        assert stats.trace_id == ""
        assert trace_mod.current_ids() == (None, None)

    def test_tls_context_cleared_after_poll(self):
        collector, tracer, _ = traced_collector()
        collector.poll_once()
        assert trace_mod.current_ids() == (None, None)
        tracer.close()

    def test_device_error_marks_span_err(self):
        collector, tracer, store = traced_collector()
        collector._backend.fail_next(1)
        collector.poll_once()
        dev = next(s for s in store.last(1)[0].spans
                   if s.name == "device_read")
        assert dev.status == "err"
        tracer.close()

    def test_trace_metrics_published(self):
        snap_store = SnapshotStore()
        store = TraceStore()
        tracer = Tracer(store, slow_poll_s=30.0)
        collector = Collector(FakeBackend(chips=1), FakeAttribution(),
                              snap_store, tracer=tracer)
        collector.poll_once()
        collector.poll_once()
        snap = snap_store.current()
        # One poll behind: the second snapshot sees the first poll's trace.
        assert snap.value("tpu_exporter_traces", ()) >= 1.0
        assert snap.value("tpu_exporter_trace_spans", ()) >= 5.0
        assert snap.value("tpu_exporter_slow_polls_total", ()) == 0.0
        tracer.close()


class TestTraceStore:
    def test_bounded_ring_evicts_oldest(self):
        store = TraceStore(max_traces=2)
        tracer = Tracer(store, slow_poll_s=0)
        ids = []
        for _ in range(3):
            t = tracer.start_poll()
            ids.append(t.trace_id)
            tracer.finish(t)
        st = store.stats()
        assert st["traces"] == 2 and st["traces_total"] == 3
        kept = [t.trace_id for t in store.last(10)]
        assert kept == ids[1:]
        # span accounting survives eviction (1 root span per trace here)
        assert st["spans"] == 2

    def test_scrape_span_ring(self):
        store = TraceStore(max_scrape_spans=4)
        for i in range(6):
            store.record_scrape("a" * 32, "b" * 16, 0.0, 0.001, client=str(i))
        scrapes = store.scrapes(100)
        assert len(scrapes) == 4
        assert store.stats()["scrape_spans_total"] == 6
        assert scrapes[-1].attrs["client"] == "5"

    def test_scrape_record_rate_cap(self):
        # The recording is driven by a client-supplied header on the
        # unauthenticated /metrics path: a forged-traceparent storm must
        # not churn genuine aggregator join spans out of the ring.
        class Clock:
            t = 0.0

            def __call__(self):
                return self.t

        clock = Clock()
        store = TraceStore(clock=clock)
        cap = TraceStore.SCRAPE_RECORDS_PER_WINDOW
        for _ in range(cap):
            assert store.record_scrape("a" * 32, "b" * 16, 0.0, 0.001)
        assert store.record_scrape("a" * 32, "b" * 16, 0.0, 0.001) is None
        st = store.stats()
        assert st["scrape_spans_total"] == cap
        assert st["scrape_spans_dropped"] == 1
        clock.t = TraceStore.SCRAPE_RECORD_WINDOW_S + 0.1
        assert store.record_scrape("a" * 32, "b" * 16, 0.0, 0.001)


class TestSlowPollProfiler:
    def _slow_backend(self, delay_s):
        inner = FakeBackend(chips=1)

        class Slow:
            name = "slow"

            def sample(self):
                time.sleep(delay_s)
                return inner.sample()

            def close(self):
                pass

        return Slow()

    def test_attaches_collapsed_stacks_and_stops_at_poll_end(self):
        store = TraceStore()
        sampler = StackSampler(hz=200.0)
        tracer = Tracer(store, slow_poll_s=0.05, sampler=sampler)
        collector = Collector(self._slow_backend(0.25), FakeAttribution(),
                              SnapshotStore(), tracer=tracer)
        collector.poll_once()
        t = store.last(1)[0]
        assert t.slow
        assert t.profile, "no stacks attached to the slow poll"
        assert t.profile_samples > 0
        # The poll thread was inside the backend's sample() sleep: the
        # collapsed stack must name the frame.
        all_stacks = [st for stacks in t.profile.values() for st in stacks]
        assert any("sample" in st for st in all_stacks), all_stacks
        # Sampler must stop once the poll ends: no further mutation.
        n = t.profile_samples
        assert not sampler.armed
        time.sleep(0.1)
        assert t.profile_samples == n
        tracer.close()

    def test_fast_poll_not_profiled(self):
        store = TraceStore()
        sampler = StackSampler(hz=200.0)
        tracer = Tracer(store, slow_poll_s=5.0, sampler=sampler)
        collector = Collector(FakeBackend(chips=1), FakeAttribution(),
                              SnapshotStore(), tracer=tracer)
        collector.poll_once()
        t = store.last(1)[0]
        assert not t.slow and t.profile is None
        assert store.stats()["slow_polls"] == 0
        tracer.close()

    def test_sample_cap_disarms(self):
        store = TraceStore()
        sampler = StackSampler(hz=1000.0, max_samples=3)
        tracer = Tracer(store, slow_poll_s=0.01, sampler=sampler)
        collector = Collector(self._slow_backend(0.2), FakeAttribution(),
                              SnapshotStore(), tracer=tracer)
        collector.poll_once()
        t = store.last(1)[0]
        assert t.profile_samples <= 3
        tracer.close()

    def test_render_trace_includes_profile(self):
        store = TraceStore()
        tracer = Tracer(store, slow_poll_s=0.02, sampler=StackSampler(hz=200))
        collector = Collector(self._slow_backend(0.1), FakeAttribution(),
                              SnapshotStore(), tracer=tracer)
        collector.poll_once()
        text = render_trace(store.last(1)[0])
        assert "[SLOW]" in text and "profile:" in text
        assert "device_read" in text
        tracer.close()


class TestWedgeAcceptance:
    """A chaos-injected device wedge produces a trace in
    which the device span is ``abandoned`` with profiler stacks naming the
    hung frame (the supervised worker is parked inside the chaos sleep, so
    the ``tpu-sup-device-*`` stack must name chaos._invoke)."""

    def test_wedged_device_trace(self):
        from tpu_pod_exporter_torch.app import ExporterApp
        from tpu_pod_exporter_torch.config import ExporterConfig

        cfg = ExporterConfig(
            port=0, host="127.0.0.1", interval_s=0.1,
            backend="fake", fake_chips=2, attribution="none",
            phase_deadline_s=0.3, breaker_failures=2,
            chaos_spec="hang:device:1:5s:x1", chaos_seed=1,
            history_retention_s=0.0, trace_slow_poll_s=0.05,
        )
        app = ExporterApp(cfg)
        app.start()  # first poll is synchronous: it IS the wedged poll
        try:
            wedged = next(
                t for t in app.trace.last(50)
                for s in t.spans
                if s.name == "device_read" and s.status == "abandoned"
            )
            dev = next(s for s in wedged.spans if s.name == "device_read")
            events = " | ".join(m for _dt, m in dev.events or ())
            assert "chaos: injected hang" in events
            assert "deadline" in events and "fenced" in events
            assert wedged.slow and wedged.profile
            worker_stacks = [
                st
                for label, stacks in wedged.profile.items()
                if label.startswith("tpu-sup-device")
                for st in stacks
            ]
            assert worker_stacks, f"no worker stacks in {wedged.profile}"
            assert any("chaos._invoke" in st for st in worker_stacks), (
                worker_stacks
            )
            # /debug/vars carries the join key for the last poll.
            _, _, body = get(f"http://127.0.0.1:{app.port}/debug/vars")
            assert json.loads(body)["last_poll"]["trace_id"]
        finally:
            app.stop()


class TestTraceparentJoin:
    """The aggregator's round trace links to the node
    scrape span via the propagated trace context."""

    def test_round_trace_joins_node_scrape_span(self):
        from tpu_pod_exporter_torch.aggregate import SliceAggregator
        from tpu_pod_exporter_torch.app import ExporterApp
        from tpu_pod_exporter_torch.config import ExporterConfig

        cfg = ExporterConfig(port=0, host="127.0.0.1", backend="fake",
                             fake_chips=2, attribution="none",
                             history_retention_s=0.0)
        app = ExporterApp(cfg)
        app.start()
        agg = None
        try:
            ts = TraceStore()
            tracer = Tracer(ts, slow_poll_s=0.0, root_name="round")
            agg = SliceAggregator((f"127.0.0.1:{app.port}",), SnapshotStore(),
                                  tracer=tracer)
            agg.poll_once()
            rt = ts.last(1)[0]
            assert rt.root.name == "round"
            scrape = next(s for s in rt.spans if s.name == "scrape")
            assert scrape.status == "ok"
            assert scrape.attrs["bytes"] > 0
            match = wait_for(lambda: [
                s for s in app.trace.scrapes(10)
                if s.trace_id == rt.trace_id
                and s.parent_id == scrape.span_id
            ])
            assert match, (
                f"node recorded no scrape span under the round trace "
                f"(have {[(s.trace_id, s.parent_id) for s in app.trace.scrapes(10)]})"
            )
            assert match[0].dur_s > 0
        finally:
            if agg is not None:
                agg.close()
            app.stop()

    def test_injected_two_arg_fetch_still_works(self):
        # Tests and ReplayFetch inject (target, timeout_s) fetches; the
        # tracer must not force a signature change on them.
        from tpu_pod_exporter_torch.aggregate import SliceAggregator

        seen = {}

        def fetch(target, timeout_s):
            seen["target"] = target
            return 'tpu_chip_info{chip_id="0",host="h"} 1\n'

        ts = TraceStore()
        agg = SliceAggregator(("h0:8000",), SnapshotStore(), fetch=fetch,
                              tracer=Tracer(ts, slow_poll_s=0,
                                            root_name="round"))
        try:
            agg.poll_once()
        finally:
            agg.close()
        assert seen["target"] == "h0:8000"
        scrape = next(s for s in ts.last(1)[0].spans if s.name == "scrape")
        assert scrape.status == "ok"

    def test_default_fetch_sends_traceparent_header(self):
        from tpu_pod_exporter_torch.app import ExporterApp
        from tpu_pod_exporter_torch.aggregate import default_fetch
        from tpu_pod_exporter_torch.config import ExporterConfig

        cfg = ExporterConfig(port=0, host="127.0.0.1", backend="fake",
                             fake_chips=1, attribution="none",
                             history_retention_s=0.0)
        app = ExporterApp(cfg)
        app.start()
        try:
            tid, sid = "c" * 32, "d" * 16
            default_fetch(f"127.0.0.1:{app.port}", 5.0,
                          traceparent=format_traceparent(tid, sid))
            assert wait_for(lambda: [
                s for s in app.trace.scrapes(10)
                if s.trace_id == tid and s.parent_id == sid
            ])
            # A plain scrape (no header) records nothing new.
            n = len(app.trace.scrapes(100))
            default_fetch(f"127.0.0.1:{app.port}", 5.0)
            time.sleep(0.05)  # give the handler thread its post-write beat
            assert len(app.trace.scrapes(100)) == n
        finally:
            app.stop()


class TestDebugTraceEndpoint:
    @pytest.fixture
    def served(self):
        from tpu_pod_exporter_torch.server import MetricsServer

        collector, tracer, tstore = traced_collector()
        for _ in range(5):
            collector.poll_once()
        store = SnapshotStore()
        server = MetricsServer(store, host="127.0.0.1", port=0, trace=tstore)
        server.start()
        yield tstore, f"http://127.0.0.1:{server.port}"
        server.stop()
        tracer.close()

    def test_valid_chrome_trace_event_json(self, served):
        _, base = served
        status, headers, body = get(base + "/debug/trace")
        assert status == 200
        assert headers["Content-Type"] == "application/json"
        doc = json.loads(body)
        validate_chrome_trace(doc)
        names = {ev["name"] for ev in doc["traceEvents"]}
        assert {"poll", "device_read", "publish"} <= names

    def test_size_bounded(self, served):
        _, base = served
        one = json.loads(get(base + "/debug/trace?last=1")[2])
        all_ = json.loads(get(base + "/debug/trace?last=9999")[2])
        assert len(one["traceEvents"]) < len(all_["traceEvents"])
        # 5 traces x ~5 spans: the clamped "everything" ask stays small.
        assert len(all_["traceEvents"]) <= 5 * 8

    @pytest.mark.parametrize("q", ["last=0", "last=-3", "last=abc"])
    def test_bad_last_is_400(self, served, q):
        _, base = served
        status, _, body = get(base + f"/debug/trace?{q}")
        assert status == 400
        assert json.loads(body)["status"] == "error"

    def test_gated_by_debug_loopback_policy(self, served, monkeypatch):
        # The satellite contract: off-loopback clients get 403 by default.
        # The policy function itself is covered in test_history
        # (TestDebugLoopbackPolicy); here we assert /debug/trace routes
        # through it by forcing the policy to deny.
        import tpu_pod_exporter_torch.server as server_mod

        _, base = served
        monkeypatch.setattr(server_mod, "debug_client_allowed",
                            lambda ip, addr: False)
        status, _, body = get(base + "/debug/trace")
        assert status == 403
        assert b"loopback-only" in body

    def test_404_when_tracing_disabled(self):
        from tpu_pod_exporter_torch.server import MetricsServer

        server = MetricsServer(SnapshotStore(), host="127.0.0.1", port=0)
        server.start()
        try:
            status, _, body = get(
                f"http://127.0.0.1:{server.port}/debug/trace"
            )
            assert status == 404
            assert b"tracing disabled" in body
        finally:
            server.stop()

    def test_trace_off_app_has_no_trace_surface(self):
        from tpu_pod_exporter_torch.app import ExporterApp
        from tpu_pod_exporter_torch.config import ExporterConfig

        cfg = ExporterConfig(port=0, host="127.0.0.1", backend="fake",
                             fake_chips=1, attribution="none",
                             history_retention_s=0.0, trace=False)
        app = ExporterApp(cfg)
        assert app.trace is None and app.tracer is None
        app.start()
        try:
            assert get(f"http://127.0.0.1:{app.port}/debug/trace")[0] == 404
            assert app.collector.last_stats.trace_id == ""
        finally:
            app.stop()


class TestSupervisorContextPropagation:
    def test_worker_annotations_land_on_phase_span(self):
        from tpu_pod_exporter_torch.supervisor import SourceSupervisor

        store = TraceStore()
        tracer = Tracer(store, slow_poll_s=0)

        def fn():
            trace_mod.annotate("from the worker thread")
            return 42

        sup = SourceSupervisor("device", fn, deadline_s=2.0)
        t = tracer.start_poll()
        t.begin("device_read")
        try:
            assert sup.call() == 42
            t.end("ok")
        finally:
            tracer.finish(t)
            sup.shutdown()
        dev = next(s for s in t.spans if s.name == "device_read")
        assert any("from the worker thread" in m for _dt, m in dev.events)

    def test_worker_tls_restored_between_calls(self):
        from tpu_pod_exporter_torch.supervisor import SourceSupervisor

        seen = []

        def fn():
            seen.append(trace_mod.current_ids()[0])
            return 1

        sup = SourceSupervisor("device", fn, deadline_s=2.0)
        tracer = Tracer(TraceStore(), slow_poll_s=0)
        t = tracer.start_poll()
        t.begin("device_read")
        sup.call()
        t.end("ok")
        tracer.finish(t)
        sup.call()  # outside any trace: worker must see no stale context
        sup.shutdown()
        assert seen[0] == t.trace_id
        assert seen[1] is None


class TestLogCorrelation:
    def _capture(self, logger):
        records = []

        class H(logging.Handler):
            def emit(self, record):
                records.append(record)

        h = H()
        logger.addHandler(h)
        logger.setLevel(logging.DEBUG)
        return records, h

    def test_json_log_lines_carry_trace_ids(self):
        from tpu_pod_exporter_torch.utils import JsonLogFormatter

        fmt = JsonLogFormatter()
        rec = logging.LogRecord("t", logging.WARNING, "f.py", 1, "msg",
                                (), None)
        tracer = Tracer(TraceStore(), slow_poll_s=0)
        t = tracer.start_poll()
        try:
            out = json.loads(fmt.format(rec))
            assert out["trace_id"] == t.trace_id
            assert out["span_id"] == t.root.span_id
        finally:
            tracer.finish(t)
        out = json.loads(fmt.format(rec))
        assert "trace_id" not in out and "span_id" not in out

    def test_suppression_tally_counts_current_trace(self):
        from tpu_pod_exporter_torch.utils import RateLimitedLogger

        logger = logging.getLogger("test_trace.rlog")
        records, handler = self._capture(logger)

        class Clock:
            t = 0.0

            def __call__(self):
                return self.t

        clock = Clock()
        rl = RateLimitedLogger(logger, min_interval_s=30.0, clock=clock)
        tracer = Tracer(TraceStore(), slow_poll_s=0)
        t = tracer.start_poll()
        try:
            rl.warning("k", "boom")         # emits
            rl.warning("k", "boom")         # suppressed (in trace)
            rl.warning("k", "boom")         # suppressed (in trace)
            clock.t = 31.0
            rl.warning("k", "boom")         # emits with per-trace tally
        finally:
            tracer.finish(t)
            logger.removeHandler(handler)
        msgs = [r.getMessage() for r in records]
        assert msgs[0] == "boom"
        assert msgs[1] == (
            f"boom (+2 similar suppressed, 2 in trace {t.trace_id[:8]})"
        )

    def test_suppression_tally_falls_back_to_dominant_trace(self):
        # Production shape: at 1 poll/s the suppression window spans ~30
        # traces and the emission happens inside a FRESH trace — the tally
        # must then name the trace that actually suppressed the most
        # lines, not silently report nothing.
        from tpu_pod_exporter_torch.utils import RateLimitedLogger

        logger = logging.getLogger("test_trace.rlog3")
        records, handler = self._capture(logger)

        class Clock:
            t = 0.0

            def __call__(self):
                return self.t

        clock = Clock()
        rl = RateLimitedLogger(logger, min_interval_s=30.0, clock=clock)
        tracer = Tracer(TraceStore(), slow_poll_s=0)
        t1 = tracer.start_poll()
        try:
            rl.warning("k", "boom")     # emits under trace 1
            rl.warning("k", "boom")     # suppressed under trace 1
            rl.warning("k", "boom")     # suppressed under trace 1
        finally:
            tracer.finish(t1)
        t2 = tracer.start_poll()        # the fresh trace doing the emitting
        try:
            clock.t = 31.0
            rl.warning("k", "boom")
        finally:
            tracer.finish(t2)
            logger.removeHandler(handler)
        assert records[-1].getMessage() == (
            f"boom (+2 similar suppressed, 2 in trace {t1.trace_id[:8]})"
        )

    def test_suppression_tally_unchanged_outside_traces(self):
        from tpu_pod_exporter_torch.utils import RateLimitedLogger

        logger = logging.getLogger("test_trace.rlog2")
        records, handler = self._capture(logger)

        class Clock:
            t = 0.0

            def __call__(self):
                return self.t

        clock = Clock()
        rl = RateLimitedLogger(logger, min_interval_s=30.0, clock=clock)
        try:
            rl.warning("k", "boom")
            rl.warning("k", "boom")
            clock.t = 31.0
            rl.warning("k", "boom")
        finally:
            logger.removeHandler(handler)
        assert [r.getMessage() for r in records] == [
            "boom", "boom (+1 similar suppressed)",
        ]


class TestChromeExport:
    def test_scrape_spans_exported_with_remote_context(self):
        store = TraceStore()
        store.record_scrape("a" * 32, "b" * 16, 1000.0, 0.002, client="10.0.0.9")
        doc = to_chrome_trace([], store.scrapes(10))
        validate_chrome_trace(doc)
        (ev,) = doc["traceEvents"]
        assert ev["name"] == "scrape" and ev["cat"] == "scrape"
        assert ev["args"]["trace_id"] == "a" * 32
        assert ev["args"]["parent_id"] == "b" * 16
        assert ev["args"]["client"] == "10.0.0.9"

    def test_profile_and_events_ride_the_export(self):
        collector, tracer, store = traced_collector()
        t = tracer.start_poll()
        t.begin("device_read")
        trace_mod.annotate("something happened")
        t.end("err")
        tracer.finish(t)
        doc = to_chrome_trace(store.last(1))
        dev = next(e for e in doc["traceEvents"]
                   if e["name"] == "device_read")
        assert dev["args"]["status"] == "err"
        assert dev["args"]["events"][0][1] == "something happened"
        tracer.close()

    def test_span_event_cap(self):
        tracer = Tracer(TraceStore(), slow_poll_s=0)
        t = tracer.start_poll()
        t.begin("device_read")
        for i in range(50):
            trace_mod.annotate(f"e{i}")
        t.end("ok")
        tracer.finish(t)
        dev = next(s for s in t.spans if s.name == "device_read")
        assert len(dev.events) == trace_mod.MAX_SPAN_EVENTS + 1
        assert dev.events[-1][1] == "…more events dropped"


class TestDemoAndOverheadCli:
    def test_trace_demo_replay(self, capsys):
        from tpu_pod_exporter_torch.trace import main

        rc = main(["--replay", "tests/fixtures/real-trace-r5.jsonl"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "trace " in out and "device_read" in out and "publish" in out

    @pytest.mark.slow
    def test_overhead_check_runs(self, capsys):
        from tpu_pod_exporter_torch.trace import main

        # Functional smoke only (tiny run; CI enforces the real budget with
        # a dedicated step): the check must run and report.
        rc = main(["--overhead-check", "--polls", "30", "--chips", "8",
                   "--budget", "5.0"])
        assert rc == 0
        assert "overhead" in capsys.readouterr().out


class TestDeviceReadInstants:
    """The poll publishes, beside its stamp, the wall-clock instants just
    before and after its device read."""

    @pytest.mark.parametrize("traced,fail_at", [(False, None), (True, None), (False, 1)],
                             ids=["untraced", "traced", "read_fails"])
    def test_edges_lie_between_the_previous_stamp_and_the_polls_own(self, traced, fail_at):
        """Also for a poll whose device read raises: its edges bound the
        failed read."""
        from tpu_pod_exporter_torch.metrics.parse import parse_exposition

        store = SnapshotStore()
        tracer = Tracer(TraceStore(), slow_poll_s=0.0) if traced else None
        backend = FakeBackend(chips=2)
        c = Collector(backend, FakeAttribution(), store, tracer=tracer)
        previous = None
        for i in range(3):
            if i == fail_at:
                backend.fail_next()
            c.poll_once()
            got = {(s.name, s.labels.get("edge")): s.value
                   for s in parse_exposition(store.current().encode().decode())
                   if s.name.startswith(("tpu_exporter_last_poll_timestamp_seconds",
                                         "tpu_exporter_last_device_read_timestamp_seconds"))}
            stamp = got[("tpu_exporter_last_poll_timestamp_seconds", None)]
            start = got[("tpu_exporter_last_device_read_timestamp_seconds", "start")]
            end = got[("tpu_exporter_last_device_read_timestamp_seconds", "end")]
            assert start <= end <= stamp
            if previous is not None:
                assert previous < start
            previous = stamp
        if traced:
            dev = next(s for s in tracer.store.last(1)[0].spans if s.name == "device_read")
            assert dev.t0_wall <= start


class TestRoundSpanTimings:
    """The aggregator's round spans carry the fetch's stages and the
    publish's phases."""

    def test_scrape_and_publish_spans_carry_their_split(self):
        from tpu_pod_exporter_torch.aggregate import FETCH_STAGES, SliceAggregator
        from tpu_pod_exporter_torch.app import ExporterApp
        from tpu_pod_exporter_torch.config import ExporterConfig

        cfg = ExporterConfig(port=0, host="127.0.0.1", backend="fake",
                             fake_chips=2, attribution="none",
                             history_retention_s=0.0)
        app = ExporterApp(cfg)
        app.start()
        agg = None
        try:
            ts = TraceStore()
            agg = SliceAggregator((f"127.0.0.1:{app.port}",), SnapshotStore(),
                                  tracer=Tracer(ts, slow_poll_s=0.0, root_name="round"))
            agg.poll_once()
            rt = ts.last(1)[0]
            scrape = next(s for s in rt.spans if s.name == "scrape")
            split = [scrape.attrs[f"{stage}_s"] for stage in FETCH_STAGES]
            assert min(split) >= 0.0
            assert sum(split) <= scrape.dur_s
            publish = next(s for s in rt.spans if s.name == "publish")
            phases = [publish.attrs[k] for k in ("parse_s", "fold_s", "build_s")]
            assert min(phases) >= 0.0 and phases[0] > 0.0
            assert sum(phases) <= publish.dur_s
        finally:
            if agg is not None:
                agg.close()
            app.stop()

    def test_untraced_round_adds_no_span_and_still_observes(self):
        from tpu_pod_exporter_torch.aggregate import SliceAggregator

        store = SnapshotStore()
        agg = SliceAggregator(("h0:8000",), store,
                              fetch=lambda target, timeout_s: 'tpu_chip_info{chip_id="0",host="h"} 1\n')
        try:
            agg.poll_once()
            agg.poll_once()
        finally:
            agg.close()
        body = store.current().encode().decode()
        assert 'tpu_aggregator_round_phase_seconds_count{phase="fold"} 1' in body

    def test_a_round_whose_publish_is_replaced_observes_no_phase(self):
        """The phases are observed by the publish itself: a round whose
        publish is wrapped and skipped observes none, and its publish span
        carries no split."""
        from tpu_pod_exporter_torch.aggregate import SliceAggregator

        class Skipping(SliceAggregator):
            skip = False

            def _publish(self, *a, **kw):
                if not self.skip:
                    super()._publish(*a, **kw)

        store, ts = SnapshotStore(), TraceStore()
        agg = Skipping(("h0:8000",), store,
                       fetch=lambda target, timeout_s: 'tpu_chip_info{chip_id="0",host="h"} 1\n',
                       tracer=Tracer(ts, slow_poll_s=0.0, root_name="round"))
        try:
            agg.poll_once()
            agg.skip = True
            agg.poll_once()
            skipped = ts.last(1)[0]
            agg.skip = False
            agg.poll_once()
        finally:
            agg.close()
        publish = next(s for s in skipped.spans if s.name == "publish")
        assert publish.attrs is None
        body = store.current().encode().decode()
        # The third round's snapshot holds the first round's phases only.
        assert 'tpu_aggregator_round_phase_seconds_count{phase="fetch"} 1' in body
