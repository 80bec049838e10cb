"""The cases of tests/test_server.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

HTTP surface tests: real sockets, scrape semantics (SURVEY.md §4.3)."""

import contextlib
import gzip
import urllib.request

import pytest

from tpu_pod_exporter_torch.metrics import MetricSpec, SnapshotBuilder, SnapshotStore
from tpu_pod_exporter_torch.server import MetricsServer


@pytest.fixture
def served_store():
    store = SnapshotStore()
    server = MetricsServer(store, host="127.0.0.1", port=0)
    server.start()
    yield store, f"http://127.0.0.1:{server.port}"
    server.stop()


def get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        resp = urllib.request.urlopen(req, timeout=5)
        return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def put_snapshot(store, value=1.0):
    b = SnapshotBuilder()
    b.add(MetricSpec(name="test_metric", help="t"), value)
    store.swap(b.build())


class TestEndpoints:
    def test_metrics_empty_before_first_poll(self, served_store):
        _, base = served_store
        status, headers, body = get(base + "/metrics")
        assert status == 200
        assert headers["Content-Type"].startswith("text/plain")
        assert body == b""

    def test_metrics_after_swap(self, served_store):
        store, base = served_store
        put_snapshot(store, 42)
        status, _, body = get(base + "/metrics")
        assert status == 200
        assert b"test_metric 42\n" in body

    def test_scrape_serves_latest_snapshot(self, served_store):
        store, base = served_store
        put_snapshot(store, 1)
        put_snapshot(store, 2)
        _, _, body = get(base + "/metrics")
        assert b"test_metric 2\n" in body

    def test_healthz(self, served_store):
        _, base = served_store
        status, _, body = get(base + "/healthz")
        assert status == 200 and body == b"ok\n"

    def test_readyz_flips_on_first_snapshot(self, served_store):
        store, base = served_store
        status, _, _ = get(base + "/readyz")
        assert status == 503
        put_snapshot(store)
        status, _, _ = get(base + "/readyz")
        assert status == 200

    def test_gzip_negotiation(self, served_store):
        store, base = served_store
        put_snapshot(store, 3)
        status, headers, body = get(
            base + "/metrics", headers={"Accept-Encoding": "gzip"}
        )
        assert status == 200
        assert headers.get("Content-Encoding") == "gzip"
        assert b"test_metric 3\n" in gzip.decompress(body)

    def test_unknown_path_404(self, served_store):
        _, base = served_store
        status, _, _ = get(base + "/nope")
        assert status == 404

    def test_root_index(self, served_store):
        _, base = served_store
        status, _, body = get(base + "/")
        assert status == 200 and b"tpu-pod-exporter" in body


class TestLivenessStaleness:
    def test_healthz_trips_when_snapshot_goes_stale(self):
        import time

        from tpu_pod_exporter_torch.metrics.registry import SnapshotBuilder

        store = SnapshotStore()
        server = MetricsServer(store, host="127.0.0.1", port=0, health_max_age_s=0.2)
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            status, _, _ = get(base + "/healthz")
            assert status == 200  # no snapshot yet: startup, not a stall
            b = SnapshotBuilder()
            b.add(MetricSpec(name="m", help="h"), 1)
            store.swap(b.build())
            status, _, _ = get(base + "/healthz")
            assert status == 200
            time.sleep(0.4)  # poll "wedges": no further swaps
            status, _, body = get(base + "/healthz")
            assert status == 503
            assert b"poll stalled" in body
            store.swap(b.build())  # poll recovers
            status, _, _ = get(base + "/healthz")
            assert status == 200
        finally:
            server.stop()


class TestLifecycle:
    def test_stop_before_start_does_not_deadlock(self):
        server = MetricsServer(SnapshotStore(), host="127.0.0.1", port=0)
        server.stop()  # must release the port without hanging


class TestPortConflict:
    def test_second_bind_fails_loudly(self):
        store = SnapshotStore()
        first = MetricsServer(store, host="127.0.0.1", port=0)
        first.start()
        try:
            with pytest.raises(OSError):
                MetricsServer(store, host="127.0.0.1", port=first.port)
        finally:
            first.stop()


class TestOpenMetrics:
    OM_ACCEPT = {
        "Accept": "application/openmetrics-text;version=1.0.0;q=0.9,text/plain;q=0.5"
    }

    def _counter_snapshot(self, store):
        from tpu_pod_exporter_torch.metrics.registry import COUNTER

        b = SnapshotBuilder()
        b.add(MetricSpec(name="g", help="a gauge"), 1.0)
        b.add(
            MetricSpec(name="c_total", help="a counter", type=COUNTER,
                       label_names=("x",)),
            3.0,
            ("v",),
        )
        store.swap(b.build())

    def test_negotiated_content_type_and_eof(self, served_store):
        store, base = served_store
        self._counter_snapshot(store)
        status, headers, body = get(base + "/metrics", headers=self.OM_ACCEPT)
        assert status == 200
        assert headers["Content-Type"].startswith("application/openmetrics-text")
        assert body.endswith(b"# EOF\n")
        # Counter family headers drop the _total suffix; samples keep it.
        assert b"# TYPE c counter" in body
        assert b'c_total{x="v"} 3' in body

    def test_plain_scrape_unchanged(self, served_store):
        store, base = served_store
        self._counter_snapshot(store)
        status, headers, body = get(base + "/metrics")
        assert headers["Content-Type"].startswith("text/plain")
        assert b"# EOF" not in body
        assert b"# TYPE c_total counter" in body

    def test_q_zero_refuses_openmetrics(self, served_store):
        # Explicit q=0 on the OpenMetrics token means "never send me this".
        store, base = served_store
        self._counter_snapshot(store)
        status, headers, body = get(
            base + "/metrics",
            headers={"Accept": "application/openmetrics-text;q=0, text/plain"},
        )
        assert headers["Content-Type"].startswith("text/plain")
        assert b"# EOF" not in body

    def test_counter_header_rewrite_is_line_anchored(self, served_store):
        # A HELP text *containing* "# HELP c_total " mid-line must not be
        # rewritten in place of the real header line.
        from tpu_pod_exporter_torch.metrics.registry import COUNTER

        store, base = served_store
        b = SnapshotBuilder()
        b.add(MetricSpec(name="a", help="docs mention # HELP c_total here"), 1.0)
        b.add(MetricSpec(name="c_total", help="a counter", type=COUNTER), 3.0)
        store.swap(b.build())
        status, headers, body = get(base + "/metrics", headers=self.OM_ACCEPT)
        assert b"# HELP a docs mention # HELP c_total here\n" in body
        assert b"\n# HELP c a counter\n" in body
        assert b"# TYPE c counter" in body

    def test_openmetrics_gzip(self, served_store):
        store, base = served_store
        self._counter_snapshot(store)
        status, headers, body = get(
            base + "/metrics",
            headers={**self.OM_ACCEPT, "Accept-Encoding": "gzip"},
        )
        assert headers.get("Content-Encoding") == "gzip"
        assert gzip.decompress(body).endswith(b"# EOF\n")

    def test_strict_openmetrics_parser_accepts_full_exporter_surface(self):
        """The reference OpenMetrics parser (prometheus_client) must parse a
        real collector snapshot — counters, info-style gauges, and all."""
        from prometheus_client.openmetrics.parser import text_string_to_metric_families

        from tpu_pod_exporter_torch.attribution.fake import FakeAttribution, simple_allocation
        from tpu_pod_exporter_torch.backend.fake import FakeBackend, FakeChipScript
        from tpu_pod_exporter_torch.collector import Collector

        store = SnapshotStore()
        backend = FakeBackend(
            chips=2,
            script=FakeChipScript(
                hbm_total_bytes=8.0, hbm_used_bytes=2.0, ici_bytes_per_step=10.0
            ),
        )
        attr = FakeAttribution([simple_allocation("p", ["0"], namespace="n")])
        c = Collector(backend, attr, store, legacy_metrics=True)
        c.poll_once()
        c.poll_once()
        text = store.current().encode_openmetrics().decode()
        fams = {f.name: f for f in text_string_to_metric_families(text)}
        assert "tpu_ici_transferred_bytes" in fams  # counter, suffix-stripped
        assert "tpu_hbm_used_bytes" in fams
        samples = fams["tpu_ici_transferred_bytes"].samples
        assert all(s.name == "tpu_ici_transferred_bytes_total" for s in samples)
        # The poll-phase histogram must be a strict-OM-valid histogram family.
        hist = fams["tpu_exporter_poll_phase_duration_seconds"]
        assert hist.type == "histogram"
        counts = {
            s.labels["phase"]: s.value
            for s in hist.samples
            if s.name.endswith("_count")
        }
        # Observations land at poll END, so the snapshot published during
        # poll 2 carries exactly poll 1's observation.
        assert counts["total"] == 1.0


def test_scrape_duration_histogram_reaches_exposition():
    """Handler threads observe; the collector emits on the next poll —
    end-to-end through a real ExporterApp."""
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
        import time

        base = f"http://127.0.0.1:{app.port}"
        for _ in range(3):
            get(base + "/metrics")
        # The observer runs on the handler thread just after the body write,
        # so the client can be back here before the observation lands —
        # poll-and-retry instead of assuming ordering.
        deadline = time.monotonic() + 5.0
        count = -1.0
        while time.monotonic() < deadline:
            app.collector.poll_once()
            body = get(base + "/metrics")[2].decode()
            lines = [
                l for l in body.splitlines()
                if l.startswith("tpu_exporter_scrape_duration_seconds_count")
            ]
            count = float(lines[0].split()[-1]) if lines else -1.0
            if count >= 3:
                break
            time.sleep(0.05)
        assert count >= 3
        assert "# TYPE tpu_exporter_scrape_duration_seconds histogram" in body
    finally:
        app.stop()


class TestAcceptParsing:
    """accepts_openmetrics q-value semantics (RFC 9110 §12.4.2 subset)."""

    def test_cases(self):
        from tpu_pod_exporter_torch.server import accepts_openmetrics as acc

        assert acc("application/openmetrics-text") is True
        assert acc("application/openmetrics-text;version=1.0.0;q=0.9") is True
        assert acc("application/openmetrics-text;q=0, text/plain") is False
        assert acc("application/openmetrics-text;q=0.0") is False
        assert acc("application/openmetrics-text; q=0 ") is False
        # client prefers text (om down-weighted below text/plain's q=1)
        assert acc("text/plain, application/openmetrics-text ;q=0.001") is False
        # om down-weighted but still above text/plain
        assert acc("text/plain;q=0.5, application/openmetrics-text;q=0.9") is True
        # the Prometheus >=2.5 header shape
        assert acc(
            "application/openmetrics-text;version=1.0.0;q=0.75,"
            "text/plain;version=0.0.4;q=0.5"
        ) is True
        # equal preference goes to the richer format
        assert acc("text/plain;q=0.5, application/openmetrics-text;q=0.5") is True
        # wildcard sets text/plain's implicit q
        assert acc("*/*;q=1, application/openmetrics-text;q=0.2") is False
        assert acc("text/plain") is False
        assert acc("") is False
        assert acc("APPLICATION/OpenMetrics-Text") is True
        # malformed q counts as accepting (q defaults to 1)
        assert acc("application/openmetrics-text;q=abc") is True


def blocking_store(release, entered):
    """A store whose snapshots block inside encode() until released —
    holds handler threads inside the guarded section deterministically."""
    store = SnapshotStore()
    put_snapshot(store, 7)
    real = store.current()

    class BlockingSnapshot:
        timestamp = real.timestamp
        series_count = real.series_count

        @staticmethod
        def encode():
            entered.release()
            release.acquire()
            return real.encode()

        encode_openmetrics = encode
        encode_gzip = encode
        encode_openmetrics_gzip = encode

    class BlockingStore:
        @staticmethod
        def current():
            return BlockingSnapshot

    return BlockingStore()


class HeldServer:
    __slots__ = ("server", "base", "release", "holders", "holder_results")

    def __init__(self, server, base, release, holders, holder_results):
        self.server = server
        self.base = base
        self.release = release
        self.holders = holders
        self.holder_results = holder_results

    def free_holders(self):
        """Release the held scrapes and WAIT for them to finish — callers
        asserting a post-release 200 must not race the holder threads out
        of their slots. Generous release count: every LATER scrape against
        the blocking store also consumes one permit in encode()."""
        self.release.release(64)
        for t in self.holders:
            t.join(timeout=5)


@contextlib.contextmanager
def held_server(n_holders: int = 1, **server_kwargs):
    """A MetricsServer with `n_holders` scrapes deterministically held
    inside the guarded render (the context cleans up regardless)."""
    import threading

    release = threading.Semaphore(0)
    entered = threading.Semaphore(0)
    server = MetricsServer(
        blocking_store(release, entered), host="127.0.0.1", port=0,
        **server_kwargs,
    )
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    results: list[int] = []
    holders = [
        threading.Thread(target=lambda: results.append(get(base + "/metrics")[0]))
        for _ in range(n_holders)
    ]
    try:
        # Inside the try: a timed-out acquire on a loaded host must still
        # release the semaphores and stop the server, or the blocked holder
        # threads hang pytest at interpreter exit.
        for t in holders:
            t.start()
        for _ in holders:
            assert entered.acquire(timeout=5)  # holder is INSIDE the render
        yield HeldServer(server, base, release, holders, results)
    finally:
        release.release(64)
        entered.release(64)
        for t in holders:
            t.join(timeout=5)
        server.stop()


class TestScrapeConcurrencyGuard:
    """VERDICT r3 #8: a scrape storm must hit a 429 wall, not eat a core.
    At most N /metrics handlers run at once; the N+1th queues briefly and
    is rejected with Retry-After."""

    def test_excess_scrapes_get_429(self):
        # TWO slots, both held: N concurrent scrapes up to the limit must
        # all serve (guards against an off-by-one in the semaphore), and
        # the N+1th must hit the wall.
        with held_server(
            n_holders=2, max_concurrent_scrapes=2, scrape_queue_timeout_s=0.1
        ) as h:
            status, headers, body = get(h.base + "/metrics")
            assert status == 429
            assert headers["Retry-After"] == "1"
            assert b"too many" in body
            # ...while non-scrape endpoints stay unguarded.
            assert get(h.base + "/healthz")[0] == 200
            assert h.server.scrape_rejects["concurrency"] == 1
            # Release the holders: both complete fine and slots free up.
            h.free_holders()
            assert h.holder_results == [200, 200]
            assert get(h.base + "/metrics")[0] == 200

    def test_reject_is_prerendered_and_closes_connection(self):
        with held_server(
            max_concurrent_scrapes=1, scrape_queue_timeout_s=0.05
        ) as h:
            base = h.base
            status, headers, body = get(base + "/metrics")
            assert status == 429
            # The pre-rendered wire bytes must still be a valid HTTP
            # response with the contract headers (VERDICT r4 #5).
            assert headers["Retry-After"] == "1"
            assert headers["Connection"] == "close"
            assert int(headers["Content-Length"]) == len(body)
            assert body == b"too many concurrent scrapes\n"

    def test_concurrent_rejects_count_exactly(self):
        # Advisor r4: the reject increment is lock-guarded — N concurrent
        # rejected scrapes must count exactly N, no lost updates under the
        # very storm the counter exists to measure.
        import threading

        with held_server(
            max_concurrent_scrapes=1, scrape_queue_timeout_s=0.05
        ) as h:
            server, base = h.server, h.base
            statuses = []

            def scrape():
                statuses.append(get(base + "/metrics")[0])

            n = 24
            threads = [threading.Thread(target=scrape) for _ in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
            assert statuses.count(429) == n
            assert server.scrape_rejects["concurrency"] == n

    def test_guard_disabled_with_zero(self):
        store = SnapshotStore()
        put_snapshot(store)
        server = MetricsServer(
            store, host="127.0.0.1", port=0, max_concurrent_scrapes=0
        )
        server.start()
        try:
            assert get(f"http://127.0.0.1:{server.port}/metrics")[0] == 200
        finally:
            server.stop()


class TestScrapeRateCap:
    """VERDICT r4 #5: a sequential storm of full-body scrapes is pure
    kernel-copy CPU the concurrency guard cannot bound — above the token
    bucket's rate, scrapes get the pre-rendered 429 instead."""

    def test_storm_hits_rate_cap_then_recovers(self):
        import time

        store = SnapshotStore()
        put_snapshot(store)
        server = MetricsServer(
            store, host="127.0.0.1", port=0, max_scrapes_per_s=5.0,
            scrape_tarpit_s=0.0,  # keep the test fast; tarpit tested below
        )
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            # Burst capacity is 2×rate = 10 tokens; 30 back-to-back scrapes
            # must drain it and hit the wall.
            statuses = [get(base + "/metrics")[0] for _ in range(30)]
            assert statuses[0] == 200           # bucket starts full
            assert statuses.count(429) >= 10    # the wall is real
            assert server.scrape_rejects["rate"] == statuses.count(429)
            # Refill: at 5/s, one token comes back well within a second.
            time.sleep(0.5)
            assert get(base + "/metrics")[0] == 200
            # Health endpoints are never rate-capped.
            assert get(base + "/healthz")[0] == 200
        finally:
            server.stop()

    def test_rate_cap_reject_is_tarpitted(self):
        # A fast 429 just speeds the storm's retry loop up; the reject must
        # hold the client for ~scrape_tarpit_s (cost: one sleeping thread,
        # not CPU).
        import time

        store = SnapshotStore()
        put_snapshot(store)
        server = MetricsServer(
            store, host="127.0.0.1", port=0, max_scrapes_per_s=0.5,
            scrape_tarpit_s=0.2,
        )
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            for _ in range(2):  # drain the 1-token bucket (refill 0.5/s)
                get(base + "/metrics")
            t0 = time.monotonic()
            status = get(base + "/metrics")[0]
            elapsed = time.monotonic() - t0
            assert status == 429
            assert elapsed >= 0.15
        finally:
            server.stop()

    def test_concurrency_reject_refunds_rate_token(self):
        # A scrape refused by the concurrency guard was
        # never served, so it must not count against the rate — a stall
        # would otherwise drain the bucket and 429 well-behaved scrapers
        # after it clears.
        with held_server(
            max_concurrent_scrapes=1, scrape_queue_timeout_s=0.05,
            max_scrapes_per_s=5.0, scrape_tarpit_s=0.0,
        ) as h:
            # 8 sem-rejects; each took then refunded a token (burst is 10,
            # and the holder itself consumed 1).
            for _ in range(8):
                assert get(h.base + "/metrics")[0] == 429
            # Free the holder's slot (joined, so no race on the slot);
            # the bucket must still hold ~9 tokens: 8 quick scrapes serve.
            h.free_holders()
            statuses = [get(h.base + "/metrics")[0] for _ in range(8)]
            assert statuses == [200] * 8

    def test_rate_cap_disabled_by_default(self):
        store = SnapshotStore()
        put_snapshot(store)
        server = MetricsServer(store, host="127.0.0.1", port=0)
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            statuses = [get(base + "/metrics")[0] for _ in range(30)]
            assert statuses == [200] * 30
        finally:
            server.stop()

    def test_token_bucket_refills_to_burst_not_beyond(self):
        from tpu_pod_exporter_torch.server import _TokenBucket

        b = _TokenBucket(rate=10.0, burst=3.0)
        assert [b.take() for _ in range(3)] == [True] * 3
        # Bucket just drained; an immediate take fails (refill in the
        # microseconds since is « 1 token at 10/s).
        assert b.take() is False
        b.last -= 10.0  # simulate 10 s idle: refill clamps at burst
        assert [b.take() for _ in range(3)] == [True] * 3
        assert b.take() is False


def test_scrape_rejects_surface_as_self_metric():
    """The 429 counter reaches the exporter's own exposition (and thus the
    TpuExporterPollErrors-style alerting surface) on the next poll."""
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
        body0 = get(base + "/metrics")[2]
        assert b'tpu_exporter_scrape_rejects_total{cause="concurrency"} 0\n' in body0
        assert b'tpu_exporter_scrape_rejects_total{cause="rate"} 0\n' in body0
        app.server.scrape_rejects["rate"] = 3  # as the guard would under a storm
        # Retry: the CollectorLoop's startup poll may still be in flight and
        # swap an older (rejects=0) snapshot AFTER our manual poll.
        import time

        deadline = time.monotonic() + 5.0
        body = b""
        while time.monotonic() < deadline:
            app.collector.poll_once()
            body = get(base + "/metrics")[2]
            if b'tpu_exporter_scrape_rejects_total{cause="rate"} 3\n' in body:
                break
            time.sleep(0.05)
        assert b'tpu_exporter_scrape_rejects_total{cause="rate"} 3\n' in body
    finally:
        app.stop()


class TestDebugStacks:
    """/debug/stacks — the pprof-equivalent SURVEY §5 asks for: a
    point-in-time dump of every thread's Python stack, served from a
    handler thread so it works even while another thread is wedged."""

    def test_wedged_thread_visible_with_blocking_site(self, served_store):
        import threading
        import time

        _, base = served_store
        started = threading.Event()
        release = threading.Event()

        def wedged_poll():
            started.set()
            release.wait()  # the "hung backend call"

        t = threading.Thread(target=wedged_poll, name="fake-poll", daemon=True)
        t.start()
        try:
            assert started.wait(timeout=5)
            # started.set() only proves the thread entered wedged_poll();
            # retry briefly until the dump catches it AT the wait site
            # (a loaded box can serve the first GET mid-bootstrap).
            text = ""
            for _ in range(50):
                status, headers, body = get(base + "/debug/stacks")
                assert status == 200
                assert headers["Content-Type"].startswith("text/plain")
                text = body.decode()
                if "release.wait()" in text:
                    break
                time.sleep(0.05)
            assert "(fake-poll)" in text
            # The dump must show WHERE the thread is blocked, not just that
            # it exists — that's the whole diagnostic value.
            assert "release.wait()" in text
            assert "in wedged_poll" in text
        finally:
            release.set()
            t.join(timeout=5)

    def test_every_live_thread_listed(self, served_store):
        import threading

        _, base = served_store
        _, _, body = get(base + "/debug/stacks")
        text = body.decode()
        # The handler thread serving this very request is live too.
        assert text.count("--- thread ") >= 1
        assert f"({threading.main_thread().name})" in text


class TestEventLoopRobustness:
    """Failure shapes specific to the event-loop server: a buggy worker
    task must still answer, and an error-closing connection must stop
    being read."""

    def test_worker_task_exception_answers_500(self):
        """An unexpected exception in a deferred worker task (here: a
        history backend raising TypeError) must produce a 500 and close —
        not a silently wedged connection that hangs the client forever."""

        class BrokenHistory:
            def series_list(self):
                raise TypeError("backend bug")

        store = SnapshotStore()
        put_snapshot(store)
        server = MetricsServer(
            store, host="127.0.0.1", port=0, history=BrokenHistory()
        )
        server.start()
        try:
            status, _, body = get(
                f"http://127.0.0.1:{server.port}/api/v1/series"
            )
            assert status == 500
            assert b"internal error" in body
        finally:
            server.stop()

    def test_worker_pool_burst_runs_in_parallel(self):
        """A burst of submits landing while one worker idles in cv.wait
        must spawn more workers (up to the cap), not serialize the whole
        batch onto the single idle thread via lost notify()s."""
        import threading
        import time

        from tpu_pod_exporter_torch.server import _WorkerPool

        pool = _WorkerPool(4)
        primed = threading.Event()
        pool.submit(primed.set)
        assert primed.wait(2)
        time.sleep(0.1)  # let the worker reach its idle cv.wait
        lock = threading.Lock()
        active = 0
        peak = 0
        done = []

        def task():
            nonlocal active, peak
            with lock:
                active += 1
                peak = max(peak, active)
            time.sleep(0.3)
            with lock:
                active -= 1
                done.append(1)

        for _ in range(3):
            pool.submit(task)
        deadline = time.monotonic() + 5
        while len(done) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        pool.shutdown()
        assert len(done) == 3
        assert peak >= 2, "burst serialized onto a single worker"

    def test_headerless_stream_gets_at_most_one_431_then_dies(self):
        """A client streaming bytes with no header terminator must be cut
        off after at most one 431 — never one error response per recv
        while its buffer grows at the client's send rate. (The server
        closes with client bytes still unread, so the teardown may be an
        RST that discards the in-flight 431 — 'at most one, then dead
        fast' is the invariant.)"""
        import socket
        import time

        store = SnapshotStore()
        put_snapshot(store)
        server = MetricsServer(store, host="127.0.0.1", port=0)
        server.start()
        try:
            s = socket.create_connection(("127.0.0.1", server.port),
                                         timeout=5)
            junk = b"x" * 65536
            got = b""
            dead = False
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                try:
                    s.sendall(junk)
                except OSError:
                    dead = True
                    break
                try:
                    s.settimeout(0.05)
                    chunk = s.recv(65536)
                    if not chunk:
                        dead = True
                        break
                    got += chunk
                except TimeoutError:
                    continue
                except OSError:
                    dead = True
                    break
                finally:
                    s.settimeout(5)
            assert dead, "server kept the header-less stream alive"
            assert got.count(b"HTTP/1.1 431") <= 1
            s.close()
        finally:
            server.stop()


class TestClientWriteTimeout:
    """Slow-client write defense (--client-write-timeout-s): a scraper that
    stops reading mid-body must not pin a handler thread — the blocked
    send times out (SO_SNDTIMEO), the connection drops, and the drop is
    counted for tpu_exporter_client_write_timeouts_total."""

    def test_stalled_reader_is_dropped_and_counted(self):
        import socket
        import time

        from tpu_pod_exporter_torch.persist import RestoredSnapshot

        store = SnapshotStore()
        # A body far larger than the kernel's socket buffers, so the
        # server-side sendall() genuinely blocks on the stalled client.
        big = RestoredSnapshot(b"x 1\n" * (16 << 20 >> 2), time.time())
        store.swap(big)
        server = MetricsServer(
            store, host="127.0.0.1", port=0, client_write_timeout_s=0.5
        )
        server.start()
        try:
            c = socket.socket()
            c.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
            c.connect(("127.0.0.1", server.port))
            c.sendall(b"GET /metrics HTTP/1.1\r\nHost: x\r\n\r\n")
            # read nothing: the handler's send must block, then time out
            deadline = time.monotonic() + 10
            while (
                server.write_timeouts["total"] == 0
                and time.monotonic() < deadline
            ):
                time.sleep(0.05)
            assert server.write_timeouts["total"] == 1
            c.close()
        finally:
            server.stop()

    def test_fast_reader_unaffected(self):
        store = SnapshotStore()
        put_snapshot(store, 7)
        server = MetricsServer(
            store, host="127.0.0.1", port=0, client_write_timeout_s=0.5
        )
        server.start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            status, _, body = get(base + "/metrics")
            assert status == 200 and b"test_metric 7\n" in body
            assert server.write_timeouts["total"] == 0
        finally:
            server.stop()


class TestWorkerPoolIdleReap:
    """A pool grown under a stall must shrink back.

    The old reap only fired when cv.wait() timed out; submit()'s notify()
    rotates through waiters, so ANY steady trickle of requests kept every
    storm-grown worker alive forever (BENCH_r06 slow_clients
    threads_after 17 vs 10). The reap now keys on each worker's idle age
    since ITS last completed task."""

    def test_pool_grows_then_reaps_to_baseline_while_trickling(self):
        import threading
        import time

        from tpu_pod_exporter_torch.server import _WorkerPool

        pool = _WorkerPool(8, idle_expire_s=0.25)
        gate = threading.Event()
        started = threading.Semaphore(0)

        def stall():
            started.release()
            gate.wait(10.0)

        for _ in range(8):
            pool.submit(stall)
        for _ in range(8):
            assert started.acquire(timeout=5.0)
        assert pool.threads == 8
        gate.set()
        # A trickle of instant tasks — the exact traffic pattern that
        # defeated the timeout-only reap (each notify() refreshed a
        # DIFFERENT waiter's timeout). The idle-age reap shrinks the pool
        # to what the trickle actually needs.
        deadline = time.monotonic() + 8.0
        while time.monotonic() < deadline and pool.threads > 2:
            pool.submit(lambda: None)
            time.sleep(0.05)
        assert pool.threads <= 2, (
            f"pool never reaped: {pool.threads} threads after trickle"
        )
        pool.shutdown()

    def test_quiet_pool_reaps_fully(self):
        import time

        from tpu_pod_exporter_torch.server import _WorkerPool

        pool = _WorkerPool(4, idle_expire_s=0.2)
        done = []
        for _ in range(4):
            pool.submit(lambda: done.append(1))
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and pool.threads:
            time.sleep(0.05)
        assert pool.threads == 0
        assert len(done) == 4
        pool.shutdown()


def _timings(server) -> dict:
    """The server's timing families as the collector would publish them:
    {(name, stage label or None): value}."""
    from tpu_pod_exporter_torch.metrics.parse import parse_exposition

    b = SnapshotBuilder()
    server.emit_timings(b)
    return {(s.name, s.labels.get("stage")): s.value
            for s in parse_exposition(b.build().encode().decode())}


def _wait_until(predicate, timeout_s=5.0):
    import time

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


class TestScrapeTimings:
    """How late the server's loop runs its due timers: its wait for the
    interpreter, with or without kernel receive stamps."""

    def test_idle_loop_samples_its_lag_about_ten_times_a_second(self):
        import time

        server = MetricsServer(SnapshotStore(), host="127.0.0.1", port=0)
        server.start()
        try:
            count = ("tpu_exporter_server_loop_lag_seconds_count", None)
            time.sleep(0.25)
            n0, t0 = _timings(server)[count], time.monotonic()
            time.sleep(1.0)
            n1, t1 = _timings(server)[count], time.monotonic()
            rate = (n1 - n0) / (t1 - t0)
            assert 5.0 <= rate <= 12.0, rate
            lag = _timings(server)[("tpu_exporter_server_loop_lag_seconds_sum", None)]
            assert 0.0 <= lag / n1 < 0.1
        finally:
            server.stop()

    @pytest.mark.parametrize("blocked_s", [0.15, 0.3])
    def test_a_blocked_loop_observes_how_late_it_ran_its_timer(self, blocked_s):
        """A callback that holds the loop past a timer's due instant makes
        that timer's lag at least the time the loop was held beyond it."""
        import threading
        import time

        server = MetricsServer(SnapshotStore(), host="127.0.0.1", port=0)
        server.start()
        try:
            fired = threading.Event()
            loop = server._loop
            loop.call_soon(lambda: (loop.call_later(0.0, fired.set),
                                    time.sleep(blocked_s)))
            assert fired.wait(5)
            got = _timings(server)
            assert got[("tpu_exporter_server_loop_lag_seconds_sum", None)] >= blocked_s * 0.9
        finally:
            server.stop()
