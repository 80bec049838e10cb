"""The cases of tests/test_stream.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

Streaming dashboard plane.

Covers the hub's delta machinery with injected poll functions (no
sockets): snapshot-then-delta row replacement, removed-series keys,
full-sync cadence, heartbeats, seq continuity; the seeded churn property
sweep asserting delta replay reproduces the polled answer exactly; the
HTTP transports (SSE registration + pushes, long-poll cursor flow) through
a real MetricsServer; admission (cap 429) and shedding (pressure rung,
slow-subscriber buffer cap); the replica source proxy; and the pump/attach
wiring the CLIs use.
"""

import json
import random
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from tpu_pod_exporter_torch.metrics import SnapshotBuilder, SnapshotStore, schema
from tpu_pod_exporter_torch.pressure import PressureGovernor, register_stream_rung
from tpu_pod_exporter_torch.server import MetricsServer
from tpu_pod_exporter_torch.shard import ReplicaSourceProxy
from tpu_pod_exporter_torch.stream import (
    HubFull,
    QueryShape,
    SseParser,
    StreamClient,
    StreamDisabled,
    StreamHub,
    StreamPump,
    StreamReplay,
    attach_stream,
    row_key,
    rows_map,
    stream_path,
)


def env_of(rows, partial=False):
    return {
        "status": "ok", "partial": partial, "source": "live",
        "data": {"result": [dict(r) for r in rows]},
        "fleet": {"targets": 4, "ok": 4},
        "took_s": 0.001,
    }


def make_world(rows=None):
    """Mutable fake backend: world['rows'] is what poll_fn answers."""
    world = {
        "gen": 1,
        "rows": rows if rows is not None else [
            {"metric": "m", "labels": {"h": "a"}, "value": 1.0},
            {"metric": "m", "labels": {"h": "b"}, "value": 2.0},
        ],
        "polls": 0,
    }

    def poll_fn(shape, gen):
        world["polls"] += 1
        return env_of(world["rows"])

    world["poll_fn"] = poll_fn
    return world


def make_hub(world, **kw):
    kw.setdefault("heartbeat_s", 3600.0)
    kw.setdefault("full_sync_s", 3600.0)
    return StreamHub(world["poll_fn"], lambda: world["gen"], **kw)


class Capture:
    """In-process subscriber: writer captures bytes, frames() parses."""

    def __init__(self):
        self.chunks = []
        self.parser = SseParser()
        self.closed = False
        self.replay = StreamReplay()

    def writer(self, payload):
        self.chunks.append(payload)

    def closer(self):
        self.closed = True

    def drain(self):
        frames = []
        for chunk in self.chunks:
            frames.extend(self.parser.feed(chunk))
        self.chunks = []
        for f in frames:
            self.replay.apply(f)
        return frames


WS = QueryShape(route="window_stats", metric="m", window_s=30.0)


class TestQueryShape:
    def test_defaults_and_key_identity(self):
        a = QueryShape.from_params({"metric": "m"}.get, {"slice_name": "s"})
        b = QueryShape.from_params(
            {"metric": "m", "window": "60"}.get, {"slice_name": "s"})
        assert a.key == b.key  # default window == explicit default
        assert a.route == "window_stats"

    @pytest.mark.parametrize("params,needle", [
        ({"route": "bogus"}, "route"),
        ({}, "metric"),
        ({"metric": "m", "window": "0"}, "window"),
        ({"metric": "m", "window": "inf"}, "window"),
        ({"route": "query_range", "metric": "m", "step": "-1"}, "step"),
        # Streams require a grid: step=0 would re-anchor at every round's
        # wall clock (full-body "deltas", zero cache hits).
        ({"route": "query_range", "metric": "m"}, "step > 0"),
        ({"route": "query_range", "metric": "m", "window": "100000",
          "step": "0.001"}, "resolution"),
        ({"route": "query_range", "metric": "m", "step": "15",
          "agg": "median"}, "agg"),
    ])
    def test_validation_errors_name_the_token(self, params, needle):
        with pytest.raises(ValueError, match=needle):
            QueryShape.from_params(params.get, {})

    def test_series_shape_ignores_metric(self):
        s = QueryShape.from_params({"route": "series"}.get, {})
        assert s.route == "series" and s.metric == ""


class TestHubDeltas:
    def test_snapshot_then_delta_changed_and_removed(self):
        world = make_world()
        hub = make_hub(world)
        cap = Capture()
        sub, first = hub.subscribe(WS, cap.writer, cap.closer)
        cap.writer(first)
        frames = cap.drain()
        assert [f["type"] for f in frames] == ["snapshot"]
        assert len(cap.replay.rows) == 2

        world["rows"] = [
            {"metric": "m", "labels": {"h": "a"}, "value": 5.0},  # changed
            {"metric": "m", "labels": {"h": "c"}, "value": 9.0},  # added
        ]  # b removed
        world["gen"] = 2
        hub.on_round(2)
        frames = cap.drain()
        assert [f["type"] for f in frames] == ["delta"]
        delta = frames[0]
        assert len(delta["changed"]) == 2
        assert len(delta["removed"]) == 1
        assert cap.replay.rows_by_key() == rows_map(
            "window_stats", env_of(world["rows"]))
        assert cap.replay.gaps == 0 and cap.replay.dups == 0

    def test_unchanged_round_ships_nothing(self):
        world = make_world()
        hub = make_hub(world)
        cap = Capture()
        _sub, first = hub.subscribe(WS, cap.writer, cap.closer)
        cap.writer(first)
        cap.drain()
        hub.on_round(2)
        hub.on_round(3)
        assert cap.drain() == []

    def test_one_evaluation_shared_by_many_subscribers(self):
        world = make_world()
        hub = make_hub(world)
        caps = [Capture() for _ in range(8)]
        for cap in caps:
            _s, first = hub.subscribe(WS, cap.writer, cap.closer)
            cap.writer(first)
            cap.drain()
        polls_before = world["polls"]
        world["rows"][0]["value"] = 42.0
        hub.on_round(2)
        # ONE poll for 8 subscribers (the fan-out inversion's cost model).
        assert world["polls"] == polls_before + 1
        for cap in caps:
            frames = cap.drain()
            assert [f["type"] for f in frames] == ["delta"]

    def test_full_sync_cadence(self):
        world = make_world()
        wall = {"t": 1000.0}
        hub = StreamHub(world["poll_fn"], lambda: world["gen"],
                        heartbeat_s=3600.0, full_sync_s=10.0,
                        wallclock=lambda: wall["t"])
        cap = Capture()
        _s, first = hub.subscribe(WS, cap.writer, cap.closer)
        cap.writer(first)
        cap.drain()
        world["rows"][0]["value"] = 2.0
        wall["t"] += 5
        hub.on_round(2)
        assert [f["type"] for f in cap.drain()] == ["delta"]
        wall["t"] += 6  # past full_sync_s since subscribe
        hub.on_round(3)  # even with NO changes, a full sync ships
        frames = cap.drain()
        assert [f["type"] for f in frames] == ["full_sync"]
        assert cap.replay.rows_by_key() == rows_map(
            "window_stats", env_of(world["rows"]))

    def test_heartbeat_only_when_quiet(self):
        world = make_world()
        wall = {"t": 1000.0}
        hub = StreamHub(world["poll_fn"], lambda: world["gen"],
                        heartbeat_s=5.0, full_sync_s=3600.0,
                        wallclock=lambda: wall["t"])
        cap = Capture()
        _s, first = hub.subscribe(WS, cap.writer, cap.closer)
        cap.writer(first)
        cap.drain()
        hub.tick()
        assert cap.drain() == []  # quiet but not past heartbeat_s yet
        wall["t"] += 6
        hub.tick()
        frames = cap.drain()
        assert [f["type"] for f in frames] == ["heartbeat"]
        assert frames[0]["seq"] == 0  # heartbeats never consume a seq

    def test_detach_stops_pushes_and_counts(self):
        world = make_world()
        hub = make_hub(world)
        cap = Capture()
        sub, first = hub.subscribe(WS, cap.writer, cap.closer)
        cap.writer(first)
        assert hub.subscribers == 1
        hub.detach(sub)
        assert hub.subscribers == 0
        world["rows"][0]["value"] = 7.0
        hub.on_round(2)
        cap.drain()
        assert cap.replay.data_frames == 1  # snapshot only

    def test_cap_rejects_and_counts(self):
        world = make_world()
        hub = make_hub(world, max_subscribers=2)
        caps = [Capture() for _ in range(2)]
        for cap in caps:
            hub.subscribe(WS, cap.writer, cap.closer)
        with pytest.raises(HubFull):
            hub.subscribe(WS, Capture().writer, Capture().closer)
        b = SnapshotBuilder()
        hub.emit(b)
        snap = b.build(timestamp=1.0)
        assert snap.value("tpu_stream_rejects_total", ("cap",)) == 1.0
        assert snap.value("tpu_stream_subscribers") == 2.0

    def test_shed_oldest_sends_shed_frame_and_frees_slots(self):
        world = make_world()
        hub = make_hub(world, max_subscribers=4)
        caps = [Capture() for _ in range(4)]
        for cap in caps:
            _s, first = hub.subscribe(WS, cap.writer, cap.closer)
            cap.writer(first)
            cap.drain()
        shed = hub.shed_oldest(0.5, reason="pressure")
        assert shed == 2 and hub.subscribers == 2
        # The OLDEST two got the shed frame + close; the newest two none.
        for cap in caps[:2]:
            cap.drain()
            assert cap.replay.shed_reason == "pressure"
            assert cap.closed
        for cap in caps[2:]:
            cap.drain()
            assert cap.replay.shed_reason is None

    def test_pressure_rung_sheds_and_halves_cap_then_recovers(self):
        world = make_world()
        hub = make_hub(world, max_subscribers=8)
        caps = [Capture() for _ in range(6)]
        for cap in caps:
            hub.subscribe(WS, cap.writer, cap.closer)
        gov = PressureGovernor(memory_budget_bytes=1)  # everything is over
        register_stream_rung(gov, hub)
        gov.tick()
        assert hub.subscribers == 3
        assert hub.max_subscribers == 4  # halved effective cap
        b = SnapshotBuilder()
        hub.emit(b)
        snap = b.build(timestamp=1.0)
        assert snap.value("tpu_stream_sheds_total", ("pressure",)) == 3.0
        # Recovery restores the configured cap (drive the ladder down).
        gov.set_memory_budget_bytes(1 << 30)
        hub.release_pressure()
        assert hub.max_subscribers == 8

    def test_bad_shape_evaluation_does_not_kill_the_round(self):
        calls = {"n": 0}

        def poll_fn(shape, gen):
            calls["n"] += 1
            if shape.metric == "bad":
                raise RuntimeError("backend exploded")
            return env_of([{"metric": "m", "labels": {}, "value": 1.0}])

        hub = StreamHub(poll_fn, lambda: 1, heartbeat_s=3600,
                        full_sync_s=3600)
        good, bad = Capture(), Capture()
        hub.subscribe(WS, good.writer, good.closer)
        with pytest.raises(RuntimeError):
            # Registration surfaces the failure to THAT subscriber only.
            hub.subscribe(
                QueryShape(route="window_stats", metric="bad"),
                bad.writer, bad.closer)
        hub.on_round(2)  # must not raise
        assert hub.subscribers == 1


class TestReplayProperty:
    """Satellite: seeded rounds with value/layout/membership churn — the
    streamed deltas applied on top of the snapshot frame must reproduce
    the polled answer exactly (the test_render_splice sweep pattern)."""

    HOSTS = ["a", "b", "c", "d", "e", "f"]

    def _mutate(self, rng, rows):
        rows = [dict(r) for r in rows]
        action = rng.random()
        if rows and action < 0.5:  # value churn on a random subset
            for r in rng.sample(rows, k=max(1, len(rows) // 2)):
                r["value"] = round(rng.uniform(0, 100), 3)
        elif action < 0.7 and len(rows) < 12:  # membership: add
            h = rng.choice(self.HOSTS)
            c = str(rng.randrange(4))
            key = {"h": h, "chip": c}
            if not any(r["labels"] == key for r in rows):
                rows.append({"metric": "m", "labels": key,
                             "value": rng.uniform(0, 100)})
        elif action < 0.85 and len(rows) > 1:  # membership: remove
            rows.pop(rng.randrange(len(rows)))
        elif rows:  # layout churn: a label VALUE changes (new series key)
            r = rng.choice(rows)
            r["labels"] = {**r["labels"], "pod": f"p{rng.randrange(3)}"}
        return rows

    @pytest.mark.parametrize("seed", range(6))
    def test_replay_equals_polled_through_churn(self, seed):
        rng = random.Random(seed)
        rows = [{"metric": "m", "labels": {"h": h, "chip": "0"},
                 "value": 1.0} for h in self.HOSTS[:3]]
        state = {"rows": rows}
        wall = {"t": 1000.0}

        def poll_fn(shape, gen):
            return env_of(state["rows"])

        # Small full_sync period so the sweep exercises delta AND
        # full_sync replay; heartbeats interleave via tick().
        hub = StreamHub(poll_fn, lambda: 1, heartbeat_s=7.0,
                        full_sync_s=13.0, wallclock=lambda: wall["t"])
        cap = Capture()
        _s, first = hub.subscribe(WS, cap.writer, cap.closer)
        cap.writer(first)
        cap.drain()
        assert cap.replay.rows_by_key() == rows_map(
            "window_stats", env_of(state["rows"]))
        for r in range(60):
            state["rows"] = self._mutate(rng, state["rows"])
            wall["t"] += rng.choice([1.0, 2.0, 5.0])
            hub.on_round(r + 2)
            if rng.random() < 0.3:
                hub.tick()
            cap.drain()
            assert cap.replay.rows_by_key() == rows_map(
                "window_stats", env_of(state["rows"])), (
                f"replay diverged at round {r} (seed {seed})")
            assert cap.replay.gaps == 0 and cap.replay.dups == 0
            assert not cap.replay.desynced

    def test_gap_detection_and_full_sync_heal(self):
        rep = StreamReplay()
        rep.apply({"type": "snapshot", "seq": 3, "gen": 1, "rows": [],
                   "meta": {}})
        rep.apply({"type": "delta", "seq": 6, "gen": 2,
                   "changed": [], "removed": [], "meta": {}})
        assert rep.gaps == 2 and rep.desynced
        rep.apply({"type": "full_sync", "seq": 7, "gen": 3,
                   "rows": [{"metric": "m", "labels": {}, "value": 1.0}],
                   "meta": {}})
        assert not rep.desynced and len(rep.rows) == 1
        rep.apply({"type": "delta", "seq": 7, "gen": 3,
                   "changed": [], "removed": [], "meta": {}})
        assert rep.dups == 1


def start_server(hub):
    server = MetricsServer(SnapshotStore(), host="127.0.0.1", port=0,
                           stream_hub=hub)
    server.start()
    return server


def get_json(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


class TestHttpTransports:
    def test_sse_subscribe_and_push_over_the_wire(self):
        world = make_world()
        hub = make_hub(world)
        server = start_server(hub)
        try:
            client = StreamClient("127.0.0.1", server.port, WS,
                                  timeout_s=5.0)
            rep = StreamReplay()
            for f in client.frames(max_frames=1, timeout_s=3.0):
                rep.apply(f)
            assert rep.seq == 0 and len(rep.rows) == 2
            world["rows"][0]["value"] = 77.0
            hub.on_round(2)
            for f in client.frames(max_frames=1, timeout_s=3.0):
                rep.apply(f)
            assert rep.rows_by_key() == rows_map(
                "window_stats", env_of(world["rows"]))
            client.close()
            # Client EOF frees the hub slot via the loop's close path.
            deadline = time.monotonic() + 3.0
            while hub.subscribers and time.monotonic() < deadline:
                time.sleep(0.02)
            assert hub.subscribers == 0
        finally:
            server.stop()

    def test_no_hub_is_404_and_client_raises_disabled(self):
        server = MetricsServer(SnapshotStore(), host="127.0.0.1", port=0)
        server.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                get_json(f"http://127.0.0.1:{server.port}/api/v1/stream"
                         f"?metric=m&transport=longpoll")
            assert ei.value.code == 404
            with pytest.raises(StreamDisabled):
                StreamClient("127.0.0.1", server.port, WS, timeout_s=3.0)
        finally:
            server.stop()

    def test_bad_params_are_400_with_the_token(self):
        world = make_world()
        hub = make_hub(world)
        server = start_server(hub)
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                get_json(f"http://127.0.0.1:{server.port}/api/v1/stream"
                         f"?route=query_range&metric=m&step=15&agg=median"
                         f"&transport=longpoll")
            assert ei.value.code == 400
            assert "agg" in json.loads(ei.value.read())["error"]
            with pytest.raises(urllib.error.HTTPError) as ei:
                get_json(f"http://127.0.0.1:{server.port}/api/v1/stream"
                         f"?metric=m&transport=carrier-pigeon")
            assert ei.value.code == 400
        finally:
            server.stop()

    def test_cap_answers_429_over_the_wire(self):
        world = make_world()
        hub = make_hub(world, max_subscribers=1)
        server = start_server(hub)
        clients = []
        try:
            clients.append(StreamClient("127.0.0.1", server.port, WS,
                                        timeout_s=5.0))
            with pytest.raises(StreamDisabled, match="429"):
                StreamClient("127.0.0.1", server.port, WS, timeout_s=5.0)
        finally:
            for c in clients:
                c.close()
            server.stop()

    def test_longpoll_cursor_flow(self):
        world = make_world()
        hub = make_hub(world)
        server = start_server(hub)
        base = f"http://127.0.0.1:{server.port}"
        try:
            doc = get_json(base + stream_path(WS, transport="longpoll"))
            assert [f["type"] for f in doc["frames"]] == ["snapshot"]
            cursor = doc["cursor"]
            # Parked request answered by the next round.
            result = {}

            def lp():
                result["doc"] = get_json(
                    base + stream_path(WS, transport="longpoll",
                                       cursor=cursor), timeout=10.0)

            t = threading.Thread(target=lp, daemon=True, name="t-lp")
            t.start()
            time.sleep(0.3)
            world["rows"][0]["value"] = 3.5
            hub.on_round(2)
            t.join(5.0)
            assert not t.is_alive()
            assert [f["type"] for f in result["doc"]["frames"]] == ["delta"]
            assert result["doc"]["cursor"] == cursor + 1
            # A stale cursor inside the ring window gets the missed
            # frames; one behind the ring gets a fresh snapshot.
            doc = get_json(base + stream_path(WS, transport="longpoll",
                                              cursor=0))
            assert [f["type"] for f in doc["frames"]] == ["delta"]
        finally:
            server.stop()

    def test_slow_subscriber_is_shed_at_buffer_cap(self):
        world = make_world()
        # Big rows so a few frames blow the tiny buffer below.
        world["rows"] = [{"metric": "m", "labels": {"h": str(i)},
                         "value": 1.0, "pad": "x" * 512}
                        for i in range(64)]
        hub = make_hub(world, full_sync_s=0.0)
        server = MetricsServer(SnapshotStore(), host="127.0.0.1", port=0,
                               stream_hub=hub,
                               stream_max_buffer_bytes=8 * 1024)
        server.start()
        try:
            sock = socket.create_connection(("127.0.0.1", server.port),
                                            timeout=5.0)
            sock.sendall(
                f"GET {stream_path(WS)} HTTP/1.1\r\n"
                f"Host: x\r\n\r\n".encode())
            sock.recv(1024)  # head+start of snapshot, then STOP reading
            # Shrink the client's receive window so pushed frames pile up
            # server-side instead of draining into kernel buffers.
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1024)
            deadline = time.monotonic() + 10.0
            shed = 0.0
            while time.monotonic() < deadline:
                for i in range(64):
                    world["rows"][i % 64]["value"] += 1.0
                hub.on_round(int(time.monotonic() * 1000) % 100000)
                b = SnapshotBuilder()
                hub.emit(b)
                shed = b.build(timestamp=1.0).value(
                    "tpu_stream_sheds_total", ("slow",)) or 0.0
                if shed:
                    break
                time.sleep(0.02)
            assert shed >= 1.0, "stalled subscriber was never shed"
            sock.close()
        finally:
            server.stop()


class TestPumpAndWiring:
    def test_pump_runs_on_round_off_the_round_thread(self):
        world = make_world()
        hub = make_hub(world)
        cap = Capture()
        _s, first = hub.subscribe(WS, cap.writer, cap.closer)
        cap.writer(first)
        cap.drain()
        pump = StreamPump(hub)
        pump.start()
        try:
            world["rows"][0]["value"] = 11.0
            pump.notify(2)
            deadline = time.monotonic() + 5.0
            while not cap.chunks and time.monotonic() < deadline:
                time.sleep(0.01)
            assert [f["type"] for f in cap.drain()] == ["delta"]
        finally:
            pump.close()

    def test_attach_stream_wires_round_and_emit_hooks(self):
        class FakeAgg:
            rounds = 1

            def __init__(self):
                self.emit_hooks = []
                self.round_hooks = []

        agg = FakeAgg()

        class FakePlane:
            def window_stats(self, metric, match, window_s):
                return env_of([{"metric": metric, "labels": {},
                                "value": 1.0}])

        hub, pump = attach_stream(agg, FakePlane())
        try:
            assert len(agg.round_hooks) == 1
            assert len(agg.emit_hooks) == 1
            b = SnapshotBuilder()
            agg.emit_hooks[0](b)
            snap = b.build(timestamp=1.0)
            assert snap.value("tpu_stream_subscribers") == 0.0
        finally:
            pump.close()
            hub.close()


class TestReplicaSourceProxy:
    def _inner(self):
        class Inner:
            def series(self):
                return {"status": "ok", "data": []}

            def window_stats(self, metric, match, window_s):
                return env_of([{"metric": metric, "labels": {},
                                "value": 1.0}])

            def query_range(self, metric, match, start, end, step,
                            agg="last"):
                return {"status": "ok", "source": "live",
                        "data": {"resultType": "matrix", "result": []}}

            def close(self):
                pass

        return Inner()

    def test_no_root_url_400s_honestly(self):
        proxy = ReplicaSourceProxy(self._inner(), replica_id="r1")
        with pytest.raises(ValueError, match="--root-url"):
            proxy.window_stats("m", {}, window_s=30.0, source="store")
        # Live queries pass straight through.
        env = proxy.window_stats("m", {}, window_s=30.0)
        assert env["status"] == "ok"

    def test_proxies_source_queries_to_root(self):
        seen = {}

        def fetch(url, timeout_s):
            seen["url"] = url
            return {"status": "ok", "source": "store",
                    "data": {"result": []}}

        proxy = ReplicaSourceProxy(self._inner(), replica_id="r1",
                                   root_url="root:9100", fetch=fetch)
        doc = proxy.window_stats("m", {"slice_name": "s"}, window_s=30.0,
                                 source="store")
        assert doc["proxied"] is True and doc["source"] == "store"
        assert "source=store" in seen["url"]
        assert "root%3A9100" not in seen["url"]  # host not double-encoded

    def test_root_refusal_relays_as_400_and_outage_degrades(self):
        def refuse(url, timeout_s):
            raise urllib.error.HTTPError(url, 400, "bad", {}, None)

        proxy = ReplicaSourceProxy(self._inner(), root_url="root:9100",
                                   fetch=refuse)
        with pytest.raises(ValueError, match="HTTP 400"):
            proxy.series(source="store")

        def dead(url, timeout_s):
            raise ConnectionRefusedError("down")

        proxy2 = ReplicaSourceProxy(self._inner(), root_url="root:9100",
                                    fetch=dead)
        doc = proxy2.query_range("m", source="store")
        assert doc["status"] == "error" and doc["proxied"] is True

    def test_emit_publishes_identity_and_counters(self):
        def fetch(url, timeout_s):
            return {"status": "ok", "data": {"result": []}}

        proxy = ReplicaSourceProxy(self._inner(), replica_id="r7",
                                   root_url="root:9100", fetch=fetch)
        proxy.window_stats("m", {}, window_s=30.0, source="store")
        b = SnapshotBuilder()
        proxy.emit(b)
        snap = b.build(timestamp=1.0)
        assert snap.value("tpu_replica_info", ("r7",)) == 1.0
        assert snap.value("tpu_replica_store_proxied_total",
                          ("ok",)) == 1.0


class TestStreamExpositionSurface:
    def test_stream_metric_names_resolve_to_schema(self):
        world = make_world()
        hub = make_hub(world)
        cap = Capture()
        hub.subscribe(WS, cap.writer, cap.closer)
        hub.on_round(2)
        b = SnapshotBuilder()
        hub.emit(b)
        snap = b.build(timestamp=1.0)
        names = {spec.name for spec in snap.families()}
        for spec in schema.STREAM_SPECS:
            assert spec.name in names
        assert snap.value("tpu_stream_query_shapes") == 1.0
        assert snap.value("tpu_stream_frames_total", ("snapshot",)) == 1.0


class TestStatusWatchFallback:
    def test_split_addr_forms(self):
        from tpu_pod_exporter_torch.status import _split_addr

        assert _split_addr("127.0.0.1:9100") == ("127.0.0.1", 9100)
        assert _split_addr("http://h:91/metrics") == ("h", 91)
        assert _split_addr("h:not-a-port") is None

    def test_watch_falls_back_when_no_stream_offered(self):
        from tpu_pod_exporter_torch.status import _watch_fleet_stream

        server = MetricsServer(SnapshotStore(), host="127.0.0.1", port=0)
        server.start()
        try:
            # No hub on this tier: the watcher must return None (the
            # caller's polling fallback), never crash or hang.
            rc = _watch_fleet_stream(f"127.0.0.1:{server.port}", 30.0,
                                     0.1, as_json="line")
            assert rc is None
        finally:
            server.stop()


class TestReviewHardening:
    """Regression pins for the review findings."""

    def test_deferred_activate_catches_up_rounds_committed_mid_setup(self):
        # A round committed between subscribe(auto_start=False) and
        # activate() must arrive via the ring catch-up — not be dropped
        # into the pre-transport window as a permanent seq gap.
        world = make_world()
        hub = make_hub(world)
        cap = Capture()
        sub, first = hub.subscribe(WS, cap.writer, cap.closer,
                                   auto_start=False)
        world["rows"][0]["value"] = 99.0
        hub.on_round(2)  # commits seq 1 while the transport is not ready
        assert cap.chunks == []  # nothing pushed to an unstarted sub
        catchup = hub.activate(sub)
        cap.writer(first + catchup)
        cap.drain()
        assert cap.replay.seq == 1
        assert cap.replay.gaps == 0 and not cap.replay.desynced
        assert cap.replay.rows_by_key() == rows_map(
            "window_stats", env_of(world["rows"]))
        # And pushes flow normally after activation.
        world["rows"][0]["value"] = 100.0
        hub.on_round(3)
        cap.drain()
        assert cap.replay.seq == 2 and cap.replay.gaps == 0

    def test_longpoll_waiter_answered_with_heartbeats_disabled(self):
        world = make_world()
        mono = {"t": 100.0}
        hub = StreamHub(world["poll_fn"], lambda: 1, heartbeat_s=0.0,
                        full_sync_s=3600.0, clock=lambda: mono["t"])
        answers = []
        parked = hub.poll_frames(
            QueryShape(route="window_stats", metric="m", window_s=30.0),
            cursor=0, callback=answers.append, wait_s=None)
        assert parked is None  # cursor == seq: held
        mono["t"] += 30.0  # past the disabled-heartbeat fallback hold
        hub.tick()
        assert answers and answers[0]["frames"][0]["type"] == "heartbeat"

    def test_shed_frame_reaches_the_viewer_before_close(self):
        # Flush-then-close: the final labeled shed frame must arrive over
        # the wire (the RUNBOOK contract), then the connection ends.
        world = make_world()
        hub = make_hub(world)
        server = start_server(hub)
        try:
            client = StreamClient("127.0.0.1", server.port, WS,
                                  timeout_s=5.0)
            rep = StreamReplay()
            for f in client.frames(max_frames=1, timeout_s=3.0):
                rep.apply(f)
            assert hub.shed_oldest(1.0, reason="pressure") == 1
            for f in client.frames(timeout_s=5.0):
                rep.apply(f)
            assert rep.shed_reason == "pressure"
            assert client.eof
        finally:
            server.stop()

    def test_full_frames_carry_per_target_status_meta(self):
        def poll_fn(shape, gen):
            env = env_of([{"metric": "m", "labels": {}, "value": 1.0}])
            env["targets"] = {"t1": {"state": "quarantined"}}
            return env

        hub = StreamHub(poll_fn, lambda: 1, heartbeat_s=3600,
                        full_sync_s=3600)
        cap = Capture()
        _s, first = hub.subscribe(WS, cap.writer, cap.closer)
        cap.writer(first)
        cap.drain()
        assert cap.replay.meta["targets"]["t1"]["state"] == "quarantined"

    def test_build_serving_governor_sheds_cache_then_viewers(self):
        # The production CLI wiring (aggregate/root/replica
        # --memory-budget-mb): the query result cache sheds FIRST,
        # oldest subscriptions LAST — and the governor actually exists
        # outside test harnesses (review finding: the rung used to be
        # wired only in loadgen).
        from tpu_pod_exporter_torch.pressure import build_serving_governor

        class FakePlane:
            enabled = True

            def cache_bytes(self):
                return 4096

            def set_cache_enabled(self, on):
                self.enabled = on

        world = make_world()
        hub = make_hub(world, max_subscribers=8)
        caps = [Capture() for _ in range(4)]
        for cap in caps:
            hub.subscribe(WS, cap.writer, cap.closer)
        plane = FakePlane()
        # Pre-built, never started: deterministic manual ticks (the CLI
        # path passes governor=None and gets a started thread instead).
        base = PressureGovernor(memory_budget_bytes=0)
        gov = build_serving_governor(1, cache_plane=plane, hub=hub,
                                     governor=base)
        assert gov is base  # extends, never duplicates
        try:
            gov.tick()  # rung 1: cache
            assert plane.enabled is False
            assert hub.subscribers == 4
            gov.tick()  # rung 2: stream_shed
            assert hub.subscribers == 2
            assert hub.max_subscribers == 4
        finally:
            gov.close()
        # No budget + no existing governor ⇒ nothing built.
        assert build_serving_governor(0, cache_plane=plane,
                                      hub=hub) is None


class TestScenarioDsl:
    def test_dashboard_storm_parses(self):
        from tpu_pod_exporter_torch.scenario import SCENARIOS, parse_event

        ev = parse_event("dashboard_storm(500)@2+6")
        assert ev.count == 500 and ev.duration == 6
        # The named drill's timeline must itself parse.
        assert SCENARIOS["dashboard_storm"].events()

    @pytest.mark.parametrize("raw,needle", [
        ("dashboard_storm()@2+4", "subscription"),
        ("dashboard_storm(x)@2+4", "integer"),
        ("dashboard_storm(0)@2+4", ">= 1"),
        ("dashboard_storm(10)@2", "duration"),
    ])
    def test_dashboard_storm_parse_errors(self, raw, needle):
        from tpu_pod_exporter_torch.scenario import parse_event

        with pytest.raises(ValueError, match=needle):
            parse_event(raw)


class TestDashboardDemoSmoke:
    def test_small_scale_end_to_end(self, tmp_path):
        """The acceptance harness at toy scale: subscriptions against one
        root + one replica over a real leaf tier, replica killed
        mid-storm, every invariant green."""
        from tpu_pod_exporter_torch.loadgen.fleet import run_dashboard_demo

        result = run_dashboard_demo(
            n_targets=12, shards=2, chips=2, subs=16, rounds=3,
            replicas=1, state_root=str(tmp_path / "dash"),
            push_p99_budget_s=5.0, rss_cap_mb=256.0,
        )
        assert result["ok"], result["failures"]
        assert result["connected"] == 16
        assert result["gaps"] == 0 and result["dups"] == 0
        assert result["equality_failures"] == 0
        assert result["replica_kill"]["live_after"] == 16
        assert result["shed"]["counted"] == result["shed"]["shed"]
        assert result["pull_baseline"]["qps_one_client"] > 0
