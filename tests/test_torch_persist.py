"""The port's persistence layer held against the JAX package's.

The cases of tests/test_persist.py run against
``tpu_pod_exporter_torch.persist`` with the imports renamed, except the two
that need modules the port does not carry yet: the aggregator's breaker
restore (``aggregate``) and the status footer (``status``). Then the two
packages share one state dir: what the JAX ``StatePersister`` writes, the
port's restores as the same history series and values, and the reverse.
One difference is pinned: from the WAL alone the JAX package restores GPU
series (``gpu_hbm_used_bytes`` and the rest of ``GPU_NODE_SPECS``) without
their labels, so they fork from the live series after a restart; the port
restores them with their labels.
"""

import json
import os
import random
import time

import pytest

from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
from tpu_pod_exporter_torch.backend.fake import FakeBackend
from tpu_pod_exporter_torch.collector import Collector
from tpu_pod_exporter_torch.history import HistoryStore
from tpu_pod_exporter_torch.metrics import SnapshotStore
from tpu_pod_exporter_torch.persist import (
    MAGIC,
    RestoredSnapshot,
    StatePersister,
    WAL_NAME,
    append_record,
    read_record_file,
    state_dir_summary,
)
from tpu_pod_exporter_torch.supervisor import CircuitBreaker, SourceSupervisor


def make_world(state_dir, chips=2, supervise=True, **persist_kw):
    """A collector + history + persister trio writing into state_dir."""
    history = HistoryStore(capacity=128, retention_s=0.0)
    store = SnapshotStore()
    supervisors = {}
    if supervise:
        supervisors["device"] = SourceSupervisor("device", lambda: None)
    persist_kw.setdefault("snapshot_interval_s", 1e9)  # WAL-only by default
    persist_kw.setdefault("fsync_interval_s", 0)       # durable per record
    persister = StatePersister(
        str(state_dir), history=history, supervisors=supervisors,
        exposition_fn=store.current, **persist_kw,
    )
    collector = Collector(
        FakeBackend(chips=chips), FakeAttribution(), store,
        history=history, persister=persister,
    )
    return collector, history, store, supervisors, persister


def drain(persister, timeout=5.0):
    """Wait until the writer thread has consumed every queued record."""
    deadline = time.monotonic() + timeout
    while persister.stats()["queue_depth"] and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)  # let the in-flight item finish its write + fsync


def series_map(history):
    return {
        (m, tuple(sorted(l.items()))): [(round(w, 6), v) for w, v in s]
        for m, l, s in history.export_series()
    }


def restore_world(state_dir, supervise=True):
    history = HistoryStore(capacity=128, retention_s=0.0)
    supervisors = {}
    if supervise:
        supervisors["device"] = SourceSupervisor("device", lambda: None)
    persister = StatePersister(
        str(state_dir), history=history, supervisors=supervisors,
    )
    restored = persister.load()
    return restored, history, supervisors


# ------------------------------------------------------------------ framing


class TestRecordFile:
    def test_roundtrip(self, tmp_path):
        path = tmp_path / "f.bin"
        with open(path, "wb") as f:
            f.write(MAGIC)
            for payload in (b"Jone", b"Stwo", b"E" + b"x" * 1000):
                append_record(f, payload)
        payloads, valid, err = read_record_file(str(path))
        assert err is None
        assert payloads == [b"Jone", b"Stwo", b"E" + b"x" * 1000]
        assert valid == os.path.getsize(path)

    def test_missing_file_is_empty(self, tmp_path):
        payloads, valid, err = read_record_file(str(tmp_path / "nope"))
        assert (payloads, valid, err) == ([], 0, None)

    def test_bad_magic(self, tmp_path):
        path = tmp_path / "f.bin"
        path.write_bytes(b"NOTMINE!" + b"rest")
        payloads, valid, err = read_record_file(str(path))
        assert payloads == [] and "magic" in err

    def test_torn_tail_yields_prefix(self, tmp_path):
        path = tmp_path / "f.bin"
        with open(path, "wb") as f:
            f.write(MAGIC)
            append_record(f, b"Jfirst")
            append_record(f, b"Jsecond")
        size = os.path.getsize(path)
        os.truncate(path, size - 3)
        payloads, valid, err = read_record_file(str(path))
        assert payloads == [b"Jfirst"]
        assert err is not None
        # valid is the truncate point: re-reading after truncation is clean
        os.truncate(path, valid)
        payloads2, _, err2 = read_record_file(str(path))
        assert payloads2 == [b"Jfirst"] and err2 is None

    def test_corrupt_crc_stops(self, tmp_path):
        path = tmp_path / "f.bin"
        with open(path, "wb") as f:
            f.write(MAGIC)
            append_record(f, b"Jfirst")
            append_record(f, b"Jsecond")
        data = bytearray(path.read_bytes())
        data[-2] ^= 0xFF  # flip a byte inside the last payload
        path.write_bytes(bytes(data))
        payloads, _, err = read_record_file(str(path))
        assert payloads == [b"Jfirst"] and "CRC" in err

    def test_implausible_length_rejected(self, tmp_path):
        import struct

        path = tmp_path / "f.bin"
        with open(path, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<II", 1 << 30, 0))
        payloads, valid, err = read_record_file(str(path))
        assert payloads == [] and "implausible" in err


# ------------------------------------------------------------- round trips


class TestPersistRestore:
    def test_wal_restore_matches_original(self, tmp_path):
        collector, history, _store, _sups, persister = make_world(tmp_path)
        persister.start()
        for _ in range(8):
            collector.poll_once()
            time.sleep(0.005)
        drain(persister)
        # crash: no close() — WAL only, no checkpoint
        orig = series_map(history)
        restored, history2, _ = restore_world(tmp_path)
        assert restored.restored
        assert series_map(history2) == orig

    def test_restored_labeled_series_merge_with_live_appends(self, tmp_path):
        """The restore-key discipline: after a restart, the first LIVE poll
        must append into the restored series objects, not fork a second
        series with identical labels. tpu_exporter_up (no labels) cannot
        catch this — both key shapes coincide for an empty label set — so
        this asserts on per-chip HBM, where the collector keys by label
        VALUE tuple."""
        collector, history, _store, _sups, persister = make_world(tmp_path)
        persister.start()
        for _ in range(4):
            collector.poll_once()
            time.sleep(0.005)
        drain(persister)
        persister.close()

        # "restarted process": fresh history restored from disk, then fed
        # by a fresh collector (fresh label caches, same fake backend).
        history2 = HistoryStore(capacity=128, retention_s=0.0)
        p2 = StatePersister(str(tmp_path), history=history2)
        restored = p2.load()
        assert restored.restored
        before = history2.stats()["series"]
        c2 = Collector(
            FakeBackend(chips=2), FakeAttribution(), SnapshotStore(),
            history=history2,
        )
        for _ in range(3):
            c2.poll_once()
        after = history2.stats()["series"]
        # Live polls may add series the restore missed (e.g. rate gauges),
        # but never a duplicate of a restored one: chip HBM existed before
        # and after, so the per-chip count must not have doubled.
        rows = history2.query_range(
            "tpu_hbm_used_bytes", {"chip_id": "0"}, start=0,
            end=time.time() + 10,
        )
        assert len(rows) == 1, "restored and live samples forked the series"
        walls = [t for t, _v in rows[0]["values"]]
        assert len(walls) >= 6  # restored 4 + live 3 (same ring)
        assert walls == sorted(walls)
        assert after <= before + 8  # no wholesale duplication of the store

    def test_checkpoint_plus_wal_dedup(self, tmp_path):
        collector, history, _store, _sups, persister = make_world(
            tmp_path, snapshot_interval_s=0.2, fsync_interval_s=0
        )
        persister.start()
        for _ in range(10):
            collector.poll_once()
            time.sleep(0.05)  # several checkpoint rotations mid-run
        drain(persister)
        assert persister.stats()["snapshots"] >= 1
        orig = series_map(history)
        restored, history2, _ = restore_world(tmp_path)
        # No duplicated samples from records both checkpointed and WAL'd.
        assert series_map(history2) == orig
        assert restored.series > 0

    def test_final_flush_on_close(self, tmp_path):
        collector, history, _store, _sups, persister = make_world(
            tmp_path, fsync_interval_s=1e9  # never fsync on cadence...
        )
        persister.start()
        for _ in range(5):
            collector.poll_once()
        persister.close()  # ...the SIGTERM drain must still make it durable
        orig = series_map(history)
        restored, history2, _ = restore_world(tmp_path)
        assert series_map(history2) == orig
        assert restored.exposition is not None

    def test_breaker_carryover(self, tmp_path):
        collector, _h, _store, sups, persister = make_world(tmp_path)
        persister.start()
        br = sups["device"].breaker
        for _ in range(6):
            br.record_failure()
        assert br.state == "open"
        collector.poll_once()  # on_poll notices the signature change
        drain(persister)
        restored, _h2, sups2 = restore_world(tmp_path)
        br2 = sups2["device"].breaker
        assert br2.state == "open"
        assert br2.reopens == br.reopens
        assert br2.consecutive_failures == br.consecutive_failures
        assert br2.transitions["open"] == br.transitions["open"]
        # The remaining open window carried over (within clock slop).
        assert abs(br2.seconds_until_probe - br.seconds_until_probe) < 1.0

    def test_half_open_restores_as_probe_now(self):
        br = CircuitBreaker(failure_threshold=1)
        br.record_failure()
        while br.decide() != "probe":
            time.sleep(0.01)
        assert br.state == "half_open"
        doc = br.export_state()
        br2 = CircuitBreaker(failure_threshold=1)
        br2.restore_state(doc)
        assert br2.state == "open"
        assert br2.decide() == "probe"  # due immediately

    def test_breaker_restore_tolerates_garbage(self):
        br = CircuitBreaker()
        for doc in (
            {},
            {"state": "bogus"},
            {"state": "open", "open_until_wall": "NaNsense",
             "consecutive_failures": 3, "reopens": 1},
            {"state": "open", "open_until_wall": time.time() + 1e9,
             "consecutive_failures": 1, "reopens": 1},
        ):
            br2 = CircuitBreaker()
            br2.restore_state(doc)
            # clamped: never quarantined past the backoff ceiling
            assert br2.seconds_until_probe <= br2.backoff_max_s + 1.0
        assert br.state == "closed"

    def test_exposition_restored_with_timestamp(self, tmp_path):
        collector, _h, store, _sups, persister = make_world(tmp_path)
        persister.start()
        collector.poll_once()
        ts = store.current().timestamp
        persister.close()
        restored, _h2, _ = restore_world(tmp_path)
        assert restored.exposition_ts == pytest.approx(ts)
        assert b"tpu_exporter_up" in restored.exposition

    def test_empty_dir_cold_start(self, tmp_path):
        restored, history, _ = restore_world(tmp_path / "fresh")
        assert not restored.restored
        assert history.stats()["series"] == 0

    def test_wal_open_failure_counts_drops_and_recovers(self, tmp_path):
        """An unopenable WAL must not silently discard records (the
        TpuExporterPersistenceFailing alert watches errors+dropped), and
        the writer must retry the open on every write — persistence comes
        back as soon as the filesystem does, not at the next rotation."""
        collector, _h, _store, _sups, persister = make_world(tmp_path)
        wal = tmp_path / WAL_NAME
        wal.mkdir()  # open(wal_path, "ab") now raises IsADirectoryError
        persister.start()
        collector.poll_once()
        deadline = time.monotonic() + 5
        while (
            persister.stats()["dropped"] == 0
            and time.monotonic() < deadline
        ):
            time.sleep(0.02)
        st = persister.stats()
        assert st["dropped"] >= 1 and st["errors"] >= 1
        wal.rmdir()  # filesystem "recovers"
        collector.poll_once()
        deadline = time.monotonic() + 5
        while (
            persister.stats()["wal_records"] == 0
            and time.monotonic() < deadline
        ):
            time.sleep(0.02)
        assert persister.stats()["wal_records"] >= 1
        persister.close()

    def test_unwritable_dir_never_raises(self):
        p = StatePersister("/proc/definitely/not/writable")
        restored = p.load()
        assert not restored.restored
        p.start()  # no-op, no crash
        p.close()


# --------------------------------------------------------- torn-write fuzz


class TestTornWriteFuzz:
    def test_random_truncation_and_corruption_always_boots(self, tmp_path):
        """Seeded fuzz: cut or scramble the WAL at random offsets; every
        boot must succeed and restore a consistent prefix — per family,
        every surviving series carries the SAME wall-timestamp sequence (a
        WAL record is all-or-nothing; no partial poll may surface), and
        every sample matches the uncorrupted restore at its position."""
        collector, _h, _store, _sups, persister = make_world(tmp_path)
        persister.start()
        for _ in range(12):
            collector.poll_once()
            time.sleep(0.002)
        drain(persister)
        wal = tmp_path / WAL_NAME
        pristine = wal.read_bytes()
        _, full_hist, _ = restore_world(tmp_path)
        full = series_map(full_hist)

        rng = random.Random(1234)
        for trial in range(25):
            data = bytearray(pristine)
            offset = rng.randrange(len(MAGIC), len(data))
            if trial % 2:
                del data[offset:]  # torn tail
            else:
                for i in range(offset, min(offset + 8, len(data))):
                    data[i] ^= 0xA5  # mid-file scramble
            wal.write_bytes(bytes(data))
            restored, hist, _ = restore_world(tmp_path)
            got = series_map(hist)
            # prefix property per series
            for key, samples in got.items():
                assert key in full, (trial, key)
                assert samples == full[key][: len(samples)], (trial, key)
            # per-poll atomicity: within one metric family, all restored
            # series agree on their timestamp set (no half-applied record)
            by_family: dict[str, set] = {}
            for (metric, _labels), samples in got.items():
                walls = tuple(w for w, _v in samples)
                by_family.setdefault(metric, set()).add(walls)
            for metric, wallsets in by_family.items():
                assert len(wallsets) <= 2, (trial, metric)
                if len(wallsets) == 2:
                    # late-born series (e.g. rate gauges from poll 2): one
                    # set must be a suffix of the other, never interleaved
                    a, b = sorted(wallsets, key=len)
                    assert b[-len(a):] == a if a else True, (trial, metric)
            # restoring a corrupted dir also truncated the WAL to the clean
            # prefix; put the pristine bytes back for the next trial
            wal.write_bytes(pristine)

    def test_query_range_never_sees_partial_record(self, tmp_path):
        collector, _h, _store, _sups, persister = make_world(tmp_path)
        persister.start()
        for _ in range(6):
            collector.poll_once()
            time.sleep(0.002)
        drain(persister)
        wal = tmp_path / WAL_NAME
        data = wal.read_bytes()
        # cut INSIDE the last record's payload
        os.truncate(wal, len(data) - 5)
        _restored, hist, _ = restore_world(tmp_path)
        rows = hist.query_range("tpu_hbm_used_bytes", {}, start=0,
                                end=time.time() + 10)
        walls = {tuple(t for t, _v in r["values"]) for r in rows}
        # every chip's series saw the same polls — the torn poll vanished
        # for all of them, not some of them
        assert len(walls) == 1


# ------------------------------------------------------------- warm start


class TestWarmStart:
    def test_restored_snapshot_patches_markers(self):
        body = (
            b"# HELP tpu_exporter_up x\n# TYPE tpu_exporter_up gauge\n"
            b"tpu_exporter_up 1\n"
            b"# HELP tpu_exporter_warm_start x\n"
            b"# TYPE tpu_exporter_warm_start gauge\n"
            b"tpu_exporter_warm_start 0\n"
            b"# HELP tpu_exporter_snapshot_stale_seconds x\n"
            b"# TYPE tpu_exporter_snapshot_stale_seconds gauge\n"
            b"tpu_exporter_snapshot_stale_seconds 0\n"
            b"# HELP tpu_ici_transferred_bytes_total x\n"
            b"# TYPE tpu_ici_transferred_bytes_total counter\n"
            b"tpu_ici_transferred_bytes_total 5\n"
        )
        ts = time.time() - 12.5
        snap = RestoredSnapshot(body, ts)
        text = snap.encode()
        assert b"tpu_exporter_warm_start 1\n" in text
        assert b"tpu_exporter_warm_start 0\n" not in text
        assert b"tpu_exporter_snapshot_stale_seconds 12." in text
        assert snap.stale_s == pytest.approx(12.5, abs=1.0)
        assert snap.poll_timestamp == ts
        assert snap.timestamp > ts  # serving-time, not data-time
        assert snap.series_count == 4
        om = snap.encode_openmetrics()
        assert om.endswith(b"# EOF\n")
        assert b"# TYPE tpu_ici_transferred_bytes counter" in om
        assert b"tpu_ici_transferred_bytes_total 5" in om  # sample unchanged
        import gzip

        assert gzip.decompress(snap.encode_gzip()) == text

    def test_app_warm_start_end_to_end(self, tmp_path):
        """Full app loop: run, SIGTERM-stop (final flush), rebuild on the
        same state dir — the new app must hold a warm snapshot whose body
        carries the markers, serve it immediately, and flip /readyz to
        warm until the first live poll lands."""
        from tpu_pod_exporter_torch.app import ExporterApp
        from tpu_pod_exporter_torch.config import ExporterConfig

        cfg = ExporterConfig(
            port=0, host="127.0.0.1", backend="fake", fake_chips=2,
            attribution="none", state_dir=str(tmp_path),
            state_fsync_interval_s=0, interval_s=0.1,
            history_retention_s=60.0, trace=False,
        )
        app = ExporterApp(cfg)
        app.collector.poll_once()
        app.persister.start()
        app.persister.close()  # the SIGTERM flush, without sockets
        app.collector.close()

        app2 = ExporterApp(cfg)
        try:
            assert app2._warm_snapshot is not None
            body = app2._warm_snapshot.encode()
            assert b"tpu_exporter_warm_start 1\n" in body
            # Simulate the serving sequence without binding sockets:
            app2.store.swap(app2._warm_snapshot)
            warm = app2._warm_state()
            assert warm is not None and warm["snapshot_stale_s"] >= 0
            # first live poll replaces the restored snapshot → warm ends
            app2.collector.poll_once()
            assert app2._warm_state() is None
            live = app2.store.current().encode()
            assert b"tpu_exporter_warm_start 0\n" in live
        finally:
            app2.persister.close()
            app2.collector.close()

    def test_readyz_reports_warm_then_ready(self, tmp_path):
        import urllib.request

        from tpu_pod_exporter_torch.metrics import (
            MetricSpec,
            SnapshotBuilder,
            SnapshotStore,
        )
        from tpu_pod_exporter_torch.server import MetricsServer

        store = SnapshotStore()
        warm = {"on": True}
        server = MetricsServer(
            store, host="127.0.0.1", port=0,
            warm_fn=lambda: {"snapshot_stale_s": 3.0} if warm["on"] else None,
        )
        server.start()
        try:
            base = f"http://127.0.0.1:{server.port}"

            def readyz():
                try:
                    with urllib.request.urlopen(base + "/readyz", timeout=5) as r:
                        return r.status, json.loads(r.read())
                except urllib.error.HTTPError as e:
                    return e.code, json.loads(e.read())

            status, body = readyz()
            assert status == 503 and body["state"] == "starting"
            b = SnapshotBuilder()
            b.add(MetricSpec(name="m", help="h"), 1.0)
            store.swap(b.build())
            status, body = readyz()
            assert status == 200 and body["state"] == "warm"
            assert body["snapshot_stale_s"] == 3.0
            warm["on"] = False
            status, body = readyz()
            assert status == 200 and body["state"] == "ready"
        finally:
            server.stop()


# ---------------------------------------------------------- phase isolation


class TestPhaseIsolation:
    def test_persist_excluded_from_publish_and_total(self, tmp_path):
        _c, history, store, sups, persister = make_world(tmp_path)
        slow_called = {"n": 0}

        class SlowPersister:
            @staticmethod
            def on_poll(snap):
                slow_called["n"] += 1
                time.sleep(0.08)
                return 1

            @staticmethod
            def stats():
                return {
                    "wal_records": 0, "wal_bytes": 0, "snapshots": 0,
                    "errors": 0, "dropped": 0, "last_fsync_s": 0.0,
                    "last_snapshot_wall": 0.0,
                }

        collector = Collector(
            FakeBackend(chips=2), FakeAttribution(), SnapshotStore(),
            history=history, persister=SlowPersister(),
        )
        stats = collector.poll_once()
        assert slow_called["n"] == 1
        # the 80 ms persist sleep must not appear in any poll phase timing
        assert stats.publish_s < 0.05
        assert stats.total_s < 0.05

    def test_poll_survives_broken_persister(self):
        class BrokenPersister:
            @staticmethod
            def on_poll(snap):
                raise OSError("disk on fire")

            @staticmethod
            def stats():
                raise OSError("still on fire")

        collector = Collector(
            FakeBackend(chips=2), FakeAttribution(), SnapshotStore(),
            persister=BrokenPersister(),
        )
        stats = collector.poll_once()
        assert stats.ok  # neither on_poll nor stats() can fail a poll

    def test_state_dir_empty_disables_layer(self):
        from tpu_pod_exporter_torch.app import ExporterApp
        from tpu_pod_exporter_torch.config import ExporterConfig

        cfg = ExporterConfig(
            port=0, host="127.0.0.1", backend="fake", fake_chips=0,
            attribution="none", trace=False,
        )
        assert cfg.state_dir == ""
        app = ExporterApp(cfg)
        try:
            assert app.persister is None
            app.collector.poll_once()
            body = app.store.current().encode()
            # persist self-metrics absent; warm markers present (live, 0)
            assert b"tpu_exporter_persist_wal_bytes" not in body
            assert b"tpu_exporter_warm_start 0\n" in body
        finally:
            app.collector.close()

    def test_persist_metrics_published_when_enabled(self, tmp_path):
        collector, _h, store, _sups, persister = make_world(tmp_path)
        persister.start()
        collector.poll_once()
        drain(persister)
        collector.poll_once()  # stats land one poll behind
        body = store.current().encode()
        assert b"tpu_exporter_persist_wal_records_total" in body
        assert b"tpu_exporter_persist_wal_bytes" in body
        persister.close()


# -------------------------------------------------- aggregator breaker file


class TestBreakerStateFile:
    def test_roundtrip(self, tmp_path):
        from tpu_pod_exporter_torch.persist import BreakerStateFile

        f = BreakerStateFile(str(tmp_path / "b.json"))
        br = CircuitBreaker(failure_threshold=1)
        br.record_failure()
        f.save({"h0:8000": br.export_state()})
        loaded = f.load()
        br2 = CircuitBreaker(failure_threshold=1)
        br2.restore_state(loaded["h0:8000"])
        assert br2.state == "open"

    def test_corrupt_file_loads_empty(self, tmp_path):
        from tpu_pod_exporter_torch.persist import BreakerStateFile

        path = tmp_path / "b.json"
        path.write_text("{not json")
        assert BreakerStateFile(str(path)).load() == {}
        path.write_text('["wrong shape"]')
        assert BreakerStateFile(str(path)).load() == {}


# ------------------------------------------------------------ chaos tokens


class TestChaosKill:
    def test_kill_kind_and_offset_parse(self):
        from tpu_pod_exporter_torch.chaos import parse_chaos_spec

        rules = parse_chaos_spec("kill:device:1:@20:x1")
        assert rules[0].kind == "kill"
        assert rules[0].min_index == 20
        assert rules[0].max_count == 1

    def test_offset_defers_injection(self):
        from tpu_pod_exporter_torch.chaos import ChaosError, ChaosWrapper, parse_chaos_spec

        class Inner:
            name = "inner"

            @staticmethod
            def sample():
                return "ok"

        rules = parse_chaos_spec("err:device:1:@3")
        w = ChaosWrapper(Inner(), "device", rules, seed=1)
        for _ in range(3):
            assert w.sample() == "ok"  # calls 0..2: rule not armed yet
        with pytest.raises(ChaosError):
            w.sample()  # call 3: armed
        assert w.injected[0] == (3, "err")

    def test_bad_offset_token_loud(self):
        from tpu_pod_exporter_torch.chaos import parse_chaos_spec

        with pytest.raises(ValueError):
            parse_chaos_spec("err:device:@nope")


# --------------------------------------------------------------- dir summary


class TestStateDirSummary:
    def test_missing_dir(self, tmp_path):
        s = state_dir_summary(str(tmp_path / "nope"))
        assert s["exists"] is False

    def test_sizes_and_age(self, tmp_path):
        collector, _h, _store, _sups, persister = make_world(
            tmp_path, snapshot_interval_s=0.05
        )
        persister.start()
        collector.poll_once()
        deadline = time.monotonic() + 5
        while (
            persister.stats()["snapshots"] == 0
            and time.monotonic() < deadline
        ):
            collector.poll_once()
            time.sleep(0.05)
        persister.close()
        s = state_dir_summary(str(tmp_path))
        assert s["exists"] and s["snapshot_bytes"] > 0
        assert s["snapshot_age_s"] is not None and s["snapshot_age_s"] < 60
        assert s["total_bytes"] >= s["snapshot_bytes"]



# ------------------------------------------------------- the two packages


def _jax_world(state_dir):
    from tpu_pod_exporter.attribution.fake import FakeAttribution as JaxAttribution
    from tpu_pod_exporter.backend.fake import FakeBackend as JaxBackend
    from tpu_pod_exporter.collector import Collector as JaxCollector
    from tpu_pod_exporter.history import HistoryStore as JaxHistory
    from tpu_pod_exporter.metrics import SnapshotStore as JaxSnapshotStore
    from tpu_pod_exporter.persist import StatePersister as JaxPersister
    from tpu_pod_exporter.supervisor import SourceSupervisor as JaxSupervisor

    history = JaxHistory(capacity=128, retention_s=0.0)
    store = JaxSnapshotStore()
    supervisors = {"device": JaxSupervisor("device", lambda: None)}
    persister = JaxPersister(str(state_dir), history=history, supervisors=supervisors,
                             exposition_fn=store.current, snapshot_interval_s=1e9,
                             fsync_interval_s=0)
    collector = JaxCollector(JaxBackend(chips=2), JaxAttribution(), store,
                             history=history, persister=persister)
    return collector, history, store, supervisors, persister


def _jax_restore(state_dir):
    from tpu_pod_exporter.history import HistoryStore as JaxHistory
    from tpu_pod_exporter.persist import StatePersister as JaxPersister
    from tpu_pod_exporter.supervisor import SourceSupervisor as JaxSupervisor

    history = JaxHistory(capacity=128, retention_s=0.0)
    persister = JaxPersister(str(state_dir), history=history,
                             supervisors={"device": JaxSupervisor("device", lambda: None)})
    return persister.load(), history


def _write(world, polls, checkpoint):
    collector, history, _store, _sups, persister = world
    persister.start()
    for _ in range(polls):
        collector.poll_once()
    drain(persister)
    if checkpoint:
        persister.close()  # writes the final checkpoint
    # else a crash: no close(), the WAL only
    return series_map(history)


class TestStateDirAcrossPackages:
    @pytest.mark.parametrize("checkpoint", [True, False], ids=["checkpoint", "wal"])
    def test_jax_state_restores_in_the_port(self, tmp_path, checkpoint):
        world = _jax_world(tmp_path)
        want = _write(world, 5, checkpoint)
        restored, history, _sups = restore_world(tmp_path)
        assert restored.restored
        assert series_map(history) == want
        assert len(want) > 10
        if not checkpoint:
            world[4].close()

    @pytest.mark.parametrize("checkpoint", [True, False], ids=["checkpoint", "wal"])
    def test_port_state_restores_in_jax(self, tmp_path, checkpoint):
        world = make_world(tmp_path)
        want = _write(world, 5, checkpoint)
        restored, history = _jax_restore(tmp_path)
        assert restored.restored
        assert series_map(history) == want
        assert len(want) > 10
        if not checkpoint:
            world[4].close()

    def test_restored_exposition_is_the_same_bytes(self, tmp_path):
        world = _jax_world(tmp_path)
        _write(world, 3, checkpoint=True)
        jax_restored, _history = _jax_restore(tmp_path)
        port_restored, _history, _sups = restore_world(tmp_path)
        assert port_restored.exposition == jax_restored.exposition
        assert port_restored.exposition


def _gpu_world(pkg, state_dir):
    """A collector over one simulated NVML card, persisting into state_dir."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    history = mod("history").HistoryStore(capacity=128, retention_s=0.0)
    store = mod("metrics").SnapshotStore()
    persister = mod("persist").StatePersister(
        str(state_dir), history=history, supervisors={}, exposition_fn=store.current,
        snapshot_interval_s=1e9, fsync_interval_s=0)
    nvml = mod("backend.nvml")
    collector = mod("collector").Collector(
        nvml.NvmlBackend(driver=nvml.SimulatedNvmlDriver(2)),
        mod("attribution.fake").FakeAttribution(), store, history=history,
        persister=persister)
    return collector, history, store, {}, persister


def _gpu_labels(history):
    return sorted(tuple(sorted(labels)) for metric, labels, _s in history.export_series()
                  if metric == "gpu_hbm_used_bytes")


class TestGpuSeriesFromTheWal:
    @pytest.mark.parametrize("writer", ["tpu_pod_exporter", "tpu_pod_exporter_torch"])
    def test_port_restores_gpu_labels(self, tmp_path, writer):
        world = _gpu_world(writer, tmp_path)
        want = _write(world, 3, checkpoint=False)
        _restored, history, _sups = restore_world(tmp_path, supervise=False)
        assert series_map(history) == want
        got = _gpu_labels(history)
        assert got == _gpu_labels(world[1])
        assert len(got) == 2 and all(got)  # one labeled series a card
        world[4].close()

    def test_reference_drops_gpu_labels(self, tmp_path):
        world = _gpu_world("tpu_pod_exporter_torch", tmp_path)
        _write(world, 3, checkpoint=False)
        _restored, history = _jax_restore(tmp_path)
        assert _gpu_labels(history) == [()]  # both cards fold into one label-less series
        world[4].close()
