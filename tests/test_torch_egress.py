"""The port's remote-write egress held against the JAX package's.

The cases of tests/test_egress.py run against ``tpu_pod_exporter_torch.egress``
with the imports renamed. Then the two packages' shippers
take the same snapshots and must frame the same batches and put the same
remote-write payload bytes on the wire.
"""

import json
import os
import random
import time

import pytest

from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
from tpu_pod_exporter_torch.backend.fake import FakeBackend
from tpu_pod_exporter_torch.chaos import ChaosReceiver, parse_chaos_spec
from tpu_pod_exporter_torch.collector import Collector
from tpu_pod_exporter_torch.egress import (
    RemoteWriteShipper,
    aggregator_egress_metrics,
    egress_dir_summary,
    encode_write_request,
    exporter_egress_metrics,
    frame_batch,
    parse_batch,
    parse_write_request,
    snappy_compress,
    snappy_decompress,
)
from tpu_pod_exporter_torch.metrics import SnapshotStore
from tpu_pod_exporter_torch.persist import MAGIC, WalBuffer
from tpu_pod_exporter_torch.supervisor import CircuitBreaker


def wait_for(predicate, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


# ---------------------------------------------------------------- the codecs


class TestSnappy:
    @pytest.mark.parametrize("data", [
        b"",
        b"x",
        b"hello world",
        b"abcd" * 5000,                      # highly compressible
        bytes(range(256)) * 300,             # mildly compressible
        os.urandom(100_000),                 # incompressible
        b"a" * 70_000,                       # one long run, >64K literals
    ])
    def test_roundtrip(self, data):
        assert snappy_decompress(snappy_compress(data)) == data

    def test_compresses_repetitive_input(self):
        data = b"tpu_hbm_used_bytes" * 2000
        assert len(snappy_compress(data)) < len(data) / 5

    def test_decoder_handles_copy_elements(self):
        # 2-byte-offset copy built by the encoder itself.
        out = snappy_compress(b"0123456789" * 20)
        assert snappy_decompress(out) == b"0123456789" * 20

    def test_decoder_rejects_garbage(self):
        with pytest.raises(ValueError):
            snappy_decompress(b"\xff\xff\xff\xff\xff")
        with pytest.raises(ValueError):
            # valid preamble, truncated literal
            snappy_decompress(b"\x0a\xfc")

    def test_decoder_rejects_bad_copy_offset(self):
        # preamble len=4, copy-1 with offset 0
        with pytest.raises(ValueError):
            snappy_decompress(b"\x04" + bytes([0x01, 0x00]))


class TestRemoteWriteProto:
    def test_roundtrip(self):
        series = [
            ([("__name__", "tpu_hbm_used_bytes"), ("chip_id", "3"),
              ("host", "h0")],
             [(1234.5, 1_700_000_000_000)]),
            ([("__name__", "tpu_exporter_up")],
             [(1.0, 1_700_000_000_000), (0.0, 1_700_000_001_000)]),
        ]
        out = parse_write_request(encode_write_request(series))
        assert out[0][0] == {"__name__": "tpu_hbm_used_bytes",
                             "chip_id": "3", "host": "h0"}
        assert out[0][1] == [(1234.5, 1_700_000_000_000)]
        assert out[1][1] == [(1.0, 1_700_000_000_000),
                             (0.0, 1_700_000_001_000)]

    def test_labels_sorted_on_wire(self):
        # remote-write requires lexically sorted labels; feed them reversed
        series = [([("zebra", "1"), ("__name__", "tpu_exporter_up")],
                   [(1.0, 1)])]
        encoded = encode_write_request(series)
        # __name__ must appear before zebra in the byte stream
        assert encoded.index(b"__name__") < encoded.index(b"zebra")

    def test_batch_frame_roundtrip(self):
        proto = encode_write_request(
            [([("__name__", "tpu_exporter_up")], [(1.0, 5)])]
        )
        head, body = parse_batch(frame_batch(7, 123.5, "delta", 1, proto))
        assert head == {"seq": 7, "wall": 123.5, "kind": "delta",
                        "samples": 1, "mono": 0.0}
        assert body == proto

    def test_parse_batch_rejects_foreign(self):
        with pytest.raises(ValueError):
            parse_batch(b"S-not-a-batch")

    def test_truncated_sample_raises_valueerror_not_struct_error(self):
        encoded = encode_write_request(
            [([("__name__", "tpu_exporter_up")], [(1.0, 5)])]
        )
        # cut inside the Sample's fixed64 value: every truncation must
        # surface as the documented ValueError (the chaos receiver's 400
        # path catches exactly that), never a bare struct.error
        for cut in range(1, len(encoded)):
            try:
                parse_write_request(encoded[:cut])
            except ValueError:
                pass


# ----------------------------------------------------------- the send buffer


class TestWalBuffer:
    def test_fifo_across_segments(self, tmp_path):
        b = WalBuffer(str(tmp_path), segment_max_bytes=128)
        b.open()
        for i in range(30):
            b.append(b"p%03d" % i * 8)
        got = []
        while b.peek() is not None:
            got.append(b.peek())
            b.ack()
        assert got == [b"p%03d" % i * 8 for i in range(30)]
        b.close()

    def test_restart_resumes_pending_not_acked(self, tmp_path):
        b = WalBuffer(str(tmp_path), segment_max_bytes=128)
        b.open()
        for i in range(10):
            b.append(b"rec-%d" % i)
        for _ in range(4):
            b.ack()
        b.close()
        b2 = WalBuffer(str(tmp_path), segment_max_bytes=128)
        info = b2.open()
        assert info["pending"] == 6
        assert b2.peek() == b"rec-4"
        b2.close()

    def test_fully_acked_segments_unlinked(self, tmp_path):
        b = WalBuffer(str(tmp_path), segment_max_bytes=64)
        b.open()
        for i in range(20):
            b.append(b"x" * 40)
        while b.peek() is not None:
            b.ack()
        segs = [n for n in os.listdir(tmp_path) if n.startswith("seg-")]
        # only the active segment may remain
        assert len(segs) <= 1
        b.close()

    def test_seal_active_reclaims_acked_bytes_without_append(self, tmp_path):
        """With a large segment cap, everything acked still sits in the
        never-rotated active segment — and rotation is append-lazy, so a
        stalled producer strands those bytes forever. seal_active must
        reclaim them on demand (the disk-pressure path's fix, found by
        the scenario fuzzer's one-round disk_full windows)."""
        b = WalBuffer(str(tmp_path), segment_max_bytes=1 << 20)
        b.open()
        for i in range(20):
            b.append(b"y" * 200)
        while b.peek() is not None:
            b.ack()
        segs = [n for n in os.listdir(tmp_path) if n.startswith("seg-")]
        assert len(segs) == 1  # acked bytes stranded in the active segment
        freed = b.seal_active()
        assert freed > 0
        assert not [n for n in os.listdir(tmp_path) if n.startswith("seg-")]
        # The sealed buffer keeps working: fresh appends land and survive.
        b.append(b"fresh")
        assert b.peek() == b"fresh"
        b.close()
        b2 = WalBuffer(str(tmp_path), segment_max_bytes=1 << 20)
        assert b2.open()["pending"] == 1
        b2.close()

    def test_seal_active_keeps_pending_records(self, tmp_path):
        """Sealing must never drop or re-order unacked records."""
        b = WalBuffer(str(tmp_path), segment_max_bytes=1 << 20)
        b.open()
        for i in range(6):
            b.append(b"rec-%d" % i)
        for _ in range(2):
            b.ack()
        assert b.seal_active() == 0  # pending head pins the sealed segment
        got = []
        while b.peek() is not None:
            got.append(b.peek())
            b.ack()
        assert got == [b"rec-%d" % i for i in range(2, 6)]
        b.close()

    def test_drained_buffer_restart_does_not_swallow_new(self, tmp_path):
        b = WalBuffer(str(tmp_path))
        b.open()
        for i in range(3):
            b.append(b"old-%d" % i)
        while b.peek() is not None:
            b.ack()
        b.close()
        b2 = WalBuffer(str(tmp_path))
        assert b2.open()["pending"] == 0
        b2.append(b"fresh")
        b2.close()
        b3 = WalBuffer(str(tmp_path))
        assert b3.open()["pending"] == 1
        assert b3.peek() == b"fresh"
        b3.close()

    def test_multi_segment_advance_unlinks_all_acked(self, tmp_path):
        """One cursor advance crossing many segments (the age-cap trim
        after a long outage) must reclaim EVERY fully-acked segment now,
        not at the next boot."""
        b = WalBuffer(str(tmp_path), segment_max_bytes=64)
        b.open()
        for i in range(40):
            b.append(b"x" * 40)  # one record per segment
        segs_before = sum(1 for n in os.listdir(tmp_path)
                          if n.startswith("seg-"))
        assert segs_before >= 15  # 2 records per 64-byte segment
        assert b.drop_oldest(35) == 35
        # 5 records remain => at most 3-4 segment files may survive; all
        # the fully-acked ones must be gone NOW, not at the next boot
        segs_after = sum(1 for n in os.listdir(tmp_path)
                         if n.startswith("seg-"))
        assert segs_after <= 4
        # the survivors still drain correctly
        n = 0
        while b.peek() is not None:
            b.ack()
            n += 1
        assert n == 5
        b.close()

    def test_drop_oldest(self, tmp_path):
        b = WalBuffer(str(tmp_path))
        b.open()
        for i in range(5):
            b.append(b"d-%d" % i)
        assert b.drop_oldest(2) == 2
        assert b.peek() == b"d-2"
        assert b.pending() == 3
        b.close()

    def test_peek_last(self, tmp_path):
        b = WalBuffer(str(tmp_path), segment_max_bytes=64)
        b.open()
        for i in range(9):
            b.append(b"t-%d" % i * 6)
        assert b.peek_last() == b"t-8" * 6
        b.close()

    def test_torn_tail_keeps_prefix_and_appends_continue(self, tmp_path):
        b = WalBuffer(str(tmp_path))
        b.open()
        for i in range(6):
            b.append(b"keep-%d" % i)
        b.close()
        seg = os.path.join(tmp_path, "seg-00000000.wal")
        os.truncate(seg, os.path.getsize(seg) - 3)
        b2 = WalBuffer(str(tmp_path))
        info = b2.open()
        assert info["pending"] == 5
        assert info["corrupt_segments"] == 1
        b2.append(b"after-tear")
        drained = []
        while b2.peek() is not None:
            drained.append(b2.peek())
            b2.ack()
        assert drained == [b"keep-%d" % i for i in range(5)] + [b"after-tear"]
        b2.close()


class TestSendBufferFuzz:
    """Satellite: truncate/scramble the egress WAL at random offsets —
    the shipper-side buffer always boots, drains a clean prefix, and never
    re-delivers an acked batch (the test_persist torn-write pattern)."""

    def test_random_corruption_always_boots_prefix_only(self, tmp_path):
        payloads = [frame_batch(i + 1, 100.0 + i, "delta", 1,
                                b"proto-%02d" % i * 11)
                    for i in range(14)]
        b = WalBuffer(str(tmp_path), segment_max_bytes=256)
        b.open()
        for p in payloads:
            b.append(p)
        acked = 4
        for _ in range(acked):
            b.ack()
        b.close()
        seg_files = sorted(
            n for n in os.listdir(tmp_path) if n.startswith("seg-")
        )
        pristine = {
            n: (tmp_path / n).read_bytes() for n in seg_files
        }
        cursor = (tmp_path / "cursor.json").read_bytes()
        acked_seqs = {h["seq"] for h in
                      (parse_batch(p)[0] for p in payloads[:acked])}
        expected_rest = [parse_batch(p)[0]["seq"] for p in payloads[acked:]]

        rng = random.Random(4321)
        for trial in range(25):
            name = seg_files[rng.randrange(len(seg_files))]
            data = bytearray(pristine[name])
            offset = rng.randrange(len(MAGIC), len(data))
            if trial % 2:
                del data[offset:]
            else:
                for i in range(offset, min(offset + 6, len(data))):
                    data[i] ^= 0xA5
            (tmp_path / name).write_bytes(bytes(data))

            b2 = WalBuffer(str(tmp_path), segment_max_bytes=256)
            b2.open()  # must never raise
            got = []
            while True:
                p = b2.peek()
                if p is None:
                    break
                try:
                    got.append(parse_batch(p)[0]["seq"])
                except ValueError:
                    pass
                b2.ack()
            b2.close()
            # never re-delivers an acked batch...
            assert not (set(got) & acked_seqs), (trial, got)
            # ...and what survives is a subsequence of the pending batches
            # (corruption may drop a contiguous chunk, never reorder or
            # invent)
            it = iter(expected_rest)
            assert all(any(seq == e for e in it) for seq in got), (trial, got)
            # restore pristine state (incl. cursor — acks above moved it)
            for n, data0 in pristine.items():
                (tmp_path / n).write_bytes(data0)
            (tmp_path / "cursor.json").write_bytes(cursor)

    def test_acked_never_resent_across_corrupt_restart(self, tmp_path):
        """Deliver some batches through a real shipper, corrupt the dir,
        restart: the receiver's ledger must stay duplicate-free."""
        recv = ChaosReceiver([], seed=0)
        recv.start()
        try:
            sh = RemoteWriteShipper(recv.url, str(tmp_path), interval_s=0.0,
                                    timeout_s=2.0)
            sh.load()
            for i in range(5):
                sh.buffer.append(frame_batch(
                    i + 1, time.time(), "delta", 1,
                    encode_write_request(
                        [([("__name__", "tpu_exporter_up")], [(1.0, i)])]
                    ),
                ))
            sh.start()
            assert wait_for(lambda: sh.buffer.pending() == 0)
            sh.close()
            # scramble whatever remains on disk mid-file
            for name in os.listdir(tmp_path):
                if name.startswith("seg-"):
                    path = tmp_path / name
                    data = bytearray(path.read_bytes())
                    if len(data) > len(MAGIC) + 4:
                        data[len(MAGIC) + 2] ^= 0xFF
                        path.write_bytes(bytes(data))
            sh2 = RemoteWriteShipper(recv.url, str(tmp_path),
                                     interval_s=0.0, timeout_s=2.0)
            sh2.load()
            sh2.start()
            time.sleep(0.3)
            sh2.close()
            stats = recv.stats()
            assert stats["accepted_seqs"] == [1, 2, 3, 4, 5]
            assert not stats["duplicate_seqs"]
            assert not stats["duplicate_samples"]
        finally:
            recv.stop()


# --------------------------------------------------------------- the shipper


class FakeSnap:
    """Minimal Snapshot stand-in: samples_view + timestamps."""

    def __init__(self, ts, **families):
        self.timestamp = ts
        self.poll_timestamp = ts
        self._families = families

    def samples_view(self, name):
        return self._families.get(name)


def up_snap(ts, up=1.0, hbm=None):
    fams = {"tpu_exporter_up": {(): up}}
    if hbm is not None:
        fams["tpu_hbm_used_bytes"] = hbm
    return FakeSnap(ts, **fams)


class CollectingSend:
    def __init__(self, status=200, fail_until=0):
        self.calls = []
        self.status = status
        self.fail_until = fail_until

    def __call__(self, url, body, headers, timeout_s):
        seq = int(headers["X-Tpe-Egress-Seq"])
        if len(self.calls) < self.fail_until:
            self.calls.append(("fail", seq))
            raise ConnectionError("injected")
        self.calls.append(("ok", seq))
        self.last_series = parse_write_request(snappy_decompress(body))
        if self.status != 200:
            import urllib.error

            raise urllib.error.HTTPError(url, self.status, "injected",
                                         hdrs=None, fp=None)
        return self.status


def make_shipper(tmp_path, send, **kw):
    kw.setdefault("interval_s", 0.0)
    # Tests drive synthetic wall timestamps (100.0, ...) against the real
    # clock; the age cap would read those as hours-old and drop them.
    kw.setdefault("max_backlog_age_s", 0.0)
    kw.setdefault("breaker", CircuitBreaker(
        failure_threshold=2, backoff_base_s=0.05, backoff_max_s=0.1))
    sh = RemoteWriteShipper("http://recv.invalid/w", str(tmp_path),
                            send=send, **kw)
    sh.load()
    return sh


class TestShipperBatching:
    def test_first_batch_full_then_delta_with_heartbeat(self, tmp_path):
        send = CollectingSend()
        sh = make_shipper(tmp_path, send)
        key = ("0", "/dev/accel0", "v", "s", "h", "0", "", "", "")
        sh._write_snapshot(up_snap(100.0, hbm={key: 5.0}))
        sh._write_snapshot(up_snap(101.0, hbm={key: 5.0}))   # unchanged
        sh._write_snapshot(up_snap(102.0, hbm={key: 9.0}))   # hbm changed
        batches = []
        while True:
            p = sh.buffer.peek()
            if p is None:
                break
            batches.append(parse_batch(p))
            sh.buffer.ack()
        assert [h["kind"] for h, _ in batches] == ["full", "delta", "delta"]
        assert batches[0][0]["samples"] == 2
        # unchanged poll ships only the up heartbeat
        series = parse_write_request(batches[1][1])
        assert [s[0]["__name__"] for s in series] == ["tpu_exporter_up"]
        # changed poll ships hbm + heartbeat
        names = sorted(s[0]["__name__"]
                       for s in parse_write_request(batches[2][1]))
        assert names == ["tpu_exporter_up", "tpu_hbm_used_bytes"]
        sh.close()

    def test_layout_change_forces_full(self, tmp_path):
        sh = make_shipper(tmp_path, CollectingSend())
        k0 = ("0",) + ("",) * 8
        k1 = ("1",) + ("",) * 8
        sh._write_snapshot(up_snap(100.0, hbm={k0: 1.0}))
        sh._write_snapshot(up_snap(101.0, hbm={k0: 1.0, k1: 2.0}))
        heads = []
        while sh.buffer.peek() is not None:
            heads.append(parse_batch(sh.buffer.peek())[0])
            sh.buffer.ack()
        assert [h["kind"] for h in heads] == ["full", "full"]
        sh.close()

    def test_periodic_full_sync(self, tmp_path):
        sh = make_shipper(tmp_path, CollectingSend(), full_sync_s=10.0)
        sh._write_snapshot(up_snap(100.0))
        sh._write_snapshot(up_snap(105.0))   # inside window: delta
        sh._write_snapshot(up_snap(111.0))   # window elapsed: full again
        heads = []
        while sh.buffer.peek() is not None:
            heads.append(parse_batch(sh.buffer.peek())[0]["kind"])
            sh.buffer.ack()
        assert heads == ["full", "delta", "full"]
        sh.close()

    def test_interval_thins_batches(self, tmp_path):
        sh = make_shipper(tmp_path, CollectingSend(), interval_s=5.0)
        for ts in (100.0, 101.0, 102.0, 106.0):
            sh._write_snapshot(up_snap(ts, up=ts))  # value always changes
        assert sh.buffer.pending() == 2  # 100.0 and 106.0
        sh.close()

    def test_extra_labels_fill_only_missing(self, tmp_path):
        send = CollectingSend()
        sh = make_shipper(tmp_path, send,
                          extra_labels={"host": "me", "slice_name": "sl"})
        key = ("0", "/dev/accel0", "v", "s", "OTHER", "0", "", "", "")
        sh._write_snapshot(up_snap(100.0, hbm={key: 5.0}))
        sh.start()
        assert wait_for(lambda: sh.buffer.pending() == 0)
        sh.close()
        by_name = {s[0]["__name__"]: s[0] for s in send.last_series}
        assert by_name["tpu_exporter_up"]["host"] == "me"
        # the chip series already carries host="OTHER"; not overwritten
        assert by_name["tpu_hbm_used_bytes"]["host"] == "OTHER"


class TestShipperSending:
    def test_outage_then_recovery_zero_loss(self, tmp_path):
        send = CollectingSend(fail_until=5)
        sh = make_shipper(tmp_path, send)
        for i in range(6):
            sh._write_snapshot(up_snap(100.0 + i, up=float(i)))
        assert sh.buffer.pending() == 6
        sh.start()
        assert wait_for(lambda: sh.buffer.pending() == 0, timeout=15)
        sh.close()
        oks = [seq for kind, seq in send.calls if kind == "ok"]
        assert oks == [1, 2, 3, 4, 5, 6]
        st = sh.stats()
        assert st["failed_sends"] >= 2  # breaker throttled the rest
        assert st["sent_batches"] == 6
        assert st["breaker_state"] == "closed"

    def test_breaker_opens_on_failures(self, tmp_path):
        send = CollectingSend(fail_until=10**9)
        sh = make_shipper(tmp_path, send)
        sh._write_snapshot(up_snap(100.0))
        sh.start()
        assert wait_for(lambda: sh.breaker.state != "closed", timeout=5)
        # breaker-gated: attempts are throttled, not one per loop spin
        time.sleep(0.3)
        attempts = len(send.calls)
        assert attempts < 30
        sh.close()
        assert sh.stats()["backlog_batches"] == 1  # nothing lost

    def test_poison_4xx_skipped_not_wedged(self, tmp_path):
        class PoisonSecond(CollectingSend):
            def __call__(self, url, body, headers, timeout_s):
                seq = int(headers["X-Tpe-Egress-Seq"])
                if seq == 2:
                    import urllib.error

                    self.calls.append(("poison", seq))
                    raise urllib.error.HTTPError(url, 400, "bad", None, None)
                return super().__call__(url, body, headers, timeout_s)

        send = PoisonSecond()
        sh = make_shipper(tmp_path, send)
        for i in range(3):
            sh._write_snapshot(up_snap(100.0 + i, up=float(i)))
        sh.start()
        assert wait_for(lambda: sh.buffer.pending() == 0, timeout=10)
        sh.close()
        st = sh.stats()
        assert st["dropped"]["poison"] == 1
        assert st["sent_batches"] == 2
        assert [s for k, s in send.calls if k == "ok"] == [1, 3]
        # poison does not open the breaker: the receiver is UP
        assert st["breaker_state"] == "closed"

    def test_429_is_retried_not_dropped(self, tmp_path):
        state = {"n": 0}

        def send(url, body, headers, timeout_s):
            state["n"] += 1
            if state["n"] <= 2:
                import urllib.error

                raise urllib.error.HTTPError(url, 429, "slow down", None,
                                             None)
            return 200

        sh = make_shipper(tmp_path, send)
        sh._write_snapshot(up_snap(100.0))
        sh.start()
        assert wait_for(lambda: sh.buffer.pending() == 0, timeout=10)
        sh.close()
        st = sh.stats()
        assert st["sent_batches"] == 1
        assert st["failed_sends"] == 2
        assert st["dropped"]["poison"] == 0

    def test_backlog_byte_cap_drops_oldest(self, tmp_path):
        sh = make_shipper(tmp_path, CollectingSend(fail_until=10**9),
                          max_backlog_mb=0.0005)  # ~512 bytes
        for i in range(20):
            sh._write_snapshot(up_snap(100.0 + i, up=float(i)))
        sh._enforce_caps()  # normally the sender thread's loop does this
        st = sh.stats()
        assert st["dropped"]["backlog"] > 0
        assert st["backlog_bytes"] <= 512 + 200  # cap + one batch slack
        sh.close()

    def test_backlog_age_cap_drops_oldest(self, tmp_path):
        # Batches created by THIS process age on the MONOTONIC clock (the
        # clock-step fence: an NTP wall step must never mass-drop a
        # healthy backlog), so the outage is simulated by advancing both
        # clocks together — the honest shape of 100 s actually passing.
        clock = {"wall": 1000.0, "mono": 500.0}
        sh = make_shipper(tmp_path, CollectingSend(fail_until=10**9),
                          max_backlog_age_s=50.0,
                          wallclock=lambda: clock["wall"],
                          clock=lambda: clock["mono"])
        sh._write_snapshot(up_snap(1000.0))
        sh._peek_meta()  # sender-side head refresh (reads the mono stamp)
        clock["wall"] = 1100.0  # 100 s pass (both clocks)
        clock["mono"] = 600.0
        sh._write_snapshot(up_snap(1100.0))
        sh._enforce_caps()  # normally the sender thread's loop does this
        st = sh.stats()
        assert st["dropped"]["backlog"] == 1
        assert st["backlog_batches"] == 1
        sh.close()

    def test_wall_step_does_not_mass_drop_backlog(self, tmp_path):
        # The fence itself: a +1 h WALL step with no real time passing
        # must not age-cap-drop batches this process created.
        clock = {"wall": 1000.0, "mono": 500.0}
        sh = make_shipper(tmp_path, CollectingSend(fail_until=10**9),
                          max_backlog_age_s=50.0,
                          wallclock=lambda: clock["wall"],
                          clock=lambda: clock["mono"])
        sh._write_snapshot(up_snap(1000.0))
        sh._peek_meta()
        clock["wall"] = 1000.0 + 3600.0  # NTP step, zero monotonic time
        sh._enforce_caps()
        st = sh.stats()
        assert st["dropped"]["backlog"] == 0
        assert st["backlog_batches"] == 1
        assert st["backlog_age_s"] == 0.0  # fenced, not 3600
        sh.close()

    def test_slow_drain_backlog_age_is_true_enqueue_age(self, tmp_path):
        # A draining backlog's head age must be the time since ENQUEUE,
        # not since the batch became head: a receiver accepting slower
        # than the batch rate would otherwise report a perpetual ~0 age
        # and the age cap/alert would never see the growing staleness.
        clock = {"wall": 1000.0, "mono": 500.0}
        sh = make_shipper(tmp_path, CollectingSend(fail_until=10**9),
                          wallclock=lambda: clock["wall"],
                          clock=lambda: clock["mono"])
        sh._write_snapshot(up_snap(1000.0))
        clock["wall"] += 300.0
        clock["mono"] += 300.0
        sh._write_snapshot(up_snap(1300.0))
        sh._peek_meta()  # a drain step re-reads the head: age must hold
        assert sh.backlog_age_s() == pytest.approx(300.0)
        sh.close()

    def test_forward_step_sheds_only_genuinely_over_age(self, tmp_path):
        # The age-cap SCAN is fenced like the trigger: with a genuinely
        # over-age head AND a +1 h wall step, only the over-age prefix
        # drops — never the fresh batches behind it.
        clock = {"wall": 1000.0, "mono": 500.0}
        sh = make_shipper(tmp_path, CollectingSend(fail_until=10**9),
                          max_backlog_age_s=50.0,
                          wallclock=lambda: clock["wall"],
                          clock=lambda: clock["mono"])
        sh._write_snapshot(up_snap(1000.0))
        clock["wall"] += 55.0
        clock["mono"] += 55.0
        sh._write_snapshot(up_snap(1055.0))   # fresh batch
        clock["wall"] += 3600.0               # NTP step, no real time
        sh._peek_meta()
        sh._enforce_caps()
        st = sh.stats()
        assert st["dropped"]["backlog"] == 1  # only the 55 s-old head
        assert st["backlog_batches"] == 1
        sh.close()

    def test_backward_wall_step_does_not_stall_shipping(self, tmp_path):
        # A backward step must not park the interval gate: without the
        # clamp, `wall - last_batch_wall` stays negative until the clock
        # catches back up and egress silently stops for the step width.
        send = CollectingSend()
        sh = make_shipper(tmp_path, send, interval_s=1.0)
        sh._write_snapshot(up_snap(1000.0))
        sh._write_snapshot(up_snap(940.0))   # clock stepped -60 s
        sh._write_snapshot(up_snap(941.5))   # next poll on the new timeline
        heads = []
        while True:
            p = sh.buffer.peek()
            if p is None:
                break
            head, _ = parse_batch(p)
            heads.append(head["wall"])
            sh.buffer.ack()
        # The 941.5 batch shipped (interval met on the NEW timeline); the
        # 940.0 one re-anchored the gate and was deliberately skipped.
        assert heads == [1000.0, 941.5]
        sh.close()

    def test_half_open_probe_on_corrupt_head_never_wedges(self, tmp_path):
        """A consumed half-open probe that hits a corrupt head batch must
        record an outcome — an outcome-less return would park the breaker
        in half_open forever (decide() answers 'skip' until restart)."""
        send = CollectingSend()
        sh = make_shipper(tmp_path, send)
        sh.buffer.append(b"not-a-batch-frame")
        sh._write_snapshot(up_snap(100.0))
        # Simulate the consumed probe: decide() moved open -> half_open.
        sh.breaker.state = "open"
        sh.breaker._next_probe_at = 0.0
        assert sh.breaker.decide() == "probe"
        assert sh.breaker.state == "half_open"
        assert sh._send_one() is True   # corrupt head dropped
        assert sh.breaker.state != "half_open"  # outcome WAS recorded
        # and the breaker recovers to deliver the real batch
        deadline = time.monotonic() + 5
        while sh.buffer.pending() and time.monotonic() < deadline:
            if sh.breaker.decide() in ("call", "probe"):
                sh._send_one()
            time.sleep(0.01)
        assert [s for k, s in send.calls if k == "ok"] == [1]
        assert sh.stats()["dropped"]["corrupt"] == 1
        sh.close()

    def test_restart_resumes_seq_and_backlog(self, tmp_path):
        sh = make_shipper(tmp_path, CollectingSend(fail_until=10**9))
        for i in range(4):
            sh._write_snapshot(up_snap(100.0 + i, up=float(i)))
        sh.close()
        send = CollectingSend()
        sh2 = make_shipper(tmp_path, send)
        assert sh2.buffer.pending() == 4
        sh2._write_snapshot(up_snap(200.0, up=99.0))  # continues the seq
        sh2.start()
        assert wait_for(lambda: sh2.buffer.pending() == 0, timeout=10)
        sh2.close()
        oks = [s for k, s in send.calls if k == "ok"]
        assert oks == [1, 2, 3, 4, 5]


class TestDiskPressureSeal:
    """The egress_compact rung seals the active segment on the writer
    thread: a seal from the governor's thread in the middle of an append
    closed the file under the write (the batch lost after its seq was
    issued) or indexed the record into the next segment."""

    def test_seal_waits_for_the_append_in_flight(self, tmp_path, monkeypatch):
        import threading

        import tpu_pod_exporter_torch.persist as persist

        real = persist.append_record
        armed, mid, go = threading.Event(), threading.Event(), threading.Event()

        def paused(f, payload):
            # The header lands, then an armed writer stops inside the record.
            f.write(persist._HDR.pack(len(payload), persist.zlib.crc32(payload)))
            if armed.is_set() and not mid.is_set():
                mid.set()
                go.wait(5.0)
            f.write(payload)
            return persist._HDR.size + len(payload)

        monkeypatch.setattr(persist, "append_record", paused)
        sh = make_shipper(tmp_path, CollectingSend(fail_until=10**9))
        sh.start()
        try:
            # A record already in the active segment: there is one to seal.
            assert sh.on_snapshot(up_snap(100.0)) == 1
            assert wait_for(lambda: sh.buffer.pending() == 1, timeout=5)
            armed.set()
            assert sh.on_snapshot(up_snap(101.0, up=2.0)) == 1
            assert mid.wait(5.0)
            shed = threading.Thread(target=sh.set_disk_pressure, args=(True,))
            shed.start()
            shed.join(5.0)
            assert not shed.is_alive()
            go.set()
            assert sh.on_snapshot(up_snap(102.0, up=3.0)) == 1
            assert wait_for(lambda: sh.buffer.pending() == 3, timeout=5)
            seqs = [parse_batch(sh.buffer.peek_at(i))[0]["seq"] for i in range(3)]
            assert seqs == [1, 2, 3]
            assert sh.stats()["enqueued_batches"] == 3
        finally:
            go.set()
            sh.close()
        monkeypatch.setattr(persist, "append_record", real)
        # Every record reads back from disk after a restart.
        again = WalBuffer(str(tmp_path))
        assert again.open()["pending"] == 3
        assert [parse_batch(p)[0]["seq"] for p in again.iter_payloads()] == [1, 2, 3]
        again.close()

    def test_seal_reclaims_acked_bytes_on_an_idle_writer(self, tmp_path):
        send = CollectingSend()
        sh = make_shipper(tmp_path, send)
        sh.start()
        try:
            for i in range(3):
                sh.on_snapshot(up_snap(100.0 + i, up=float(i)))
            assert wait_for(lambda: len(send.calls) == 3
                            and sh.buffer.pending() == 0)
            assert egress_dir_summary(str(tmp_path))["segment_bytes"] > 0
            sh.set_disk_pressure(True)
            # The writer is idle on its queue: the seal runs at once.
            assert wait_for(lambda: egress_dir_summary(
                str(tmp_path))["segment_bytes"] == 0, timeout=2)
        finally:
            sh.close()

    def test_seal_before_start_runs_in_place(self, tmp_path):
        sh = make_shipper(tmp_path, CollectingSend())
        sh._write_snapshot(up_snap(100.0))
        sh.buffer.ack()
        assert egress_dir_summary(str(tmp_path))["segment_bytes"] > 0
        sh.set_disk_pressure(True)
        assert egress_dir_summary(str(tmp_path))["segment_bytes"] == 0
        sh.close()


class TestShipperEndToEnd:
    def test_chaos_receiver_flap_exactly_once(self, tmp_path):
        recv = ChaosReceiver(
            parse_chaos_spec("err:recv:1:@2:x3,reject:recv:1:@6:x2"),
            seed=3,
        )
        recv.start()
        try:
            sh = RemoteWriteShipper(
                recv.url, str(tmp_path), interval_s=0.0, timeout_s=2.0,
                breaker=CircuitBreaker(failure_threshold=2,
                                       backoff_base_s=0.05,
                                       backoff_max_s=0.1),
            )
            sh.load()
            sh.start()
            base = time.time()
            for i in range(10):
                sh._q.put(up_snap(base + 0.001 * i, up=float(i)))
            # One batch per snapshot (values change every time); wait on
            # the RECEIVER's ledger — buffer-empty races the writer thread.
            assert wait_for(lambda: recv.accepted_batches() >= 10,
                            timeout=20)
            sh.close()
            stats = recv.stats()
            seqs = stats["accepted_seqs"]
            assert sorted(seqs) == list(range(1, max(seqs) + 1))
            assert not stats["duplicate_seqs"]
            assert not stats["duplicate_samples"]
            assert {k for _i, k in stats["injected"]} == {"err", "reject"}
        finally:
            recv.stop()

    def test_truncate_mid_body_is_retried(self, tmp_path):
        recv = ChaosReceiver(parse_chaos_spec("truncate:recv:1:x1"), seed=1)
        recv.start()
        try:
            sh = RemoteWriteShipper(
                recv.url, str(tmp_path), interval_s=0.0, timeout_s=2.0,
                breaker=CircuitBreaker(failure_threshold=3,
                                       backoff_base_s=0.05,
                                       backoff_max_s=0.1),
            )
            sh.load()
            sh.start()
            sh._q.put(up_snap(time.time()))
            assert wait_for(lambda: recv.accepted_batches() >= 1,
                            timeout=10)
            sh.close()
            stats = recv.stats()
            assert stats["accepted_seqs"] == [1]
            assert not stats["duplicate_seqs"]
            assert stats["injected"] == [(0, "truncate")]
        finally:
            recv.stop()


# ------------------------------------------------------ collector integration


class TestCollectorIntegration:
    def test_egress_excluded_from_publish_and_total(self):
        called = {"n": 0}

        class SlowShipper:
            @staticmethod
            def on_snapshot(snap):
                called["n"] += 1
                time.sleep(0.5)
                return 1

            @staticmethod
            def emit(b):
                pass

        collector = Collector(
            FakeBackend(chips=2), FakeAttribution(), SnapshotStore(),
            shipper=SlowShipper(),
        )
        stats = collector.poll_once()
        assert called["n"] == 1
        # the 500 ms egress sleep must not appear in any poll phase
        # timing (generous thresholds: full-suite CPU contention has made
        # a 4-chip publish run tens of ms — the assertion is about the
        # SLEEP leaking, not about absolute publish speed)
        assert stats.publish_s < 0.4
        assert stats.total_s < 0.4

    def test_poll_survives_broken_shipper(self):
        class BrokenShipper:
            @staticmethod
            def on_snapshot(snap):
                raise OSError("receiver on fire")

            @staticmethod
            def emit(b):
                raise OSError("still on fire")

        collector = Collector(
            FakeBackend(chips=2), FakeAttribution(), SnapshotStore(),
            shipper=BrokenShipper(),
        )
        stats = collector.poll_once()
        assert stats.ok

    def test_egress_specs_in_exposition(self, tmp_path):
        store = SnapshotStore()
        sh = make_shipper(tmp_path, CollectingSend())
        collector = Collector(
            FakeBackend(chips=2), FakeAttribution(), store, shipper=sh,
        )
        collector.poll_once()
        collector.poll_once()
        snap = store.current()
        assert snap.value("tpu_exporter_egress_breaker_state") == 0.0
        assert snap.value("tpu_exporter_egress_backlog_batches") is not None
        assert snap.value("tpu_exporter_egress_dropped_total",
                          {"reason": "poison"}) == 0.0
        body = snap.encode().decode()
        assert "# TYPE tpu_exporter_egress_send_seconds histogram" in body
        sh.close()

    def test_no_shipper_no_egress_series(self):
        store = SnapshotStore()
        collector = Collector(FakeBackend(chips=2), FakeAttribution(), store)
        collector.poll_once()
        assert store.current().value(
            "tpu_exporter_egress_breaker_state") is None


# -------------------------------------------------------------- chaos grammar


class TestChaosRecvGrammar:
    def test_recv_rules_parse(self):
        rules = parse_chaos_spec(
            "hang:recv:1:2s,err:recv:0.5,reject:recv:1:x2,"
            "truncate:recv:1:@3"
        )
        assert [r.kind for r in rules] == ["hang", "err", "reject",
                                           "truncate"]
        assert all(r.source == "recv" for r in rules)

    def test_receiver_only_kinds_rejected_for_sources(self):
        with pytest.raises(ValueError, match="only\\s+valid for the recv"):
            parse_chaos_spec("reject:device:1")
        with pytest.raises(ValueError, match="only\\s+valid for the recv"):
            parse_chaos_spec("truncate:procscan:1")

    def test_source_only_kinds_rejected_for_recv(self):
        with pytest.raises(ValueError, match="not\\s+valid for the recv"):
            parse_chaos_spec("kill:recv:1")
        with pytest.raises(ValueError, match="not\\s+valid for the recv"):
            parse_chaos_spec("garbage:recv:1")

    def test_schedule_is_seeded_deterministic(self):
        for _ in range(2):
            recv = ChaosReceiver(parse_chaos_spec("err:recv:0.5"), seed=9)
            drawn = [recv._draw(i) is not None for i in range(20)]
            if _ == 0:
                first = drawn
        assert drawn == first


# ------------------------------------------------------------- status footer


class TestStatusFooter:
    def test_egress_line_missing_dir(self, tmp_path):
        from tpu_pod_exporter_torch.status import egress_line

        line = egress_line("http://r/w", str(tmp_path / "nope"))
        assert "missing" in line

    def test_egress_line_renders_status(self, tmp_path):
        from tpu_pod_exporter_torch.status import egress_line

        (tmp_path / "egress-status.json").write_text(json.dumps({
            "wall": time.time(), "breaker": "open",
            "backlog_batches": 7, "backlog_bytes": 12345,
            "last_send_latency_s": 0.01,
            "last_send_ok_wall": time.time() - 5,
            "last_error": "HTTP 503",
        }))
        line = egress_line("http://r/w", str(tmp_path))
        assert "breaker open" in line
        assert "7 batch(es)" in line
        assert "HTTP 503" in line

    def test_dir_summary(self, tmp_path):
        b = WalBuffer(str(tmp_path))
        b.open()
        b.append(b"xyz")
        b.close()
        s = egress_dir_summary(str(tmp_path))
        assert s["exists"] and s["segments"] == 1
        assert s["segment_bytes"] > 0


# ------------------------------------------------------------- metric wiring


class TestMetricSets:
    def test_exporter_set_is_the_tracked_set(self):
        from tpu_pod_exporter_torch.history import HISTORY_TRACKED_METRICS

        assert set(exporter_egress_metrics()) == set(HISTORY_TRACKED_METRICS)

    def test_aggregator_set_is_the_rollup_surface(self):
        names = aggregator_egress_metrics()
        assert "tpu_slice_hbm_used_bytes" in names
        assert "tpu_aggregator_target_up" in names
        # plumbing counters stay out
        assert "tpu_aggregator_scrape_errors_total" not in names

    def test_degraded_predicate(self, tmp_path):
        sh = make_shipper(tmp_path, CollectingSend())
        assert not sh.degraded
        sh.breaker.state = "open"
        sh.breaker.reopens = 3
        assert sh.degraded
        detail = sh.ready_detail()
        assert detail["degraded"] is True
        sh.close()


# ------------------------------------------------------- the two packages


def _twin_shippers(tmp_path):
    """One shipper of each package, clocks pinned, sends captured."""
    from tpu_pod_exporter.egress import RemoteWriteShipper as JaxShipper
    from tpu_pod_exporter.supervisor import CircuitBreaker as JaxBreaker

    out = []
    for name, shipper_cls, breaker_cls in (("jax", JaxShipper, JaxBreaker),
                                           ("torch", RemoteWriteShipper, CircuitBreaker)):
        bodies = []

        def send(url, body, headers, timeout_s, bodies=bodies):
            bodies.append((headers["X-Tpe-Egress-Seq"], body))
            return 200

        sh = shipper_cls("http://recv.invalid/w", str(tmp_path / name), send=send,
                         interval_s=0.0, max_backlog_age_s=0.0, breaker=breaker_cls(),
                         extra_labels={"host": "h0", "slice_name": "s"},
                         clock=lambda: 42.0, wallclock=lambda: 1_700_000_000.0)
        sh.load()
        out.append((sh, bodies))
    return out


def _framed(shipper):
    got = []
    while True:
        payload = shipper.buffer.peek()
        if payload is None:
            return got
        got.append(payload)
        shipper.buffer.ack()


class TestShippersAcrossPackages:
    def test_same_snapshots_frame_the_same_batches(self, tmp_path):
        key = ("0", "/dev/nvidia3", "v", "s", "h", "0", "", "", "")
        snaps = [up_snap(100.0, hbm={key: 5.0}), up_snap(101.0, hbm={key: 5.0}),
                 up_snap(102.0, hbm={key: 19_003_924_480.0}), up_snap(103.0, up=0.0)]
        (jax_sh, _), (port_sh, _) = _twin_shippers(tmp_path)
        for snap in snaps:
            jax_sh._write_snapshot(snap)
            port_sh._write_snapshot(snap)
        want, got = _framed(jax_sh), _framed(port_sh)
        assert len(want) == len(snaps)
        assert got == want
        jax_sh.close()
        port_sh.close()

    def test_a_polled_snapshot_gives_the_same_wire_bytes(self, tmp_path):
        from tpu_pod_exporter.attribution.fake import FakeAttribution as JaxAttribution
        from tpu_pod_exporter.backend.fake import FakeBackend as JaxBackend
        from tpu_pod_exporter.collector import Collector as JaxCollector
        from tpu_pod_exporter.metrics import SnapshotStore as JaxSnapshotStore

        store = JaxSnapshotStore()
        JaxCollector(JaxBackend(chips=4), JaxAttribution(), store).poll_once()
        snap = store.current()
        twins = _twin_shippers(tmp_path)
        for sh, _bodies in twins:
            sh._write_snapshot(snap)
            assert sh._send_one()
        (_, want), (_, got) = twins
        assert len(want) == 1
        assert got == want
        series = parse_write_request(snappy_decompress(got[0][1]))
        assert any(labels.get("__name__") == "tpu_hbm_used_bytes" for labels, _ in series)
        for sh, _bodies in twins:
            sh.close()

    def test_codecs_give_the_same_bytes(self):
        from tpu_pod_exporter.egress import encode_write_request as jax_encode
        from tpu_pod_exporter.egress import snappy_compress as jax_snappy

        rng = random.Random(5)
        series = [([("__name__", "gpu_hbm_used_bytes"), ("chip_id", str(i)),
                    ("device_path", f"/dev/nvidia{i + 3}")],
                   [(rng.random() * 8e10, 1_700_000_000_000 + 250 * j) for j in range(3)])
                  for i in range(8)]
        proto = encode_write_request(series)
        assert proto == jax_encode(series)
        assert snappy_compress(proto) == jax_snappy(proto)
