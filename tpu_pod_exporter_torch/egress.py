"""Remote-write egress — push shipping that survives receiver outages.

The exporter (and the aggregator) are pull-only: fan-in is capped at
whatever scrapes them, and a dead scraper silently loses telemetry.
Production fleets push into a central TSDB. This module turns the node
agent into a complete telemetry shipper by composing the two hard pieces
the repo already owns — ``persist.py``'s crash-safe WAL machinery and
``supervisor.py``'s breaker/backoff discipline — into an egress path where
an unreachable, hanging, or flapping receiver degrades gracefully and
drops nothing:

- :class:`RemoteWriteShipper` hangs off the same snapshot-swap hook the
  history store uses. Each swap enqueues a **delta-aware** batch (full
  series on a layout-generation change, changed samples otherwise) into a
  durable on-disk send buffer (:class:`~tpu_pod_exporter_torch.persist.WalBuffer`
  under ``--egress-dir``: CRC32-framed segments, rotation, torn-write-
  tolerant replay, a fsynced ack cursor), so a receiver outage or a
  process restart loses zero samples — on reconnect the backlog drains
  oldest-first under ``--egress-max-backlog-mb`` / ``-age-s`` caps.
- The sender thread speaks Prometheus **remote-write** (protobuf +
  snappy; both codecs vendored stdlib-only below — no new runtime deps)
  behind a :class:`~tpu_pod_exporter_torch.supervisor.CircuitBreaker`: timeouts,
  connection errors, 5xx and 429 open it with exponential backoff +
  jitter; half-open sends a single probe batch; other 4xx are **poison**
  (counted, skipped — a batch the receiver rejects must not wedge the
  queue behind it).
- Backpressure is **counted, not blocking**: the poll/scrape path's entire
  egress cost is one non-blocking queue put (the persist discipline); a
  wedged receiver grows an on-disk backlog and a metric, never a poll.

Everything is auditable from the exposition (``tpu_exporter_egress_*``,
``metrics/schema.py``) and from ``status`` (the ``egress:`` footer).

CLI (``python -m tpu_pod_exporter_torch.egress``):

- ``--demo``        — ``make egress-demo``: a seeded chaos receiver
  (hangs, 5xx, 429s, a mid-body truncation) wedges a live exporter's
  egress, the breaker opens, the backlog grows on disk, a SIGKILL lands
  mid-send, and the restarted shipper drains the backlog with **zero
  loss and no acked re-send** — while scrape/poll p99 stay within budget
  of an egress-off baseline throughout the wedge.
- ``--drain-check`` — backlog-drain budget: a simulated N-second receiver
  outage's backlog must drain within budget once the receiver returns.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import socket
import struct
import threading
import time
import urllib.error
import urllib.request
from typing import TYPE_CHECKING, Any, Callable, Mapping, Sequence

from tpu_pod_exporter_torch.metrics import HistogramStore, schema
from tpu_pod_exporter_torch.persist import WalBuffer, atomic_write
from tpu_pod_exporter_torch.supervisor import (
    DEGRADED_AFTER_REOPENS,
    STATE_VALUES,
    CircuitBreaker,
    CLOSED,
)
from tpu_pod_exporter_torch.utils import RateLimitedLogger

if TYPE_CHECKING:  # typing only — no runtime import cost
    from tpu_pod_exporter_torch.metrics.registry import MetricSpec, Snapshot

log = logging.getLogger("tpu_pod_exporter_torch.egress")

# Remote-write wire headers (Prometheus remote-write 1.0).
CONTENT_TYPE = "application/x-protobuf"
REMOTE_WRITE_VERSION = "0.1.0"
# Exactly-once bookkeeping for the chaos receiver / demo: the batch's
# durable sequence number rides a private header real receivers ignore.
SEQ_HEADER = "X-Tpe-Egress-Seq"

STATUS_NAME = "egress-status.json"

# Segment size the send buffer rotates at while the disk-pressure ladder's
# egress rung is applied: small segments mean acked records (the bulk of a
# healthy shipper's on-disk footprint between 4 MB rotations) become
# reclaimable within one ack sweep instead of one rotation — steady-state
# disk then holds roughly one segment plus the pending backlog. Rotation
# per ~8 KB is ~one extra open/close per batch at exposition batch sizes:
# trivial, and only paid while the disk is actually under pressure.
SHED_SEGMENT_BYTES = 8 << 10

_U32 = struct.Struct("<I")


# --------------------------------------------------------------- snappy codec
# Vendored snappy BLOCK format (github.com/google/snappy format_description):
# a varint uncompressed length, then literal/copy elements. Stdlib-only —
# the container has no python-snappy, and a hard dep for one encoder would
# violate the no-new-runtime-deps rule. The encoder is a greedy 4-byte-hash
# matcher emitting 2-byte-offset copies (a strict subset of valid snappy,
# decodable by every real receiver); the decoder handles every element type
# (the chaos receiver and tests round-trip through it).

_MAX_LITERAL = 1 << 16


def _emit_literal(out: bytearray, data: bytes, start: int, end: int) -> None:
    i = start
    while i < end:
        n = min(end - i, _MAX_LITERAL)
        if n <= 60:
            out.append((n - 1) << 2)
        elif n <= 256:
            out.append(60 << 2)
            out.append(n - 1)
        else:
            out.append(61 << 2)
            out += (n - 1).to_bytes(2, "little")
        out += data[i:i + n]
        i += n


def snappy_compress(data: bytes) -> bytes:
    """Snappy block-format compression (literals + 2-byte-offset copies)."""
    out = bytearray()
    # Preamble: uncompressed length, little-endian varint.
    n = len(data)
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    table: dict[bytes, int] = {}
    i = 0
    lit = 0
    limit = len(data) - 4
    while i <= limit:
        key = data[i:i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is None or i - cand > 0xFFFF:
            i += 1
            continue
        # Extend the match (the 4-byte key already matches by identity).
        mlen = 4
        maxlen = min(len(data) - i, 64)
        while mlen < maxlen and data[cand + mlen] == data[i + mlen]:
            mlen += 1
        _emit_literal(out, data, lit, i)
        out.append(2 | ((mlen - 1) << 2))  # copy, 2-byte offset
        out += (i - cand).to_bytes(2, "little")
        i += mlen
        lit = i
    _emit_literal(out, data, lit, len(data))
    return bytes(out)


def snappy_decompress(data: bytes) -> bytes:
    """Snappy block-format decompression (all element types)."""
    # Preamble varint.
    expected = 0
    shift = 0
    i = 0
    while True:
        if i >= len(data):
            raise ValueError("snappy: truncated preamble")
        b = data[i]
        i += 1
        expected |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
        if shift > 35:
            raise ValueError("snappy: preamble varint too long")
    out = bytearray()
    n = len(data)
    while i < n:
        tag = data[i]
        typ = tag & 3
        if typ == 0:  # literal
            length = (tag >> 2) + 1
            i += 1
            if length > 60:
                extra = length - 60
                if i + extra > n:
                    raise ValueError("snappy: truncated literal length")
                length = int.from_bytes(data[i:i + extra], "little") + 1
                i += extra
            if i + length > n:
                raise ValueError("snappy: truncated literal")
            out += data[i:i + length]
            i += length
            continue
        if typ == 1:  # copy, 1-byte offset
            length = 4 + ((tag >> 2) & 0x7)
            if i + 2 > n:
                raise ValueError("snappy: truncated copy-1")
            offset = ((tag >> 5) << 8) | data[i + 1]
            i += 2
        elif typ == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            if i + 3 > n:
                raise ValueError("snappy: truncated copy-2")
            offset = int.from_bytes(data[i + 1:i + 3], "little")
            i += 3
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            if i + 5 > n:
                raise ValueError("snappy: truncated copy-4")
            offset = int.from_bytes(data[i + 1:i + 5], "little")
            i += 5
        if offset == 0 or offset > len(out):
            raise ValueError("snappy: copy offset out of range")
        for _ in range(length):  # may overlap — byte-at-a-time is the spec
            out.append(out[-offset])
    if len(out) != expected:
        raise ValueError(
            f"snappy: length mismatch (got {len(out)}, want {expected})"
        )
    return bytes(out)


# ------------------------------------------------------- remote-write protobuf
# Hand-rolled wire encoding of the four-message prometheus remote-write
# schema (WriteRequest{timeseries=1} / TimeSeries{labels=1,samples=2} /
# Label{name=1,value=2} / Sample{value=1,timestamp=2}) — ~60 lines beats a
# vendored _pb2 module for a fixed, tiny schema, and the decoder gives the
# chaos receiver and the tests an independent read-back path.


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _pb_len(field: int, payload: bytes) -> bytes:
    return _pb_varint((field << 3) | 2) + _pb_varint(len(payload)) + payload


def _pb_label(name: str, value: str) -> bytes:
    return (
        _pb_len(1, name.encode("utf-8")) + _pb_len(2, value.encode("utf-8"))
    )


def _pb_sample(value: float, ts_ms: int) -> bytes:
    return (
        _pb_varint((1 << 3) | 1) + struct.pack("<d", value)
        + _pb_varint(2 << 3) + _pb_varint(ts_ms)
    )


def encode_write_request(
    series: Sequence[tuple[Sequence[tuple[str, str]], Sequence[tuple[float, int]]]],
) -> bytes:
    """[(labels, samples)] → WriteRequest bytes. Labels are sorted by name
    (the remote-write contract); samples are (value, unix-ms)."""
    out = bytearray()
    for labels, samples in series:
        ts = bytearray()
        for name, value in sorted(labels):
            ts += _pb_len(1, _pb_label(name, value))
        for value, ts_ms in samples:
            ts += _pb_len(2, _pb_sample(value, ts_ms))
        out += _pb_len(1, bytes(ts))
    return bytes(out)


def _pb_scan(data: bytes, i: int, end: int) -> tuple[int, int, int]:
    """One field header + varint/skip bookkeeping → (field, wire, i)."""
    key = 0
    shift = 0
    while True:
        if i >= end:
            raise ValueError("protobuf: truncated field key")
        b = data[i]
        i += 1
        key |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    return key >> 3, key & 7, i


def _pb_read_varint(data: bytes, i: int, end: int) -> tuple[int, int]:
    n = 0
    shift = 0
    while True:
        if i >= end:
            raise ValueError("protobuf: truncated varint")
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def parse_write_request(
    data: bytes,
) -> list[tuple[dict[str, str], list[tuple[float, int]]]]:
    """WriteRequest bytes → [(labels dict, [(value, unix-ms)])] — the
    decoder side for the chaos receiver and round-trip tests."""
    out: list[tuple[dict[str, str], list[tuple[float, int]]]] = []
    i, end = 0, len(data)
    while i < end:
        field, wire, i = _pb_scan(data, i, end)
        if field != 1 or wire != 2:
            raise ValueError(f"WriteRequest: unexpected field {field}/{wire}")
        length, i = _pb_read_varint(data, i, end)
        ts_end = i + length
        if ts_end > end:
            raise ValueError("protobuf: truncated TimeSeries")
        labels: dict[str, str] = {}
        samples: list[tuple[float, int]] = []
        while i < ts_end:
            f2, w2, i = _pb_scan(data, i, ts_end)
            ln2, i = _pb_read_varint(data, i, ts_end)
            sub_end = i + ln2
            if sub_end > ts_end:
                raise ValueError("protobuf: truncated submessage")
            if f2 == 1 and w2 == 2:  # Label
                name = value = ""
                while i < sub_end:
                    f3, _w3, i = _pb_scan(data, i, sub_end)
                    ln3, i = _pb_read_varint(data, i, sub_end)
                    if i + ln3 > sub_end:
                        raise ValueError("protobuf: truncated string")
                    text = data[i:i + ln3].decode("utf-8")
                    i += ln3
                    if f3 == 1:
                        name = text
                    elif f3 == 2:
                        value = text
                labels[name] = value
            elif f2 == 2 and w2 == 2:  # Sample
                val = 0.0
                ts_ms = 0
                while i < sub_end:
                    f3, w3, i = _pb_scan(data, i, sub_end)
                    if w3 == 1:
                        if i + 8 > sub_end:
                            raise ValueError("protobuf: truncated fixed64")
                        (num,) = struct.unpack_from("<d", data, i)
                        i += 8
                        if f3 == 1:
                            val = num
                    else:
                        num_i, i = _pb_read_varint(data, i, sub_end)
                        if f3 == 2:
                            ts_ms = num_i
                samples.append((val, ts_ms))
            else:
                i = sub_end
        i = ts_end
        out.append((labels, samples))
    return out


# ------------------------------------------------------------- batch framing
# One WalBuffer record per batch: b"B" + <u32 header_len> + JSON header +
# raw (uncompressed) WriteRequest bytes. The proto is stored uncompressed
# so a backlog is inspectable with parse_write_request; snappy is applied
# per send attempt (cheap at batch scale, and a resend recompresses).


def frame_batch(seq: int, wall: float, kind: str, samples: int,
                proto: bytes, mono: float = 0.0) -> bytes:
    # ``mono`` is the writer's MONOTONIC clock at enqueue: meaningful only
    # within the process that wrote it (seqs above the boot seq), where it
    # gives an exact, NTP-step-immune batch age. Pre-restart batches age
    # on their wall stamp instead (see RemoteWriteShipper._head_age).
    head = json.dumps(
        {"seq": seq, "wall": wall, "kind": kind, "samples": samples,
         "mono": mono}
    ).encode()
    return b"B" + _U32.pack(len(head)) + head + proto


def parse_batch(payload: bytes) -> tuple[dict[str, Any], bytes]:
    """→ (header dict, proto bytes); raises ValueError on a foreign frame."""
    if payload[:1] != b"B" or len(payload) < 5:
        raise ValueError("not an egress batch record")
    (jlen,) = _U32.unpack_from(payload, 1)
    head = json.loads(payload[5:5 + jlen])
    return head, payload[5 + jlen:]


# --------------------------------------------------------------- the shipper


def default_send(url: str, body: bytes, headers: Mapping[str, str],
                 timeout_s: float) -> int:
    """POST one compressed batch; returns the HTTP status. Raises on
    connection-level failure (timeout, refused, reset)."""
    req = urllib.request.Request(
        url, data=body, headers=dict(headers), method="POST"
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:  # noqa: S310 — operator-supplied receiver
        resp.read()
        return int(resp.status)


# Always included in delta batches (fresh timestamp every batch): the
# liveness series a receiving TSDB alerts on.
_HEARTBEAT_METRICS = ("tpu_exporter_up", "tpu_aggregator_target_up")


def build_breaker(failures: int, backoff_s: float,
                  backoff_max_s: float) -> CircuitBreaker:
    """The ONE egress-breaker construction (exporter app + aggregator CLI
    both call it — duplicated clamping had the same flag values configure
    different breakers per tier): ``failures <= 0`` disables via an
    unreachable threshold (the source-breaker contract), zero/inverted
    backoffs clamp sane instead of crashing startup."""
    base = backoff_s if backoff_s > 0 else 1.0
    return CircuitBreaker(
        failure_threshold=failures if failures > 0 else (1 << 30),
        backoff_base_s=base,
        backoff_max_s=max(backoff_max_s, base),
    )


# The exporter ships exactly the families the history recorder tracks (the
# same "what matters for forensics" judgment); the aggregator ships its
# rollup surface. Both orders are sorted for deterministic batch layouts.
def exporter_egress_metrics() -> tuple[str, ...]:
    from tpu_pod_exporter_torch.history import HISTORY_TRACKED_METRICS

    return tuple(sorted(HISTORY_TRACKED_METRICS))


def aggregator_egress_metrics() -> tuple[str, ...]:
    return tuple(sorted(
        spec.name for spec in schema.AGGREGATE_EGRESS_SPECS
    ))


class RemoteWriteShipper:
    """WAL-buffered Prometheus remote-write sender for snapshot swaps.

    Three threads touch it, with strictly bounded coupling:

    - the POLL thread calls :meth:`on_snapshot` — one non-blocking queue
      put of an immutable snapshot reference (drops + counts when the
      writer stalls; polling never waits on egress);
    - the WRITER thread extracts the delta, frames the batch, and appends
      it durably to the :class:`~tpu_pod_exporter_torch.persist.WalBuffer`
      (fsync per batch — batches are ~1/s, and the zero-loss contract
      needs a durable tail), then enforces the backlog byte/age caps;
    - the SENDER thread drains the buffer oldest-first behind the
      breaker: 2xx acks (fsynced cursor — never re-sent, even across a
      crash), timeout/connection/5xx/429 are failures that open the
      breaker with expo backoff + jitter, other 4xx are poison (counted,
      acked-without-delivery so the queue never wedges).
    """

    def __init__(
        self,
        url: str,
        egress_dir: str,
        metrics: Sequence[str] | None = None,
        interval_s: float = 1.0,
        timeout_s: float = 5.0,
        max_backlog_mb: float = 64.0,
        max_backlog_age_s: float = 3600.0,
        breaker: CircuitBreaker | None = None,
        extra_labels: Mapping[str, str] | None = None,
        send: Callable[[str, bytes, Mapping[str, str], float], int] = default_send,
        queue_max: int = 4,
        full_sync_s: float = 120.0,
        clock: Callable[[], float] = time.monotonic,
        wallclock: Callable[[], float] = time.time,
    ) -> None:
        self.url = url
        self.egress_dir = egress_dir
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.max_backlog_bytes = int(max_backlog_mb * (1 << 20))
        self.max_backlog_age_s = max_backlog_age_s
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self._extra_labels = dict(extra_labels or {})
        self._send = send
        self._clock = clock
        self._wallclock = wallclock
        self._metric_order = tuple(
            metrics if metrics is not None else exporter_egress_metrics()
        )
        spec_map: dict[str, "MetricSpec"] = {}
        for spec in (*schema.ALL_SPECS, *schema.AGGREGATE_SPECS,
                     *schema.HISTORY_SPECS, *schema.PERSIST_SPECS,
                     *schema.EGRESS_SPECS, *schema.FLEET_QUERY_SPECS):
            spec_map[spec.name] = spec
        self._spec_map = spec_map
        self._rlog = RateLimitedLogger(log)
        self.buffer = WalBuffer(egress_dir)
        self.send_hist = HistogramStore(
            schema.TPU_EXPORTER_EGRESS_SEND_SECONDS_HIST
        )
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=queue_max)
        self._work = threading.Event()     # sender wake-up on append
        self._stop = threading.Event()
        self._writer: threading.Thread | None = None
        self._sender: threading.Thread | None = None
        # Writer-thread state (single owner).
        self._last_values: dict[tuple[str, tuple[str, ...]], float] = {}
        self._last_keys: frozenset[tuple[str, tuple[str, ...]]] = frozenset()
        self._last_batch_wall = 0.0
        # Periodic full resync: delta-only shipping of STATIC gauges would
        # let the receiving TSDB mark them stale (Prometheus drops series
        # 5 min after their last sample); a full batch at this cadence
        # keeps every series fresh. Must stay under that 5 min window.
        self.full_sync_s = full_sync_s
        self._last_full_wall = 0.0
        self._seq = 0
        # Sender-thread cache of the head batch's header (age accounting):
        # (seq, wall stamp, monotonic ENQUEUE stamp from the frame header).
        # Batches created by THIS process age on their enqueue-monotonic
        # stamp — exact, and an NTP step (clock_step chaos) can neither
        # inflate their age into an age-cap mass-drop nor hide a genuinely
        # stale slowly-draining backlog; only batches restored from a
        # pre-restart backlog age on wall time (their true age genuinely
        # predates this process, and their mono stamp belongs to a dead
        # clock).
        self._head_meta: tuple[int, float, float] | None = None
        self._boot_seq = 0  # seqs <= this predate this process (see load)
        # Resource-pressure shed (tpu_pod_exporter_torch.pressure, disk ladder
        # rung "egress_compact"): under disk pressure the buffer rotates
        # TINY segments — acked-but-unrotated bytes are the bulk of a
        # healthy shipper's disk footprint, and small segments let the
        # ack sweep reclaim them promptly (no data loss) — and the
        # pending-backlog byte cap tightens (bounded, counted loss, only
        # while the receiver is down). Flag flipped by the governor
        # thread, read by the writer/sender threads.
        self._disk_pressure = False
        self._normal_segment_bytes = self.buffer.segment_max_bytes
        self._pressure_hook: Callable[[BaseException], bool] | None = None
        self._stats_lock = threading.Lock()
        self._stats: dict[str, Any] = {
            "enqueued_batches": 0,
            "enqueued_samples": 0,
            "sent_batches": 0,
            "sent_samples": 0,
            "failed_sends": 0,
            "dropped": {"backlog": 0, "poison": 0, "queue": 0, "corrupt": 0},
            "last_send_latency_s": 0.0,
            "last_send_ok_wall": 0.0,
            "last_error": "",
        }
        self._open_errors: list[str] = []

    # ------------------------------------------------------------------ boot

    def load(self) -> dict:
        """Open + replay the send buffer; resumes the durable batch
        sequence. Never refuses to start: a hopeless dir records the error
        and the shipper runs degraded (every append drops, counted)."""
        try:
            info = self.buffer.open()
        except OSError as e:
            self._open_errors.append(str(e))
            log.error("egress dir %s unusable (%s); egress will drop until "
                      "it recovers", self.egress_dir, e)
            return {"pending": 0, "errors": [str(e)]}
        dropped = 0
        max_seq = 0
        # Seqs are monotonic in queue order, so the NEWEST pending batch
        # carries the highest one; a head corrupted into unparseability is
        # dropped so delivery can proceed (counted below).
        tail = self.buffer.peek_last()
        if tail is not None:
            try:
                head, _proto = parse_batch(tail)
                max_seq = int(head.get("seq", 0))
            except (ValueError, KeyError):
                pass
        while self.buffer.pending():
            payload = self.buffer.peek()
            if payload is None:
                break
            try:
                head, _proto = parse_batch(payload)
                with self._stats_lock:
                    self._head_meta = (int(head.get("seq", 0)),
                                       float(head.get("wall", 0.0)),
                                       float(head.get("mono", 0.0)))
                break
            except (ValueError, KeyError, TypeError):
                self.buffer.drop_oldest(1)
                dropped += 1
        # Belt over the scan's braces: the status sidecar (written on
        # every send attempt and after every cap-drop — i.e. whenever the
        # pending set can shrink toward empty) carries the last issued
        # seq, covering the drained-buffer restart where no pending batch
        # is left to read the sequence from. No extra fsync: the sidecar
        # is written anyway for the `status` footer.
        try:
            with open(os.path.join(self.egress_dir, STATUS_NAME),
                      encoding="utf-8") as f:
                max_seq = max(max_seq, int(json.load(f).get("seq", 0)))
        except FileNotFoundError:
            pass
        except Exception:  # noqa: BLE001 — a torn sidecar restarts from the scan
            pass
        self._seq = max_seq
        # Everything at or below this seq predates this process: its age
        # is genuinely its wall age. Batches ABOVE it age monotonically
        # (clock-step fence — see _head_age).
        self._boot_seq = max_seq
        corrupt = info.get("corrupt_segments", 0) + dropped
        if corrupt:
            with self._stats_lock:
                self._stats["dropped"]["corrupt"] += corrupt
        if info.get("pending"):
            log.info("egress backlog restored from %s: %d batch(es), %d "
                     "bytes pending (resuming at seq %d)", self.egress_dir,
                     info["pending"], info.get("pending_bytes", 0),
                     self._seq)
        return info

    def start(self) -> None:
        if self._writer is not None:
            return
        self._writer = threading.Thread(
            target=self._writer_run, name="tpu-egress-writer", daemon=True
        )
        self._sender = threading.Thread(
            target=self._sender_run, name="tpu-egress-sender", daemon=True
        )
        self._writer.start()
        self._sender.start()

    # ------------------------------------------------------------- poll side

    def on_snapshot(self, snap: "Snapshot") -> int:
        """The poll thread's entire egress cost: one non-blocking put of
        the (immutable) snapshot. Returns 1 when queued, 0 when dropped."""
        if self._writer is None:
            return 0
        try:
            self._q.put_nowait(snap)
            return 1
        except queue.Full:
            with self._stats_lock:
                self._stats["dropped"]["queue"] += 1
            self._rlog.warning(
                "egress_queue",
                "egress writer queue full; dropping a snapshot from the "
                "egress stream — polling is unaffected",
            )
            return 0

    # ----------------------------------------------------------- writer side

    def _writer_run(self) -> None:
        while not self._stop.is_set():
            try:
                snap = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            try:
                self._write_snapshot(snap)
            except Exception as e:  # noqa: BLE001 — egress must survive anything
                self._rlog.warning("egress_write", "egress batch build "
                                   "failed: %s", e)

    def _extract(self, snap: "Snapshot") -> dict[tuple[str, tuple[str, ...]], float]:
        current: dict[tuple[str, tuple[str, ...]], float] = {}
        for name in self._metric_order:
            view = snap.samples_view(name)
            if view:
                for key, value in view.items():
                    current[(name, key)] = value
        return current

    def _same_poll_instant(self, wall: float) -> bool:
        """True when a batch for this exact poll instant was already
        framed. Every sample timestamp in a batch derives solely from the
        snapshot's poll wall, so framing the same instant twice emits
        identical (series, timestamp) samples under a fresh seq — the
        receiving ledger counts them as duplicates and exactly-once is
        gone. Reached when the poller stalls (root death, wedged store)
        and the same frozen snapshot keeps arriving: with ``interval_s``
        of 0 the interval gate passes (0 < 0 is false) and the heartbeat
        ride-along would re-send at the frozen timestamp every cycle."""
        return wall == self._last_batch_wall

    def _write_snapshot(self, snap: "Snapshot") -> None:
        wall = float(getattr(snap, "poll_timestamp", snap.timestamp))
        if self._same_poll_instant(wall):
            return
        if wall < self._last_batch_wall:
            # Wall clock stepped BACKWARDS (NTP correction): without this
            # clamp the interval gate `wall - last < interval` stays
            # negative until the clock catches back up and egress silently
            # stops shipping for the whole step width. Resync the
            # reference points to the new timeline instead.
            self._last_batch_wall = wall
            self._last_full_wall = min(self._last_full_wall, wall)
        if wall - self._last_batch_wall < self.interval_s:
            return
        current = self._extract(snap)
        if not current:
            return
        keys = frozenset(current)
        if (
            keys != self._last_keys
            or (self.full_sync_s > 0
                and wall - self._last_full_wall >= self.full_sync_s)
        ):
            kind = "full"
            batch = current
            self._last_full_wall = wall
        else:
            kind = "delta"
            last = self._last_values
            batch = {k: v for k, v in current.items() if last.get(k) != v}
            # Heartbeat: the up-series always rides along (fresh timestamp,
            # tiny cost) so the receiving TSDB sees a live exporter even
            # across a perfectly static poll — delta-aware must not read
            # as dead-air.
            for hb in _HEARTBEAT_METRICS:
                for k in current:
                    if k[0] == hb:
                        batch.setdefault(k, current[k])
        self._last_keys = keys
        self._last_values = current
        if not batch:
            return
        mono = self._clock()
        ts_ms = int(wall * 1000.0)
        series: list[tuple[list[tuple[str, str]], list[tuple[float, int]]]] = []
        extra = self._extra_labels
        for (metric, key), value in batch.items():
            spec = self._spec_map.get(metric)
            label_names = spec.label_names if spec is not None else ()
            labels = [("__name__", metric)]
            labels.extend(zip(label_names, key))
            if extra:
                have = {n for n, _ in labels}
                labels.extend(
                    (n, v) for n, v in extra.items() if n not in have
                )
            series.append((labels, [(value, ts_ms)]))
        proto = encode_write_request(series)
        self._seq += 1
        payload = frame_batch(self._seq, wall, kind, len(series), proto,
                              mono=mono)
        try:
            self.buffer.append(payload)
        except OSError as e:
            # The append FAILED, so seq N was never durably issued and may
            # be reused — rolling back after a SUCCESSFUL append would
            # stamp two different batches with one seq and break the
            # exactly-once ledger.
            self._seq -= 1
            with self._stats_lock:
                self._stats["dropped"]["queue"] += 1
            hook = self._pressure_hook
            if hook is not None:
                try:
                    hook(e)  # ENOSPC sheds the disk ladder immediately
                except Exception:  # noqa: BLE001 — governor must not break the writer
                    pass
            self._rlog.warning("egress_append", "egress buffer append "
                               "failed: %s", e)
            return
        self._last_batch_wall = wall
        with self._stats_lock:
            self._stats["enqueued_batches"] += 1
            self._stats["enqueued_samples"] += len(series)
            if self._head_meta is None:
                # First pending batch: seed the cached head metadata so the
                # poll thread's backlog-age read never touches the disk.
                self._head_meta = (self._seq, wall, mono)
        self._work.set()

    def _enforce_caps(self) -> None:
        """Backlog byte/age caps. Runs ONLY on the sender thread — the one
        thread that moves the ack cursor. A cap-drop concurrent with an
        in-flight send would shift the head under the sender's feet and
        make its eventual ack() discard an UNDELIVERED batch; single-
        consumer discipline makes that impossible. Each cap sheds in ONE
        cursor advance: trimming a long outage's backlog must not pay a
        cursor fsync per dropped batch."""
        cap = self.max_backlog_bytes
        if self._disk_pressure:
            cap = max(cap // 8, SHED_SEGMENT_BYTES)
        dropped = self.buffer.trim_to_bytes(cap)
        if self.max_backlog_age_s > 0:
            now = self._wallclock()
            # Cached head age first: the scan below re-reads batches from
            # disk, and paying that on EVERY sender iteration just to
            # learn the head is fresh would double the per-send head I/O.
            # _head_age is the clock-step-fenced read: this-process
            # batches age monotonically, so an NTP step can never trip
            # the age cap into mass-dropping a healthy backlog.
            if self._head_meta is None or (
                self._head_age(now) > self.max_backlog_age_s
            ):
                over_age = 0
                while True:
                    payload = self.buffer.peek_at(over_age)
                    if payload is None:
                        break
                    try:
                        head, _ = parse_batch(payload)
                        # Per-batch age with the SAME clock-step fence as
                        # the trigger: this-process batches age on their
                        # enqueue-monotonic stamp, so a forward NTP step
                        # sheds exactly the genuinely-over-age prefix —
                        # never the healthy batches behind it.
                        if self._batch_age(head, now) <= self.max_backlog_age_s:
                            break
                    except (ValueError, KeyError, TypeError):
                        pass  # unparseable: over-age by policy, shed with it
                    over_age += 1
                if over_age:
                    dropped += self.buffer.drop_oldest(over_age)
        if dropped:
            self._peek_meta()
            with self._stats_lock:
                self._stats["dropped"]["backlog"] += dropped
            self._rlog.warning(
                "egress_backlog",
                "egress backlog over cap while the receiver is unreachable; "
                "dropped %d oldest batch(es) (bounded loss by design — see "
                "--egress-max-backlog-mb/-age-s)", dropped,
            )
            # A drop can empty the buffer; persist the issued seq so a
            # restart right now cannot reuse the dropped batches' numbers.
            self._write_status()

    def _peek_meta(self) -> tuple[int, float, float] | None:
        """(seq, wall, seen_mono) of the oldest pending batch; refreshes
        the cached head metadata. Sender-thread only (reads the buffer
        from disk)."""
        payload = self.buffer.peek()
        meta: tuple[int, float, float] | None = None
        if payload is not None:
            try:
                head, _ = parse_batch(payload)
                meta = (int(head["seq"]), float(head["wall"]),
                        float(head.get("mono", 0.0)))
            except (ValueError, KeyError, TypeError):
                meta = None
        with self._stats_lock:
            self._head_meta = meta
        return meta

    # ----------------------------------------------------------- sender side

    def _sender_run(self) -> None:
        while not self._stop.is_set():
            if self.buffer.pending() == 0:
                self._work.clear()
                self._work.wait(0.25)
                continue
            self._enforce_caps()
            if self.buffer.pending() == 0:
                continue
            decision = self.breaker.decide()
            if decision == "skip":
                self._stop.wait(
                    min(max(self.breaker.seconds_until_probe, 0.05), 0.25)
                )
                continue
            try:
                progressed = self._send_one()
            except Exception as e:  # noqa: BLE001 — the sender must survive anything
                progressed = False
                self.breaker.record_failure()
                with self._stats_lock:
                    self._stats["failed_sends"] += 1
                    self._stats["last_error"] = f"unexpected: {e}"
                self._rlog.warning("egress_send", "egress send failed "
                                   "unexpectedly: %s", e)
            if not progressed and self.breaker.state == CLOSED:
                # Failure floor for the disabled-breaker configuration
                # (--egress-breaker-failures 0 never opens): a connection-
                # refused receiver fails in microseconds, and retrying
                # with zero delay would spin a full core re-compressing
                # the same head batch at kHz rates.
                self._stop.wait(0.05)

    def _send_one(self) -> bool:
        """One send attempt against the head batch. Returns True when the
        queue progressed (ack, poison skip, corrupt drop), False on a
        failed attempt. EVERY exit must leave the breaker with a recorded
        outcome: decide() already consumed this turn (possibly the single
        half-open probe), and an outcome-less return would park the
        breaker in HALF_OPEN forever — decide() then answers 'skip' until
        restart while the backlog rots."""
        payload = self.buffer.peek()
        if payload is None:
            # Transient read failure (the index says pending > 0): count
            # it against the breaker so a consumed half-open probe reopens
            # instead of wedging.
            if self.breaker.state != CLOSED:
                self.breaker.record_failure()
            return False
        try:
            head, proto = parse_batch(payload)
        except (ValueError, KeyError):
            # A foreign/torn record at the head must not wedge the queue.
            self.buffer.drop_oldest(1)
            with self._stats_lock:
                self._stats["dropped"]["corrupt"] += 1
            self._peek_meta()
            self._write_status()  # a drop can empty the buffer (seq source)
            if self.breaker.state != CLOSED:
                # The probe never reached the receiver; reopen and let the
                # next probe try the (now different) head.
                self.breaker.record_failure()
            return True
        body = snappy_compress(proto)
        headers = {
            "Content-Type": CONTENT_TYPE,
            "Content-Encoding": "snappy",
            "X-Prometheus-Remote-Write-Version": REMOTE_WRITE_VERSION,
            SEQ_HEADER: str(head.get("seq", 0)),
        }
        t0 = self._clock()
        status: int | None = None
        error = ""
        try:
            status = self._send(self.url, body, headers, self.timeout_s)
        except urllib.error.HTTPError as e:
            status = e.code
            error = f"HTTP {e.code}"
        except (urllib.error.URLError, TimeoutError, socket.timeout,
                ConnectionError, OSError) as e:
            error = f"{type(e).__name__}: {e}"
        latency = self._clock() - t0
        self.send_hist.observe(latency)
        if status is not None and 200 <= status < 300:
            self.breaker.record_success()
            self.buffer.ack()
            self._peek_meta()
            samples = int(head.get("samples", 0))
            wall = self._wallclock()
            with self._stats_lock:
                self._stats["sent_batches"] += 1
                self._stats["sent_samples"] += samples
                self._stats["last_send_latency_s"] = latency
                self._stats["last_send_ok_wall"] = wall
                self._stats["last_error"] = ""
            self._write_status()
            return True
        if status is not None and 400 <= status < 500 and status != 429:
            # Poison: the receiver is UP and rejects this batch's body.
            # Retrying forever would park every batch behind it; skip it,
            # loudly. 429 is deliberate backpressure, handled as a failure
            # (retry with backoff) below — skipping would LOSE the batch.
            self.breaker.record_success()
            self.buffer.ack()
            self._peek_meta()
            with self._stats_lock:
                self._stats["dropped"]["poison"] += 1
                self._stats["last_error"] = f"poison: HTTP {status}"
            self._rlog.warning(
                "egress_poison",
                "receiver rejected batch seq=%s with HTTP %d; skipping it "
                "(poison batches must not wedge the queue)",
                head.get("seq"), status,
            )
            self._write_status()
            return True
        self.breaker.record_failure()
        with self._stats_lock:
            self._stats["failed_sends"] += 1
            self._stats["last_send_latency_s"] = latency
            self._stats["last_error"] = error or f"HTTP {status}"
        if self.breaker.state != CLOSED:
            self._rlog.warning(
                "egress_fail",
                "egress send failed (%s); breaker %s, next probe in %.1fs, "
                "%d batch(es) buffered on disk",
                error or f"HTTP {status}", self.breaker.state,
                self.breaker.seconds_until_probe, self.buffer.pending(),
            )
        self._write_status()
        return False

    def _write_status(self) -> None:
        """Small operator-facing sidecar for `status`'s egress footer —
        written by the sender thread per attempt (~1/s), atomically."""
        doc = {
            "wall": self._wallclock(),
            "url": self.url,
            "breaker": self.breaker.state,
            "backlog_batches": self.buffer.pending(),
            "backlog_bytes": self.buffer.pending_bytes(),
            # Last issued batch seq — the drained-buffer restart's only
            # seq source (see load()).
            "seq": self._seq,
        }
        with self._stats_lock:
            doc.update(
                last_send_latency_s=self._stats["last_send_latency_s"],
                last_send_ok_wall=self._stats["last_send_ok_wall"],
                last_error=self._stats["last_error"],
                sent_batches=self._stats["sent_batches"],
            )
        try:
            atomic_write(
                os.path.join(self.egress_dir, STATUS_NAME),
                json.dumps(doc).encode(),
            )
        except OSError:
            pass

    # ------------------------------------------------- pressure-shed hooks

    def set_disk_pressure(self, on: bool) -> None:
        """Disk-ladder rung ``egress_compact`` (tpu_pod_exporter_torch.pressure):
        tiny segment rotation so acked bytes reclaim promptly (lossless)
        plus a tightened pending-backlog cap (bounded loss only while the
        receiver is down). Idempotent; reversed on recovery."""
        self._disk_pressure = bool(on)
        self.buffer.segment_max_bytes = (
            SHED_SEGMENT_BYTES if on else self._normal_segment_bytes
        )
        if on:
            # Reclaim acked bytes NOW, not at the next append: with the
            # producer stalled, the lazily-rotated active segment can be
            # 100% acked yet hold the disk over budget forever (the
            # fuzzer's one-round disk_full find).
            self.buffer.seal_active()
        self._work.set()  # wake the sender so the cap applies promptly

    def set_pressure_hook(self, hook: Callable[[BaseException], bool]) -> None:
        """Governor callback for buffer-append failures (ENOSPC sheds the
        disk ladder immediately instead of waiting for a usage scan)."""
        self._pressure_hook = hook

    # ----------------------------------------------------------------- state

    @property
    def degraded(self) -> bool:
        """/readyz degraded predicate — same reopen threshold as sources."""
        return (
            self.breaker.state != CLOSED
            and self.breaker.reopens >= DEGRADED_AFTER_REOPENS
        )

    def _batch_age(self, head: Mapping[str, Any], now_wall: float) -> float:
        """Clock-step-fenced age of one batch header: batches created by
        this process age on their enqueue-MONOTONIC stamp (exact — an NTP
        step can neither inflate their age into an age-cap mass-drop nor
        hide a genuinely stale slowly-draining backlog); batches restored
        from a pre-restart backlog age on wall time (their mono stamp
        belongs to a dead clock). Never negative either way (a
        future-stamped batch reads as fresh, not as a fault)."""
        mono = float(head.get("mono", 0.0))
        # mono == 0: an unstamped frame (externally appended / older
        # format) — wall age is the only honest read, never "monotonic
        # since boot" (which would mass-expire it as ancient).
        if mono > 0 and int(head.get("seq", 0)) > self._boot_seq:
            return max(self._clock() - mono, 0.0)
        return max(now_wall - float(head.get("wall", 0.0)), 0.0)

    def _head_age(self, now_wall: float) -> float:
        """:meth:`_batch_age` of the CACHED head metadata (poll-thread
        safe: no buffer file reads)."""
        with self._stats_lock:
            meta = self._head_meta
        if meta is None:
            return 0.0
        seq, wall, mono = meta
        return self._batch_age({"seq": seq, "wall": wall, "mono": mono},
                               now_wall)

    def backlog_age_s(self) -> float:
        """Age of the oldest pending batch, from the CACHED head metadata
        only — this is read on the poll thread (collector emit), which
        must never touch the buffer's files."""
        if self.buffer.pending() == 0:
            return 0.0
        return self._head_age(self._wallclock())

    def stats(self) -> dict:
        with self._stats_lock:
            out: dict[str, Any] = dict(self._stats)
            out["dropped"] = dict(self._stats["dropped"])
        out["backlog_batches"] = self.buffer.pending()
        out["backlog_bytes"] = self.buffer.pending_bytes()
        out["backlog_age_s"] = self.backlog_age_s()
        out["breaker_state"] = self.breaker.state
        out["breaker_state_value"] = STATE_VALUES[self.breaker.state]
        out["breaker_reopens"] = self.breaker.reopens
        out["seq"] = self._seq
        out["degraded"] = self.degraded
        out["disk_pressure"] = self._disk_pressure
        if self._open_errors:
            out["open_errors"] = list(self._open_errors)
        return out

    def emit(self, b: Any) -> None:
        """Publish the egress self-metric surface into a SnapshotBuilder
        (called from the collector's / aggregator's publish)."""
        for spec in schema.EGRESS_SPECS:
            b.declare(spec)
        s = self.stats()
        b.add(schema.TPU_EXPORTER_EGRESS_SENT_BATCHES_TOTAL,
              float(s["sent_batches"]))
        b.add(schema.TPU_EXPORTER_EGRESS_SENT_SAMPLES_TOTAL,
              float(s["sent_samples"]))
        b.add(schema.TPU_EXPORTER_EGRESS_FAILED_SENDS_TOTAL,
              float(s["failed_sends"]))
        for reason, n in s["dropped"].items():
            b.add(schema.TPU_EXPORTER_EGRESS_DROPPED_TOTAL, float(n),
                  (reason,))
        b.add(schema.TPU_EXPORTER_EGRESS_BACKLOG_BATCHES,
              float(s["backlog_batches"]))
        b.add(schema.TPU_EXPORTER_EGRESS_BACKLOG_BYTES,
              float(s["backlog_bytes"]))
        b.add(schema.TPU_EXPORTER_EGRESS_BACKLOG_AGE_SECONDS,
              s["backlog_age_s"])
        b.add(schema.TPU_EXPORTER_EGRESS_BREAKER_STATE,
              s["breaker_state_value"])
        self.send_hist.emit(b)

    def ready_detail(self) -> dict:
        """Egress block for the /readyz JSON body."""
        s = self.stats()
        return {
            "breaker_state": s["breaker_state"],
            "backlog_batches": s["backlog_batches"],
            "backlog_bytes": s["backlog_bytes"],
            "backlog_age_s": round(s["backlog_age_s"], 3),
            "last_error": s["last_error"],
            "degraded": s["degraded"],
        }

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._work.set()
        for t in (self._writer, self._sender):
            if t is not None:
                t.join(timeout)
        self._writer = self._sender = None
        self._write_status()
        self.buffer.close()


# ------------------------------------------------------------- status footer


def egress_dir_summary(egress_dir: str) -> dict:
    """Lightweight on-disk summary for ``status``'s ``egress:`` footer and
    /debug/vars: segment sizes plus the shipper's own status sidecar (no
    record parsing — same cheapness contract as state_dir_summary)."""
    out: dict[str, Any] = {
        "egress_dir": egress_dir,
        "exists": os.path.isdir(egress_dir),
        "segment_bytes": 0,
        "segments": 0,
        "status": None,
    }
    if not out["exists"]:
        return out
    try:
        for name in os.listdir(egress_dir):
            if name.startswith("seg-") and name.endswith(".wal"):
                try:
                    out["segment_bytes"] += os.stat(
                        os.path.join(egress_dir, name)
                    ).st_size
                    out["segments"] += 1
                except OSError:
                    continue
    except OSError:
        pass
    try:
        with open(os.path.join(egress_dir, STATUS_NAME),
                  encoding="utf-8") as f:
            out["status"] = json.load(f)
    except (OSError, ValueError):
        pass
    return out


# -------------------------------------------------------------------- checks


def _wait(predicate: Callable[[], bool], timeout_s: float,
          interval_s: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return predicate()


def _metric_value(base: str, name: str, timeout: float = 5.0) -> float:
    with urllib.request.urlopen(base + "/metrics", timeout=timeout) as r:
        body = r.read().decode()
    for line in body.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{"):
            try:
                return float(line.rsplit(" ", 1)[1])
            except ValueError:
                continue
    return float("nan")


def _p99(samples: list[float]) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(int(len(s) * 0.99), len(s) - 1)]


def _sample_perf(base: str, n: int, interval_s: float) -> tuple[float, float]:
    """(scrape_p99_s, poll_total_p99_s) over n samples against a live
    exporter — the demo's egress-on vs -off perf comparison."""
    scrapes: list[float] = []
    polls: list[float] = []
    for _ in range(n):
        t0 = time.perf_counter()
        with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
            r.read()
        scrapes.append(time.perf_counter() - t0)
        with urllib.request.urlopen(base + "/debug/vars", timeout=5) as r:
            dv = json.loads(r.read())
        total = (dv.get("last_poll") or {}).get("total_s")
        if isinstance(total, (int, float)):
            polls.append(float(total))
        time.sleep(interval_s)
    return _p99(scrapes), _p99(polls)


def _demo(ns: Any) -> int:
    """``make egress-demo``: wedge → open → backlog → SIGKILL mid-send →
    WAL-backed resume → drain, with zero loss and no acked re-send."""
    import shutil
    import signal as _signal
    import subprocess
    import sys
    import tempfile

    from tpu_pod_exporter_torch.chaos import ChaosReceiver, parse_chaos_spec
    from tpu_pod_exporter_torch.persist import _wait_http

    own_dir = not ns.egress_dir
    egress_dir = ns.egress_dir or tempfile.mkdtemp(prefix="tpe-egress-demo-")
    os.makedirs(egress_dir, exist_ok=True)
    interval = 0.2
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = f"http://127.0.0.1:{port}"

    # Seeded flap schedule: requests 0-5 healthy, then two 2.5 s hangs,
    # three 500s, two 429s, one mid-body truncation, healthy after.
    spec = ("hang:recv:1:2500ms:@6:x2,err:recv:1:@8:x3,"
            "reject:recv:1:@11:x2,truncate:recv:1:@13:x1")
    recv = ChaosReceiver(parse_chaos_spec(spec), seed=ns.seed)
    recv.start()
    print(f"chaos receiver on {recv.url}  (spec: {spec}, seed {ns.seed})")

    def cmd(egress: bool) -> list[str]:
        out = [
            sys.executable, "-m", "tpu_pod_exporter_torch",
            "--host", "127.0.0.1", "--port", str(port),
            "--backend", "fake", "--fake-chips", "4",
            "--attribution", "none",
            "--interval-s", f"{interval:g}",
            "--history-retention-s", "60",
            "--log-level", "warning",
        ]
        if egress:
            out += [
                "--egress-url", recv.url,
                "--egress-dir", egress_dir,
                "--egress-interval-s", f"{interval:g}",
                "--egress-timeout-s", "1",
                "--egress-breaker-failures", "2",
                "--egress-breaker-backoff-s", "0.5",
                "--egress-breaker-backoff-max-s", "2",
            ]
        return out

    child: subprocess.Popen | None = None
    rc = 1
    try:
        # ---- phase 0: egress-OFF perf baseline --------------------------
        print("phase 0: egress-off baseline (scrape + poll p99)")
        child = subprocess.Popen(cmd(egress=False))
        _wait_http(base + "/readyz", 30)
        base_scrape, base_poll = _sample_perf(base, ns.perf_samples, 0.05)
        child.terminate()
        child.wait(timeout=10)
        print(f"         baseline: scrape p99 {1e3 * base_scrape:.2f}ms, "
              f"poll p99 {1e3 * base_poll:.2f}ms")

        # ---- phase 1: healthy egress ------------------------------------
        print("phase 1: egress on, receiver healthy")
        child = subprocess.Popen(cmd(egress=True))
        _wait_http(base + "/readyz", 30)
        if not _wait(lambda: recv.accepted_batches() >= 3, 20):
            print(f"FAIL: receiver accepted only "
                  f"{recv.accepted_batches()} batches")
            return 1
        print(f"         {recv.accepted_batches()} batches delivered")

        # ---- phase 2: seeded wedge — breaker opens, backlog grows -------
        print("phase 2: receiver flapping (hang/5xx/429/truncate) — "
              "expecting breaker open + disk backlog")
        saw_open = _wait(
            lambda: _metric_value(
                base, "tpu_exporter_egress_breaker_state") >= 1.0,
            30,
        )
        if not saw_open:
            print("FAIL: egress breaker never opened during the wedge")
            return 1
        _wait(
            lambda: _metric_value(
                base, "tpu_exporter_egress_backlog_batches") >= 2.0,
            20,
        )
        backlog = _metric_value(base, "tpu_exporter_egress_backlog_batches")
        wedge_scrape, wedge_poll = _sample_perf(base, ns.perf_samples, 0.05)
        print(f"         breaker OPEN, backlog {backlog:g} batch(es); "
              f"during wedge: scrape p99 {1e3 * wedge_scrape:.2f}ms, "
              f"poll p99 {1e3 * wedge_poll:.2f}ms")
        # Poll/scrape isolation: egress ON + wedged receiver must stay
        # within budget of the egress-OFF baseline (absolute floor keeps
        # micro-benchmark noise from failing a passing design).
        scrape_budget = base_scrape * (1.0 + ns.perf_budget) + 0.002
        poll_budget = base_poll * (1.0 + ns.perf_budget) + 0.002
        if wedge_scrape > scrape_budget or wedge_poll > poll_budget:
            print(f"FAIL: wedged-receiver p99 over budget (scrape "
                  f"{1e3 * wedge_scrape:.2f} > {1e3 * scrape_budget:.2f}ms "
                  f"or poll {1e3 * wedge_poll:.2f} > "
                  f"{1e3 * poll_budget:.2f}ms)")
            return 1

        # ---- phase 3: SIGKILL mid-send ----------------------------------
        print("phase 3: SIGKILL mid-send (receiver holds the in-flight "
              "request; no drain, no ack)")
        inflight = recv.hold_next(hold_s=10.0)
        if not inflight.wait(30):
            print("FAIL: no send arrived to hold")
            return 1
        child.send_signal(_signal.SIGKILL)
        child.wait(timeout=10)
        recv.release_hold()
        print("         killed mid-send; backlog is on disk, cursor "
              "fsynced at the last ack")

        # ---- phase 4: restart → WAL-backed resume → drain ---------------
        print("phase 4: restart on the same egress dir; receiver healthy")
        t_restart = time.monotonic()
        child = subprocess.Popen(cmd(egress=True))
        _wait_http(base + "/readyz", 30)
        drained = _wait(
            lambda: _metric_value(
                base, "tpu_exporter_egress_backlog_batches") == 0.0
            and recv.accepted_batches() > 0,
            ns.drain_budget_s,
            interval_s=0.1,
        )
        drain_s = time.monotonic() - t_restart
        if not drained:
            print(f"FAIL: backlog did not drain within "
                  f"{ns.drain_budget_s:g}s budget")
            return 1
        print(f"         backlog drained {drain_s:.1f}s after restart "
              f"(budget {ns.drain_budget_s:g}s)")
        # Let a few more healthy sends land, then audit the ledger.
        time.sleep(6 * interval)
        stats = recv.stats()
        seqs = stats["accepted_seqs"]
        if not seqs:
            print("FAIL: receiver accepted nothing")
            return 1
        missing = sorted(set(range(min(seqs), max(seqs) + 1)) - set(seqs))
        if missing:
            print(f"FAIL: zero-loss violated — batch seq(s) {missing} "
                  f"were enqueued but never delivered")
            return 1
        if stats["duplicate_seqs"]:
            print(f"FAIL: acked batches re-sent: {stats['duplicate_seqs']}")
            return 1
        if stats["duplicate_samples"]:
            print(f"FAIL: {stats['duplicate_samples']} duplicate "
                  f"(series, timestamp) samples accepted")
            return 1
        print(f"         ledger: {len(seqs)} batches seq "
              f"{min(seqs)}..{max(seqs)} contiguous, 0 duplicate batches, "
              f"0 duplicate samples, {stats['accepted_samples']} samples "
              f"delivered exactly once")
        print("egress-demo: OK (wedge → open → backlog → SIGKILL mid-send "
              "→ WAL resume → drain; zero loss, no acked re-send, poll/"
              "scrape p99 within budget while wedged)")
        rc = 0
    finally:
        if child is not None and child.poll() is None:
            child.terminate()
            try:
                child.wait(timeout=10)
            except subprocess.TimeoutExpired:
                child.kill()
        recv.stop()
        if own_dir and rc == 0:
            shutil.rmtree(egress_dir, ignore_errors=True)
        elif rc != 0:
            print(f"egress dir kept for inspection: {egress_dir}")
    return rc


def _drain_check(ns: Any) -> int:
    """Backlog-drain budget: synthesize the backlog an ``--outage-s``
    receiver outage leaves behind (one batch per egress interval), then
    let the sender drain it against an in-process receiver and fail if the
    drain exceeds ``--budget-s``. In-process and send-injected: this
    measures the shipper's drain throughput, not socket setup."""
    import tempfile

    batches = max(int(ns.outage_s / max(ns.egress_interval_s, 0.05)), 1)
    egress_dir = ns.egress_dir or tempfile.mkdtemp(prefix="tpe-drain-check-")
    accepted: list[int] = []

    def send(url: str, body: bytes, headers: Mapping[str, str],
             timeout_s: float) -> int:
        parse_write_request(snappy_decompress(body))  # must decode
        accepted.append(int(headers[SEQ_HEADER]))
        return 200

    shipper = RemoteWriteShipper(
        "http://drain-check.invalid/api/v1/write", egress_dir, send=send,
        interval_s=0.0,
    )
    shipper.load()
    # Writer-thread work done inline: frame batches the shape a 4-chip
    # exporter produces (the demo shape), straight into the buffer.
    labels = [("__name__", "tpu_hbm_used_bytes"), ("chip_id", "0"),
              ("host", "drain-check")]
    t_build = time.monotonic()
    for i in range(batches):
        proto = encode_write_request(
            [(labels, [(float(i), 1_700_000_000_000 + i)])] * 24
        )
        shipper.buffer.append(frame_batch(i + 1, time.time(), "delta", 24,
                                          proto))
    build_s = time.monotonic() - t_build
    t0 = time.monotonic()
    shipper.start()
    ok = _wait(lambda: shipper.buffer.pending() == 0, ns.budget_s + 5,
               interval_s=0.02)
    drain_s = time.monotonic() - t0
    shipper.close()
    import shutil

    if not ns.egress_dir:
        shutil.rmtree(egress_dir, ignore_errors=True)
    print(f"drain-check: {batches} batches (a {ns.outage_s:g}s outage at "
          f"{ns.egress_interval_s:g}s cadence, built+fsynced in "
          f"{build_s:.1f}s) drained in {drain_s:.2f}s "
          f"(budget {ns.budget_s:g}s)")
    if not ok or drain_s > ns.budget_s:
        print("FAIL: backlog drain exceeded budget")
        return 1
    # Unsorted: the arrival order IS the assertion — sorting would let an
    # out-of-order drain regression slip the "in-order" half of the gate.
    if accepted != list(range(1, batches + 1)):
        print("FAIL: drain was not in-order exactly-once")
        return 1
    print("OK: backlog drains within budget, in order, exactly once")
    return 0


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="tpu-pod-exporter-egress",
        description="Remote-write egress harness: chaos-receiver demo and "
                    "backlog-drain budget check.",
    )
    p.add_argument("--demo", action="store_true",
                   help="wedge a live exporter's egress with a seeded "
                        "chaos receiver, SIGKILL mid-send, assert "
                        "zero-loss exactly-once drain after restart")
    p.add_argument("--egress-dir", default="",
                   help="send-buffer dir for --demo/--drain-check "
                        "(default: a temp dir, removed on success)")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--drain-budget-s", type=float, default=30.0,
                   help="max seconds from restart to a fully-drained "
                        "backlog in --demo")
    p.add_argument("--perf-budget", type=float, default=0.05,
                   help="max fractional scrape/poll p99 regression with "
                        "egress on + receiver wedged vs egress off "
                        "(plus a 2 ms absolute noise floor)")
    p.add_argument("--perf-samples", type=int, default=30)
    p.add_argument("--drain-check", action="store_true",
                   help="synthesize an --outage-s backlog and fail if it "
                        "drains slower than --budget-s")
    p.add_argument("--outage-s", type=float, default=180.0)
    p.add_argument("--egress-interval-s", type=float, default=1.0)
    p.add_argument("--budget-s", type=float, default=20.0)
    ns = p.parse_args(argv)

    if ns.demo:
        return _demo(ns)
    if ns.drain_check:
        return _drain_check(ns)
    p.error("need --demo or --drain-check")
    return 2


if __name__ == "__main__":
    import sys

    sys.exit(main())
