"""Crash-safe state persistence — restart survivability for the exporter.

Everything the exporter has learned lives in process memory: the history
flight recorder's rings, each source's circuit-breaker state, and the
pre-encoded exposition snapshot. A DaemonSet rolling update, an
OOM-kill, or a node drain discards all of it — ``/readyz`` drops to 503,
the aggregator's ``--history-fallback-window`` has a hole it cannot fill,
and every breaker re-learns a still-wedged source from closed. The
reference exporter has the same amnesia (``main.go:74-114`` rebuilds from
scratch every cycle); at production scale the single most common scenario —
the process restarting — must be a non-event.

:class:`StatePersister` makes it one, with two cooperating files under
``--state-dir``:

- ``snapshot.bin`` — a periodic full checkpoint (history rings, breaker
  states with open-until wall timestamps, the last published exposition
  with its poll timestamp), written to a temp file, fsynced, and renamed
  into place — a crash mid-rotation can never leave a half checkpoint.
- ``wal.bin`` — an append-only log between checkpoints: one ``samples``
  record per poll (the tracked families' values in a layout-described
  order), plus ``layout`` records on churn and ``breaker`` records on
  state transitions.

Every record is individually CRC-checked. On boot :meth:`StatePersister.load`
replays snapshot + WAL with torn-write tolerance — the WAL is truncated at
the first corrupt record, a bad snapshot restores whatever consistent
prefix it holds, and NOTHING refuses to start: a hopeless state dir logs a
warning and cold-starts. The restored exposition is served immediately
(:class:`RestoredSnapshot` patches ``tpu_exporter_warm_start 1`` and the
measured ``tpu_exporter_snapshot_stale_seconds`` into the cached bytes) so
scrapes and the aggregator see continuity instead of a gap, while
``/readyz`` reports a distinct ``warm`` state until the first live poll.

Threading: the poll thread's per-poll cost is a breaker-signature check and
one queue put — snapshots are immutable after the swap, so the writer
thread extracts values, frames records, and does every byte of I/O off the
poll loop (the same discipline as the history append: persistence can
never stretch a poll, and a wedged disk drops WAL records rather than
wedging polling). ``--state-dir ""`` (the default) disables the layer
entirely.

CLI (``python -m tpu_pod_exporter_torch.persist``):

- ``--restart-demo``  — the kill/restart chaos harness (``make
  restart-demo``): SIGKILLs a live exporter mid-poll via the chaos
  ``kill`` injection, restarts it on the same state dir, and asserts
  history continuity, breaker-state carryover, and corrupt-WAL cold-start.
- ``--fsync-check``   — fsync-latency budget on the persistence hot path.
- ``--overhead-check`` — poll-thread CPU with persistence on vs off.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import struct
import threading
import time
import zlib
from array import array
from collections import deque
from dataclasses import dataclass, field
from typing import IO, TYPE_CHECKING, Any, Callable, Iterator, Mapping

if TYPE_CHECKING:  # typing only — no runtime import cost
    from tpu_pod_exporter_torch.history import HistoryStore
    from tpu_pod_exporter_torch.metrics.registry import Snapshot
    from tpu_pod_exporter_torch.supervisor import SourceSupervisor

from tpu_pod_exporter_torch.utils import RateLimitedLogger

log = logging.getLogger("tpu_pod_exporter_torch.persist")

# File magic: 8 bytes, versioned. A magic mismatch means "not ours /
# future format" — treated as an empty file, never a crash.
MAGIC = b"TPEPST01"

# Record framing: <payload_len, crc32(payload)> then payload. The CRC is
# the torn-write detector: a record whose bytes were cut by a crash (or
# scrambled by a bad disk) fails its checksum and everything from it on is
# ignored — the consistent prefix before it is the restored state.
_HDR = struct.Struct("<II")
_F64 = struct.Struct("<d")

# Hard sanity bound on one record: a corrupted length field must not make
# the reader allocate gigabytes before the CRC gets a chance to reject it.
MAX_RECORD_BYTES = 256 << 20

SNAPSHOT_NAME = "snapshot.bin"
WAL_NAME = "wal.bin"

# Payload type bytes (payload[0:1]):
#   J  JSON control: {"t": "meta" | "layout" | "breaker" | "end"}
#   S  per-poll samples: <d wall> + float64 values in current layout order
#   R  one series' ring dump: <I jlen> + json{"m","l"} + (wall, value)*
#   E  exposition: <d poll_timestamp> + raw exposition bytes


def append_record(f: IO[bytes], payload: bytes) -> int:
    """Frame + write one record; returns bytes written (buffered, not
    synced — fsync cadence is the caller's policy)."""
    f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
    f.write(payload)
    return _HDR.size + len(payload)


def _walk_records(
    path: str, collect_payloads: bool
) -> tuple[list[tuple[int, int]], list[bytes], int, str | None]:
    """The ONE CRC-framed record walker (read_record_file and the
    WalBuffer segment scan are both views of it — the framing rules must
    never exist twice). Returns (offsets, payloads, valid_bytes, error):
    ``offsets`` is [(payload_offset, payload_len), ...] for the longest
    clean prefix, ``payloads`` the corresponding bytes when requested,
    ``valid_bytes`` the file offset just past the prefix (the truncate
    point for a torn tail), ``error`` why reading stopped early (None for
    a clean end-of-file)."""
    offsets: list[tuple[int, int]] = []
    payloads: list[bytes] = []
    try:
        f = open(path, "rb")
    except FileNotFoundError:
        return offsets, payloads, 0, None
    except OSError as e:
        return offsets, payloads, 0, f"unreadable: {e}"
    with f:
        head = f.read(len(MAGIC))
        if len(head) < len(MAGIC):
            return offsets, payloads, 0, None if not head else "short magic"
        if head != MAGIC:
            return offsets, payloads, 0, f"bad magic {head!r}"
        valid = len(MAGIC)
        while True:
            hdr = f.read(_HDR.size)
            if not hdr:
                return offsets, payloads, valid, None
            if len(hdr) < _HDR.size:
                return offsets, payloads, valid, "torn record header"
            length, crc = _HDR.unpack(hdr)
            if length > MAX_RECORD_BYTES:
                return (offsets, payloads, valid,
                        f"implausible record length {length}")
            payload = f.read(length)
            if len(payload) < length:
                return offsets, payloads, valid, "torn record payload"
            if zlib.crc32(payload) != crc:
                return offsets, payloads, valid, "record CRC mismatch"
            offsets.append((valid + _HDR.size, length))
            if collect_payloads:
                payloads.append(payload)
            valid += _HDR.size + length


def read_record_file(path: str) -> tuple[list[bytes], int, str | None]:
    """Read a record file; returns (payloads, valid_bytes, error) — the
    longest clean prefix of records (see :func:`_walk_records`)."""
    _offsets, payloads, valid, err = _walk_records(path, True)
    return payloads, valid, err


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it is durable (best-effort —
    some filesystems refuse directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, data: bytes) -> None:
    """write-temp, fsync, rename — the snapshot-rotation discipline."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


# --------------------------------------------------------------- warm start


def _rewrite_counter_headers(body: bytes) -> bytes:
    """Plain-text exposition → OpenMetrics header shape: counter HELP/TYPE
    lines drop the ``_total`` suffix (same transform as
    ``Snapshot.encode_openmetrics``, but self-describing from the body so a
    restored exposition needs no schema objects)."""
    for line in body.split(b"\n"):
        if line.startswith(b"# TYPE ") and line.endswith(b" counter"):
            name = line[len(b"# TYPE "):-len(b" counter")]
            if not name.endswith(b"_total"):
                continue
            base = name[: -len(b"_total")]
            for old, new in (
                (b"# HELP " + name + b" ", b"# HELP " + base + b" "),
                (b"# TYPE " + name + b" counter",
                 b"# TYPE " + base + b" counter"),
            ):
                if body.startswith(old):
                    body = new + body[len(old):]
                else:
                    body = body.replace(b"\n" + old, b"\n" + new, 1)
    return body


class RestoredSnapshot:
    """A served-from-disk stand-in for :class:`metrics.Snapshot`.

    Wraps the persisted exposition bytes with the warm-start markers
    patched in: ``tpu_exporter_warm_start`` flips to 1 and
    ``tpu_exporter_snapshot_stale_seconds`` carries how old the restored
    data was when serving resumed (both series exist in every live body, so
    this is a value edit, not a header injection). ``timestamp`` is the
    restore instant — the snapshot starts *serving* now; the underlying
    poll's wall time stays readable as ``poll_timestamp`` (and as the
    body's own ``tpu_exporter_last_poll_timestamp_seconds``), which keeps
    ``/healthz``'s staleness rule measuring serving age, not data age — a
    warm boot must not be instantly "stale" and crash-looped by kubelet.
    """

    def __init__(self, body: bytes, poll_timestamp: float,
                 restored_at: float | None = None) -> None:
        import re

        now = time.time() if restored_at is None else restored_at
        self.poll_timestamp = poll_timestamp
        self.timestamp = now
        self.stale_s = max(now - poll_timestamp, 0.0)
        from tpu_pod_exporter_torch.metrics.registry import format_value

        stale = format_value(round(self.stale_s, 3)).encode()
        body = re.sub(rb"^tpu_exporter_warm_start .*$",
                      b"tpu_exporter_warm_start 1", body, count=1,
                      flags=re.M)
        body = re.sub(rb"^tpu_exporter_snapshot_stale_seconds .*$",
                      b"tpu_exporter_snapshot_stale_seconds " + stale,
                      body, count=1, flags=re.M)
        self._body = body
        self._gzipped: bytes | None = None
        self._openmetrics: bytes | None = None
        self._openmetrics_gzipped: bytes | None = None
        self._series_count: int | None = None

    @property
    def series_count(self) -> int:
        if self._series_count is None:
            self._series_count = sum(
                1 for line in self._body.split(b"\n")
                if line and not line.startswith(b"#")
            )
        return self._series_count

    def encode(self) -> bytes:
        return self._body

    def encode_gzip(self) -> bytes:
        # Lock-free lazy cache (same idiom as registry.BodySet): racing
        # scrapers may both compress once — identical bytes, GIL-atomic
        # publish, and no thread ever holds a lock across the compression.
        gz = self._gzipped
        if gz is None:
            import gzip

            gz = gzip.compress(self._body, compresslevel=1)
            self._gzipped = gz
        return gz

    def encode_openmetrics(self) -> bytes:
        om = self._openmetrics
        if om is None:
            om = _rewrite_counter_headers(self._body) + b"# EOF\n"
            self._openmetrics = om
        return om

    def encode_openmetrics_gzip(self) -> bytes:
        gz = self._openmetrics_gzipped
        if gz is None:
            import gzip

            gz = gzip.compress(self.encode_openmetrics(), compresslevel=1)
            self._openmetrics_gzipped = gz
        return gz

    def cached_exposition(self, openmetrics: bool = False,
                          gzipped: bool = False) -> bytes | None:
        """Event-loop fast path (see ``Snapshot.cached_exposition``): the
        restored identity body is always in memory; derived encodings are
        served inline once the first (worker-rendered) request cached
        them."""
        if openmetrics:
            return self._openmetrics_gzipped if gzipped else self._openmetrics
        if gzipped:
            return self._gzipped
        return self._body


# ------------------------------------------------------------------- restore


@dataclass
class RestoredState:
    """What :meth:`StatePersister.load` brought back (all best-effort)."""

    exposition: bytes | None = None
    exposition_ts: float = 0.0
    breakers: dict[str, dict] = field(default_factory=dict)
    series: int = 0
    samples: int = 0
    wal_records: int = 0
    max_wall: float = 0.0
    errors: list[str] = field(default_factory=list)

    @property
    def restored(self) -> bool:
        return bool(
            self.exposition or self.series or self.samples or self.breakers
        )


class StatePersister:
    """Periodic checksummed snapshot + per-poll WAL under ``state_dir``.

    Construction never raises on a bad directory (it tries to create it
    and records the failure); ``load()`` restores whatever consistent
    state exists; ``start()`` spawns the writer thread; ``on_poll()`` is
    the poll thread's only touchpoint. ``close()`` drains the queue and
    writes a final fsynced snapshot — the SIGTERM flush.
    """

    def __init__(
        self,
        state_dir: str,
        history: "HistoryStore | None" = None,
        supervisors: Mapping[str, SourceSupervisor] | None = None,
        # () -> Snapshot-like (encode()/timestamp)
        exposition_fn: Callable[[], Any] | None = None,
        snapshot_interval_s: float = 60.0,
        fsync_interval_s: float = 5.0,
        queue_max: int = 8,
        clock: Callable[[], float] = time.monotonic,
        wallclock: Callable[[], float] = time.time,
    ) -> None:
        self.state_dir = state_dir
        self.snapshot_path = os.path.join(state_dir, SNAPSHOT_NAME)
        self.wal_path = os.path.join(state_dir, WAL_NAME)
        self._history = history
        self._supervisors = supervisors or {}
        self._exposition_fn = exposition_fn
        self.snapshot_interval_s = snapshot_interval_s
        self.fsync_interval_s = fsync_interval_s
        self._clock = clock
        self._wallclock = wallclock
        self._rlog = RateLimitedLogger(log)
        # Persisted families = exactly what the history recorder tracks;
        # sorted for a deterministic layout order.
        from tpu_pod_exporter_torch.history import HISTORY_TRACKED_METRICS

        self._metric_order = tuple(sorted(HISTORY_TRACKED_METRICS))
        # Bounded handoff: queue items hold references to IMMUTABLE
        # snapshots, so the writer reads them without copies or locks. A
        # stalled disk fills the queue and drops WAL records (counted) —
        # persistence degrades, polling never does.
        self._q: queue.Queue = queue.Queue(maxsize=queue_max)
        self._thread: threading.Thread | None = None
        # Poll-side breaker change detection (cheap signatures).
        self._breaker_sigs: dict[str, tuple] = {}
        # Writer-side state (single-threaded: the writer owns these).
        self._wal = None
        self._wal_dirty = False
        self._last_fsync = 0.0
        self._last_rotate = 0.0
        self._fam_keys: dict[str, tuple] = {}
        self._fam_names: tuple[str, ...] = ()
        # Resource-pressure shed state (tpu_pod_exporter_torch.pressure): the
        # governor's disk-ladder rungs flip these. Written on the governor
        # thread, read on the writer thread — plain attribute flips, no
        # lock needed (any single read is consistent).
        self._wal_stride = 1       # write every Nth samples record
        self._wal_enabled = True   # False = WAL-off-but-serving (last rung)
        self._snapshot_factor = 1.0  # checkpoint interval multiplier
        self._stride_seq = 0
        # Checkpoint retry: a failed rotation retries on this cadence
        # instead of waiting out a full snapshot interval (the WAL-reopen
        # discipline applied to the checkpoint path).
        self._snapshot_failed = False
        self._last_snapshot_attempt = 0.0
        self._pressure_hook: Callable[[BaseException], bool] | None = None
        self._stats_lock = threading.Lock()
        self._stats = {
            "wal_records": 0,
            "wal_samples": 0,
            "wal_bytes": 0,
            "snapshots": 0,
            "errors": 0,
            "dropped": 0,
            "fsyncs": 0,
            "last_fsync_s": 0.0,
            "last_snapshot_wall": 0.0,
        }
        # Reason splits (same totals as errors/dropped above): ENOSPC is a
        # FULL disk, not a flaky one — the DiskPressure alert keys on it.
        self._errors_by_reason = {"disk_full": 0, "io": 0}
        self._dropped_by_reason = {
            "queue": 0, "disk_full": 0, "io": 0, "shed": 0,
        }
        self.restored_info: dict = {"restored": False}
        self._dir_error: str | None = None
        try:
            os.makedirs(state_dir, exist_ok=True)
        except OSError as e:
            self._dir_error = str(e)
            log.error("state dir %s unusable (%s); persistence disabled "
                      "for this run", state_dir, e)

    # ------------------------------------------------------------------ load

    def load(self) -> RestoredState:
        """Replay snapshot + WAL into the attached history store and
        breakers. Never raises: any corruption restores the clean prefix
        before it; a hopeless state dir logs and returns an empty state
        (cold start)."""
        rs = RestoredState()
        if self._dir_error is not None:
            rs.errors.append(self._dir_error)
            return rs
        # Orphaned temp files from atomic writes a crash (or ENOSPC)
        # interrupted between write and rename: reclaim them before they
        # silently eat the very disk budget the pressure governor polices.
        # Age 0 is safe here — load() runs before the writer thread exists.
        from tpu_pod_exporter_torch.pressure import reclaim_tmp_files

        reclaim_tmp_files([self.state_dir], min_age_s=0.0)
        try:
            self._load_inner(rs)
        except Exception as e:  # noqa: BLE001 — NEVER refuse to start
            rs.errors.append(f"unexpected restore failure: {e}")
            log.warning("state restore failed (%s); cold-starting", e,
                        exc_info=True)
        for err in rs.errors:
            log.warning("state restore: %s (continuing with the clean "
                        "prefix)", err)
        if rs.restored:
            log.info(
                "warm state restored from %s: %d series / %d samples, "
                "%d breaker(s), exposition %s (%d WAL records)",
                self.state_dir, rs.series, rs.samples, len(rs.breakers),
                "present" if rs.exposition else "absent", rs.wal_records,
            )
        self.restored_info = {
            "restored": rs.restored,
            "series": rs.series,
            "samples": rs.samples,
            "breakers": sorted(rs.breakers),
            "wal_records": rs.wal_records,
            "errors": list(rs.errors),
        }
        return rs

    def _load_inner(self, rs: RestoredState) -> None:
        now_mono = self._clock()
        now_wall = self._wallclock()
        offset = now_wall - now_mono

        def wall_to_mono(w: float) -> float:
            return w - offset

        # --- snapshot.bin: the checkpoint baseline ---
        payloads, _, err = read_record_file(self.snapshot_path)
        if err:
            rs.errors.append(f"{SNAPSHOT_NAME}: {err}")
        saw_end = False
        for payload in payloads:
            try:
                self._apply_snapshot_record(payload, rs, wall_to_mono)
                if payload[:1] == b"J":
                    doc = json.loads(payload[1:])
                    if doc.get("t") == "end":
                        saw_end = True
            except Exception as e:  # noqa: BLE001 — prefix semantics
                rs.errors.append(f"{SNAPSHOT_NAME}: bad record ({e})")
                break
        if payloads and not saw_end:
            rs.errors.append(f"{SNAPSHOT_NAME}: missing end marker "
                             f"(partial checkpoint restored)")

        # --- wal.bin: records since the checkpoint ---
        payloads, valid_bytes, err = read_record_file(self.wal_path)
        if err:
            rs.errors.append(f"{WAL_NAME}: {err}; truncating at the last "
                             f"clean record")
            try:
                os.truncate(self.wal_path, valid_bytes)
            except OSError as e:
                rs.errors.append(f"{WAL_NAME}: truncate failed ({e})")
        entries: list[tuple[str, dict]] | None = None
        acc: list[list[tuple[float, float]]] = []
        for payload in payloads:
            try:
                kind = payload[:1]
                if kind == b"J":
                    doc = json.loads(payload[1:])
                    t = doc.get("t")
                    if t == "layout":
                        self._flush_wal_batch(entries, acc, rs, wall_to_mono)
                        entries = self._layout_entries(doc)
                        acc = [[] for _ in entries]
                    elif t == "breaker":
                        rs.breakers[str(doc.get("name", ""))] = doc
                elif kind == b"S" and entries is not None:
                    wall = _F64.unpack_from(payload, 1)[0]
                    vals = array("d")
                    vals.frombytes(payload[1 + _F64.size:])
                    if len(vals) != len(entries):
                        rs.errors.append(
                            f"{WAL_NAME}: samples/layout length mismatch; "
                            f"stopping replay"
                        )
                        break
                    rs.wal_records += 1
                    if wall > rs.max_wall:
                        for a, v in zip(acc, vals):
                            a.append((wall, v))
                # unknown kinds: forward compatibility — skip silently
            except Exception as e:  # noqa: BLE001 — prefix semantics
                rs.errors.append(f"{WAL_NAME}: bad record ({e})")
                break
        self._flush_wal_batch(entries, acc, rs, wall_to_mono)

        # --- apply breaker states onto the live supervisors ---
        from tpu_pod_exporter_torch.supervisor import CLOSED

        for name, doc in rs.breakers.items():
            sup = self._supervisors.get(name)
            if sup is None:
                continue
            try:
                sup.breaker.restore_state(doc, wallclock=self._wallclock)
                if sup.breaker.state != CLOSED:
                    log.warning(
                        "breaker for source %s restored %s (reopens=%d, "
                        "next probe in %.1fs) — carrying the quarantine "
                        "across the restart",
                        name, sup.breaker.state, sup.breaker.reopens,
                        sup.breaker.seconds_until_probe,
                    )
            except Exception as e:  # noqa: BLE001
                rs.errors.append(f"breaker {name}: restore failed ({e})")

    def _layout_entries(self, doc: dict) -> list[tuple[str, dict]]:
        from tpu_pod_exporter_torch.metrics import schema

        spec_by_name = {s.name: s for s in schema.ALL_SPECS + schema.GPU_NODE_SPECS}
        entries: list[tuple[str, dict]] = []
        for fam in doc.get("fams", ()):
            name = fam["m"]
            spec = spec_by_name.get(name)
            label_names = spec.label_names if spec is not None else ()
            for lvs in fam["k"]:
                entries.append(
                    (name, dict(zip(label_names, (str(v) for v in lvs))))
                )
        return entries

    def _flush_wal_batch(self, entries: list[tuple[str, dict[str, str]]],
                         acc: list[list[tuple[float, float]]],
                         rs: RestoredState,
                         wall_to_mono: Callable[[float], float]) -> None:
        if not entries or self._history is None:
            return
        for (metric, labels), samples in zip(entries, acc):
            if samples:
                rs.samples += self._history.restore_series(
                    metric, labels, samples, wall_to_mono
                )

    def _apply_snapshot_record(self, payload: bytes, rs: RestoredState,
                               wall_to_mono: Callable[[float], float]) -> None:
        kind = payload[:1]
        if kind == b"J":
            doc = json.loads(payload[1:])
            t = doc.get("t")
            if t == "breaker":
                rs.breakers[str(doc.get("name", ""))] = doc
            elif t == "meta":
                rs.max_wall = max(rs.max_wall, float(doc.get("max_wall", 0.0)))
        elif kind == b"R":
            jlen = struct.unpack_from("<I", payload, 1)[0]
            head = 1 + 4
            doc = json.loads(payload[head:head + jlen])
            vals = array("d")
            vals.frombytes(payload[head + jlen:])
            samples = [
                (vals[i], vals[i + 1]) for i in range(0, len(vals) - 1, 2)
            ]
            if samples:
                rs.series += 1
                if self._history is not None:
                    rs.samples += self._history.restore_series(
                        doc["m"], dict(doc.get("l") or {}), samples,
                        wall_to_mono,
                    )
                last_wall = samples[-1][0]
                if last_wall > rs.max_wall:
                    rs.max_wall = last_wall
        elif kind == b"E":
            ts = _F64.unpack_from(payload, 1)[0]
            rs.exposition = payload[1 + _F64.size:]
            rs.exposition_ts = ts

    # ------------------------------------------------------------- poll side

    def start(self) -> None:
        if self._thread is not None or self._dir_error is not None:
            return
        self._last_rotate = self._clock()
        self._thread = threading.Thread(
            target=self._writer_run, name="tpu-exporter-persist", daemon=True
        )
        self._thread.start()

    def on_poll(self, snap: "Snapshot") -> int:
        """The poll thread's entire persistence cost: breaker-change
        signatures plus one non-blocking queue put (the snapshot is
        immutable — value extraction happens on the writer thread)."""
        if self._thread is None:
            return 0
        queued = 0
        for name, sup in self._supervisors.items():
            b = sup.breaker
            sig = (b.state, b.consecutive_failures, b.reopens)
            if self._breaker_sigs.get(name) != sig:
                self._breaker_sigs[name] = sig
                self._enqueue(("breaker", name))
        if self._enqueue(("samples", snap)):
            queued = 1
        return queued

    def _enqueue(self, item: tuple) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except queue.Full:
            self._count_dropped("queue")
            self._rlog.warning(
                "persist_drop",
                "persistence queue full (writer stalled?); dropping a WAL "
                "record — polling is unaffected",
            )
            return False

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
            out["errors_by_reason"] = dict(self._errors_by_reason)
            out["dropped_by_reason"] = dict(self._dropped_by_reason)
        out["queue_depth"] = self._q.qsize()
        out["restored"] = self.restored_info.get("restored", False)
        out["wal_stride"] = self._wal_stride
        out["wal_enabled"] = self._wal_enabled
        out["snapshot_factor"] = self._snapshot_factor
        return out

    # ------------------------------------------------- pressure-shed hooks
    # Flipped by the resource-pressure governor's disk ladder
    # (tpu_pod_exporter_torch.pressure). Plain attribute writes read by the
    # writer thread; each rung is idempotent and individually reversible.

    def set_wal_stride(self, n: int) -> None:
        """Rung 1 (``wal_coarse``): write only every ``n``-th per-poll
        samples record. Skipped polls are counted as reason="shed" drops —
        a thinner WAL is a POLICY, and the restore-fidelity cost must stay
        visible. Layout/breaker records always write (tiny, and replay
        correctness needs them)."""
        self._wal_stride = max(int(n), 1)

    def set_wal_enabled(self, enabled: bool) -> None:
        """Rung 4 (``wal_off``): the deepest shed — no WAL records at all,
        checkpoints (at whatever cadence rung 3 left) remain the only
        durability. The exporter keeps serving throughout."""
        self._wal_enabled = bool(enabled)

    def set_snapshot_interval_factor(self, factor: float) -> None:
        """Rung 3 (``checkpoint_halved``): multiply the checkpoint
        interval (2.0 halves the frequency — worst-case restore staleness
        doubles, disk writes halve)."""
        self._snapshot_factor = max(float(factor), 1.0)

    def set_pressure_hook(self, hook: Callable[[BaseException], bool]) -> None:
        """Governor callback for write failures: ENOSPC reports shed the
        disk ladder immediately instead of waiting for a usage scan."""
        self._pressure_hook = hook

    def _count_dropped(self, reason: str) -> None:
        with self._stats_lock:
            self._stats["dropped"] += 1
            self._dropped_by_reason[reason] = (
                self._dropped_by_reason.get(reason, 0) + 1
            )

    @staticmethod
    def _io_reason(exc: BaseException | None) -> str:
        from tpu_pod_exporter_torch.pressure import is_disk_full_error

        return "disk_full" if (
            exc is not None and is_disk_full_error(exc)
        ) else "io"

    def close(self, timeout: float = 10.0) -> None:
        """Drain the queue, write a final fsynced snapshot (the SIGTERM
        flush), and stop the writer."""
        t = self._thread
        if t is None:
            return
        done = threading.Event()
        try:
            self._q.put(("stop", done), timeout=timeout)
        except queue.Full:
            pass
        done.wait(timeout)
        t.join(timeout)
        self._thread = None

    # ----------------------------------------------------------- writer side

    def _writer_run(self) -> None:
        try:
            self._open_wal()
        except OSError as e:
            self._count_error("WAL open failed: %s", e, exc=e)
        while True:
            try:
                item = self._q.get(timeout=0.25)
            except queue.Empty:
                item = None
            try:
                if item is not None:
                    if item[0] == "stop":
                        self._drain_and_stop(item[1])
                        return
                    self._write_item(item)
                self._maybe_fsync()
                self._maybe_rotate()
            except Exception as e:  # noqa: BLE001 — the writer must survive I/O faults
                self._count_error("persistence write failed: %s", e, exc=e)

    def _drain_and_stop(self, done: threading.Event) -> None:
        try:
            while True:
                item = self._q.get_nowait()
                if item[0] != "stop":
                    self._write_item(item)
        except queue.Empty:
            pass
        except Exception as e:  # noqa: BLE001
            self._count_error("final drain failed: %s", e)
        try:
            self._write_snapshot()
        except Exception as e:  # noqa: BLE001
            self._count_error("final snapshot failed: %s", e)
        if self._wal is not None:
            try:
                self._wal.flush()
                os.fsync(self._wal.fileno())
                self._wal.close()
            except OSError:
                pass
            self._wal = None
        done.set()

    def _count_error(self, fmt: str, *args: object,
                     exc: BaseException | None = None) -> None:
        reason = self._io_reason(exc)
        with self._stats_lock:
            self._stats["errors"] += 1
            self._errors_by_reason[reason] = (
                self._errors_by_reason.get(reason, 0) + 1
            )
        hook = self._pressure_hook
        if hook is not None and exc is not None:
            try:
                hook(exc)
            except Exception:  # noqa: BLE001 — the governor must not break the writer
                pass
        self._rlog.warning("persist_error", fmt, *args)

    def _open_wal(self, truncate: bool = False) -> None:
        if self._wal is not None:
            try:
                self._wal.close()
            except OSError:
                pass
        # None until the open succeeds: a raise here must not leave _wal
        # pointing at the closed previous file (every write would then
        # fail with "closed file" until the next rotation).
        self._wal = None
        mode = "wb" if truncate else "ab"
        self._wal = open(self.wal_path, mode)
        if self._wal.tell() == 0:
            self._wal.write(MAGIC)
        # Reopening invalidates the reader-side layout assumption only on
        # truncate; on append the old file's last layout still stands, but
        # we cannot know it here — force a fresh layout record either way.
        self._fam_keys = {}
        self._fam_names = ()
        with self._stats_lock:
            self._stats["wal_bytes"] = self._wal.tell()

    def _write_item(self, item: tuple) -> None:
        kind = item[0]
        if kind == "breaker":
            self._write_breaker(item[1])
        elif kind == "samples":
            self._write_samples(item[1])

    def _ensure_wal(self) -> bool:
        """Reopen the WAL if a previous open failed — retried on every
        write attempt (not just at rotation), so persistence recovers as
        soon as the filesystem does. A record that cannot be written is a
        DROP (counted, alertable), never a silent discard."""
        if self._wal is not None:
            return True
        try:
            self._open_wal()
            return True
        except OSError as e:
            self._count_error("WAL reopen failed: %s", e, exc=e)
            self._count_dropped(self._io_reason(e))
            return False

    def _write_breaker(self, name: str) -> None:
        sup = self._supervisors.get(name)
        if sup is None or not self._ensure_wal():
            return
        doc = sup.breaker.export_state(wallclock=self._wallclock)
        doc.update({"t": "breaker", "scope": "source", "name": name})
        n = append_record(self._wal, b"J" + json.dumps(doc).encode())
        self._wal_dirty = True
        with self._stats_lock:
            self._stats["wal_records"] += 1
            self._stats["wal_bytes"] += n

    def _write_samples(self, snap: "Snapshot") -> None:
        # Pressure shedding (disk ladder): WAL-off drops everything, the
        # stride rung thins coverage to every Nth poll. Both are counted
        # as reason="shed" drops — deliberate, but never silent.
        self._stride_seq += 1
        if not self._wal_enabled:
            self._count_dropped("shed")
            return
        if self._wal_stride > 1 and self._stride_seq % self._wal_stride != 0:
            self._count_dropped("shed")
            return
        if not self._ensure_wal():
            return
        # Extract the tracked families from the (immutable) snapshot.
        fams: list[tuple[str, dict]] = []
        for name in self._metric_order:
            view = snap.samples_view(name)
            if view:
                fams.append((name, view))
        names = tuple(n for n, _ in fams)
        changed = names != self._fam_names
        vals = array("d")
        new_keys: list[tuple[str, tuple]] = []
        for name, view in fams:
            keys = tuple(view)
            if not changed and self._fam_keys.get(name) != keys:
                changed = True
            new_keys.append((name, keys))
            vals.extend(view.values())
        written = 0
        if changed:
            self._fam_names = names
            self._fam_keys = dict(new_keys)
            layout = {
                "t": "layout",
                "fams": [
                    {"m": name, "k": [list(k) for k in keys]}
                    for name, keys in new_keys
                ],
            }
            written += append_record(
                self._wal, b"J" + json.dumps(layout).encode()
            )
        ts = getattr(snap, "poll_timestamp", snap.timestamp)
        written += append_record(
            self._wal, b"S" + _F64.pack(ts) + vals.tobytes()
        )
        self._wal_dirty = True
        with self._stats_lock:
            self._stats["wal_records"] += 1 + (1 if changed else 0)
            self._stats["wal_samples"] += len(vals)
            self._stats["wal_bytes"] += written

    def _maybe_fsync(self) -> None:
        if self._wal is None or not self._wal_dirty:
            return
        now = self._clock()
        if self.fsync_interval_s > 0 and (
            now - self._last_fsync < self.fsync_interval_s
        ):
            return
        self._last_fsync = now
        t0 = self._clock()
        self._wal.flush()
        os.fsync(self._wal.fileno())
        self._wal_dirty = False
        with self._stats_lock:
            self._stats["fsyncs"] += 1
            self._stats["last_fsync_s"] = self._clock() - t0

    # A failed checkpoint retries on this cadence instead of waiting out a
    # full --state-snapshot-interval-s (the WAL-reopen discipline applied
    # to the checkpoint path: recover as soon as the filesystem does).
    SNAPSHOT_RETRY_S = 5.0

    def _maybe_rotate(self) -> None:
        now = self._clock()
        if self.snapshot_interval_s <= 0:
            return
        interval = self.snapshot_interval_s * self._snapshot_factor
        if self._snapshot_failed:
            # Failed-checkpoint retry cadence: every SNAPSHOT_RETRY_S, not
            # every writer iteration (a full disk must not be hammered
            # with checkpoint-sized writes 4x a second) and not the full
            # interval (recover as soon as the filesystem does).
            if now - self._last_snapshot_attempt < self.SNAPSHOT_RETRY_S:
                return
        elif now - self._last_rotate < interval:
            return
        self._last_snapshot_attempt = now
        try:
            self._write_snapshot()
        except Exception as e:  # noqa: BLE001 — a failed checkpoint must retry, not wait
            self._snapshot_failed = True
            # atomic_write may have left a partial .tmp behind (ENOSPC
            # mid-write): reclaim it now — a full disk is exactly when a
            # dead temp file hurts most.
            try:
                os.unlink(self.snapshot_path + ".tmp")
            except OSError:
                pass
            self._count_error("checkpoint rotation failed: %s (retrying "
                              "in %.0fs)", e, self.SNAPSHOT_RETRY_S, exc=e)
            return
        self._snapshot_failed = False
        self._last_rotate = now

    def _write_snapshot(self) -> None:
        """Full checkpoint: history rings + breaker states + exposition,
        write-temp → fsync → rename, then a fresh WAL."""
        import io

        buf = io.BytesIO()
        buf.write(MAGIC)
        rows = self._history.export_series() if self._history is not None else []
        max_wall = 0.0
        for _metric, _labels, samples in rows:
            if samples and samples[-1][0] > max_wall:
                max_wall = samples[-1][0]
        meta = {"t": "meta", "version": 1, "wall": self._wallclock(),
                "max_wall": max_wall, "series": len(rows)}
        append_record(buf, b"J" + json.dumps(meta).encode())
        for name, sup in self._supervisors.items():
            doc = sup.breaker.export_state(wallclock=self._wallclock)
            doc.update({"t": "breaker", "scope": "source", "name": name})
            append_record(buf, b"J" + json.dumps(doc).encode())
        for metric, labels, samples in rows:
            head = json.dumps({"m": metric, "l": labels}).encode()
            flat = array("d")
            for wall, value in samples:
                flat.append(wall)
                flat.append(value)
            append_record(
                buf,
                b"R" + struct.pack("<I", len(head)) + head + flat.tobytes(),
            )
        if self._exposition_fn is not None:
            try:
                snap = self._exposition_fn()
            except Exception:  # noqa: BLE001 — exposition is optional payload
                snap = None
            if snap is not None and snap.timestamp > 0:
                ts = getattr(snap, "poll_timestamp", snap.timestamp)
                append_record(buf, b"E" + _F64.pack(ts) + snap.encode())
        append_record(buf, b"J" + json.dumps({"t": "end"}).encode())
        atomic_write(self.snapshot_path, buf.getvalue())
        # The checkpoint covers everything; start a fresh WAL. A crash in
        # between leaves the old WAL alongside the new snapshot, which the
        # loader dedups via the checkpoint's max_wall.
        self._open_wal(truncate=True)
        self._last_fsync = self._clock()
        self._wal_dirty = False
        with self._stats_lock:
            self._stats["snapshots"] += 1
            self._stats["last_snapshot_wall"] = self._wallclock()


# ------------------------------------------------------ durable send buffer


def _scan_segment(path: str) -> tuple[list[tuple[int, int]], int, str | None]:
    """Scan one CRC-framed segment file; returns (records, valid_bytes,
    error). ``records`` is [(payload_offset, payload_len), ...] for the
    longest clean prefix — the offset/length pairs a consumer needs to
    re-read payloads lazily instead of materializing the whole backlog
    (the offsets-only view of :func:`_walk_records`)."""
    offsets, _payloads, valid, err = _walk_records(path, False)
    return offsets, valid, err


class WalBuffer:
    """Durable, segmented FIFO of opaque payload records — the reusable
    generalization of :class:`StatePersister`'s WAL machinery (same CRC32
    framing, rotation, and torn-write-tolerant replay) packaged as a queue
    with a persisted consumer cursor. Built for the remote-write egress
    send buffer (``tpu_pod_exporter_torch.egress``); generic over payload bytes.

    Layout under ``dir``: ``seg-%08d.wal`` segment files (each MAGIC +
    CRC-framed records) plus ``cursor.json`` — ``{"seg": n, "rec": k}``
    means the first ``k`` records of segment ``n`` (and every earlier
    segment) are acknowledged and must NEVER be re-delivered, even across
    a crash: the cursor is written atomically (write-temp → fsync →
    rename) on every ack. Fully-acked segments are unlinked.

    Boot replay (:meth:`open`) tolerates torn writes: the newest segment
    is truncated at its last clean record (appends continue from there);
    an older segment corrupted mid-file keeps its clean prefix and the
    segments after it — corruption loses the torn records, never the
    buffer. A missing cursor segment means it was fully acked.

    Threading: one appender thread plus one consumer thread. The internal
    lock guards ONLY in-memory index state (entry deque, counters); all
    file I/O happens outside it, so neither thread can ever park the other
    inside a filesystem call — and the poll thread never touches this
    class at all.
    """

    SEGMENT_FMT = "seg-%08d.wal"
    CURSOR_NAME = "cursor.json"

    def __init__(self, path: str, segment_max_bytes: int = 4 << 20,
                 fsync: bool = True) -> None:
        self.dir = path
        self.segment_max_bytes = segment_max_bytes
        self.fsync_each = fsync
        self._lock = threading.Lock()
        # Pending (unacked) records, oldest first: (seg_no, rec_idx,
        # payload_offset, payload_len).
        self._entries: "deque[tuple[int, int, int, int]]" = deque()
        self._pending_bytes = 0
        self._acked_seg = -1   # cursor: segments <= this with...
        self._acked_rec = 0    # ...first _acked_rec records of _acked_seg acked
        # Lowest segment number that may still have a file on disk — the
        # unlink sweep's start. Advanced only past segments actually
        # removed (a failed unlink is retried on the next advance).
        self._min_seg = 0
        self._active_seg = 0
        self._active_count = 0   # records written to the active segment
        self._active_bytes = 0
        self._f: IO[bytes] | None = None
        self.corrupt_segments = 0
        self.errors: list[str] = []

    def _seg_path(self, seg: int) -> str:
        return os.path.join(self.dir, self.SEGMENT_FMT % seg)

    @property
    def _cursor_path(self) -> str:
        return os.path.join(self.dir, self.CURSOR_NAME)

    # ------------------------------------------------------------------ boot

    def open(self) -> dict:
        """Create the dir, load the cursor, replay segments into the
        pending index. Never raises on corruption (clean-prefix semantics);
        raises OSError only if the directory itself cannot be created."""
        os.makedirs(self.dir, exist_ok=True)
        cur_seg, cur_rec = -1, 0
        try:
            with open(self._cursor_path, encoding="utf-8") as f:
                doc = json.load(f)
            cur_seg = int(doc.get("seg", -1))
            cur_rec = max(int(doc.get("rec", 0)), 0)
        except FileNotFoundError:
            pass
        except Exception as e:  # noqa: BLE001 — a bad cursor restarts delivery, never boot
            self.errors.append(f"cursor unreadable ({e}); delivering from "
                               f"the oldest retained record")
        seg_nos = []
        try:
            for name in os.listdir(self.dir):
                if name.startswith("seg-") and name.endswith(".wal"):
                    try:
                        seg_nos.append(int(name[4:-4]))
                    except ValueError:
                        continue
        except OSError as e:
            self.errors.append(f"segment listing failed: {e}")
        seg_nos.sort()
        for seg in seg_nos:
            path = self._seg_path(seg)
            if seg < cur_seg:
                # Fully acked before the crash; reclaim the disk.
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            records, valid, err = _scan_segment(path)
            if err:
                self.corrupt_segments += 1
                self.errors.append(f"segment {seg}: {err}; kept the clean "
                                   f"prefix ({len(records)} records)")
                if seg == seg_nos[-1]:
                    # Newest segment: truncate the torn tail so appends
                    # continue from a clean boundary.
                    try:
                        os.truncate(path, valid)
                    except OSError as e:
                        self.errors.append(f"segment {seg}: truncate "
                                           f"failed ({e})")
            start = cur_rec if seg == cur_seg else 0
            for idx, (off, length) in enumerate(records):
                if idx < start:
                    continue
                self._entries.append((seg, idx, off, length))
                self._pending_bytes += _HDR.size + length
            if seg == seg_nos[-1]:
                if seg == cur_seg and len(records) < cur_rec:
                    # Corruption swallowed part of the ACKED region: new
                    # appends to this file would land below the cursor and
                    # be skipped as "already acked" on the next boot. Seal
                    # it and start a fresh segment instead.
                    self._active_seg = seg + 1
                    self._active_count = 0
                    self._active_bytes = 0
                else:
                    self._active_seg = seg
                    self._active_count = len(records)
                    self._active_bytes = valid if valid else len(MAGIC)
        if not seg_nos:
            # No segments on disk (fresh dir, or everything was acked and
            # unlinked). Start a FRESH segment past the cursor: record
            # indices within a file always start at 0 on rescan, so reusing
            # the cursor's segment number would make its "first rec acked"
            # offset swallow genuinely-new records after a restart.
            self._active_seg = cur_seg + 1 if cur_seg >= 0 else 0
            self._active_count = 0
            self._active_bytes = 0
        self._acked_seg, self._acked_rec = cur_seg, cur_rec
        self._min_seg = seg_nos[0] if seg_nos else self._active_seg
        return {"pending": len(self._entries),
                "pending_bytes": self._pending_bytes,
                "corrupt_segments": self.corrupt_segments,
                "errors": list(self.errors)}

    # ---------------------------------------------------------------- append

    def _ensure_writer(self) -> IO[bytes]:
        if self._f is not None:
            return self._f
        path = self._seg_path(self._active_seg)
        f = open(path, "ab")
        if f.tell() == 0:
            f.write(MAGIC)
            f.flush()
        self._active_bytes = f.tell()
        self._f = f
        return f

    def append(self, payload: bytes) -> None:
        """Durably append one record (raises OSError if the filesystem
        refuses — the caller counts a drop and retries on the next append,
        the StatePersister._ensure_wal discipline)."""
        try:
            if self._active_bytes >= self.segment_max_bytes and self._active_count > 0:
                self._rotate()
            f = self._ensure_writer()
            offset = self._active_bytes + _HDR.size
            n = append_record(f, payload)
            f.flush()
            if self.fsync_each:
                os.fsync(f.fileno())
        except OSError:
            # The failed write may have left a TORN partial record in the
            # segment; appending past it would strand every later record
            # behind the tear at the next rescan (clean-prefix semantics),
            # and rescan indices would no longer match the cursor's.
            # Seal the segment — already-indexed records sit before the
            # tear and stay readable — and start fresh on the next append.
            self._close_writer()
            self._active_seg += 1
            self._active_count = 0
            self._active_bytes = 0
            raise
        with self._lock:
            self._entries.append(
                (self._active_seg, self._active_count, offset, len(payload))
            )
            self._pending_bytes += n
        self._active_count += 1
        self._active_bytes += n

    def _rotate(self) -> None:
        self._close_writer()
        self._active_seg += 1
        self._active_count = 0
        self._active_bytes = 0
        self._ensure_writer()

    def seal_active(self) -> int:
        """Rotate the active segment off WITHOUT waiting for the next
        append, then reclaim every fully-acked segment this unblocks.

        Rotation is normally append-lazy, which is fine in steady state —
        but under disk pressure with a stalled producer the active
        segment can hold nothing but already-acked records, and those
        bytes stay on disk until an append that may never come. The ack
        sweep cannot touch them either (it never unlinks the active
        segment). Sealing makes the segment sweepable now. Returns the
        bytes reclaimed; 0 when the active segment was already empty."""
        with self._lock:
            if self._active_count == 0:
                return 0
            self._close_writer()
            self._active_seg += 1
            self._active_count = 0
            self._active_bytes = 0
            head_seg = (
                self._entries[0][0] if self._entries else self._active_seg
            )
        freed = 0
        for seg in range(self._min_seg, head_seg):
            if seg == self._active_seg:
                break
            path = self._seg_path(seg)
            try:
                size = os.path.getsize(path)
                os.unlink(path)
                freed += size
            except FileNotFoundError:
                pass
            except OSError:
                break
            self._min_seg = seg + 1
        else:
            self._min_seg = max(self._min_seg, head_seg)
        return freed

    def _close_writer(self) -> None:
        f = self._f
        self._f = None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass

    # --------------------------------------------------------------- consume

    def peek(self) -> bytes | None:
        """Oldest unacknowledged payload (None when drained). Re-reads from
        disk — the backlog is never held in memory."""
        return self._read_entry(0)

    def peek_last(self) -> bytes | None:
        """NEWEST pending payload (None when drained) — lets a consumer
        resume monotonic bookkeeping (e.g. the egress batch sequence) from
        the tail without materializing the whole backlog."""
        return self._read_entry(-1)

    def peek_at(self, index: int) -> bytes | None:
        """Pending payload at ``index`` from the head (None past the end)
        — lets a consumer walk the backlog (e.g. the egress age-cap scan)
        without advancing the cursor."""
        with self._lock:
            if index >= len(self._entries):
                return None
        return self._read_entry(index)

    def iter_payloads(self) -> Iterator[bytes]:
        """Every pending payload, oldest first, reading each segment file
        ONCE — the boot-replay path for consumers that rebuild in-memory
        state from the whole backlog (the fleet store's tier restore),
        where a peek_at() walk would reopen the segment per record. The
        entry index is snapshotted under the lock; all file I/O happens
        outside it. Unreadable/torn entries are skipped, never raised —
        replay keeps whatever prefix the disk still answers for."""
        with self._lock:
            entries = list(self._entries)
        cur_seg = -1
        f: IO[bytes] | None = None
        try:
            for seg, _idx, off, length in entries:
                if seg != cur_seg:
                    if f is not None:
                        f.close()
                    f = None
                    cur_seg = seg
                    try:
                        f = open(self._seg_path(seg), "rb")
                    except OSError:
                        continue
                if f is None:
                    continue
                try:
                    f.seek(off)
                    payload = f.read(length)
                except OSError:
                    continue
                if len(payload) == length:
                    yield payload
        finally:
            if f is not None:
                f.close()

    def trim_to_bytes(self, max_bytes: int) -> int:
        """Drop as many OLDEST records as needed to bring the pending
        byte total under ``max_bytes``, in ONE cursor advance (one fsynced
        cursor write however many records shed — a long-outage trim must
        not pay a cursor fsync per dropped batch). Returns the count."""
        with self._lock:
            count = 0
            excess = self._pending_bytes - max_bytes
            for _seg, _idx, _off, length in self._entries:
                if excess <= 0:
                    break
                excess -= _HDR.size + length
                count += 1
        if count == 0:
            return 0
        return self._advance(count)

    def _read_entry(self, index: int) -> bytes | None:
        with self._lock:
            if not self._entries:
                return None
            seg, _idx, off, length = self._entries[index]
        try:
            with open(self._seg_path(seg), "rb") as f:
                f.seek(off)
                payload = f.read(length)
        except OSError:
            return None
        return payload if len(payload) == length else None

    def ack(self) -> None:
        """Mark the oldest pending record delivered: advance + durably
        persist the cursor, unlink fully-acked segments. A crash right
        after this call must never re-deliver the record."""
        self._advance(1)

    def drop_oldest(self, n: int) -> int:
        """Advance the cursor past up to ``n`` oldest records WITHOUT
        delivery (backlog caps). Returns how many were dropped."""
        return self._advance(n)

    def _advance(self, n: int) -> int:
        advanced = 0
        with self._lock:
            while advanced < n and self._entries:
                seg, idx, _off, length = self._entries.popleft()
                self._pending_bytes -= _HDR.size + length
                self._acked_seg, self._acked_rec = seg, idx + 1
                advanced += 1
            head_seg = (
                self._entries[0][0] if self._entries else self._active_seg
            )
            acked_seg, acked_rec = self._acked_seg, self._acked_rec
        if advanced:
            try:
                atomic_write(
                    self._cursor_path,
                    json.dumps({"seg": acked_seg, "rec": acked_rec}).encode(),
                )
            except OSError as e:
                self.errors.append(f"cursor write failed: {e}")
            # Sweep EVERY fully-acked segment below the new head (a single
            # multi-segment advance — e.g. an age-cap trim after a long
            # outage — must reclaim all of them now, not at the next
            # boot). _min_seg advances only past successful unlinks so a
            # transient failure is retried on the next advance.
            for seg in range(self._min_seg, head_seg):
                if seg == self._active_seg:
                    break
                try:
                    os.unlink(self._seg_path(seg))
                except FileNotFoundError:
                    pass
                except OSError:
                    break
                self._min_seg = seg + 1
            else:
                self._min_seg = max(self._min_seg, head_seg)
        return advanced

    # ----------------------------------------------------------------- stats

    def pending(self) -> int:
        with self._lock:
            return len(self._entries)

    def pending_bytes(self) -> int:
        with self._lock:
            return self._pending_bytes

    def close(self) -> None:
        self._close_writer()


# ------------------------------------------------- aggregator breaker state


class _JsonStateFile:
    """Shared skeleton for the tiny keyed-JSON state files (atomic write,
    tolerant load, wall-stamped wrapper) — one crash discipline for every
    subclass, at a scale where a WAL would be overkill: state that changes
    on transitions, not per round. Subclasses set ``INNER_KEY`` (the one
    document key under the wall stamp) and ``WHAT`` (log wording)."""

    INNER_KEY = "state"
    WHAT = "state"

    def __init__(self, path: str,
                 wallclock: Callable[[], float] = time.time) -> None:
        self.path = path
        self._wallclock = wallclock
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        except OSError as e:
            log.error("%s dir for %s unusable: %s", self.WHAT, path, e)

    def _load_inner(self) -> dict:
        """The inner document ({} when absent/corrupt — callers rebuild
        from live inputs and the next save repairs the file)."""
        try:
            with open(self.path, encoding="utf-8") as f:
                doc = json.load(f)
            if not isinstance(doc, dict):
                raise TypeError("top-level value must be an object")
            inner = doc.get(self.INNER_KEY, {})
            return inner if isinstance(inner, dict) else {}
        except FileNotFoundError:
            return {}
        except Exception as e:  # noqa: BLE001 — never refuse to start
            log.warning("%s %s unreadable (%s); rebuilding from live "
                        "inputs", self.WHAT, self.path, e)
            return {}

    def _save_inner(self, inner: dict) -> None:
        doc = {"wall": self._wallclock(), self.INNER_KEY: inner}
        try:
            atomic_write(self.path, json.dumps(doc).encode())
        except OSError as e:
            log.warning("%s save to %s failed: %s", self.WHAT, self.path, e)


class BreakerStateFile(_JsonStateFile):
    """Per-target circuit-breaker persistence for the aggregator tiers:
    a restart keeps its quarantines instead of re-learning every dead
    target from closed."""

    INNER_KEY = "targets"
    WHAT = "breaker state"

    def load(self) -> dict[str, dict]:
        return {
            str(k): v for k, v in self._load_inner().items()
            if isinstance(v, dict)
        }

    def save(self, states: dict[str, dict]) -> None:
        self._save_inner(states)


class ShardMapFile(_JsonStateFile):
    """Consistent-hash shard-map persistence
    (``tpu_pod_exporter_torch.shard``): a restarted leaf or root resumes the
    assignment view it last acted on, so the first refresh after a
    restart counts real reshard moves instead of re-learning the whole
    map as churn."""

    INNER_KEY = "shard_map"
    WHAT = "shard map"

    def load(self) -> dict[str, object]:
        return self._load_inner()

    def save(self, doc: dict[str, object]) -> None:
        self._save_inner(doc)


# ------------------------------------------------------------ status helper


def state_dir_summary(state_dir: str) -> dict:
    """Lightweight on-disk summary for ``status --watch`` and /debug/vars:
    file sizes plus the checkpoint's age (mtime — no record parsing)."""
    out = {
        "state_dir": state_dir,
        "exists": os.path.isdir(state_dir),
        "snapshot_bytes": 0,
        "snapshot_age_s": None,
        "wal_bytes": 0,
        "total_bytes": 0,
    }
    if not out["exists"]:
        return out
    snap = os.path.join(state_dir, SNAPSHOT_NAME)
    wal = os.path.join(state_dir, WAL_NAME)
    try:
        st = os.stat(snap)
        out["snapshot_bytes"] = st.st_size
        out["snapshot_age_s"] = round(max(time.time() - st.st_mtime, 0.0), 1)
    except OSError:
        pass
    try:
        out["wal_bytes"] = os.stat(wal).st_size
    except OSError:
        pass
    out["total_bytes"] = out["snapshot_bytes"] + out["wal_bytes"]
    return out


# ------------------------------------------------------------------- checks


def _fsync_check(records: int, doubles: int, budget_s: float,
                 state_dir: str) -> int:
    """fsync-latency budget on the persistence hot path: append + fsync
    WAL-shaped records (the 256-chip samples payload is ~4.4k float64s)
    and fail if the p99 exceeds the budget — a state dir on a pathological
    filesystem (NFS, throttled EBS) must be caught by CI, not discovered
    as a wedged writer thread in production."""
    import statistics
    import tempfile

    own_dir = not state_dir
    if own_dir:
        state_dir = tempfile.mkdtemp(prefix="tpe-fsync-check-")
    os.makedirs(state_dir, exist_ok=True)
    path = os.path.join(state_dir, "fsync-check.bin")
    payload = b"S" + _F64.pack(time.time()) + array(
        "d", [1.0] * doubles
    ).tobytes()
    lat: list[float] = []
    with open(path, "wb") as f:
        f.write(MAGIC)
        for _ in range(records):
            append_record(f, payload)
            t0 = time.perf_counter()
            f.flush()
            os.fsync(f.fileno())
            lat.append(time.perf_counter() - t0)
    os.unlink(path)
    if own_dir:
        try:
            os.rmdir(state_dir)
        except OSError:
            pass
    lat.sort()
    p50 = statistics.median(lat)
    p99 = lat[min(int(len(lat) * 0.99), len(lat) - 1)]
    print(f"WAL fsync latency over {records} records of "
          f"{len(payload)} bytes: p50 {1e3 * p50:.2f}ms  "
          f"p99 {1e3 * p99:.2f}ms  max {1e3 * lat[-1]:.2f}ms  "
          f"(budget p99 {1e3 * budget_s:.0f}ms)")
    if p99 > budget_s:
        print("FAIL: fsync p99 exceeds budget — this filesystem cannot "
              "sustain the persistence hot path")
        return 1
    print("OK: fsync latency within budget")
    return 0


def _overhead_check(polls: int, chips: int, budget: float) -> int:
    """Persistence-on vs persistence-off POLL-THREAD CPU at the bench
    shape. The budget applies to the poll loop (persistence I/O runs on
    its own writer thread by design — the same exclusion as the history
    append); whole-process CPU, which includes the writer thread, is
    reported alongside for honesty. Interleaved segments with alternating
    order, same methodology as ``trace --overhead-check`` (whole-run A/B
    drowns in scheduler drift)."""
    import tempfile

    from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
    from tpu_pod_exporter_torch.backend.fake import FakeBackend
    from tpu_pod_exporter_torch.collector import Collector
    from tpu_pod_exporter_torch.history import HistoryStore
    from tpu_pod_exporter_torch.metrics import SnapshotStore
    from tpu_pod_exporter_torch import utils

    state_dir = tempfile.mkdtemp(prefix="tpe-persist-overhead-")

    def make(with_persist: bool) -> tuple:
        history = HistoryStore(capacity=64, max_series=8192, retention_s=0.0)
        store = SnapshotStore()
        persister = None
        if with_persist:
            persister = StatePersister(
                state_dir, history=history,
                snapshot_interval_s=0.0,  # steady state: WAL only
                fsync_interval_s=1.0,
                exposition_fn=store.current,
            )
            persister.start()
        collector = Collector(
            FakeBackend(chips=chips), FakeAttribution(), store,
            history=history, persister=persister,
        )
        for _ in range(30):  # warm caches/layouts
            collector.poll_once()
        return collector, persister

    def segment(collector: Any, n: int) -> tuple[float, float]:
        t0 = time.thread_time()
        c0 = utils.process_cpu_seconds()
        for _ in range(n):
            collector.poll_once()
        return (time.thread_time() - t0,
                utils.process_cpu_seconds() - c0)

    (off, _), (on, persister) = make(False), make(True)
    seg_len = max(polls // 8, 10)
    t_off = t_on = p_off = p_on = 0.0
    try:
        for seg in range(16):
            order = ((on, True), (off, False)) if seg % 2 else ((off, False), (on, True))
            for collector, is_on in order:
                t, p = segment(collector, seg_len)
                if is_on:
                    t_on += t
                    p_on += p
                else:
                    t_off += t
                    p_off += p
    finally:
        if persister is not None:
            persister.close()
        import shutil

        shutil.rmtree(state_dir, ignore_errors=True)
    overhead = t_on / t_off - 1.0 if t_off > 0 else 0.0
    proc = p_on / p_off - 1.0 if p_off > 0 else 0.0
    print(f"poll-thread CPU over {16 * seg_len} interleaved polls/mode at "
          f"{chips} chips: persist-off {t_off:.3f}s, persist-on {t_on:.3f}s "
          f"→ overhead {100 * overhead:+.1f}% (budget {100 * budget:.0f}%)")
    print(f"whole-process CPU (incl. the persistence writer thread): "
          f"{p_off:.3f}s → {p_on:.3f}s ({100 * proc:+.1f}%)")
    if overhead > budget:
        print("FAIL: persistence poll-loop overhead exceeds budget")
        return 1
    print("OK: persistence poll-loop overhead within budget")
    return 0


# --------------------------------------------------------------- restart demo


def _wait_http(url: str, timeout_s: float) -> tuple[int, bytes]:
    """Poll a URL until it answers (any status); returns (status, body)."""
    import urllib.error
    import urllib.request

    deadline = time.monotonic() + timeout_s
    last: Exception | None = None
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=2) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
        except Exception as e:  # noqa: BLE001 — not up yet
            last = e
            time.sleep(0.05)
    raise TimeoutError(f"{url} did not answer within {timeout_s:g}s: {last}")


def _get_json(url: str, timeout_s: float = 10.0) -> dict:
    status, body = _wait_http(url, timeout_s)
    if status != 200:
        raise RuntimeError(f"{url} → {status}: {body[:200]!r}")
    return json.loads(body)


def _restart_demo(ns: Any) -> int:
    """``make restart-demo``: the kill/restart chaos harness.

    Phase 1 runs a live exporter whose device source errors until the
    breaker is open, then a chaos ``kill`` injection SIGKILLs the process
    MID-POLL (no drain, no flush beyond the WAL's own fsync cadence).
    Phase 2 restarts on the same state dir and asserts (a) the history
    series is contiguous across the boundary — restored pre-kill samples
    meet fresh post-restart samples with no hole beyond the measured
    downtime plus one poll interval; (b) the device breaker carried its
    state over instead of re-learning the failure from closed. Phase 3
    corrupts the WAL mid-file and asserts the exporter still boots (cold
    or partial-warm) — torn state must never crash-loop the DaemonSet.
    """
    import shutil
    import signal as _signal
    import socket
    import subprocess
    import sys
    import tempfile

    own_dir = not ns.state_dir
    state_dir = ns.state_dir or tempfile.mkdtemp(prefix="tpe-restart-demo-")
    os.makedirs(state_dir, exist_ok=True)
    interval = 0.25
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base_cmd = [
        sys.executable, "-m", "tpu_pod_exporter_torch",
        "--host", "127.0.0.1", "--port", str(port),
        "--backend", "fake", "--fake-chips", "4",
        "--attribution", "none",
        "--interval-s", f"{interval:g}",
        "--state-dir", state_dir,
        "--state-snapshot-interval-s", "3",
        # fsync every WAL record: the demo's continuity assertion is
        # "gap ≤ one poll interval", which needs a durable tail.
        "--state-fsync-interval-s", "0",
        "--breaker-failures", "2",
        "--breaker-backoff-s", "0.5",
        "--breaker-backoff-max-s", "30",
        "--history-retention-s", "120",
        "--log-level", "warning",
    ]
    base = f"http://127.0.0.1:{port}"
    child = None
    rc = 1
    try:
        # ---- phase 1: poll, wedge the breaker open, SIGKILL mid-poll ----
        # Device calls 8.. all error (breaker opens after 2); the kill rule
        # sits first so call 14 — a half-open probe, mid-poll — dies by
        # SIGKILL. Deterministic: seeded chaos, probability 1 rules.
        spec = "kill:device:1:@14:x1,err:device:1:@8"
        print(f"phase 1: exporter on {base}, state dir {state_dir}")
        print(f"         chaos spec {spec} (SIGKILL mid-poll on device "
              f"call 14)")
        t_start = time.time()
        child = subprocess.Popen(
            base_cmd + ["--chaos-spec", spec, "--chaos-seed", "7"]
        )
        _wait_http(base + "/readyz", 30)
        child.wait(timeout=120)
        t_killed = time.time()
        if child.returncode != -_signal.SIGKILL:
            print(f"FAIL: expected death by SIGKILL, got rc={child.returncode}")
            return 1
        print(f"         killed by SIGKILL after {t_killed - t_start:.1f}s "
              f"(mid-poll, no drain)")

        # ---- phase 2: restart on the same state dir ----
        print("phase 2: restarting on the same state dir (no chaos)")
        child = subprocess.Popen(base_cmd)
        _wait_http(base + "/readyz", 30)
        t_up = time.time()
        downtime = t_up - t_killed
        dv = _get_json(base + "/debug/vars")
        persist = dv.get("persist") or {}
        if not persist.get("restored"):
            print(f"FAIL: /debug/vars reports no restored state: {persist}")
            return 1
        sup = (dv.get("supervisors") or {}).get("device") or {}
        errors_new = (dv.get("last_poll") or {}).get("errors") or []
        reopens = sup.get("reopens", 0)
        opens = (sup.get("transitions") or {}).get("open", 0)
        if sup.get("state") == "open" and reopens >= 1:
            print(f"         breaker carryover: device restored OPEN "
                  f"(reopens={reopens}, next probe in "
                  f"{sup.get('seconds_until_probe', 0):.1f}s) — no "
                  f"re-learning storm")
        elif opens >= 1 and not errors_new:
            # The open window elapsed during the restart and the (now
            # healthy) probe closed it — carryover is still proven by the
            # restored transition counters with zero fresh device errors.
            print(f"         breaker carryover: restored transitions "
                  f"(open={opens}) with no fresh device errors")
        else:
            print(f"FAIL: no breaker carryover: {sup}")
            return 1

        # History continuity across the boundary: let a few live polls land,
        # then walk tpu_exporter_up's samples over the whole window.
        time.sleep(6 * interval)
        doc = _get_json(
            base + f"/api/v1/query_range?metric=tpu_exporter_up"
                   f"&start={t_start - 5:.3f}&end={time.time() + 1:.3f}"
        )
        series = doc["data"]["result"]
        if len(series) != 1:
            print(f"FAIL: expected one tpu_exporter_up series, got "
                  f"{len(series)}")
            return 1
        ts = [t for t, _v in series[0]["values"]]
        pre = [t for t in ts if t <= t_killed]
        post = [t for t in ts if t > t_up - 1.0]
        if not pre or not post:
            print(f"FAIL: no samples on both sides of the restart "
                  f"(pre={len(pre)}, post={len(post)})")
            return 1
        tail_gap = t_killed - max(pre)
        gaps = [b - a for a, b in zip(ts, ts[1:])]
        worst = max(gaps)
        budget = downtime + 2 * interval + 0.5
        print(f"         history continuity: {len(ts)} samples, pre-kill "
              f"tail {tail_gap:.2f}s before SIGKILL (≤ {2 * interval + 0.2:.2f}s "
              f"budget), worst gap {worst:.2f}s (downtime {downtime:.2f}s "
              f"+ 2 intervals = {budget:.2f}s budget)")
        if tail_gap > 2 * interval + 0.2:
            print("FAIL: pre-kill history tail lost more than one poll")
            return 1
        if worst > budget:
            print("FAIL: history gap across the restart exceeds downtime "
                  "+ one poll interval")
            return 1
        # The same continuity for a LABELED series: restored and live
        # samples must land in ONE series per chip, not fork into two
        # identically-labeled series (the restore-key discipline in
        # HistoryStore.restore_series). tpu_exporter_up alone cannot catch
        # that — its label set is empty, so both key shapes coincide.
        doc = _get_json(
            base + f"/api/v1/query_range?metric=tpu_hbm_used_bytes"
                   f"&match%5Bchip_id%5D=0"
                   f"&start={t_start - 5:.3f}&end={time.time() + 1:.3f}"
        )
        chip_series = doc["data"]["result"]
        if len(chip_series) != 1:
            print(f"FAIL: chip 0's HBM history forked into "
                  f"{len(chip_series)} series across the restart")
            return 1
        cts = [t for t, _v in chip_series[0]["values"]]
        if not (
            any(t <= t_killed for t in cts)
            and any(t > t_up - 1.0 for t in cts)
        ):
            print("FAIL: chip 0's HBM series lacks samples on both sides "
                  "of the restart")
            return 1
        print(f"         labeled-series continuity: chip 0 HBM is ONE "
              f"series with {len(cts)} samples spanning the restart")

        # ---- phase 3: corrupt the WAL mid-file; boot must survive ----
        print("phase 3: SIGKILL again, corrupt wal.bin mid-file, restart")
        child.send_signal(_signal.SIGKILL)
        child.wait(timeout=30)
        wal_path = os.path.join(state_dir, WAL_NAME)
        size = os.path.getsize(wal_path)
        with open(wal_path, "r+b") as f:
            f.seek(max(size // 2, len(MAGIC)))
            f.write(b"\xde\xad\xbe\xef" * 8)
        child = subprocess.Popen(base_cmd)
        status, _body = _wait_http(base + "/readyz", 30)
        dv = _get_json(base + "/debug/vars")
        persist = dv.get("persist") or {}
        print(f"         boot survived the corrupt WAL (readyz {status}, "
              f"restored={persist.get('restored')}) — truncated at the "
              f"torn record, no crash loop")
        print("restart-demo: OK (kill mid-poll → warm restore → "
              "contiguous history, breaker carryover, corrupt-WAL boot)")
        rc = 0
    finally:
        if child is not None and child.poll() is None:
            child.terminate()
            try:
                child.wait(timeout=10)
            except subprocess.TimeoutExpired:
                child.kill()
        if own_dir and rc == 0:
            shutil.rmtree(state_dir, ignore_errors=True)
        elif rc != 0:
            print(f"state dir kept for inspection: {state_dir}")
    return rc


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="tpu-pod-exporter-persist",
        description="Restart-survivability harness: kill/restart demo, "
                    "fsync budget check, persistence overhead check.",
    )
    p.add_argument("--restart-demo", action="store_true",
                   help="SIGKILL a live exporter mid-poll, restart it on "
                        "the same --state-dir, assert history continuity "
                        "+ breaker carryover + corrupt-WAL boot")
    p.add_argument("--state-dir", default="",
                   help="state dir for --restart-demo/--fsync-check "
                        "(default: a temp dir, removed on success)")
    p.add_argument("--fsync-check", action="store_true",
                   help="measure WAL append+fsync latency and fail past "
                        "--budget-ms")
    p.add_argument("--records", type=int, default=100)
    p.add_argument("--doubles", type=int, default=4400,
                   help="float64s per record (256-chip tracked-set shape)")
    p.add_argument("--budget-ms", type=float, default=50.0)
    p.add_argument("--overhead-check", action="store_true",
                   help="measure persistence-on vs -off poll-thread CPU "
                        "and fail past --budget")
    p.add_argument("--polls", type=int, default=200)
    p.add_argument("--chips", type=int, default=256)
    p.add_argument("--budget", type=float, default=0.02,
                   help="max tolerated fractional poll-thread CPU overhead "
                        "(0.02 = 2%%)")
    ns = p.parse_args(argv)

    if ns.restart_demo:
        return _restart_demo(ns)
    if ns.fsync_check:
        return _fsync_check(ns.records, ns.doubles, ns.budget_ms / 1e3,
                            ns.state_dir)
    if ns.overhead_check:
        return _overhead_check(ns.polls, ns.chips, ns.budget)
    p.error("need --restart-demo, --fsync-check, or --overhead-check")
    return 2


if __name__ == "__main__":
    import sys

    sys.exit(main())
