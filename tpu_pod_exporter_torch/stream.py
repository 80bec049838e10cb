"""Streaming dashboard plane — per-round delta subscriptions over /api/v1.

The event-loop server made a *pull* cheap (cached-bytes scrapes) and the
fleet plane's generation-keyed result cache already collapses N dashboard
panels into one fan-out per round — but every viewer refresh still re-sends
a full body, and there is exactly one root to send it. This module inverts
pull into push: a client registers a query **once**
(``GET /api/v1/stream?metric=...``) and thereafter receives per-round
*deltas* — the changed series only, the same "ship what changed" idiom the
exposition splice (``metrics.registry.ExpositionTemplate``) and the egress
delta batches (``egress.py``) already use.

Cost model, the whole point of the inversion:

- **One delta computation per query shape per round**, shared by every
  subscriber of that shape (the hub answers through the tier's existing
  query plane, whose generation-keyed cache makes the underlying fan-out
  once-per-round too).
- **One small write per subscriber per round**, handed to the event loop
  (``server.py``) — no per-viewer threads, no per-viewer fan-outs, and a
  stalled viewer costs a write-progress deadline, never a handler thread.

Stream rot defenses, all lessons already paid for elsewhere in the tree:

- an initial **snapshot** frame at registration (delta streams need a base);
- periodic **full_sync** frames (``full_sync_s`` — the egress lesson:
  delta-only streams rot; a missed frame or a bug on either side
  self-heals within one sync period);
- **heartbeat** frames while rounds are quiet (idle TCP streams die
  silently behind NATs and proxies);
- a **shape-level ``seq``** on every data frame so a client can prove it
  missed nothing (the dashboard-storm drill's zero-missed/zero-duplicate
  invariant reads it);
- a subscriber cap (admission) plus a ``stream_shed`` memory-ladder rung
  (``pressure.register_stream_rung``) that sheds the oldest subscriptions,
  counted — policy, never silent.

Transports: SSE (``event:``/``data:`` frames on a close-delimited response)
is the default; ``?transport=longpoll`` is the chunked long-poll fallback —
each request carries a ``cursor`` (the last seq seen) and the server holds
it until a newer frame exists, then answers with the missed frames.

Delta semantics (exactness by construction): the hub keys every row of the
polled answer by its series identity ``(metric, sorted labels)``; a delta
carries the rows whose content changed plus the keys that vanished.
Replaying snapshot + deltas therefore reproduces the polled answer's row
set *bit for bit* (``StreamReplay``; property-tested in
``tests/test_stream.py`` against seeded value/layout/membership churn).

Thread contract: ``on_round`` is called by the tier's ONE round thread
(after publish); ``subscribe``/``poll_frames`` run on server worker
threads; ``tick`` runs on the event loop. The hub lock guards registry
state only — query evaluation, JSON serialization and subscriber writes
all happen outside it.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Mapping

from tpu_pod_exporter_torch.metrics import CounterStore, HistogramStore, schema
from tpu_pod_exporter_torch.metrics.registry import SnapshotBuilder
from tpu_pod_exporter_torch.utils import RateLimitedLogger

log = logging.getLogger("tpu_pod_exporter_torch.stream")

STREAM_ROUTES: tuple[str, ...] = ("series", "query_range", "window_stats",
                                 "alerts")

# Frame types a data-bearing frame may carry (heartbeats repeat the last
# seq instead of consuming one; continuity is asserted over these three).
DATA_FRAME_TYPES: tuple[str, ...] = ("snapshot", "delta", "full_sync")


class HubFull(Exception):
    """Subscriber cap reached — the caller answers 429 and the client
    should retry against a read replica."""


class StreamDisabled(Exception):
    """No hub attached on this tier (the server answers 404)."""


# ------------------------------------------------------------------ shapes


@dataclass(frozen=True)
class QueryShape:
    """One registered query: the canonical identity every subscriber of
    the same dashboard panel shares. ``window_s`` is the trailing span the
    per-round evaluation covers (``end=now`` each round; ``query_range``
    grid-aligns through the plane's existing step snapping, so successive
    rounds inside one step bucket produce identical grids and ship no
    bytes)."""

    route: str
    metric: str = ""
    match: tuple[tuple[str, str], ...] = ()
    window_s: float = 60.0
    step: float = 0.0
    agg: str = "last"

    @property
    def key(self) -> tuple:
        return (self.route, self.metric, self.match, self.window_s,
                self.step, self.agg)

    def params_doc(self) -> dict[str, Any]:
        """JSON-able echo of the registered query (rides the snapshot
        frame so a client can prove what the server heard)."""
        doc: dict[str, Any] = {"route": self.route}
        if self.route not in ("series", "alerts"):
            doc["metric"] = self.metric
            doc["match"] = dict(self.match)
            doc["window"] = self.window_s
        if self.route == "query_range":
            doc["step"] = self.step
            doc["agg"] = self.agg
        return doc

    @classmethod
    def from_params(cls, param: Callable[[str], str | None],
                    match: Mapping[str, str] | None = None) -> "QueryShape":
        """Validated construction from HTTP query params; raises
        ValueError with a message naming the offending token (the server
        maps it to the same 400 contract as the polled routes)."""
        route = param("route") or "window_stats"
        if route not in STREAM_ROUTES:
            raise ValueError(
                f"route must be one of {'/'.join(STREAM_ROUTES)}"
            )
        if route in ("series", "alerts"):
            # Parameterless shapes: every subscriber shares one canonical
            # identity (alerts rows are keyed by alertname + instance
            # labels; transitions arrive as row deltas).
            return cls(route=route)
        metric = param("metric")
        if not metric:
            raise ValueError("missing required parameter: metric")
        window = float(param("window") or
                       (300.0 if route == "query_range" else 60.0))
        if not window > 0 or window != window or window == float("inf"):
            raise ValueError("window must be a finite number > 0")
        step = 0.0
        agg = "last"
        if route == "query_range":
            # Streams REQUIRE a step: step=0 (raw samples) re-anchors the
            # grid at every round's wall clock, so every row would change
            # every round (full-body "deltas") and the plane's grid-
            # aligned generation cache could never hit — the whole
            # one-evaluation-per-shape cost model needs a grid to share.
            step = float(param("step") or 0.0)
            if not (step > 0 and step == step and step != float("inf")):
                raise ValueError(
                    "query_range streams need a finite step > 0 (a "
                    "stepless sliding window re-ships every row every "
                    "round; use route=window_stats for scalar panels)"
                )
            if window / step > 11000:
                raise ValueError(
                    "query resolution too high: window / step must be "
                    "<= 11000"
                )
            agg = param("agg") or "last"
            if agg not in ("last", "min", "max", "mean"):
                raise ValueError("agg must be one of last/min/max/mean")
        return cls(
            route=route, metric=metric,
            match=tuple(sorted((match or {}).items())),
            window_s=window, step=step, agg=agg,
        )


def row_key(row: Mapping[str, Any]) -> tuple:
    """Series identity of one answer row — the label-identity keying every
    merge tier already uses (``fleet._merge`` / ``RootQueryPlane``)."""
    labels = row.get("labels")
    if not isinstance(labels, Mapping):
        labels = {}
    return (str(row.get("metric", "")),
            tuple(sorted((str(k), str(v)) for k, v in labels.items())))


def key_doc(key: tuple) -> list:
    """JSON-able form of a row key (rides delta frames' ``removed``)."""
    return [key[0], [[k, v] for k, v in key[1]]]


def doc_key(doc: Any) -> tuple:
    """Inverse of :func:`key_doc` (client side)."""
    metric, pairs = doc
    return (str(metric), tuple((str(k), str(v)) for k, v in pairs))


def sse_bytes(frame_json: str, frame_type: str) -> bytes:
    return (b"event: " + frame_type.encode("ascii")
            + b"\ndata: " + frame_json.encode("utf-8") + b"\n\n")


# ------------------------------------------------------------- hub internals


@dataclass
class _Subscriber:
    """One live SSE subscription. ``writer`` hands frame bytes to the
    event loop; ``closer`` asks the loop to flush-then-close the
    connection (used by shed). Both must be thread-safe (the server's
    are call_soon posts). ``base_seq`` is the seq the snapshot was built
    at; frames committed before :meth:`StreamHub.activate` flips
    ``started`` are caught up from the shape ring, never lost."""

    shape_key: tuple
    writer: Callable[[bytes], None]
    closer: Callable[[], None]
    created: float
    base_seq: int = 0
    started: bool = False
    closed: bool = False


@dataclass
class _Waiter:
    """One parked long-poll request: answered by the next data frame past
    ``cursor``, or by a heartbeat when ``deadline`` passes."""

    shape_key: tuple
    cursor: int
    callback: Callable[[dict], None]
    deadline: float
    done: bool = False


class _ShapeState:
    """Per-shape registry entry. ``seq``/``rows_by_key``/``ring`` are
    written only under the hub lock (commit step of ``on_round`` /
    first-subscribe init); readers take the lock briefly and never hold
    it across serialization."""

    __slots__ = ("shape", "seq", "generation", "rows_by_key", "meta",
                 "ring", "subscribers", "waiters", "last_full_wall",
                 "last_push_wall", "last_used_mono", "bytes_est")

    RING_FRAMES = 32

    def __init__(self, shape: QueryShape) -> None:
        self.shape = shape
        self.seq = 0
        self.generation = -1
        self.rows_by_key: dict[tuple, dict] | None = None
        self.meta: dict[str, Any] = {}
        # (seq, frame_type, frame_json, sse) of recent data frames — the
        # long-poll catch-up window.
        self.ring: deque[tuple[int, str, str, bytes]] = deque(
            maxlen=self.RING_FRAMES)
        self.subscribers: list[_Subscriber] = []
        self.waiters: list[_Waiter] = []
        self.last_full_wall = 0.0
        self.last_push_wall = 0.0
        self.last_used_mono = 0.0
        self.bytes_est = 0


def _frame_meta(env: Mapping[str, Any], full: bool) -> dict[str, Any]:
    """Envelope extras worth shipping. Full frames carry the fleet health
    summary AND the per-target status map (status --watch's degraded-
    target footer reads it; refreshed once per full_sync_s); deltas carry
    only the two flags a renderer needs — per-target durations change
    every round and would make every delta fat."""
    meta: dict[str, Any] = {
        "partial": bool(env.get("partial")),
        "source": env.get("source", "live"),
    }
    if full:
        fl = env.get("fleet")
        if isinstance(fl, Mapping):
            meta["fleet"] = dict(fl)
        tg = env.get("targets")
        if isinstance(tg, Mapping):
            meta["targets"] = dict(tg)
    return meta


class StreamHub:
    """The subscription registry plus per-round delta fan-in/fan-out.

    ``poll_fn(shape, generation)`` answers one registered query with the
    tier's regular envelope (the server wires it to the same plane the
    polled ``/api/v1`` routes use, so streamed and polled answers cannot
    drift). ``generation_fn`` is the tier's round counter (the same value
    the result cache keys on).
    """

    # A slow subscriber's pending-bytes cap lives in the server (it owns
    # the buffers); the hub's own bound is the subscriber cap.
    def __init__(
        self,
        poll_fn: Callable[[QueryShape, int], dict],
        generation_fn: Callable[[], int],
        heartbeat_s: float = 10.0,
        full_sync_s: float = 60.0,
        max_subscribers: int = 10000,
        clock: Callable[[], float] = time.monotonic,
        wallclock: Callable[[], float] = time.time,
    ) -> None:
        self._poll_fn = poll_fn
        self._generation_fn = generation_fn
        self.heartbeat_s = heartbeat_s
        self.full_sync_s = full_sync_s
        self._max_subscribers = max_subscribers
        # The admission cap as configured — pressure shed halves the
        # EFFECTIVE cap; recovery restores this one.
        self._configured_max = max_subscribers
        self._clock = clock
        self._wallclock = wallclock
        self._lock = threading.Lock()
        self._shapes: dict[tuple, _ShapeState] = {}
        self._n_subscribers = 0
        self._rlog = RateLimitedLogger(log)
        self._counters = CounterStore()
        self._hist = HistogramStore(schema.TPU_STREAM_PUSH_SECONDS)
        # Pre-seed the conditional surface (stable from first exposition).
        for t in ("snapshot", "delta", "full_sync", "heartbeat"):
            self._counters.inc(schema.TPU_STREAM_FRAMES_TOTAL.name, (t,), 0.0)
        for tr in ("sse", "longpoll"):
            self._counters.inc(schema.TPU_STREAM_SUBSCRIBES_TOTAL.name,
                               (tr,), 0.0)
        self._counters.inc(schema.TPU_STREAM_REJECTS_TOTAL.name, ("cap",),
                           0.0)
        for r in ("pressure", "slow", "cap"):
            self._counters.inc(schema.TPU_STREAM_SHEDS_TOTAL.name, (r,), 0.0)
        self._counters.inc(schema.TPU_STREAM_FRAME_BYTES_TOTAL.name, (), 0.0)
        # Push-latency witnesses for the storm drill: wall ts of the last
        # on_round entry (frames also carry their emission wall ts).
        self.last_round_wall = 0.0

    # ------------------------------------------------------------ lifecycle

    @property
    def subscribers(self) -> int:
        with self._lock:
            return self._n_subscribers

    @property
    def max_subscribers(self) -> int:
        return self._max_subscribers

    def set_max_subscribers(self, n: int) -> None:
        """Runtime cap change: updates BOTH the configured cap (what
        pressure release restores / apply halves) and the effective one —
        otherwise the next pressure cycle would silently revert it."""
        self._configured_max = max(0, int(n))
        self._max_subscribers = self._configured_max

    # ------------------------------------------------------------ subscribe

    def _shape_state(self, shape: QueryShape) -> _ShapeState:
        """Registry entry for ``shape``, created (and primed with an
        initial evaluation) on first use. The evaluation runs OUTSIDE the
        lock; a racing first-subscriber's result commits only if the slot
        is still unprimed."""
        with self._lock:
            st = self._shapes.get(shape.key)
            if st is None:
                st = self._shapes[shape.key] = _ShapeState(shape)
                # The heartbeat countdown starts at creation, not at the
                # epoch — a fresh stream must not open with a heartbeat.
                st.last_push_wall = self._wallclock()
            st.last_used_mono = self._clock()
            if st.rows_by_key is not None:
                return st
        generation = self._generation_fn()
        env = self._poll_fn(shape, generation)
        rows = _env_rows(shape.route, env)
        new_map: dict[tuple, dict] = {}
        for row in rows:
            if isinstance(row, dict):
                new_map[row_key(row)] = row
        meta = _frame_meta(env, full=True)
        now_wall = self._wallclock()
        with self._lock:
            if st.rows_by_key is None:
                st.rows_by_key = new_map
                st.meta = meta
                st.generation = generation
                st.last_full_wall = now_wall
        return st

    def subscribe(
        self,
        shape: QueryShape,
        writer: Callable[[bytes], None],
        closer: Callable[[], None],
        auto_start: bool = True,
    ) -> tuple[_Subscriber, bytes]:
        """Register one SSE subscription; returns the subscriber handle
        plus the initial bytes (snapshot frame, and with ``auto_start``
        any data frames that landed while it was being serialized) the
        caller must write first. Raises :class:`HubFull` at the cap.

        ``auto_start=False`` (the server's mode) defers the catch-up +
        push enablement to :meth:`activate`, which the caller runs ONLY
        once its transport is ready to accept writer() frames — a round
        committed between subscribe and transport-ready would otherwise
        race the writer against the transport setup and silently drop a
        frame (a permanent seq gap until the next full sync)."""
        with self._lock:
            if self._n_subscribers >= self._max_subscribers:
                self._counters.inc(schema.TPU_STREAM_REJECTS_TOTAL.name,
                                   ("cap",))
                raise HubFull(
                    f"stream subscriber cap reached "
                    f"({self._max_subscribers})"
                )
            self._n_subscribers += 1
        try:
            st = self._shape_state(shape)
        except Exception:
            with self._lock:
                self._n_subscribers -= 1
            raise
        sub = _Subscriber(shape_key=shape.key, writer=writer, closer=closer,
                          created=self._clock())
        with self._lock:
            base_seq = st.seq
            rows = list((st.rows_by_key or {}).values())
            meta = dict(st.meta)
            generation = st.generation
            st.subscribers.append(sub)
        # Serialize OUTSIDE the lock (lock-io discipline); frames that
        # commit meanwhile are caught up from the ring below.
        frame = {
            "type": "snapshot", "seq": base_seq, "gen": generation,
            "ts": self._wallclock(), "shape": shape.params_doc(),
            "rows": rows, "meta": meta,
        }
        payload = sse_bytes(_dumps(frame), "snapshot")
        sub.base_seq = base_seq
        catchup: list[bytes] = []
        with self._lock:
            if auto_start:
                catchup = [s for q, _t, _j, s in st.ring if q > base_seq]
                sub.started = True
            if st.bytes_est == 0:
                # Memory accounting from the first subscriber on — a
                # shape that never full-synced must not read as free.
                st.bytes_est = len(payload)
        self._counters.inc(schema.TPU_STREAM_SUBSCRIBES_TOTAL.name, ("sse",))
        self._counters.inc(schema.TPU_STREAM_FRAMES_TOTAL.name,
                           ("snapshot",))
        out = payload + b"".join(catchup)
        self._counters.inc(schema.TPU_STREAM_FRAME_BYTES_TOTAL.name, (),
                           float(len(out)))
        return sub, out

    def activate(self, sub: _Subscriber) -> bytes:
        """Second half of ``subscribe(auto_start=False)``: atomically
        collect every data frame committed since the snapshot's base seq
        (from the shape ring) and enable round pushes. Returns the
        catch-up bytes the caller must append after the snapshot — a
        frame is either in the catch-up or pushed via writer(), never
        dropped and never duplicated."""
        with self._lock:
            if sub.closed or sub.started:
                return b""
            st = self._shapes.get(sub.shape_key)
            if st is None:
                return b""
            catchup = [s for q, _t, _j, s in st.ring if q > sub.base_seq]
            sub.started = True
        if catchup:
            self._counters.inc(schema.TPU_STREAM_FRAME_BYTES_TOTAL.name, (),
                               float(sum(len(c) for c in catchup)))
        return b"".join(catchup)

    def detach(self, sub: _Subscriber) -> None:
        """Connection closed (client drop, write deadline, server stop)."""
        with self._lock:
            if sub.closed:
                return
            sub.closed = True
            st = self._shapes.get(sub.shape_key)
            if st is not None:
                try:
                    st.subscribers.remove(sub)
                except ValueError:
                    pass
            self._n_subscribers -= 1

    def count_slow_shed(self) -> None:
        """The server shed a subscriber whose pending write buffer blew
        the cap (it owns the buffers; the hub owns the counter)."""
        self._counters.inc(schema.TPU_STREAM_SHEDS_TOTAL.name, ("slow",))

    # -------------------------------------------------------------- rounds

    def on_round(self, generation: int | None = None) -> None:
        """One round happened: evaluate every live shape once, push the
        delta to its subscribers, answer its parked long-polls. Called by
        the tier's round thread AFTER publish (single caller by contract —
        seq/ring have one writer)."""
        if generation is None:
            generation = self._generation_fn()
        now_wall = self._wallclock()
        self.last_round_wall = now_wall
        with self._lock:
            live = [st for st in self._shapes.values()
                    if st.subscribers or st.waiters]
        for st in live:
            t0 = self._clock()
            try:
                env = self._poll_fn(st.shape, generation)
            except Exception as e:  # noqa: BLE001 — one bad shape must not stall the rest
                self._rlog.warning(f"shape:{st.shape.key!r}",
                                   "stream shape evaluation failed: %s", e)
                continue
            rows = _env_rows(st.shape.route, env)
            new_map: dict[tuple, dict] = {}
            for row in rows:
                if isinstance(row, dict):
                    new_map[row_key(row)] = row
            with self._lock:
                old_map = st.rows_by_key or {}
                seq = st.seq
            changed = [r for k, r in new_map.items() if old_map.get(k) != r]
            removed = [key_doc(k) for k in old_map if k not in new_map]
            full_due = (self.full_sync_s > 0
                        and now_wall - st.last_full_wall >= self.full_sync_s)
            if not changed and not removed and not full_due:
                # Nothing to ship: the heartbeat timer covers liveness.
                with self._lock:
                    st.generation = generation
                continue
            seq += 1
            # Stamped at BUILD time, per frame: ts is the push-latency
            # witness (client recv minus ts), and an entry-time stamp
            # would bill every shape for the evaluation time of the
            # shapes computed before it in this pass.
            frame_wall = self._wallclock()
            if full_due:
                ftype = "full_sync"
                frame: dict[str, Any] = {
                    "type": ftype, "seq": seq, "gen": generation,
                    "ts": frame_wall, "rows": list(new_map.values()),
                    "meta": _frame_meta(env, full=True),
                }
            else:
                ftype = "delta"
                frame = {
                    "type": ftype, "seq": seq, "gen": generation,
                    "ts": frame_wall, "changed": changed,
                    "removed": removed,
                    "meta": _frame_meta(env, full=False),
                }
            frame_json = _dumps(frame)
            payload = sse_bytes(frame_json, ftype)
            with self._lock:
                st.seq = seq
                st.generation = generation
                st.rows_by_key = new_map
                st.meta = _frame_meta(env, full=True)
                st.ring.append((seq, ftype, frame_json, payload))
                st.last_push_wall = now_wall
                if full_due:
                    st.last_full_wall = now_wall
                    # bytes_est refreshed on every full sync; deltas
                    # leave the retained-rows estimate alone (drift is
                    # bounded by one full_sync period).
                    st.bytes_est = len(frame_json)
                subs = [s for s in st.subscribers if s.started]
                waiters = [w for w in st.waiters if not w.done]
                st.waiters = []
            self._push(subs, payload, ftype)
            for w in waiters:
                self._answer_waiter(w, [(seq, frame_json)])
            self._hist.observe(self._clock() - t0)

    def _push(self, subs: list[_Subscriber], payload: bytes,
              ftype: str) -> None:
        n = 0
        for sub in subs:
            if sub.closed:
                continue
            try:
                sub.writer(payload)
                n += 1
            except Exception:  # noqa: BLE001 — one dead writer must not stop the fan-out
                self.detach(sub)
        if n:
            self._counters.inc(schema.TPU_STREAM_FRAMES_TOTAL.name,
                               (ftype,), float(n))
            self._counters.inc(schema.TPU_STREAM_FRAME_BYTES_TOTAL.name, (),
                               float(n * len(payload)))

    # ----------------------------------------------------------- long-poll

    def poll_frames(
        self,
        shape: QueryShape,
        cursor: int | None,
        callback: Callable[[dict], None],
        wait_s: float | None = None,
    ) -> dict | None:
        """Long-poll transport: answer immediately when frames newer than
        ``cursor`` exist (or no cursor → snapshot), else park the request;
        ``callback`` fires with the answer document from a later
        ``on_round``/``tick``. Returns the immediate answer or None when
        parked."""
        st = self._shape_state(shape)
        self._counters.inc(schema.TPU_STREAM_SUBSCRIBES_TOTAL.name,
                           ("longpoll",))
        with self._lock:
            seq = st.seq
            generation = st.generation
            if cursor is None or cursor > seq:
                rows = list((st.rows_by_key or {}).values())
                meta = dict(st.meta)
                snap = True
                ring: list[tuple[int, str]] = []
            elif cursor < seq:
                ring = [(q, j) for q, _t, j, _s in st.ring if q > cursor]
                snap = not ring or ring[0][0] != cursor + 1
                if snap:
                    # The ring no longer reaches the cursor: resync.
                    rows = list((st.rows_by_key or {}).values())
                    meta = dict(st.meta)
                    ring = []
            else:
                # Waiter deadline: heartbeat cadence, or a sane hold when
                # heartbeats are disabled — a parked long-poll must ALWAYS
                # get answered (tick() expires waiters unconditionally).
                hold = (wait_s if wait_s is not None
                        else (self.heartbeat_s if self.heartbeat_s > 0
                              else 25.0))
                w = _Waiter(
                    shape_key=shape.key, cursor=cursor, callback=callback,
                    deadline=self._clock() + hold,
                )
                st.waiters.append(w)
                return None
        if snap:
            frame = {
                "type": "snapshot", "seq": seq, "gen": generation,
                "ts": self._wallclock(), "shape": shape.params_doc(),
                "rows": rows, "meta": meta,
            }
            self._counters.inc(schema.TPU_STREAM_FRAMES_TOTAL.name,
                               ("snapshot",))
            return {"status": "ok", "cursor": seq, "frames": [frame]}
        frames = [json.loads(j) for _q, j in ring]
        return {"status": "ok", "cursor": ring[-1][0], "frames": frames}

    def _answer_waiter(self, w: _Waiter,
                       frames: list[tuple[int, str]]) -> None:
        if w.done:
            return
        w.done = True
        doc = {"status": "ok", "cursor": frames[-1][0],
               "frames": [json.loads(j) for _q, j in frames]}
        try:
            w.callback(doc)
        except Exception:  # noqa: BLE001 — a dead waiter must not stop the round
            log.exception("long-poll waiter callback failed")

    # ----------------------------------------------------------------- tick

    def tick(self, now: float | None = None) -> None:
        """Periodic maintenance (the server arms a 1 s loop timer):
        heartbeats to quiet subscribers, heartbeat answers to expired
        long-poll waiters, and GC of shapes nobody watches."""
        mono = self._clock() if now is None else now
        now_wall = self._wallclock()
        hb_due: list[tuple[_ShapeState, list[_Subscriber],
                           list[_Waiter]]] = []
        with self._lock:
            for key in [k for k, st in self._shapes.items()
                        if not st.subscribers and not st.waiters
                        and mono - st.last_used_mono > 60.0]:
                del self._shapes[key]
            for st in self._shapes.values():
                # Waiter expiry is UNCONDITIONAL: a parked long-poll must
                # be answered even with heartbeat frames disabled
                # (heartbeat_s gates only the subscriber-side keep-alives).
                expired = [w for w in st.waiters
                           if not w.done and w.deadline <= mono]
                subs: list[_Subscriber] = []
                if (self.heartbeat_s > 0 and st.subscribers
                        and now_wall - st.last_push_wall
                        >= self.heartbeat_s):
                    subs = [s for s in st.subscribers if s.started]
                    st.last_push_wall = now_wall
                if expired:
                    st.waiters = [w for w in st.waiters
                                  if not w.done and w.deadline > mono]
                if subs or expired:
                    hb_due.append((st, subs, expired))
        for st, subs, expired in hb_due:
            frame = {"type": "heartbeat", "seq": st.seq,
                     "gen": st.generation, "ts": now_wall}
            frame_json = _dumps(frame)
            if subs:
                self._push(subs, sse_bytes(frame_json, "heartbeat"),
                           "heartbeat")
            for w in expired:
                if w.done:
                    continue
                w.done = True
                doc = {"status": "ok", "cursor": st.seq,
                       "frames": [json.loads(frame_json)]}
                try:
                    w.callback(doc)
                except Exception:  # noqa: BLE001 — a dead waiter must not stop the tick
                    log.exception("long-poll heartbeat callback failed")

    # ------------------------------------------------------------- pressure

    def shed_oldest(self, fraction: float = 0.5,
                    reason: str = "pressure") -> int:
        """Close the oldest ``fraction`` of live subscriptions (each gets
        a final ``shed`` frame naming the reason, then its connection is
        closed — the client should reconnect against a replica). The
        memory ladder's ``stream_shed`` rung. Returns the count shed."""
        with self._lock:
            subs = [s for st in self._shapes.values()
                    for s in st.subscribers if not s.closed]
        if not subs:
            return 0
        subs.sort(key=lambda s: s.created)
        n = max(1, int(len(subs) * fraction))
        victims = subs[:n]
        frame = _dumps({"type": "shed", "reason": reason,
                        "ts": self._wallclock()})
        payload = sse_bytes(frame, "shed")
        for sub in victims:
            try:
                sub.writer(payload)
                sub.closer()
            except Exception:  # noqa: BLE001 — shedding must not raise
                pass
            self.detach(sub)
            self._counters.inc(schema.TPU_STREAM_SHEDS_TOTAL.name, (reason,))
        return len(victims)

    def apply_pressure(self) -> None:
        """``stream_shed`` rung apply: shed the oldest half and halve the
        effective cap so a storm cannot instantly refill what was shed."""
        self.shed_oldest(0.5, reason="pressure")
        self._max_subscribers = max(1, self._configured_max // 2)

    def release_pressure(self) -> None:
        self._max_subscribers = self._configured_max

    def shape_seqs(self) -> dict[tuple, int]:
        """Current data-frame seq per shape key — the drills' catch-up
        oracle: a subscriber is caught up when its replay seq reaches its
        shape's seq (a shape whose rows did not change ships nothing, so
        'saw every generation' would be the wrong invariant)."""
        with self._lock:
            return {key: st.seq for key, st in self._shapes.items()}

    def memory_bytes(self) -> int:
        """Estimated retained bytes (last answers + catch-up rings) for
        the memory budget's component accounting — the same number
        /debug/vars reports."""
        total = 0
        with self._lock:
            for st in self._shapes.values():
                total += st.bytes_est
                total += sum(len(j) for _q, _t, j, _s in st.ring)
        return total

    # ------------------------------------------------------------ exposition

    def emit(self, b: SnapshotBuilder) -> None:
        """Publish the plane's self-metrics into one snapshot (called from
        the owning tier's publish via its emit hook — conditional surface,
        present only while a hub is attached)."""
        for spec in schema.STREAM_SPECS:
            b.declare(spec)
        with self._lock:
            n_subs = self._n_subscribers
            n_shapes = len(self._shapes)
        b.add(schema.TPU_STREAM_SUBSCRIBERS, float(n_subs))
        b.add(schema.TPU_STREAM_QUERY_SHAPES, float(n_shapes))
        for spec in (schema.TPU_STREAM_SUBSCRIBES_TOTAL,
                     schema.TPU_STREAM_REJECTS_TOTAL,
                     schema.TPU_STREAM_FRAMES_TOTAL,
                     schema.TPU_STREAM_FRAME_BYTES_TOTAL,
                     schema.TPU_STREAM_SHEDS_TOTAL):
            for lv, v in self._counters.items_for(spec.name):
                b.add(spec, v, lv)
        self._hist.emit(b)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "subscribers": self._n_subscribers,
                "shapes": len(self._shapes),
                "max_subscribers": self._max_subscribers,
                "configured_max_subscribers": self._configured_max,
                "heartbeat_s": self.heartbeat_s,
                "full_sync_s": self.full_sync_s,
                "waiters": sum(len(st.waiters)
                               for st in self._shapes.values()),
                "memory_bytes_est": sum(
                    st.bytes_est + sum(len(j) for _q, _t, j, _s in st.ring)
                    for st in self._shapes.values()
                ),
            }

    def close(self) -> None:
        with self._lock:
            subs = [s for st in self._shapes.values()
                    for s in st.subscribers]
            self._shapes.clear()
            self._n_subscribers = 0
        for sub in subs:
            sub.closed = True
            try:
                sub.closer()
            except Exception:  # noqa: BLE001 — draining must finish
                pass


def attach_stream(
    agg: Any,
    plane: Any,
    heartbeat_s: float = 10.0,
    full_sync_s: float = 60.0,
    max_subscribers: int = 10000,
    alerts_fn: Callable[[], list] | None = None,
) -> tuple[StreamHub, "StreamPump"]:
    """Standard tier wiring: a hub answering through ``plane`` (the same
    query plane the polled /api/v1 serves), generation = the tier's round
    counter, a started pump hooked to the tier's round hook, and the
    hub's self-metrics riding the tier's publish. Used by the aggregator,
    root and replica CLIs — one wiring path, not three twins.
    ``alerts_fn`` (root only) feeds the ``route=alerts`` shape."""
    hub = StreamHub(
        plane_poll_fn(plane, alerts_fn=alerts_fn),
        generation_fn=lambda: agg.rounds,
        heartbeat_s=heartbeat_s,
        full_sync_s=full_sync_s,
        max_subscribers=max_subscribers,
    )
    pump = StreamPump(hub)
    pump.start()
    agg.round_hooks.append(pump.notify)
    agg.emit_hooks.append(hub.emit)
    return hub, pump


class StreamPump:
    """Decouples the round thread from delta evaluation.

    ``poll_once`` must stay a merge + publish — evaluating K query shapes
    (each potentially a cached-or-real fan-out) on the round thread would
    read as round time and page the round-budget alerts. The tier's round
    hook costs one ``Event.set``; this pump's own (named, daemon) thread
    runs ``hub.on_round`` — the same poll-side-cheap discipline as the
    persistence and egress writer threads. Deterministic harnesses (the
    scenario engine, the drills) skip the pump and call ``on_round``
    directly.
    """

    def __init__(self, hub: StreamHub) -> None:
        self._hub = hub
        self._event = threading.Event()
        self._stopping = False
        self._generation = 0
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="tpu-stream-pump", daemon=True,
        )
        self._thread.start()

    def notify(self, generation: int) -> None:
        """Round hook (any thread): schedule one on_round pass. Back-to-
        back rounds coalesce — the pump always evaluates against the
        NEWEST generation, and a skipped intermediate round simply means
        one delta carries two rounds' changes (seq stays contiguous)."""
        self._generation = int(generation)
        self._event.set()

    def _run(self) -> None:
        while True:
            self._event.wait()
            self._event.clear()
            if self._stopping:
                return
            try:
                self._hub.on_round(self._generation)
            except Exception:  # noqa: BLE001 — one bad round must not kill the pump
                log.exception("stream pump round failed")

    def close(self) -> None:
        self._stopping = True
        self._event.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def _dumps(obj: Any) -> str:
    """Frame serialization: compact separators (these bytes repeat per
    subscriber) and NaN-safe (same contract as the JSON routes)."""
    try:
        return json.dumps(obj, separators=(",", ":"), allow_nan=False)
    except ValueError:
        from tpu_pod_exporter_torch.server import _json_sanitize

        return json.dumps(_json_sanitize(obj), separators=(",", ":"))


def _env_rows(route: str, env: Mapping[str, Any]) -> list:
    from tpu_pod_exporter_torch.fleet import rows_of

    return rows_of(route, env)


# ---------------------------------------------------------------- poll_fn


def plane_poll_fn(plane: Any,
                  wallclock: Callable[[], float] = time.time,
                  alerts_fn: Callable[[], list] | None = None,
                  ) -> Callable[[QueryShape, int], dict]:
    """Adapter: a fleet-like query plane (``series``/``query_range``/
    ``window_stats``) → the hub's ``poll_fn``. The trailing window is
    re-anchored at now each round; the plane's own grid alignment and
    generation-keyed cache make repeated evaluations cheap. ``alerts_fn``
    feeds the ``route=alerts`` shape (the AlertEvaluator's active rows);
    a tier with no evaluator streams an empty, never-erroring row set."""

    def poll(shape: QueryShape, generation: int) -> dict:  # noqa: ARG001 — the plane caches by its own generation
        match = dict(shape.match)
        if shape.route == "alerts":
            rows = alerts_fn() if alerts_fn is not None else []
            return {"status": "ok", "source": "live",
                    "data": {"result": rows}}
        if shape.route == "series":
            return plane.series()
        if shape.route == "window_stats":
            return plane.window_stats(shape.metric, match,
                                      window_s=shape.window_s)
        end = wallclock()
        return plane.query_range(shape.metric, match,
                                 start=end - shape.window_s, end=end,
                                 step=shape.step, agg=shape.agg)

    return poll


def history_poll_fn(history: Any,
                    wallclock: Callable[[], float] = time.time,
                    ) -> Callable[[QueryShape, int], dict]:
    """Adapter for the node tier's HistoryStore: wraps its raw answers in
    the same envelope shape the fleet planes serve, so one replay client
    reads every tier."""

    def poll(shape: QueryShape, generation: int) -> dict:  # noqa: ARG001
        match = dict(shape.match)
        if shape.route == "alerts":
            # Node tier owns no evaluator — an alerts stream is legal but
            # empty (the root is where alerting lives).
            return {"status": "ok", "source": "live",
                    "data": {"result": []}}
        if shape.route == "series":
            return {"status": "ok", "source": "live",
                    "data": history.series_list()}
        if shape.route == "window_stats":
            result = history.window_stats(shape.metric, match,
                                          window_s=shape.window_s)
            return {"status": "ok", "source": "live",
                    "data": {"result": result or []}}
        end = wallclock()
        result = history.query_range(shape.metric, match,
                                     end - shape.window_s, end, shape.step,
                                     agg=shape.agg)
        return {"status": "ok", "source": "live",
                "data": {"resultType": "matrix", "result": result or []}}

    return poll


# ------------------------------------------------------------------ replay


class StreamReplay:
    """Client-side frame application + continuity accounting.

    Applying a snapshot then every subsequent delta/full_sync reproduces
    the polled answer's row set exactly (the server diffs whole rows by
    series key); ``gaps``/``dups`` count seq discontinuities — the
    dashboard-storm drill asserts both stay zero, and ``desynced`` flags
    a replay that saw a gap and has not yet been healed by a full_sync."""

    def __init__(self) -> None:
        self.rows: dict[tuple, dict] = {}
        self.meta: dict[str, Any] = {}
        self.shape_doc: dict[str, Any] | None = None
        self.seq: int | None = None
        self.generation: int | None = None
        self.frames = 0
        self.data_frames = 0
        self.gaps = 0
        self.dups = 0
        self.desynced = False
        self.shed_reason: str | None = None
        # Wall latency of the last frame (receiver clock minus the
        # frame's emission ts — meaningful when both sides share a host,
        # as in the drills).
        self.last_latency_s: float | None = None

    def apply(self, frame: Mapping[str, Any],
              recv_wall: float | None = None) -> None:
        self.frames += 1
        ftype = frame.get("type")
        ts = frame.get("ts")
        if recv_wall is not None and isinstance(ts, (int, float)):
            self.last_latency_s = max(recv_wall - float(ts), 0.0)
        if ftype == "shed":
            self.shed_reason = str(frame.get("reason", ""))
            return
        if ftype == "heartbeat":
            return
        if ftype not in DATA_FRAME_TYPES:
            return
        seq = int(frame.get("seq", 0))
        if ftype == "snapshot":
            self.shape_doc = dict(frame.get("shape") or {})
            self._load_full(frame, seq)
            self.desynced = False
        elif ftype == "full_sync":
            if self.seq is not None and seq > self.seq + 1:
                self.gaps += seq - self.seq - 1
            elif self.seq is not None and seq <= self.seq:
                self.dups += 1
                return
            self._load_full(frame, seq)
            self.desynced = False  # a full sync heals any earlier gap
        else:  # delta
            if self.seq is None:
                # Delta before any snapshot: unusable base.
                self.desynced = True
                return
            if seq <= self.seq:
                self.dups += 1
                return
            if seq > self.seq + 1:
                self.gaps += seq - self.seq - 1
                self.desynced = True
            for row in frame.get("changed") or []:
                if isinstance(row, dict):
                    self.rows[row_key(row)] = row
            for kd in frame.get("removed") or []:
                try:
                    self.rows.pop(doc_key(kd), None)
                except (TypeError, ValueError, IndexError):
                    continue
            self._meta(frame)
            self.seq = seq
            self.generation = int(frame.get("gen", 0))
        self.data_frames += 1

    def _load_full(self, frame: Mapping[str, Any], seq: int) -> None:
        self.rows = {}
        for row in frame.get("rows") or []:
            if isinstance(row, dict):
                self.rows[row_key(row)] = row
        self._meta(frame)
        self.seq = seq
        self.generation = int(frame.get("gen", 0))

    def _meta(self, frame: Mapping[str, Any]) -> None:
        meta = frame.get("meta")
        if isinstance(meta, Mapping):
            self.meta.update(meta)

    def rows_by_key(self) -> dict[tuple, dict]:
        return dict(self.rows)


def rows_map(route: str, env: Mapping[str, Any]) -> dict[tuple, dict]:
    """Polled envelope → the same keyed row map a replay reconstructs
    (the drills' equality oracle)."""
    return {row_key(r): r for r in _env_rows(route, env)
            if isinstance(r, dict)}


# ------------------------------------------------------------------ client


class SseParser:
    """Incremental SSE frame parser: feed raw bytes, get frame dicts.
    Shared by the blocking client below and the storm harness's
    selector-driven clients (loadgen)."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> list[dict]:
        self._buf += data
        frames: list[dict] = []
        while True:
            idx = self._buf.find(b"\n\n")
            if idx < 0:
                break
            block = bytes(self._buf[:idx])
            del self._buf[:idx + 2]
            data_lines = [line[5:].strip() for line in block.split(b"\n")
                          if line.startswith(b"data:")]
            if not data_lines:
                continue
            try:
                frames.append(json.loads(b"\n".join(data_lines)))
            except ValueError:
                continue
        return frames


def stream_path(shape: QueryShape, transport: str = "",
                cursor: int | None = None) -> str:
    """``/api/v1/stream`` request path for one shape."""
    import urllib.parse

    params: dict[str, str] = {"route": shape.route}
    if shape.route != "series":
        params["metric"] = shape.metric
        params["window"] = f"{shape.window_s:g}"
        for k, v in shape.match:
            params[f"match[{k}]"] = v
    if shape.route == "query_range":
        params["step"] = f"{shape.step:g}"
        params["agg"] = shape.agg
    if transport:
        params["transport"] = transport
    if cursor is not None:
        params["cursor"] = str(cursor)
    return "/api/v1/stream?" + urllib.parse.urlencode(params)


class StreamClient:
    """Minimal blocking SSE subscriber (status --watch, tests, small
    drills; the 5-10k-connection storm harness uses its own selector loop
    over :class:`SseParser` instead)."""

    def __init__(self, host: str, port: int, shape: QueryShape,
                 timeout_s: float = 10.0) -> None:
        self.shape = shape
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)
        path = stream_path(shape)
        self._sock.sendall(
            f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
            f"Accept: text/event-stream\r\n\r\n".encode()
        )
        self._parser = SseParser()
        self._closed = False
        # Set when the server closed the stream (shed, restart, death) —
        # distinct from a frames() timeout; watchers read it to decide
        # between waiting more and falling back to polling.
        self.eof = False
        # Read the response head; non-200 means no stream here (the
        # caller falls back to polling).
        head = b""
        while b"\r\n\r\n" not in head:
            chunk = self._sock.recv(4096)
            if not chunk:
                raise ConnectionError("stream endpoint closed during head")
            head += chunk
        head, _, rest = head.partition(b"\r\n\r\n")
        status_line = head.split(b"\r\n", 1)[0]
        parts = status_line.split()
        self.status = int(parts[1]) if len(parts) > 1 else 0
        if self.status != 200:
            body = rest
            try:
                while True:
                    chunk = self._sock.recv(4096)
                    if not chunk:
                        break
                    body += chunk
            except OSError:
                pass
            self.close()
            raise StreamDisabled(
                f"stream endpoint answered HTTP {self.status}: "
                f"{body[:200].decode('utf-8', 'replace')}"
            )
        self._pending: deque[dict] = deque(self._parser.feed(rest))

    def frames(self, max_frames: int | None = None,
               timeout_s: float | None = None) -> Iterator[dict]:
        """Yield frames as they arrive; stops on connection close, after
        ``max_frames``, or when one read waits past ``timeout_s``."""
        n = 0
        if timeout_s is not None:
            self._sock.settimeout(timeout_s)
        while max_frames is None or n < max_frames:
            while self._pending:
                yield self._pending.popleft()
                n += 1
                if max_frames is not None and n >= max_frames:
                    return
            try:
                chunk = self._sock.recv(65536)
            except socket.timeout:
                return
            except OSError:
                self.eof = True
                return
            if not chunk:
                self.eof = True
                return
            self._pending.extend(self._parser.feed(chunk))

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._sock.close()
            except OSError:
                pass
