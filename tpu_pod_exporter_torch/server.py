"""HTTP export surface — ``GET /metrics`` plus health endpoints.

Analog of the reference's promhttp goroutine (``main.go:67-72``), with the
scrape path made collection-free *and* render-free: the poll loop pre-encodes
the exposition text into the SnapshotStore, so a scrape is one reference
read and one kernel copy of cached bytes. This is what keeps p99 scrape
latency flat regardless of chip count (SURVEY.md §3.3, §7 "hard parts").

Serving architecture: a single ``selectors``-based event
loop owns every socket — accept, request parse, and all response writes —
so a thousand idle keep-alive scrapers or trickle-reading clients cost file
descriptors, not threads. Work that may block (an uncached render, the
/api/v1 history/fleet queries, /debug serialization) is handed to a small
elastic worker pool whose results are written back by the loop; the common
scrape (body already cached on the snapshot) is served entirely inline.
The pre-event-loop defenses carry over as natural loop constructs:

- ``--client-write-timeout-s`` (SO_SNDTIMEO on the old thread-per-connection
  server) is now a per-connection write-progress deadline: a client that
  stalls mid-body is dropped and counted once no byte has moved for that
  long.
- The scrape-rate tarpit is a loop timer, not a sleeping thread.
- Admission control (connection cap, per-client cap) and the pre-rendered
  429 + Retry-After paths run inline on the loop before any work is spent.

Endpoints the reference lacks:
- ``/healthz`` — liveness (200 unless the poll loop is provably wedged).
- ``/readyz`` — readiness JSON (200 once data is being served, 503
  before) with a ``state`` field: ``starting`` / ``warm`` (serving a
  restored pre-restart snapshot, first live poll pending — see
  ``tpu_pod_exporter_torch.persist``) / ``ready`` / ``degraded``.
- ``/api/v1/series`` / ``/api/v1/query_range`` / ``/api/v1/window_stats`` —
  JSON queries against the node-local history flight recorder
  (``tpu_pod_exporter_torch.history``); served on the metrics port because the
  slice aggregator consumes them. Absent history (``--history-retention-s
  0``) answers 404 JSON. On the aggregator the same routes are served by
  the federated fleet query plane (``tpu_pod_exporter_torch.fleet``) behind the
  same 2-permit fence.
- ``/debug/vars``, ``/debug/stacks`` and ``/debug/trace`` (poll traces as
  Chrome ``trace_event`` JSON) answer **loopback clients only** by default
  (thread stacks, config and traces are operator surface, not fleet
  surface); ``--debug-addr 0.0.0.0`` restores remote access.

Probe routes (/healthz, /readyz, /) answer inline on the loop so a scrape
storm or a wedged render can never starve kubelet; their optional hooks
(``live_fn``/``ready_detail_fn``/``warm_fn``) must therefore stay
non-blocking — every in-repo hook is a lock-free stats read.
"""

from __future__ import annotations

import heapq
import json
import logging
import math
import selectors
import socket
import threading
import time
from collections import deque
from itertools import islice
from typing import Any, Callable
from urllib.parse import parse_qs

from tpu_pod_exporter_torch.metrics import SnapshotStore
from tpu_pod_exporter_torch.trace import parse_traceparent, to_chrome_trace


def _json_sanitize(obj: Any) -> Any:
    """Replace non-finite floats with None, recursively (slow path of
    JSON serving — only runs when a response actually contains one)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_json_sanitize(v) for v in obj]
    return obj


def debug_client_allowed(client_ip: str, debug_addr: str) -> bool:
    """Whether a /debug/* request from ``client_ip`` may be served.

    Default policy is loopback-only: thread stacks and effective config are
    operator surface. ``--debug-addr 0.0.0.0`` (or ``*``) opens the debug
    endpoints to any client that can reach the metrics port. Loopback is
    always allowed regardless of the setting — the RUNBOOK's on-node curl
    must never lock itself out."""
    if client_ip.startswith("127.") or client_ip == "::1" or client_ip.startswith("::ffff:127."):
        return True
    return debug_addr in ("0.0.0.0", "*")


def _format_stacks() -> str:
    """Every live thread's Python stack, one block per thread.

    ``sys._current_frames`` is a documented-CPython atomic snapshot (the
    dict is built under the GIL); traceback formatting walks frame objects
    that stay valid while referenced, so a wedged thread's stack renders
    even though that thread never cooperates."""
    import sys
    import traceback

    frames = sys._current_frames()
    by_id = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in sorted(frames.items()):
        t = by_id.get(ident)
        name = t.name if t else "?"
        daemon = " daemon" if (t and t.daemon) else ""
        out.append(f"--- thread {ident} ({name}){daemon} ---")
        out.extend(
            line.rstrip("\n")
            for line in traceback.format_stack(frame)
        )
        out.append("")
    return "\n".join(out) + "\n"


log = logging.getLogger("tpu_pod_exporter_torch.server")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"


def prerender_429(body: bytes, content_type: str) -> bytes:
    """A 429 + Retry-After response as raw wire bytes, rendered once at
    import: under a storm the reject path runs per request, and formatting
    a status line plus four headers each time is measurable CPU that a
    reject must not spend. ``Connection: close`` both caps the connection's
    lifetime and tells well-behaved clients to back off the keep-alive
    connection. Shared by the /metrics scrape guard and the /api/v1 query
    fence (exporter and aggregator both — extracted, not duplicated)."""
    return (
        b"HTTP/1.1 429 Too Many Requests\r\n"
        b"Content-Type: " + content_type.encode("ascii") + b"\r\n"
        b"Retry-After: 1\r\n"
        b"Content-Length: " + str(len(body)).encode("ascii") + b"\r\n"
        b"Connection: close\r\n"
        b"\r\n" + body
    )


_REJECT_RESPONSE = prerender_429(
    b"too many concurrent scrapes\n", "text/plain; charset=utf-8"
)
# The /api/v1 fence's twin: still JSON (every consumer of these endpoints
# parses JSON, including during the very storm this rejects).
_API_REJECT_RESPONSE = prerender_429(
    b'{"status": "error", "error": "too many concurrent api queries"}',
    "application/json",
)
# Admission-control rejects (scrape-storm defense):
# a storm must cost rejected requests, never file descriptors
# or handler-thread pile-up. Same pre-rendered-bytes discipline as the
# scrape guard — the reject path runs per storm request.
_CONN_REJECT_RESPONSE = prerender_429(
    b"connection limit reached\n", "text/plain; charset=utf-8"
)
_CLIENT_REJECT_RESPONSE = prerender_429(
    b"per-client request limit reached\n", "text/plain; charset=utf-8"
)
# Stream-subscriber cap (the dashboard plane's admission half): a viewer
# storm past the cap pays a pre-rendered 429 and should retry against a
# read replica — tpu_stream_rejects_total{cause="cap"} counts it.
_STREAM_REJECT_RESPONSE = prerender_429(
    b'{"status": "error", "error": "stream subscriber cap reached; '
    b'retry against a read replica"}',
    "application/json",
)

# Probe paths exempt from admission control: a scrape storm must never be
# able to 429 kubelet's liveness/readiness probes into restarting the pod.
_ADMISSION_EXEMPT_PATHS = ("/healthz", "/readyz")

# Scatter-gather writes need sendmsg (Linux/BSD; absent on some
# platforms — the per-view send() path below is the fallback).
_HAS_SENDMSG = hasattr(socket.socket, "sendmsg")


def accepts_openmetrics(accept: str) -> bool:
    """Whether content negotiation should pick OpenMetrics over plain text.

    A real (if minimal) q-value parse rather than a substring test
    (RFC 9110 §12.4.2 subset): OpenMetrics is served only when its q is
    positive AND at least the q the client gave ``text/plain`` (directly or
    via a wildcard) — a client sending ``text/plain;q=1,
    application/openmetrics-text;q=0.1`` deliberately prefers text and must
    get it. Malformed q-values count as q=1; unlisted types inherit the
    wildcard q, if any.
    """
    qs: dict[str, float] = {}
    for entry in accept.split(","):
        parts = entry.split(";")
        mtype = parts[0].strip().lower()
        if not mtype:
            continue
        q = 1.0
        for param in parts[1:]:
            name, _, value = param.partition("=")
            if name.strip().lower() == "q":
                try:
                    q = float(value.strip())
                except ValueError:
                    q = 1.0
        qs[mtype] = max(q, qs.get(mtype, 0.0))
    wildcard = max(qs.get("*/*", 0.0), qs.get("text/*", 0.0))
    q_om = qs.get("application/openmetrics-text", 0.0)
    q_text = qs.get("text/plain", wildcard)
    return q_om > 0.0 and q_om >= q_text


class _TokenBucket:
    """Scrape-rate cap for /metrics. The concurrency fence bounds how
    many big bodies are in flight, but not how many per second — and a
    sequential storm of full-body scrapes is pure kernel-copy cost
    (~0.4 ms CPU per ~950 KB body at 256 chips; measured, bench.py) that
    no amount of server cleverness removes. Above the bucket rate the
    exporter answers with the pre-rendered 429 instead: monitoring losing
    a scrape beats monitoring stealing the TPU host's cores. The default
    rate (config.max_scrapes_per_s=100) is ~20× any sane setup — a few
    Prometheus replicas plus an aggregator at 1 Hz."""

    __slots__ = ("rate", "burst", "tokens", "last", "lock")

    def __init__(self, rate: float, burst: float) -> None:
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.last = time.monotonic()
        self.lock = threading.Lock()

    def take(self) -> bool:
        with self.lock:
            # monotonic() read INSIDE the lock: a stale `now` against a
            # newer `last` written by another thread would apply a negative
            # refill, silently draining tokens (code-review r5).
            now = time.monotonic()
            self.tokens = min(
                self.burst, self.tokens + (now - self.last) * self.rate
            )
            self.last = now
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True
            return False

    def refund(self) -> None:
        """Return a taken token (the request was refused downstream anyway —
        e.g. by the concurrency guard — so it must not count against the
        rate: a stall would otherwise drain the bucket and 429 well-behaved
        scrapers after it clears)."""
        with self.lock:
            self.tokens = min(self.burst, self.tokens + 1.0)


# --------------------------------------------------------------- HTTP pieces

_MAX_HEADER_BYTES = 65536
# GET requests carry no meaningful body here; anything advertised beyond
# this is refused rather than buffered (the loop must never hold unbounded
# client bytes).
_MAX_BODY_DISCARD = 1 << 20

_STATUS_LINES = {
    200: b"HTTP/1.1 200 OK\r\n",
    400: b"HTTP/1.1 400 Bad Request\r\n",
    403: b"HTTP/1.1 403 Forbidden\r\n",
    404: b"HTTP/1.1 404 Not Found\r\n",
    413: b"HTTP/1.1 413 Content Too Large\r\n",
    429: b"HTTP/1.1 429 Too Many Requests\r\n",
    431: b"HTTP/1.1 431 Request Header Fields Too Large\r\n",
    500: b"HTTP/1.1 500 Internal Server Error\r\n",
    501: b"HTTP/1.1 501 Not Implemented\r\n",
    503: b"HTTP/1.1 503 Service Unavailable\r\n",
}


class _Request:
    """One parsed request head (the loop never buffers request bodies)."""

    __slots__ = ("method", "target", "headers", "keep_alive")

    def __init__(self, method: str, target: str, headers: dict[str, str],
                 keep_alive: bool) -> None:
        self.method = method
        self.target = target
        self.headers = headers
        self.keep_alive = keep_alive


def _parse_head(head: bytes) -> _Request | None:
    """Parse request line + headers. None = malformed (caller 400s)."""
    lines = head.split(b"\r\n")
    parts = lines[0].split()
    if len(parts) != 3:
        return None
    method_b, target_b, version = parts
    if not version.startswith(b"HTTP/1."):
        return None
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        key, sep, value = line.partition(b":")
        if not sep:
            return None
        try:
            headers[key.strip().decode("latin-1").lower()] = (
                value.strip().decode("latin-1")
            )
        except UnicodeDecodeError:  # pragma: no cover - latin-1 total
            return None
    keep_alive = version == b"HTTP/1.1"
    conn_tokens = headers.get("connection", "").lower()
    if "close" in conn_tokens:
        keep_alive = False
    elif "keep-alive" in conn_tokens:
        keep_alive = True
    return _Request(method_b.decode("latin-1"), target_b.decode("latin-1"),
                    headers, keep_alive)


class _Response:
    """A response the loop serializes and writes. ``observe`` marks a
    served scrape (duration observed + trace span recorded at flush)."""

    __slots__ = ("status", "headers", "body", "close", "observe",
                 "trace_ctx")

    def __init__(self, status: int, headers: list[tuple[str, str]],
                 body: bytes, close: bool = False, observe: bool = False,
                 trace_ctx: tuple[str, str] | None = None) -> None:
        self.status = status
        self.headers = headers
        self.body = body
        self.close = close
        self.observe = observe
        self.trace_ctx = trace_ctx


def _text_response(code: int, body: bytes, close: bool = False) -> _Response:
    return _Response(
        code, [("Content-Type", "text/plain; charset=utf-8")], body,
        close=close,
    )


def _json_response(code: int, obj: Any) -> _Response:
    try:
        # allow_nan=False: bare NaN/Infinity literals are not JSON and
        # break every strict parser (jq, JSON.parse, encoding/json) —
        # exactly during the forensics these endpoints serve. Backends
        # CAN report NaN samples (format_value supports them), so the
        # fallback path maps non-finite values to null instead of 500ing.
        body = json.dumps(obj, allow_nan=False).encode()  # lint: disable=loop-blocking(probe payloads only: readyz/healthz/debug docs are a few hundred bytes, microseconds to encode — the metrics exposition never comes through here)
    except ValueError:
        body = json.dumps(_json_sanitize(obj)).encode()  # lint: disable=loop-blocking(same probe-sized payload as the line above, non-finite fallback)
    return _Response(code, [("Content-Type", "application/json")], body)


class _Conn:
    """Per-connection loop state: read buffer, pending write queue, and the
    bookkeeping the admission/observation paths need at request finish."""

    __slots__ = (
        "sock", "fd", "ip", "rbuf", "wbufs", "admitted", "keep_alive",
        "busy", "close_after", "closed", "client_key", "req_t0",
        "observe_scrape", "trace_ctx", "need_discard", "events",
        "response_pending", "last_write_progress", "write_deadline_armed",
        "streaming", "stream_sub",
    )

    def __init__(self, sock: socket.socket, ip: str) -> None:
        self.sock = sock
        self.fd = sock.fileno()
        self.ip = ip
        self.rbuf = bytearray()
        self.wbufs: deque[memoryview] = deque()
        self.admitted = True
        self.keep_alive = True
        self.busy = False            # a request is in flight
        self.close_after = False
        self.closed = False
        self.client_key: str | None = None
        self.req_t0 = 0.0
        self.observe_scrape = False
        self.trace_ctx: tuple[str, str] | None = None
        self.need_discard = 0        # request-body bytes left to drop
        self.events = 0              # current selector interest mask
        self.response_pending = False
        self.last_write_progress = 0.0
        self.write_deadline_armed = False
        # Dashboard stream subscription riding this connection (SSE,
        # close-delimited): the loop pushes frames instead of finishing a
        # request, and closing detaches the hub subscriber.
        self.streaming = False
        self.stream_sub: Any = None


class _WorkerPool:
    """Elastic thread pool for request work that may block (uncached
    renders, history/fleet queries, /debug serialization). Threads are
    spawned on demand up to ``max_workers`` and expire after idling — the
    steady state of a healthy exporter is zero to one worker, because the
    hot path never leaves the loop."""

    _IDLE_EXPIRE_S = 10.0

    def __init__(self, max_workers: int,
                 idle_expire_s: float | None = None) -> None:
        self._max = max(1, max_workers)
        self._idle_expire = (idle_expire_s if idle_expire_s is not None
                             else self._IDLE_EXPIRE_S)
        self._tasks: deque[Callable[[], None]] = deque()
        self._lock = threading.Lock()
        # LIFO stack of idle workers' wake events. Submit wakes the MOST
        # recently parked worker: work concentrates on few hot threads and
        # the rest genuinely idle until the reap takes them. (The old
        # Condition.notify() rotated wakeups round-robin through every
        # waiter, which both refreshed each one's idle clock AND spread a
        # trickle of tasks across the whole storm-grown pool — BENCH_r06's
        # slow_clients threads_after never returned to baseline.)
        self._waiters: list[threading.Event] = []
        self._threads = 0
        self._seq = 0
        self._stopping = False

    @property
    def threads(self) -> int:
        return self._threads

    @property
    def queued(self) -> int:
        return len(self._tasks)

    def submit(self, fn: Callable[[], None]) -> None:
        spawn = False
        wake: threading.Event | None = None
        with self._lock:
            if self._stopping:
                return
            self._tasks.append(fn)
            if self._waiters:
                wake = self._waiters.pop()  # LIFO: hottest worker first
            elif self._threads < self._max:
                self._threads += 1
                self._seq += 1
                spawn = True
                seq = self._seq
        if wake is not None:
            wake.set()
        if spawn:
            threading.Thread(
                target=self._run,
                name=f"tpu-exporter-http-worker-{seq}",
                daemon=True,
            ).start()

    def _run(self) -> None:
        ev = threading.Event()
        last_active = time.monotonic()
        while True:
            fn: Callable[[], None] | None = None
            with self._lock:
                if self._tasks:
                    fn = self._tasks.popleft()
                elif self._stopping:
                    self._threads -= 1
                    return
                else:
                    idle_for = time.monotonic() - last_active
                    if idle_for >= self._idle_expire:
                        # This worker hasn't been needed for a full grace
                        # period: the pool shrinks back toward the traffic
                        # it actually has (steady state 0-1 workers).
                        self._threads -= 1
                        return
                    ev.clear()
                    self._waiters.append(ev)
            if fn is None:
                ev.wait(timeout=self._idle_expire
                        - (time.monotonic() - last_active))
                with self._lock:
                    try:
                        self._waiters.remove(ev)
                    except ValueError:
                        pass  # a submit popped us — a task is waiting
                continue
            try:
                fn()
            except Exception:  # noqa: BLE001 — a task must not kill the pool
                log.exception("http worker task failed")
            last_active = time.monotonic()

    def shutdown(self) -> None:
        with self._lock:
            self._stopping = True
            waiters = list(self._waiters)
            self._waiters.clear()
        for ev in waiters:
            ev.set()


class _HandlerState:
    """Every knob and shared counter the request paths read.

    Exposed to tests as ``server._httpd.RequestHandlerClass`` — the
    pre-event-loop server bound these as class attributes on a
    per-instance handler subclass, and the admission/fence tests poke
    them (``client_active``, ``client_lock``, ``api_sem``) directly."""

    def __init__(self) -> None:
        self.store: SnapshotStore = None  # type: ignore[assignment]
        self.debug_vars: Callable[[], dict] | None = None
        self.history: Any = None
        self.fleet: Any = None
        self.trace: Any = None
        self.api_sem: threading.BoundedSemaphore | None = None
        self.api_queue_timeout_s: float = 0.25
        self.debug_addr: str = "127.0.0.1"
        self.health_max_age_s: float = 0.0
        self.live_fn: Callable[[], str | None] | None = None
        self.ready_detail_fn: Callable[[], dict] | None = None
        self.warm_fn: Callable[[], dict | None] | None = None
        self.scrape_sem: threading.BoundedSemaphore | None = None
        self.scrape_queue_timeout_s: float = 0.25
        self.scrape_bucket: _TokenBucket | None = None
        self.scrape_tarpit_s: float = 0.1
        self.scrape_rejects: dict[str, int] = {}
        self.scrape_rejects_lock = threading.Lock()
        self.scrape_observer: Callable[[float], None] | None = None
        self.max_open_connections: int = 0
        self.conn_stats: dict[str, int] = {}
        self.conn_lock = threading.Lock()
        self.max_requests_per_client: int = 0
        self.client_active: dict[str, int] = {}
        self.client_lock = threading.Lock()
        self.client_write_timeout_s: float = 10.0
        self.write_timeouts: dict[str, int] = {}
        self.write_timeouts_lock = threading.Lock()
        # Streaming dashboard plane (tpu_pod_exporter_torch.stream.StreamHub);
        # None = /api/v1/stream answers 404 on this tier.
        self.stream: Any = None
        self.stream_max_buffer_bytes: int = 2 << 20


class _CompatHandle:
    """Legacy introspection shim: tests (and only tests) reach the shared
    handler state through ``server._httpd.RequestHandlerClass``, the path
    the stdlib-server implementation exposed."""

    def __init__(self, state: _HandlerState) -> None:
        self.RequestHandlerClass = state


# Loop-dispatch probe seam. analysis/witness.py's LoopWitness sets this
# under TPE_LOOP_WITNESS=1 to time every callback the loop runs inline
# (the runtime half of the loop-blocking contract; the static half never
# imports this module). None — the default — keeps dispatch at one global
# read plus a branch.
LOOP_PROBE: "Callable[[str, Callable[..., None], float], None] | None" = None


class _EventLoopServer:
    """The selector loop plus request routing. Single-threaded: every
    socket operation happens on the loop thread; workers communicate back
    exclusively through :meth:`call_soon` + the wake pipe."""

    def __init__(self, host: str, port: int, state: _HandlerState,
                 max_workers: int,
                 worker_idle_expire_s: float = 10.0) -> None:
        self.state = state
        self._sel = selectors.DefaultSelector()
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        # SO_REUSEADDR (TIME_WAIT rebinds) but never SO_REUSEPORT: a second
        # exporter instance binding the same live port must fail loudly,
        # not silently steal scrapes.
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            lsock.bind((host, port))
        except OSError:
            lsock.close()
            raise
        lsock.listen(128)
        lsock.setblocking(False)
        self._lsock = lsock
        # Cached: the port must stay readable after close() (stop() then
        # a late .port read must not raise on the dead socket).
        self._port = int(lsock.getsockname()[1])
        self._conns: dict[int, _Conn] = {}
        self._timers: list[tuple[float, int, Callable[[], None]]] = []
        self._timer_seq = 0
        self._pending: deque[Callable[[], None]] = deque()
        self._pending_lock = threading.Lock()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._stopping = False
        self.pool = _WorkerPool(max_workers, worker_idle_expire_s)
        self.served = {"inline": 0, "worker": 0}
        self._sel.register(lsock, selectors.EVENT_READ, None)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)

    @property
    def port(self) -> int:
        return self._port

    # ------------------------------------------------------------ loop core

    def run(self) -> None:
        try:
            while not self._stopping:
                timeout: float | None = None
                if self._timers:
                    timeout = max(0.0, self._timers[0][0] - time.monotonic())
                for key, mask in self._sel.select(timeout):
                    if key.fileobj is self._lsock:
                        self._invoke("accept", self._accept)
                    elif key.fileobj is self._wake_r:
                        self._invoke("wake", self._drain_wake)
                    else:
                        conn: _Conn = key.data
                        if conn.closed:
                            continue
                        if mask & selectors.EVENT_WRITE:
                            self._invoke("write", self._try_write, conn)
                        if mask & selectors.EVENT_READ and not conn.closed:
                            self._invoke("read", self._on_readable, conn)
                self._run_pending()
                self._run_timers()
        finally:
            for conn in list(self._conns.values()):
                self._close_conn(conn)
            self.pool.shutdown()
            try:
                self._sel.unregister(self._lsock)
                self._sel.unregister(self._wake_r)
            except (KeyError, ValueError):
                pass
            self._sel.close()
            self._wake_r.close()
            self._wake_w.close()
            self._lsock.close()

    def wake(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except (BlockingIOError, OSError):
            pass  # a wake is already pending (or the loop is gone)

    def _invoke(self, kind: str, fn: Callable[..., None],
                *args: Any) -> None:
        """Loop-dispatch choke point: every callback the loop runs inline
        passes through here, so the loop-stall witness can time it and the
        static analyzer can tag the ``fn`` argument with the loop role
        (CALLBACK_ROLES in analysis/concurrency.py)."""
        probe = LOOP_PROBE
        if probe is None:
            fn(*args)
            return
        t0 = time.monotonic()
        try:
            fn(*args)
        finally:
            probe(kind, fn, time.monotonic() - t0)

    def call_soon(self, fn: Callable[[], None]) -> None:
        """Thread-safe: schedule ``fn`` on the loop thread."""
        with self._pending_lock:
            self._pending.append(fn)
        self.wake()

    def call_later(self, delay_s: float, fn: Callable[[], None]) -> None:
        """Loop-thread only: run ``fn`` after ``delay_s``."""
        self._timer_seq += 1
        heapq.heappush(
            self._timers, (time.monotonic() + delay_s, self._timer_seq, fn)
        )

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _run_pending(self) -> None:
        while True:
            with self._pending_lock:
                if not self._pending:
                    return
                fn = self._pending.popleft()
            try:
                self._invoke("pending", fn)
            except Exception:  # noqa: BLE001 — one callback must not kill the loop
                log.exception("loop callback failed")

    def _run_timers(self) -> None:
        now = time.monotonic()
        while self._timers and self._timers[0][0] <= now:
            _, _, fn = heapq.heappop(self._timers)
            try:
                self._invoke("timer", fn)
            except Exception:  # noqa: BLE001 — one timer must not kill the loop
                log.exception("loop timer failed")

    # ----------------------------------------------------- connection state

    def _set_events(self, conn: _Conn, events: int) -> None:
        if conn.closed or events == conn.events:
            return
        if events == 0:
            self._sel.unregister(conn.sock)
        elif conn.events == 0:
            self._sel.register(conn.sock, events, conn)
        else:
            self._sel.modify(conn.sock, events, conn)
        conn.events = events

    def _accept(self) -> None:
        st = self.state
        for _ in range(128):
            try:
                sock, addr = self._lsock.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock, addr[0])
            cap = st.max_open_connections
            with st.conn_lock:
                if cap > 0 and st.conn_stats["open"] >= cap:
                    # Over the cap: the connection still gets ONE request
                    # handled — a probe answer, or the pre-rendered 429 —
                    # then closes. It is never counted as open.
                    conn.admitted = False
                else:
                    st.conn_stats["open"] += 1
                    if st.conn_stats["open"] > st.conn_stats["peak"]:
                        st.conn_stats["peak"] = st.conn_stats["open"]
            self._conns[conn.fd] = conn
            self._set_events(conn, selectors.EVENT_READ)

    def _close_conn(self, conn: _Conn) -> None:
        if conn.closed:
            return
        try:
            self._set_events(conn, 0)
        except (KeyError, ValueError, OSError):
            pass
        conn.closed = True
        sub = conn.stream_sub
        if sub is not None:
            conn.stream_sub = None
            hub = self.state.stream
            if hub is not None:
                try:
                    hub.detach(sub)
                except Exception:  # noqa: BLE001 — teardown must not kill the loop
                    log.exception("stream detach failed")
        self._release_client_slot(conn)
        self._conns.pop(conn.fd, None)
        try:
            conn.sock.close()
        except OSError:
            pass
        if conn.admitted:
            with self.state.conn_lock:
                self.state.conn_stats["open"] -= 1

    def _release_client_slot(self, conn: _Conn) -> None:
        key = conn.client_key
        if key is None:
            return
        conn.client_key = None
        st = self.state
        with st.client_lock:
            cur = st.client_active.get(key, 1) - 1
            if cur <= 0:
                st.client_active.pop(key, None)
            else:
                st.client_active[key] = cur

    # --------------------------------------------------------------- reads

    def _on_readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(65536)
        except BlockingIOError:
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:
            self._close_conn(conn)
            return
        if conn.streaming:
            # A subscriber never pipelines; anything it sends after the
            # subscribe request is discarded. The read interest stays on
            # solely so a client close is noticed promptly (the recv above
            # returning b"" is how a dropped viewer frees its slot).
            return
        conn.rbuf += data
        if conn.busy:
            if len(conn.rbuf) > 4 * _MAX_HEADER_BYTES:
                # Pipelining flood while a response is in flight: stop
                # reading until the current request finishes.
                self._set_events(conn, conn.events & ~selectors.EVENT_READ)
            return
        self._process_rbuf(conn)

    def _process_rbuf(self, conn: _Conn) -> None:
        if conn.need_discard:
            take = min(conn.need_discard, len(conn.rbuf))
            del conn.rbuf[:take]
            conn.need_discard -= take
            if conn.need_discard:
                return
        idx = conn.rbuf.find(b"\r\n\r\n")
        if idx < 0:
            if len(conn.rbuf) > _MAX_HEADER_BYTES:
                self._respond(conn, _text_response(
                    431, b"request header too large\n", close=True))
            return
        head = bytes(conn.rbuf[:idx])
        del conn.rbuf[:idx + 4]
        req = _parse_head(head)
        if req is None:
            self._respond(conn, _text_response(
                400, b"malformed request\n", close=True))
            return
        if "transfer-encoding" in req.headers:
            self._respond(conn, _text_response(
                400, b"request bodies are not accepted\n", close=True))
            return
        try:
            body_len = int(req.headers.get("content-length", "0") or "0")
        except ValueError:
            self._respond(conn, _text_response(
                400, b"bad content-length\n", close=True))
            return
        if body_len > _MAX_BODY_DISCARD:
            self._respond(conn, _text_response(
                413, b"request body too large\n", close=True))
            return
        if body_len > 0:
            conn.need_discard = body_len
            take = min(conn.need_discard, len(conn.rbuf))
            del conn.rbuf[:take]
            conn.need_discard -= take
        conn.busy = True
        conn.req_t0 = time.monotonic()
        conn.keep_alive = req.keep_alive
        if req.method != "GET":
            self._respond(conn, _text_response(
                501, b"only GET is supported\n", close=True))
            return
        try:
            self._handle_request(conn, req)
        except Exception:  # noqa: BLE001 — routing bug must not kill the loop
            log.exception("request handling failed")
            if not conn.closed and not conn.response_pending:
                self._respond(conn, _text_response(
                    500, b"internal error\n", close=True))

    # -------------------------------------------------------------- writes

    def _respond(self, conn: _Conn, resp: _Response) -> None:
        if conn.closed:
            return
        body = resp.body
        close = resp.close or not conn.keep_alive
        head = [_STATUS_LINES[resp.status]]
        for k, v in resp.headers:
            head.append(f"{k}: {v}\r\n".encode("latin-1"))
        head.append(b"Content-Length: " + str(len(body)).encode("ascii")
                    + b"\r\n")
        if close:
            head.append(b"Connection: close\r\n")
        head.append(b"\r\n")
        conn.wbufs.append(memoryview(b"".join(head)))
        if body:
            conn.wbufs.append(memoryview(body))
        conn.close_after = close
        conn.observe_scrape = resp.observe
        conn.trace_ctx = resp.trace_ctx
        conn.response_pending = True
        conn.last_write_progress = time.monotonic()
        if close:
            self._stop_reading(conn)
        self._try_write(conn)

    def _send_raw(self, conn: _Conn, raw: bytes) -> None:
        """Queue pre-rendered wire bytes (the 429 family) and close after."""
        if conn.closed:
            return
        conn.wbufs.append(memoryview(raw))
        conn.close_after = True
        conn.observe_scrape = False
        conn.trace_ctx = None
        conn.response_pending = True
        conn.last_write_progress = time.monotonic()
        self._stop_reading(conn)
        self._try_write(conn)

    def _stop_reading(self, conn: _Conn) -> None:
        """This connection will close once its response flushes: stop
        reading and drop any buffered client bytes. Without this a client
        streaming header-less bytes (no terminator, never reading) would
        grow ``rbuf`` at its send rate and queue one 431 per recv — an
        unauthenticated memory lever — since the pipelining read-throttle
        only engages while ``busy`` is set."""
        conn.rbuf.clear()
        conn.need_discard = 0
        self._set_events(conn, conn.events & ~selectors.EVENT_READ)

    # Scatter-gather width for sendmsg: response head + body leave in one
    # syscall (the identity keep-alive fast path — a ~1 MB cached body was
    # previously one send per queued view, and the head/body split cost a
    # second syscall per request); bounded well under IOV_MAX.
    _SENDMSG_MAX_VIEWS = 16

    def _try_write(self, conn: _Conn) -> None:
        sock = conn.sock
        while conn.wbufs:
            try:
                if len(conn.wbufs) > 1 and _HAS_SENDMSG:
                    # Zero-copy gather of the queued memoryviews — no
                    # join, no intermediate bytes; the kernel walks the
                    # iovec straight out of the cached body. islice, not
                    # a full-deque copy: a backlogged stream subscriber
                    # can hold hundreds of queued frame views, and this
                    # runs on the loop's hot path.
                    bufs = list(islice(conn.wbufs,
                                       self._SENDMSG_MAX_VIEWS))
                    n = sock.sendmsg(bufs)
                else:
                    n = sock.send(conn.wbufs[0])
            except BlockingIOError:
                self._set_events(conn, conn.events | selectors.EVENT_WRITE)
                self._arm_write_deadline(conn)
                return
            except OSError:
                self._close_conn(conn)
                return
            if not n:
                break
            conn.last_write_progress = time.monotonic()
            # Advance the queue by n bytes (sendmsg may span views).
            while n:
                mv = conn.wbufs[0]
                if n < len(mv):
                    conn.wbufs[0] = mv[n:]
                    n = 0
                else:
                    n -= len(mv)
                    conn.wbufs.popleft()
        if conn.events & selectors.EVENT_WRITE:
            self._set_events(conn, conn.events & ~selectors.EVENT_WRITE)
        if conn.response_pending:
            conn.response_pending = False
            self._finish_request(conn)

    def _arm_write_deadline(self, conn: _Conn) -> None:
        """Slow-client write defense: the old server set SO_SNDTIMEO so a
        blocked sendall() raised after --client-write-timeout-s; on the
        loop the same contract is a progress deadline — a connection whose
        pending bytes move nothing for that long is dropped and counted
        (tpu_exporter_client_write_timeouts_total)."""
        t = self.state.client_write_timeout_s
        if t <= 0 or conn.write_deadline_armed:
            return
        conn.write_deadline_armed = True

        def check() -> None:
            if conn.closed or not conn.wbufs:
                conn.write_deadline_armed = False
                return
            idle = time.monotonic() - conn.last_write_progress
            if idle >= t:
                st = self.state
                with st.write_timeouts_lock:
                    st.write_timeouts["total"] += 1
                log.debug("client write timeout from %s", conn.ip)
                self._close_conn(conn)
            else:
                self.call_later(t - idle, check)

        self.call_later(t, check)

    def _finish_request(self, conn: _Conn) -> None:
        if conn.observe_scrape:
            dur = time.monotonic() - conn.req_t0
            observer = self.state.scrape_observer
            if observer is not None:
                try:
                    observer(dur)
                except Exception:  # noqa: BLE001 — observer must not kill the loop
                    log.exception("scrape observer failed")
            ctx = conn.trace_ctx
            tstore = self.state.trace
            if ctx is not None and tstore is not None:
                # Cross-tier join: a scrape carrying a W3C traceparent
                # header (the aggregator stamps one per fan-out scrape)
                # records a node-side scrape span under the REMOTE trace
                # context, so the aggregator's round trace links to this
                # exporter's serve time. Headerless scrapes (Prometheus)
                # record nothing — no per-scrape ring churn.
                tstore.record_scrape(
                    ctx[0], ctx[1], time.time() - dur, dur, client=conn.ip,
                )
            conn.observe_scrape = False
            conn.trace_ctx = None
        self._release_client_slot(conn)
        conn.busy = False
        if conn.close_after:
            self._close_conn(conn)
            return
        self._set_events(conn, conn.events | selectors.EVENT_READ)
        if conn.rbuf or conn.need_discard:
            # Deferred (not recursed): a client that pipelined hundreds of
            # requests into one buffer must cost loop iterations, not
            # Python stack depth.
            self.call_soon(lambda: self._resume_buffered(conn))

    def _resume_buffered(self, conn: _Conn) -> None:
        if not conn.closed and not conn.busy:
            self._process_rbuf(conn)

    # ----------------------------------------------------------- streaming

    _STREAM_HEAD = (
        b"HTTP/1.1 200 OK\r\n"
        b"Content-Type: text/event-stream\r\n"
        b"Cache-Control: no-cache\r\n"
        b"X-Accel-Buffering: no\r\n"
        b"Connection: close\r\n"
        b"\r\n"
    )

    def _begin_stream(self, conn: _Conn, sub: Any, payload: bytes) -> None:
        """Loop-thread: turn this connection into a live SSE subscription.
        ``payload`` is the hub-built snapshot (plus any frames that landed
        during serialization); everything after arrives via
        :meth:`_stream_write` posts from round/tick threads."""
        hub = self.state.stream
        if conn.closed:
            # The viewer dropped while the worker was subscribing.
            if hub is not None:
                hub.detach(sub)
            return
        conn.streaming = True
        conn.stream_sub = sub
        conn.keep_alive = False
        conn.close_after = False    # pushes keep coming until detach
        conn.response_pending = False
        # The subscription is capped by the hub, not the per-client
        # request cap — a dashboard opening 8 panels from one IP is the
        # normal case, not an attack the request cap should stop.
        self._release_client_slot(conn)
        conn.wbufs.append(memoryview(self._STREAM_HEAD))
        conn.wbufs.append(memoryview(payload))
        # Transport is ready: enable round pushes AND atomically collect
        # any frame committed since the snapshot was built (the ring
        # catch-up) — writer() posts land on this loop strictly after
        # this callback, so a frame is never dropped into the
        # pre-streaming window and never duplicated.
        if hub is not None:
            try:
                catchup = hub.activate(sub)
            except Exception:  # noqa: BLE001 — a hub bug must not kill the loop
                log.exception("stream activate failed")
                catchup = b""
            if catchup:
                conn.wbufs.append(memoryview(catchup))
        conn.last_write_progress = time.monotonic()
        self._try_write(conn)

    def _stream_write(self, conn: _Conn, payload: bytes) -> None:
        """Loop-thread: push one frame to a subscriber. A viewer that
        stopped reading accumulates pending views; past the buffer cap it
        is shed immediately (counted) rather than waiting out the write
        deadline — its memory cost is bounded either way."""
        if conn.closed or not conn.streaming or conn.close_after:
            # close_after = the stream is already ending (shed flush in
            # flight): later frames are dropped, not re-shed/re-counted.
            return
        pending = sum(len(m) for m in conn.wbufs)
        if pending + len(payload) > self.state.stream_max_buffer_bytes:
            hub = self.state.stream
            if hub is not None:
                hub.count_slow_shed()
            log.debug("stream subscriber %s shed: %d pending bytes",
                      conn.ip, pending)
            self._close_conn(conn)
            return
        conn.wbufs.append(memoryview(payload))
        self._try_write(conn)

    def _end_stream(self, conn: _Conn) -> None:
        """Server-initiated stream end (shed, hub close): FLUSH-then-
        close — the final labeled ``shed`` frame already queued must
        reach the viewer (the RUNBOOK contract); a viewer too stalled to
        take it is bounded by the write-progress deadline as ever."""
        if conn.closed:
            return
        if not conn.streaming:
            self._close_conn(conn)
            return
        conn.close_after = True
        if not conn.wbufs:
            self._close_conn(conn)
            return
        conn.response_pending = True  # drain → _finish_request → close
        self._try_write(conn)

    def _task_stream(self, conn: _Conn, query: str) -> None:
        """Worker task for GET /api/v1/stream: validate the query shape,
        then either register an SSE subscription (snapshot now, deltas
        pushed per round) or serve/park one long-poll turn."""
        from tpu_pod_exporter_torch.stream import HubFull, QueryShape

        st = self.state
        hub = st.stream
        if hub is None:
            self.post_response(conn, _json_response(404, {
                "status": "error",
                "error": "streaming not enabled on this tier "
                         "(no stream hub attached; poll /api/v1 instead)",
            }))
            return
        qs = parse_qs(query, keep_blank_values=True)

        def param(name: str) -> str | None:
            vals = qs.get(name)
            return vals[-1] if vals else None

        match = {
            k[len("match["):-1]: vs[-1]
            for k, vs in qs.items()
            if k.startswith("match[") and k.endswith("]") and len(k) > 7
        }
        try:
            shape = QueryShape.from_params(param, match)
        except ValueError as e:
            self.post_response(conn, _json_response(400, {
                "status": "error", "error": str(e)}))
            return
        transport = param("transport") or "sse"
        if transport not in ("sse", "longpoll"):
            self.post_response(conn, _json_response(400, {
                "status": "error",
                "error": "transport must be sse or longpoll"}))
            return
        if transport == "longpoll":
            raw = param("cursor")
            try:
                cursor = int(raw) if raw is not None else None
            except ValueError:
                self.post_response(conn, _json_response(400, {
                    "status": "error", "error": "cursor must be an integer",
                }))
                return

            def answer(doc: dict) -> None:
                self.post_response(conn, _json_response(200, doc))

            try:
                doc = hub.poll_frames(shape, cursor, answer)
            except Exception as e:  # noqa: BLE001 — a broken shape answers, never hangs
                self.post_response(conn, _json_response(500, {
                    "status": "error", "error": str(e)}))
                return
            if doc is not None:
                answer(doc)
            # else: parked — the hub answers from a later round or the
            # heartbeat tick.
            return
        try:
            sub, first = hub.subscribe(
                shape,
                writer=lambda payload: self.call_soon(
                    lambda: self._stream_write(conn, payload)),
                closer=lambda: self.call_soon(
                    lambda: self._end_stream(conn)),
                auto_start=False,
            )
        except HubFull:
            self.post_raw(conn, _STREAM_REJECT_RESPONSE)
            return
        except Exception as e:  # noqa: BLE001 — a broken shape answers, never hangs
            self.post_response(conn, _json_response(500, {
                "status": "error", "error": str(e)}))
            return
        self.call_soon(lambda: self._begin_stream(conn, sub, first))

    def _arm_stream_tick(self) -> None:
        """Loop-thread: recurring 1 s maintenance tick for the stream hub
        (heartbeats, long-poll timeouts, idle-shape GC)."""
        hub = self.state.stream
        if hub is None or self._stopping:
            return

        def tick() -> None:
            if self._stopping:
                return
            h = self.state.stream
            if h is not None:
                h.tick()
            self.call_later(1.0, tick)

        self.call_later(1.0, tick)

    # ------------------------------------------------------------- routing

    def _count_reject(self, cause: str) -> None:
        st = self.state
        # += on a dict value is a read-modify-write, NOT GIL-atomic; the
        # worker reject paths share this counter with the loop (advisor r4).
        with st.scrape_rejects_lock:
            st.scrape_rejects[cause] = st.scrape_rejects.get(cause, 0) + 1

    def _handle_request(self, conn: _Conn, req: _Request) -> None:
        st = self.state
        path, _, query = req.target.partition("?")
        exempt = path in _ADMISSION_EXEMPT_PATHS
        if not conn.admitted:
            # Over the connection cap: this connection never got a slot.
            # Probe paths still answer (then close); everything else gets
            # the pre-rendered 429 — the storm pays, kubelet never does.
            if exempt:
                resp = self._probe_response(path)
                resp.close = True
                self._respond(conn, resp)
            else:
                self._count_reject("connections")
                self._send_raw(conn, _CONN_REJECT_RESPONSE)
            return
        cap = st.max_requests_per_client
        if cap > 0 and not exempt:
            ip = conn.ip
            with st.client_lock:
                cur = st.client_active.get(ip, 0)
                over = cur >= cap
                if not over:
                    st.client_active[ip] = cur + 1
            if over:
                self._count_reject("client")
                self._send_raw(conn, _CLIENT_REJECT_RESPONSE)
                return
            # Held until this request's response is flushed (or the
            # connection dies) — the loop equivalent of the old handler
            # thread occupying the slot for the handler's lifetime.
            conn.client_key = ip
        self._dispatch(conn, req, path, query)

    def _dispatch(self, conn: _Conn, req: _Request, path: str,
                  query: str) -> None:
        st = self.state
        if path == "/metrics":
            self._handle_metrics(conn, req)
        elif path == "/api/v1/stream":
            # Outside the 2-permit /api/v1 fence: a subscription is a
            # long-lived registration, not a query — holding a permit for
            # the stream's lifetime would wedge the polled API behind two
            # viewers. The hub's subscriber cap is the admission control.
            self._defer(conn, lambda: self._task_stream(conn, query))
        elif path.startswith("/api/v1/"):
            self._defer(conn, lambda: self._task_api(conn, req, path, query))
        elif path.startswith("/debug/") and not debug_client_allowed(
            conn.ip, st.debug_addr
        ):
            # Loopback-only by default: stacks + effective config are
            # operator surface. --debug-addr 0.0.0.0 restores remote reads.
            self._respond(conn, _text_response(
                403, b"debug endpoints are loopback-only "
                     b"(start with --debug-addr 0.0.0.0 to expose)\n"))
        elif path == "/debug/vars" and st.debug_vars is not None:
            self._defer(conn, lambda: self._task_debug_vars(conn))
        elif path == "/debug/trace":
            self._defer(conn, lambda: self._task_trace(conn, query))
        elif path == "/debug/stacks":
            # The pprof-equivalent SURVEY §5 asks for, sized to this
            # process: a point-in-time dump of every thread's Python stack.
            # THE tool for the wedge /healthz detects — `curl
            # /debug/stacks` from the node shows exactly where a stuck
            # poll thread is blocked (a hung gRPC call, a dead NFS mount)
            # without kubectl exec, a debugger, or signals. Served from a
            # worker thread, so it renders even while the poll thread (or
            # a render) is wedged.
            self._defer(conn, lambda: self._task_stacks(conn))
        elif path in _ADMISSION_EXEMPT_PATHS:
            self._respond(conn, self._probe_response(path))
        elif path == "/":
            self._respond(conn, _text_response(
                200,
                b"tpu-pod-exporter\n/metrics /healthz /readyz "
                b"/api/v1/series /api/v1/query_range /api/v1/window_stats\n",
            ))
        else:
            self._respond(conn, _text_response(404, b"not found\n"))

    def _defer(self, conn: _Conn, fn: Callable[[], None]) -> None:
        self.served["worker"] += 1

        def run() -> None:
            try:
                fn()
            except Exception:  # noqa: BLE001 — a task bug must still answer
                log.exception("worker request task failed")
                # Without this the client hangs until its own timeout and
                # the keep-alive connection is wedged forever (busy never
                # clears). Scheduled AFTER any response the task itself
                # posted (call_soon is FIFO), so the guard below can tell
                # "no response ever sent" from "response already in
                # flight/flushed".
                def fail() -> None:
                    if conn.closed or conn.response_pending or not conn.busy:
                        return
                    self._respond(conn, _text_response(
                        500, b"internal error\n", close=True))
                self.call_soon(fail)

        self.pool.submit(run)

    def post_response(self, conn: _Conn, resp: _Response) -> None:
        """Worker-side: hand a finished response to the loop for writing."""
        self.call_soon(lambda: self._respond(conn, resp))

    def post_raw(self, conn: _Conn, raw: bytes) -> None:
        self.call_soon(lambda: self._send_raw(conn, raw))

    # ------------------------------------------------------------- /metrics

    def _handle_metrics(self, conn: _Conn, req: _Request) -> None:
        st = self.state
        bucket = st.scrape_bucket
        if bucket is not None and not bucket.take():
            self._count_reject("rate")
            if st.scrape_tarpit_s > 0:
                # Rate-cap rejects answer late: a fast 429 just makes a
                # storming client retry faster. On the loop the tarpit is
                # a timer — zero threads parked, however wide the storm.
                self.call_later(
                    st.scrape_tarpit_s,
                    lambda: self._send_raw(conn, _REJECT_RESPONSE),
                )
            else:
                self._send_raw(conn, _REJECT_RESPONSE)
            return
        sem = st.scrape_sem
        if sem is not None and not sem.acquire(blocking=False):
            # Contended: queue briefly on a worker with the old timeout
            # semantics (429 + token refund when the wait expires).
            self._defer(conn, lambda: self._task_metrics_queued(conn, req))
            return
        # Permit held (or no fence). Fast path: a body already rendered for
        # this (format, encoding) pair is served inline — one cached-bytes
        # lookup, no worker handoff, no blocking anywhere.
        snap = st.store.current()
        openmetrics = accepts_openmetrics(req.headers.get("accept", ""))
        gzipped = "gzip" in req.headers.get("accept-encoding", "")
        cached = getattr(snap, "cached_exposition", None)
        body = cached(openmetrics, gzipped) if cached is not None else None
        if body is not None:
            self.served["inline"] += 1
            if sem is not None:
                sem.release()
            self._respond(conn, self._metrics_response(
                req, body, openmetrics, gzipped))
            return
        # Uncached (first scrape of a fresh encoding, or a store whose
        # snapshots render lazily): the render may block — worker, with
        # the already-held permit transferred.
        self._defer(
            conn, lambda: self._task_metrics_render(conn, req, sem),
        )

    def _metrics_response(self, req: _Request, body: bytes,
                          openmetrics: bool, gzipped: bool) -> _Response:
        headers = [(
            "Content-Type",
            OPENMETRICS_CONTENT_TYPE if openmetrics else CONTENT_TYPE,
        )]
        if gzipped:
            headers.append(("Content-Encoding", "gzip"))
        ctx = None
        if self.state.trace is not None:
            ctx = parse_traceparent(req.headers.get("traceparent", ""))
        return _Response(200, headers, body, observe=True, trace_ctx=ctx)

    def _task_metrics_queued(self, conn: _Conn, req: _Request) -> None:
        st = self.state
        sem = st.scrape_sem
        assert sem is not None
        if not sem.acquire(timeout=st.scrape_queue_timeout_s):
            if st.scrape_bucket is not None:
                st.scrape_bucket.refund()  # this scrape was never served
            # No tarpit here: this path already queued for
            # scrape_queue_timeout_s, which throttles the client the same
            # way.
            self._count_reject("concurrency")
            self.post_raw(conn, _REJECT_RESPONSE)
            return
        try:
            self._render_metrics(conn, req)
        finally:
            sem.release()

    def _task_metrics_render(self, conn: _Conn, req: _Request,
                             sem: threading.BoundedSemaphore | None) -> None:
        try:
            self._render_metrics(conn, req)
        finally:
            if sem is not None:
                sem.release()

    def _render_metrics(self, conn: _Conn, req: _Request) -> None:
        snap = self.state.store.current()
        # Content negotiation: Prometheus ≥2.5 advertises OpenMetrics in
        # Accept; both formats are served from cached bytes, so the
        # negotiation costs a header parse, not a render.
        openmetrics = accepts_openmetrics(req.headers.get("accept", ""))
        gzipped = "gzip" in req.headers.get("accept-encoding", "")
        if gzipped:
            body = (
                snap.encode_openmetrics_gzip() if openmetrics
                else snap.encode_gzip()
            )
        else:
            body = snap.encode_openmetrics() if openmetrics else snap.encode()
        self.post_response(conn, self._metrics_response(
            req, body, openmetrics, gzipped))

    # --------------------------------------------------------------- probes

    def _probe_response(self, path: str) -> _Response:
        if path == "/healthz":
            return self._healthz_response()
        return self._readyz_response()

    def _healthz_response(self) -> _Response:
        st = self.state
        reason = None
        if st.live_fn is not None:
            try:
                reason = st.live_fn()
            except Exception as e:  # noqa: BLE001 — a broken hook is itself unhealthy
                reason = f"liveness hook failed: {e}"
        snap = st.store.current()
        if reason:
            return _text_response(503, f"{reason}\n".encode())
        if (
            st.health_max_age_s > 0
            and snap.timestamp > 0
            and time.time() - snap.timestamp > st.health_max_age_s
        ):
            age = time.time() - snap.timestamp
            return _text_response(
                503, f"poll stalled: last snapshot {age:.1f}s old\n".encode()
            )
        return _text_response(200, b"ok\n")

    def _readyz_response(self) -> _Response:
        st = self.state
        snap = st.store.current()
        ready = snap.timestamp > 0
        body: dict = {"ready": ready}
        warm = None
        if ready and st.warm_fn is not None:
            try:
                warm = st.warm_fn()
            except Exception:  # noqa: BLE001 — warm detail must not break probes
                warm = None
        if not ready:
            body["state"] = "starting"
            body["reason"] = "no poll completed yet"
        elif warm is not None:
            # Serving the restored pre-restart snapshot; no live poll
            # yet. Still 200 — data IS being served (that is the whole
            # point of warm start) — but distinctly labeled so rollouts
            # and operators can tell restored from live.
            body["state"] = "warm"
            body.update(warm)
        else:
            body["state"] = "ready"
        if st.ready_detail_fn is not None:
            try:
                detail = st.ready_detail_fn() or {}
                body.update(detail)
                # Degraded = still serving, but an operator should
                # look: a source breaker stuck open across probes, or
                # the egress receiver unreachable past the same reopen
                # threshold (batches buffering to disk, not flowing).
                egress = detail.get("egress") or {}
                if body["state"] == "ready" and (
                    detail.get("degraded_sources")
                    or egress.get("degraded")
                ):
                    body["state"] = "degraded"
            except Exception:  # noqa: BLE001 — detail must not break probes
                pass
        # JSON either way (kubelet only reads the status code; humans
        # and the RUNBOOK read the state + degraded-source detail).
        return _json_response(200 if ready else 503, body)

    # ------------------------------------------------------------ /debug/*

    def _task_debug_vars(self, conn: _Conn) -> None:
        st = self.state
        assert st.debug_vars is not None
        try:
            body = json.dumps(st.debug_vars(), indent=1).encode()
        except Exception as e:  # noqa: BLE001 — debug must not 500 loops
            body = json.dumps({"error": str(e)}).encode()
        self.post_response(conn, _Response(
            200, [("Content-Type", "application/json")], body))

    def _task_stacks(self, conn: _Conn) -> None:
        self.post_response(conn, _text_response(200, _format_stacks().encode()))

    # /debug/trace response bound: `last` is clamped so the export stays a
    # bounded handful of MB no matter what a client asks for (each trace is
    # ~8 spans; scrape spans are capped by their own ring).
    TRACE_EXPORT_MAX_LAST = 200

    def _task_trace(self, conn: _Conn, query: str) -> None:
        ts = self.state.trace
        if ts is None:
            self.post_response(conn, _json_response(404, {
                "status": "error",
                "error": "tracing disabled (--trace off)",
            }))
            return
        qs = parse_qs(query, keep_blank_values=True)
        try:
            last = int((qs.get("last") or ["20"])[-1])
        except ValueError:
            self.post_response(conn, _json_response(400, {
                "status": "error", "error": "last must be an integer",
            }))
            return
        if last < 1:
            self.post_response(conn, _json_response(400, {
                "status": "error", "error": "last must be >= 1",
            }))
            return
        last = min(last, self.TRACE_EXPORT_MAX_LAST)
        # Copy references under the store lock; build + serialize the (much
        # larger) JSON document on this worker — never on the loop, never
        # under the store lock (the /debug/* lock audit).
        traces = ts.last(last)
        scrapes = ts.scrapes(min(4 * last, 512))
        self.post_response(
            conn, _json_response(200, to_chrome_trace(traces, scrapes)))

    # ------------------------------------------------------------- /api/v1

    def _task_api(self, conn: _Conn, req: _Request, path: str,
                  query: str) -> None:
        """JSON query surface: node-local history flight recorder, or the
        aggregator's federated fleet query plane when one is attached.
        Outside the scrape fences (the aggregator's missed-round fallback
        must not compete with the very scrape storm it is working around)
        but behind its own small concurrency cap — the same 2-permit fence
        and pre-rendered 429 + Retry-After on both exporter and
        aggregator."""
        st = self.state
        sem = st.api_sem
        if sem is not None and not sem.acquire(timeout=st.api_queue_timeout_s):
            self.post_raw(conn, _API_REJECT_RESPONSE)
            return
        try:
            t0 = time.perf_counter()
            resp = self._api_response(path, query)
            tstore = st.trace
            if tstore is not None:
                # Same cross-tier join as /metrics: an /api/v1 request
                # carrying a traceparent (the fleet query plane stamps one
                # per fan-out leg) records this node's serve span under the
                # remote query trace. Headerless queries record nothing.
                ctx = parse_traceparent(req.headers.get("traceparent", ""))
                if ctx is not None:
                    dur = time.perf_counter() - t0
                    tstore.record_scrape(
                        ctx[0], ctx[1], time.time() - dur, dur,
                        client=conn.ip,
                    )
            self.post_response(conn, resp)
        finally:
            if sem is not None:
                sem.release()

    @staticmethod
    def _parse_range_params(
        param: Callable[[str], str | None],
    ) -> tuple[str, float, float, float, str]:
        """Validated query_range params — shared by the node-local and
        fleet routes so the 400 contract cannot drift between tiers."""
        metric = param("metric")
        if not metric:
            raise ValueError("missing required parameter: metric")
        end = float(param("end") or time.time())
        start = float(param("start") or (end - 300.0))
        step = float(param("step") or 0.0)
        agg = param("agg") or "last"
        if agg not in ("last", "min", "max", "mean"):
            raise ValueError("agg must be one of last/min/max/mean")
        # Finite + bounded before the store walks a grid: the grid
        # loop is O((end-start)/step) Python iterations, and this
        # endpoint is unauthenticated and exempt from the scrape
        # fences — start=0&step=1 (~1.7e9 points) or end=inf must
        # be a 400, not a pinned worker thread. Cap matches
        # Prometheus's 11k resolution limit.
        if not (math.isfinite(start) and math.isfinite(end)
                and math.isfinite(step)):
            raise ValueError("start/end/step must be finite")
        if step < 0:
            raise ValueError("step must be >= 0")
        if end < start:
            raise ValueError("end must be >= start")
        if step > 0 and (end - start) / step > 11000:
            raise ValueError(
                "query resolution too high: (end - start) / step "
                "must be <= 11000"
            )
        return metric, start, end, step, agg

    @staticmethod
    def _parse_window_params(
        param: Callable[[str], str | None],
    ) -> tuple[str, float]:
        metric = param("metric")
        if not metric:
            raise ValueError("missing required parameter: metric")
        window = float(param("window") or 60.0)
        if window <= 0:
            raise ValueError("window must be > 0")
        return metric, window

    def _api_response(self, path: str, query: str) -> _Response:
        st = self.state
        qs = parse_qs(query, keep_blank_values=True)

        def param(name: str) -> str | None:
            vals = qs.get(name)
            return vals[-1] if vals else None

        match = {
            k[len("match["):-1]: vs[-1]
            for k, vs in qs.items()
            if k.startswith("match[") and k.endswith("]") and len(k) > 7
        }
        if st.fleet is not None:
            return self._fleet_api_response(path, param, match)
        if param("source"):
            # The node tier has no store: a ?source= knob that silently
            # does nothing would let an operator trust an answer that is
            # not what they asked for (same rule as the store-less
            # aggregator below).
            return _json_response(400, {
                "status": "error",
                "error": "source= requires a store-backed root "
                         "(no fleet store attached on this tier)",
            })
        h = st.history
        if h is None:
            return _json_response(404, {
                "status": "error",
                "error": "history disabled (--history-retention-s 0)",
            })
        try:
            if path == "/api/v1/series":
                return _json_response(200, {"status": "ok", "source": "live",
                                            "data": h.series_list()})
            if path == "/api/v1/query_range":
                metric, start, end, step, agg = self._parse_range_params(
                    param)
                result = h.query_range(metric, match, start, end, step,
                                       agg=agg)
                if not result:
                    return _json_response(404, {
                        "status": "error",
                        "error": f"no samples for metric {metric!r} "
                                 f"matching {match!r} in range",
                    })
                return _json_response(200, {
                    "status": "ok",
                    # Shared envelope contract across tiers: node-local
                    # answers are "live" by definition (the root's
                    # store-backed plane answers live|store|merged under
                    # the same key) — shapes must not drift between tiers.
                    "source": "live",
                    "data": {"resultType": "matrix", "result": result},
                })
            if path == "/api/v1/window_stats":
                metric, window = self._parse_window_params(param)
                result = h.window_stats(metric, match, window_s=window)
                if not result:
                    return _json_response(404, {
                        "status": "error",
                        "error": f"no samples for metric {metric!r} "
                                 f"matching {match!r} in window",
                    })
                return _json_response(200, {"status": "ok", "source": "live",
                                            "data": {"result": result}})
        except ValueError as e:
            return _json_response(400, {"status": "error", "error": str(e)})
        return _json_response(404, {"status": "error",
                                    "error": "unknown API path"})

    def _fleet_api_response(self, path: str,
                            param: Callable[[str], str | None],
                            match: dict) -> _Response:
        """Federated /api/v1 on the aggregator: same routes, same param
        validation, but the answer is the fleet envelope — merged series
        plus per-target status — and a dead target is partial=true, never
        a non-200 round failure."""
        fleet = self.state.fleet
        # ?source=live|store|merged is meaningful only on a store-backed
        # plane (the root with --store-dir). Asking a store-less tier for
        # it must be an actionable 400, never a silently-ignored knob —
        # an operator reading "source":"live" back from a query they sent
        # ?source=store to would trust data that is not what they asked.
        source = param("source")
        kwargs: dict = {}
        if getattr(fleet, "handles_source", False):
            if source:
                kwargs["source"] = source
        elif source:
            return _json_response(400, {
                "status": "error",
                "error": "source= requires a store-backed root "
                         "(no fleet store attached on this tier)",
            })
        try:
            if path == "/api/v1/series":
                return _json_response(200, fleet.series(**kwargs))
            if path == "/api/v1/query_range":
                metric, start, end, step, agg = self._parse_range_params(
                    param)
                return _json_response(200, fleet.query_range(
                    metric, match, start, end, step, agg=agg, **kwargs))
            if path == "/api/v1/window_stats":
                metric, window = self._parse_window_params(param)
                return _json_response(200, fleet.window_stats(
                    metric, match, window_s=window, **kwargs))
        except ValueError as e:
            return _json_response(400, {"status": "error", "error": str(e)})
        return _json_response(404, {"status": "error",
                                    "error": "unknown API path"})


class MetricsServer:
    """Owns the event loop thread. Unlike the reference (hardcoded
    ``:8000``, ``log.Fatal`` on listener death, ``main.go:71``), port 0 is
    allowed for tests (ephemeral) and shutdown is clean."""

    def __init__(
        self,
        store: SnapshotStore,
        host: str = "0.0.0.0",
        port: int = 8000,
        debug_vars: Callable[[], dict] | None = None,
        health_max_age_s: float = 0.0,
        max_concurrent_scrapes: int = 4,
        scrape_queue_timeout_s: float = 0.25,
        max_scrapes_per_s: float = 0.0,
        scrape_tarpit_s: float = 0.1,
        scrape_observer: Callable[[float], None] | None = None,
        history: Any = None,
        fleet: Any = None,
        trace: Any = None,
        debug_addr: str = "127.0.0.1",
        live_fn: Callable[[], str | None] | None = None,
        ready_detail_fn: Callable[[], dict] | None = None,
        client_write_timeout_s: float = 10.0,
        warm_fn: Callable[[], dict | None] | None = None,
        max_open_connections: int = 0,
        max_requests_per_client: int = 0,
        max_workers: int = 8,
        worker_idle_expire_s: float = 10.0,
        stream_hub: Any = None,
        stream_max_buffer_bytes: int = 2 << 20,
    ) -> None:
        # Every cause pre-seeded so the self-metric publishes a 0 series
        # per cause from poll 1 (stable surface). "connections"/"client"
        # are the admission-control causes (0 unless the caps are on).
        self.scrape_rejects = {
            "concurrency": 0, "rate": 0, "connections": 0, "client": 0,
        }
        self.write_timeouts = {"total": 0}
        # Open-connection accounting for the admission cap (peak is the
        # scrape-storm drill's bound witness).
        self.conn_stats = {"open": 0, "peak": 0}
        state = _HandlerState()
        state.store = store
        state.debug_vars = debug_vars
        state.history = history
        state.fleet = fleet
        state.trace = trace
        state.api_sem = (
            threading.BoundedSemaphore(2)
            if history is not None or fleet is not None
            else None
        )
        state.debug_addr = debug_addr
        state.health_max_age_s = health_max_age_s
        state.live_fn = live_fn
        state.ready_detail_fn = ready_detail_fn
        state.warm_fn = warm_fn
        state.client_write_timeout_s = client_write_timeout_s
        state.write_timeouts = self.write_timeouts
        state.scrape_sem = (
            threading.BoundedSemaphore(max_concurrent_scrapes)
            if max_concurrent_scrapes > 0
            else None
        )
        state.scrape_queue_timeout_s = scrape_queue_timeout_s
        # Burst 2× rate: absorbs scrape-alignment spikes (every scraper
        # firing in the same second) without letting a sustained storm
        # exceed ~rate serves/s.
        state.scrape_bucket = (
            _TokenBucket(max_scrapes_per_s, 2.0 * max_scrapes_per_s)
            if max_scrapes_per_s > 0
            else None
        )
        state.scrape_tarpit_s = scrape_tarpit_s
        state.scrape_rejects = self.scrape_rejects
        state.scrape_observer = scrape_observer
        state.max_open_connections = max_open_connections
        state.conn_stats = self.conn_stats
        state.max_requests_per_client = max_requests_per_client
        state.stream = stream_hub
        state.stream_max_buffer_bytes = stream_max_buffer_bytes
        self._state = state
        self._loop = _EventLoopServer(host, port, state, max_workers,
                                      worker_idle_expire_s)
        self._httpd = _CompatHandle(state)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._loop.port

    def stats(self) -> dict[str, int]:
        """Loop/pool counters for /debug/vars (RUNBOOK 'server')."""
        loop = self._loop
        return {
            "open_connections": self.conn_stats["open"],
            "peak_connections": self.conn_stats["peak"],
            "write_timeouts": self.write_timeouts["total"],
            "served_inline": loop.served["inline"],
            # Counted at dispatch, not completion: includes requests the
            # task itself later 429s (the /api/v1 fence) or fails with 500.
            "worker_dispatched": loop.served["worker"],
            "worker_threads": loop.pool.threads,
            "worker_queue": loop.pool.queued,
            "stream_subscribers": (
                self._state.stream.subscribers
                if self._state.stream is not None else 0
            ),
        }

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("already started")
        self._thread = threading.Thread(
            target=self._loop.run, name="tpu-exporter-http", daemon=True,
        )
        self._thread.start()
        if self._state.stream is not None:
            # Heartbeats / long-poll timeouts / shape GC ride a loop
            # timer; call_soon is the thread-safe way onto the loop.
            self._loop.call_soon(self._loop._arm_stream_tick)

    def stop(self) -> None:
        loop = self._loop
        if self._thread is not None:
            loop._stopping = True
            loop.wake()
            self._thread.join(timeout=5.0)
            self._thread = None
        else:
            # Never started: release the port + selector resources without
            # spinning the loop (stop-before-start must not deadlock).
            loop._stopping = True
            loop.pool.shutdown()
            loop._sel.close()
            loop._wake_r.close()
            loop._wake_w.close()
            loop._lsock.close()
