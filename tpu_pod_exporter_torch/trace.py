"""End-to-end poll tracing — per-phase spans, slow-poll stack profiling.

The supervision layer (``supervisor.py``) says *that* a poll degraded and
the phase histograms say *how often*, but neither says where the 1.8 s of a
slow poll went or what the poll thread was doing while the deadline burned.
This module closes that gap with three zero-dependency pieces:

- **Spans.** Every collector poll (and every aggregator round) becomes a
  :class:`PollTrace`: a root span plus one child span per supervised phase
  (device read, attribution, process scan, join, publish, history append,
  persist, egress / per-target scrape, history fallback). The post-swap
  phases (history append, persist, egress) are deliberately excluded from
  the publish/total timings they would otherwise inflate — each is its own
  span and its own phase-histogram label. Each span carries a status
  (``ok|err|abandoned|skipped``), the source breaker's state at entry, and
  byte/series counts, and collects free-form events — the supervisor and
  the chaos injector annotate the active span, so a wedge incident reads
  as a causal story instead of a pile of counters.
- **Slow-poll profiler.** When a poll runs past ``--trace-slow-poll-s``,
  :class:`StackSampler` captures the poll thread's Python stack (plus any
  ``tpu-sup-*`` phase-worker threads — a supervised hang blocks the worker,
  not the poll thread) via ``sys._current_frames()`` at ~50 Hz for the
  remainder of the poll and attaches the collapsed stacks to the trace: a
  hang the supervisor deadline abandons comes with the exact frame it was parked
  in.
- **Propagation.** The aggregator stamps a W3C ``traceparent`` header on
  its scrape fan-out; the exporter's ``/metrics`` handler records a scrape
  span under that remote context, so the aggregator's round trace joins
  the node-side scrape span for true cross-tier latency attribution.

Finished traces land in a bounded ring (:class:`TraceStore`, the same
hard-bounded eviction discipline as ``history.py``'s rings) and export as
Chrome ``trace_event`` JSON via ``GET /debug/trace?last=N`` — loopback-only
by default like every other ``/debug/*`` route, and copy-then-serialize so
export never blocks the poll thread.

Thread-local context (:func:`current_ids`) lets the JSON log formatter and
:class:`~tpu_pod_exporter_torch.utils.RateLimitedLogger` stamp ``trace_id`` /
``span_id`` onto every log line emitted inside a poll; the supervisor
propagates the context onto its worker threads so even a fenced worker's
chaos annotations land on the right span.

``python -m tpu_pod_exporter_torch.trace --replay trace.jsonl`` replays a
recorded backend trace through a traced collector and prints a rendered
trace tree (``make trace-demo``); ``--overhead-check`` measures tracing-on
vs tracing-off poll-loop CPU and fails loudly past a budget (CI smoke).
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Callable, Sequence

if TYPE_CHECKING:  # typing only — no runtime import cost
    import types

# Span statuses — the vocabulary the collector maps phase outcomes onto.
OK = "ok"
ERR = "err"
ABANDONED = "abandoned"  # phase deadline hit; worker fenced (supervisor)
SKIPPED = "skipped"      # breaker open / quarantined; no call made

# Cap on events per span: annotations are diagnostics, not a log transport.
MAX_SPAN_EVENTS = 16

_tls = threading.local()


def new_trace_id() -> str:
    """16-byte lowercase hex, the W3C trace-id shape (one per poll, so a
    real random read is affordable here)."""
    return os.urandom(16).hex()


# Span ids are minted ~6x per poll on the hot path: os.urandom there is a
# getrandom(2) syscall per span (measured: a visible % of poll CPU at the
# bench shape). A randomly-seeded process-global counter keeps W3C-shaped,
# process-unique, never-zero ids at the cost of one dict-free C-level
# next() — cross-process uniqueness comes from the 64-bit random seed, the
# same collision budget os.urandom(8) had.
_span_ids = itertools.count(int.from_bytes(os.urandom(8), "big") | 1)


def new_span_id() -> str:
    """8-byte lowercase hex, the W3C parent-id shape."""
    return f"{next(_span_ids) & 0xFFFFFFFFFFFFFFFF:016x}"


# ------------------------------------------------------------- TLS context


def current_span() -> "Span | None":
    """The span active on the calling thread (None outside a poll)."""
    return getattr(_tls, "span", None)


def current_ids() -> tuple[str | None, str | None]:
    """(trace_id, span_id) of the active span, or (None, None)."""
    s = getattr(_tls, "span", None)
    if s is None:
        return None, None
    return s.trace_id, s.span_id


def swap_current(span: "Span | None") -> "Span | None":
    """Set the calling thread's active span; returns the previous one.

    Used by the supervisor to carry the poll thread's span context onto
    the phase-worker thread (restore the return value in a finally)."""
    prev = getattr(_tls, "span", None)
    _tls.span = span
    return prev


def annotate(message: str) -> None:
    """Attach a free-form event to the calling thread's active span.

    No-op outside a poll — callers (supervisor, chaos) never need to know
    whether tracing is enabled."""
    s = getattr(_tls, "span", None)
    if s is not None:
        s.add_event(message)


# ------------------------------------------------------------- traceparent


def format_traceparent(trace_id: str, span_id: str) -> str:
    """W3C Trace Context header value (version 00, sampled)."""
    return f"00-{trace_id}-{span_id}-01"


_HEX_DIGITS = frozenset("0123456789abcdefABCDEF")


def _is_hex(s: str) -> bool:
    # NOT int(s, 16): that accepts '+'/'-' signs, underscores and
    # surrounding whitespace, which would let malformed ids through
    # "strict" validation and into the export verbatim.
    return all(c in _HEX_DIGITS for c in s)


def parse_traceparent(header: str) -> tuple[str, str] | None:
    """``traceparent`` header → (trace_id, parent_span_id), or None.

    Strict on the parts we consume (lengths, hex, non-zero ids), lenient on
    the rest (unknown versions parse; trailing fields ignored) — a malformed
    header from an arbitrary client must degrade to "no context", never to
    an error on the scrape path."""
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    _ver, tid, sid = parts[0], parts[1], parts[2]
    if len(tid) != 32 or len(sid) != 16:
        return None
    if not (_is_hex(tid) and _is_hex(sid)):
        return None
    if tid == "0" * 32 or sid == "0" * 16:
        return None
    return tid.lower(), sid.lower()


# ------------------------------------------------------------------- spans


class Span:
    """One timed operation within a trace. Mutable until ``dur_s`` is set
    (by ``PollTrace.end_span``); treated as immutable afterwards — the
    export path copies references, not contents."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0_wall",
                 "t0_mono", "dur_s", "status", "breaker", "attrs", "events",
                 "thread")

    def __init__(self, trace_id: str, name: str, parent_id: str | None,
                 t0_wall: float, t0_mono: float, breaker: str = "") -> None:
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.name = name
        self.t0_wall = t0_wall
        self.t0_mono = t0_mono
        self.dur_s: float | None = None
        self.status = OK
        self.breaker = breaker
        self.attrs: dict | None = None
        self.events: list | None = None
        self.thread = threading.get_ident()

    def add_event(self, message: str) -> None:
        ev = self.events
        if ev is None:
            ev = self.events = []
        if len(ev) >= MAX_SPAN_EVENTS:
            if ev[-1][1] != "…more events dropped":
                ev.append((time.time() - self.t0_wall, "…more events dropped"))  # lint: disable=wall-clock(event stamps are wall offsets from the trace wall epoch by design)
            return
        ev.append((time.time() - self.t0_wall, message))  # lint: disable=wall-clock(event stamps are wall offsets from the trace wall epoch by design)


class PollTrace:
    """One poll's (or aggregation round's) trace: a root span plus phase
    children. ``begin``/``end`` are the poll thread's depth-1 conveniences
    (they also maintain the thread-local context); ``span``/``end_span``
    are the explicit form for fan-out workers (aggregator pool threads),
    where list.append's GIL-atomicity makes concurrent span creation safe.
    """

    __slots__ = ("trace_id", "root", "spans", "profile", "profile_samples",
                 "slow", "_clock", "_wallclock")

    def __init__(self, root_name: str, clock: Callable[[], float],
                 wallclock: Callable[[], float]) -> None:
        self.trace_id = new_trace_id()
        self._clock = clock
        self._wallclock = wallclock
        self.root = Span(self.trace_id, root_name, None,
                         wallclock(), clock())
        self.spans: list[Span] = [self.root]
        # {thread label: {collapsed stack: sample count}} — written by the
        # StackSampler while this poll runs slow, read-only afterwards.
        self.profile: dict[str, dict[str, int]] | None = None
        self.profile_samples = 0
        self.slow = False

    # explicit form (any thread)

    def span(self, name: str, parent_id: str | None = None,
             breaker: str = "") -> Span:
        s = Span(self.trace_id, name,
                 parent_id if parent_id is not None else self.root.span_id,
                 self._wallclock(), self._clock(), breaker)
        self.spans.append(s)
        return s

    def end_span(self, span: Span, status: str = OK, **attrs: object) -> None:
        span.dur_s = self._clock() - span.t0_mono
        span.status = status
        if attrs:
            span.attrs = attrs

    # TLS-threaded form (poll thread only; depth 1 under the root)

    def begin(self, name: str, breaker: str = "") -> Span:
        s = self.span(name, breaker=breaker)
        _tls.span = s
        return s

    def end(self, status: str = OK, **attrs: object) -> None:
        s = getattr(_tls, "span", None)
        if s is None or s is self.root:
            return
        self.end_span(s, status, **attrs)
        _tls.span = self.root


# ------------------------------------------------------------- trace store


class TraceStore:
    """Bounded ring of finished traces plus a ring of remote-context scrape
    spans (the node side of the aggregator's fan-out propagation).

    Same eviction discipline as ``history.py``: hard-capped, oldest-out,
    allocated only for traces actually present. Readers copy *references*
    under the lock and serialize outside it (finished traces are immutable)
    — export must never block the poll thread's append."""

    # Scrape-span recording is driven by a CLIENT-supplied header on the
    # unauthenticated /metrics path, so it is rate-capped: a scraper
    # spraying forged traceparent headers must not be able to churn the
    # genuine aggregator join spans out of the ring (nor spend lock+alloc
    # per storm request). The cap is ~20x any sane fan-in — a handful of
    # aggregators at one scrape per round each.
    SCRAPE_RECORD_WINDOW_S = 10.0
    SCRAPE_RECORDS_PER_WINDOW = 64

    def __init__(self, max_traces: int = 256,
                 max_scrape_spans: int = 512,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if max_traces < 1:
            raise ValueError("max_traces must be >= 1")
        self.max_traces = max_traces
        self._clock = clock
        self._lock = threading.Lock()
        self._traces: deque[PollTrace] = deque(maxlen=max_traces)
        self._scrapes: deque[Span] = deque(maxlen=max_scrape_spans)
        self._spans = 0  # spans retained across the trace ring
        self.traces_total = 0
        self.slow_polls = 0
        self.scrape_spans_total = 0
        self.scrape_spans_dropped = 0
        self._scrape_window_start = 0.0
        self._scrape_window_count = 0

    def append(self, trace: PollTrace) -> None:
        with self._lock:
            if len(self._traces) == self._traces.maxlen:
                self._spans -= len(self._traces[0].spans)
            self._traces.append(trace)
            self._spans += len(trace.spans)
            self.traces_total += 1
            if trace.slow:
                self.slow_polls += 1

    def record_scrape(self, trace_id: str, parent_id: str, t0_wall: float,
                      dur_s: float, **attrs: object) -> Span | None:
        """Record a served-scrape span under a REMOTE trace context (from a
        ``traceparent`` header) — the join point the aggregator's round
        trace links to. Returns None when the record was dropped by the
        rate cap (see SCRAPE_RECORDS_PER_WINDOW)."""
        with self._lock:
            now = self._clock()
            if now - self._scrape_window_start >= self.SCRAPE_RECORD_WINDOW_S:
                self._scrape_window_start = now
                self._scrape_window_count = 0
            if self._scrape_window_count >= self.SCRAPE_RECORDS_PER_WINDOW:
                self.scrape_spans_dropped += 1
                return None
            self._scrape_window_count += 1
            s = Span(trace_id, "scrape", parent_id, t0_wall, t0_mono=0.0)
            s.dur_s = dur_s
            if attrs:
                s.attrs = attrs
            self._scrapes.append(s)
            self.scrape_spans_total += 1
        return s

    # Rough per-span retained cost (Span object + id strings + attrs dict)
    # for the byte accounting the memory-pressure ladder reads. An
    # estimate, not a measurement — but the SAME estimate the shed
    # decision and /debug/vars both see, which is the contract.
    SPAN_EST_BYTES = 640

    def set_max_traces(self, n: int) -> None:
        """Resize the trace ring in place, keeping the NEWEST traces — the
        memory-pressure ladder's ``trace_halved`` rung. Reversible: a
        larger ``n`` re-grows the bound (evicted traces stay gone)."""
        n = max(int(n), 1)
        with self._lock:
            if n == self.max_traces:
                return
            kept = list(self._traces)[-n:]
            self._traces = deque(kept, maxlen=n)
            self._spans = sum(len(t.spans) for t in kept)
            self.max_traces = n

    def memory_bytes(self) -> int:
        """Estimated retained bytes (trace ring + scrape-span ring) for
        the memory budget's component accounting."""
        with self._lock:
            return (self._spans + len(self._scrapes)) * self.SPAN_EST_BYTES

    def last(self, n: int) -> list[PollTrace]:
        """Newest-last reference copy of up to the last ``n`` traces."""
        with self._lock:
            if n >= len(self._traces):
                return list(self._traces)
            return [self._traces[i]
                    for i in range(len(self._traces) - n, len(self._traces))]

    def scrapes(self, n: int) -> list[Span]:
        with self._lock:
            if n >= len(self._scrapes):
                return list(self._scrapes)
            return [self._scrapes[i]
                    for i in range(len(self._scrapes) - n, len(self._scrapes))]

    def counts(self) -> tuple[int, int, int]:
        """(slow_polls, traces retained, spans retained) — the per-poll
        metrics read, allocation-light (the full stats() dict is for
        /debug/vars, not the publish hot path)."""
        with self._lock:
            return self.slow_polls, len(self._traces), self._spans

    def stats(self) -> dict:
        with self._lock:
            return {
                "traces": len(self._traces),
                "spans": self._spans,
                "traces_total": self.traces_total,
                "slow_polls": self.slow_polls,
                "scrape_spans": len(self._scrapes),
                "scrape_spans_total": self.scrape_spans_total,
                "scrape_spans_dropped": self.scrape_spans_dropped,
                "max_traces": self.max_traces,
            }


# ---------------------------------------------------- slow-poll profiler


def _collapse(frame: "types.FrameType | None") -> str:
    """One thread's stack as a collapsed ``mod.func;mod.func`` line,
    outermost first (the flamegraph folded format)."""
    out = []
    while frame is not None:
        mod = frame.f_globals.get("__name__", "?")
        out.append(f"{mod}.{frame.f_code.co_name}")
        frame = frame.f_back
    out.reverse()
    return ";".join(out)


class StackSampler:
    """Samples the poll thread's stack while a poll runs past its slow
    threshold, via ``sys._current_frames()`` (a documented-CPython atomic
    snapshot built under the GIL — a wedged thread's stack renders without
    its cooperation, same mechanism as ``/debug/stacks``).

    One daemon thread, started lazily on first :meth:`arm`. ``arm`` is
    called at poll start (cheap: one lock + event set); the sampler sleeps
    until ``delay_s`` into the poll, then samples at ``hz`` until
    :meth:`disarm` (poll finished), the per-poll sample cap, or a re-arm.
    Supervised phase workers (threads named ``tpu-sup-*``) are sampled too:
    a supervised hang blocks the worker, not the poll thread, and the whole
    point is naming the hung frame.

    Mutation contract: samples write into ``trace.profile`` only while the
    trace is still the armed one, checked under the sampler lock — after
    ``disarm`` returns, the trace is immutable and safe to serialize."""

    WORKER_PREFIX = "tpu-sup-"
    # Idle/pre-threshold scan period. arm() only wakes the sampler thread
    # when the slow threshold lands INSIDE the current scan window — at the
    # production default (slow_poll_s=1.0 > 0.5) arming is just a lock'd
    # store, because a per-poll Event.set() forces a context switch to the
    # sampler thread every poll, which measured as ~10% poll-loop CPU on a
    # single-core host. The scan loop then hits the threshold exactly (it
    # computes the precise remaining wait once it sees the armed poll).
    SCAN_PERIOD_S = 0.5

    def __init__(self, hz: float = 50.0, max_samples: int = 2048,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if hz <= 0:
            raise ValueError("hz must be positive")
        self.hz = hz
        self.max_samples = max_samples
        self._clock = clock
        self._lock = threading.Lock()
        self._wake = threading.Event()
        # (trace, sample_at_mono, poll thread ident) while a poll is armed.
        self._armed: tuple | None = None
        self._thread: threading.Thread | None = None
        self._stop = False
        self.polls_profiled = 0

    def arm(self, trace: PollTrace, delay_s: float) -> None:
        with self._lock:
            self._armed = (trace, self._clock() + delay_s,
                           threading.get_ident())
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="tpu-trace-sampler", daemon=True
                )
                self._thread.start()
        if delay_s < self.SCAN_PERIOD_S + 0.1:
            # Only thresholds inside the scan window need an early wake-up
            # (tests use tiny thresholds); see SCAN_PERIOD_S for why a
            # per-poll set() is too expensive to do unconditionally.
            self._wake.set()

    def disarm(self, trace: PollTrace) -> None:
        with self._lock:
            if self._armed is not None and self._armed[0] is trace:
                self._armed = None
            if trace.profile_samples:
                self.polls_profiled += 1

    def stop(self) -> None:
        self._stop = True
        self._wake.set()

    @property
    def armed(self) -> bool:
        with self._lock:
            return self._armed is not None

    def _run(self) -> None:
        while not self._stop:
            with self._lock:
                st = self._armed
            if st is None:
                self._wake.wait(self.SCAN_PERIOD_S)
                self._wake.clear()
                continue
            trace, sample_at, ident = st
            now = self._clock()
            if now < sample_at:
                # Not slow yet: sleep exactly until the threshold (or a
                # re-arm wakes us for a newer short-threshold poll).
                self._wake.wait(min(sample_at - now, self.SCAN_PERIOD_S))
                self._wake.clear()
                continue
            self._sample(trace, ident)
            time.sleep(1.0 / self.hz)

    def _sample(self, trace: PollTrace, poll_ident: int) -> None:
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        targets = [(poll_ident, names.get(poll_ident, "poll"))]
        targets += [
            (tid, name) for tid, name in names.items()
            if name.startswith(self.WORKER_PREFIX) and tid != poll_ident
        ]
        with self._lock:
            st = self._armed
            if st is None or st[0] is not trace:
                return  # poll finished while we walked the frames
            if trace.profile_samples >= self.max_samples:
                self._armed = None  # cap hit: stop profiling this poll
                return
            prof = trace.profile
            if prof is None:
                prof = trace.profile = {}
            for tid, label in targets:
                frame = frames.get(tid)
                if frame is None:
                    continue
                stack = _collapse(frame)
                d = prof.setdefault(label, {})
                d[stack] = d.get(stack, 0) + 1
            trace.profile_samples += 1


# ------------------------------------------------------------------ tracer


class Tracer:
    """Owns the trace lifecycle for one poll loop: start → phase spans →
    finish (slow detection, profiler collection, store append).

    ``slow_poll_s <= 0`` disables the slow-poll profiler but keeps spans;
    ``sampler=None`` likewise. The whole tracer is optional everywhere it
    is consumed — a collector built without one runs the exact pre-trace
    code path."""

    def __init__(self, store: TraceStore, slow_poll_s: float = 1.0,
                 sampler: StackSampler | None = None, root_name: str = "poll",
                 clock: Callable[[], float] = time.monotonic,
                 wallclock: Callable[[], float] = time.time) -> None:
        self.store = store
        self.slow_poll_s = slow_poll_s
        self.root_name = root_name
        self._sampler = sampler
        self._clock = clock
        self._wallclock = wallclock

    def start_poll(self) -> PollTrace:
        t = PollTrace(self.root_name, self._clock, self._wallclock)
        # A poll aborted by a mid-poll BaseException leaves a stale TLS
        # span; starting the next poll simply overwrites it (the aborted
        # trace is dropped, never stored half-finished).
        _tls.span = t.root
        if self._sampler is not None and self.slow_poll_s > 0:
            self._sampler.arm(t, self.slow_poll_s)
        return t

    def finish(self, trace: PollTrace, status: str = OK, **attrs: object) -> PollTrace:
        trace.end_span(trace.root, status, **attrs)
        if self._sampler is not None:
            self._sampler.disarm(trace)
        trace.slow = bool(
            (self.slow_poll_s > 0 and trace.root.dur_s >= self.slow_poll_s)
            or trace.profile_samples
        )
        self.store.append(trace)
        _tls.span = None
        return trace

    def close(self) -> None:
        if self._sampler is not None:
            self._sampler.stop()


# ------------------------------------------------------------ export/render


def to_chrome_trace(traces: Sequence[PollTrace],
                    scrape_spans: Sequence[Span] = ()) -> dict:
    """Finished traces → a Chrome ``trace_event`` JSON document
    (chrome://tracing / Perfetto "JSON Array with metadata" flavor).

    Pure function over immutable finished spans — callers copy references
    out of the :class:`TraceStore` under its lock and build the (much
    larger) JSON structure here, outside it."""
    pid = os.getpid()
    events: list[dict] = []
    for t in traces:
        for s in t.spans:
            args: dict = {
                "trace_id": t.trace_id,
                "span_id": s.span_id,
                "status": s.status,
            }
            if s.parent_id:
                args["parent_id"] = s.parent_id
            if s.breaker:
                args["breaker"] = s.breaker
            if s.attrs:
                args.update(s.attrs)
            if s.events:
                args["events"] = [[round(dt, 6), msg] for dt, msg in s.events]
            if s is t.root:
                if t.slow:
                    args["slow"] = True
                if t.profile is not None:
                    args["profile"] = t.profile
                    args["profile_samples"] = t.profile_samples
            events.append({
                "name": s.name,
                "cat": "poll",
                "ph": "X",
                "ts": s.t0_wall * 1e6,  # trace_event wants microseconds
                "dur": (s.dur_s or 0.0) * 1e6,
                "pid": pid,
                "tid": s.thread,
                "args": args,
            })
    for s in scrape_spans:
        events.append({
            "name": s.name,
            "cat": "scrape",
            "ph": "X",
            "ts": s.t0_wall * 1e6,
            "dur": (s.dur_s or 0.0) * 1e6,
            "pid": pid,
            "tid": s.thread,
            "args": {
                "trace_id": s.trace_id,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "status": s.status,
                **(s.attrs or {}),
            },
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _fmt_attrs(s: Span) -> str:
    parts = []
    if s.breaker:
        parts.append(f"breaker={s.breaker}")
    if s.attrs:
        parts.extend(f"{k}={v}" for k, v in s.attrs.items())
    return "  ".join(parts)


def render_trace(trace: PollTrace) -> str:
    """Human-readable trace tree (``make trace-demo`` output)."""
    r = trace.root
    lines = [
        f"trace {trace.trace_id[:16]}…  {r.name}  "
        f"total {1e3 * (r.dur_s or 0):.2f}ms  {r.status}"
        + ("  [SLOW]" if trace.slow else "")
    ]
    children = [s for s in trace.spans if s is not r]
    for i, s in enumerate(children):
        tee = "└─" if i == len(children) - 1 else "├─"
        extra = _fmt_attrs(s)
        lines.append(
            f"{tee} {s.name:<16} {1e3 * (s.dur_s or 0):8.2f}ms  "
            f"{s.status:<9}" + (f"  {extra}" if extra else "")
        )
        for dt, msg in s.events or ():
            pad = "   " if i == len(children) - 1 else "│  "
            lines.append(f"{pad}   +{1e3 * dt:.1f}ms  {msg}")
    if trace.profile:
        lines.append(f"profile: {trace.profile_samples} samples")
        for label, stacks in trace.profile.items():
            top = sorted(stacks.items(), key=lambda kv: -kv[1])[:3]
            for stack, n in top:
                leaf = stack.rsplit(";", 2)
                lines.append(f"  [{label}] ×{n}  …{';'.join(leaf[-2:])}")
    return "\n".join(lines)


# --------------------------------------------------------------------- CLI


def _demo_replay(path: str, polls: int, slow_poll_s: float) -> int:
    """Replay a recorded backend trace through a traced collector and print
    the rendered trace tree of the last poll (``make trace-demo``)."""
    from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
    from tpu_pod_exporter_torch.backend.recorded import RecordedBackend
    from tpu_pod_exporter_torch.collector import Collector
    from tpu_pod_exporter_torch.metrics import SnapshotStore

    backend = RecordedBackend(path, loop=True)
    n = polls or len(backend)
    store = TraceStore(max_traces=max(n, 1))
    tracer = Tracer(store, slow_poll_s=slow_poll_s, sampler=StackSampler())
    collector = Collector(backend, FakeAttribution(), SnapshotStore(),
                          tracer=tracer)
    for _ in range(n):
        collector.poll_once()
    st = store.stats()
    print(f"replayed {n} polls from {path}")
    print(f"traces: {st['traces']} retained ({st['spans']} spans), "
          f"{st['slow_polls']} slow\n")
    for t in store.last(1):
        print(render_trace(t))
    tracer.close()
    return 0


def _overhead_check(polls: int, chips: int, budget: float) -> int:
    """Tracing-on vs tracing-off poll-loop CPU on the loadgen/bench shape
    (fake backend, 256 chips — the shape bench.py budgets). Exit 1 past
    the budget — the CI smoke for the 'tracing is on by default' overhead
    contract.

    Methodology: two long-lived collectors (one traced, one not) measured
    in small INTERLEAVED segments with alternating order. Whole-run A/B
    comparisons drown in scheduler/allocator drift on shared hosts
    (measured: ±10% run-to-run for the SAME mode, far above the effect);
    interleaving cancels the drift and reproduces a stable ratio."""
    from tpu_pod_exporter_torch import utils
    from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
    from tpu_pod_exporter_torch.backend.fake import FakeBackend
    from tpu_pod_exporter_torch.collector import Collector
    from tpu_pod_exporter_torch.metrics import SnapshotStore

    # Small ring, filled during warmup: the measured regime must be the
    # STEADY state, where each poll's retained trace objects are balanced
    # by an eviction's deallocations. Measuring the ring's fill phase
    # instead reads as a spurious extra-GC "overhead" (+16 net tracked
    # allocations per poll until the default 256-trace ring fills — ~4
    # minutes of a real deployment, but most of a short bench run).
    ring = TraceStore(max_traces=32)

    def make(tracer: Tracer | None) -> Collector:
        collector = Collector(FakeBackend(chips=chips), FakeAttribution(),
                              SnapshotStore(), tracer=tracer)
        for _ in range(50):  # warm caches/layouts; fill the trace ring
            collector.poll_once()
        return collector

    def segment(collector: Collector, n: int) -> float:
        c0 = utils.process_cpu_seconds()
        for _ in range(n):
            collector.poll_once()
        return utils.process_cpu_seconds() - c0

    tracer = Tracer(ring, slow_poll_s=3600.0, sampler=StackSampler())
    off, on = make(None), make(tracer)
    seg_len = max(polls // 8, 10)
    t_off = t_on = 0.0
    try:
        for seg in range(16):
            if seg % 2:
                t_on += segment(on, seg_len)
                t_off += segment(off, seg_len)
            else:
                t_off += segment(off, seg_len)
                t_on += segment(on, seg_len)
    finally:
        tracer.close()
    overhead = t_on / t_off - 1.0 if t_off > 0 else 0.0
    print(f"poll-loop CPU over {16 * seg_len} interleaved polls/mode at "
          f"{chips} chips: trace-off {t_off:.3f}s, trace-on {t_on:.3f}s "
          f"→ overhead {100 * overhead:+.1f}% (budget {100 * budget:.0f}%)")
    if overhead > budget:
        print("FAIL: tracing overhead exceeds budget")
        return 1
    print("OK: tracing overhead within budget")
    return 0


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="tpu-pod-exporter-trace",
        description="Poll-trace demo and tracing-overhead smoke check.",
    )
    p.add_argument("--replay", default="",
                   help="JSONL backend trace to replay through a traced "
                        "collector; prints the rendered trace tree")
    p.add_argument("--polls", type=int, default=0,
                   help="polls to run (replay default: one pass; "
                        "overhead default: 300)")
    p.add_argument("--slow-poll-s", type=float, default=1.0)
    p.add_argument("--overhead-check", action="store_true",
                   help="measure tracing-on vs tracing-off poll CPU and "
                        "fail past --budget")
    p.add_argument("--chips", type=int, default=256)
    p.add_argument("--budget", type=float, default=0.05,
                   help="max tolerated fractional CPU overhead (0.05 = 5%%)")
    ns = p.parse_args(argv)

    if ns.overhead_check:
        return _overhead_check(ns.polls or 300, ns.chips, ns.budget)
    if ns.replay:
        return _demo_replay(ns.replay, ns.polls, ns.slow_poll_s)
    p.error("need --replay PATH or --overhead-check")
    return 2


if __name__ == "__main__":
    sys.exit(main())
