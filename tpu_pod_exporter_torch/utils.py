"""Small shared utilities.

RateLimitedLogger: the reference prints per-pod PID dumps every 30 s cycle
(``main.go:81,89,104,108``) — at a 1 s interval the equivalent would be
86 400 lines/day per failing source. Repeated messages are keyed and
suppressed within a window; the next emission reports how many were
dropped, so operators see both the fault and its frequency.
"""

from __future__ import annotations

import logging
import time

from tpu_pod_exporter_torch import trace as trace_mod

# Per-key cap on distinct trace ids tracked while suppressing: the tally is
# a correlation hint, not a full index — one poll per second over a 30 s
# window is ≤30 traces, and a flapping key must not grow an unbounded map.
_MAX_TRACES_PER_KEY = 32


class RateLimitedLogger:
    def __init__(
        self,
        logger: logging.Logger,
        min_interval_s: float = 30.0,
        clock=time.monotonic,
    ) -> None:
        self._logger = logger
        self._min_interval_s = min_interval_s
        self._clock = clock
        self._last_emit: dict[str, float] = {}
        # key -> (count, last suppression time, {trace_id: count}); counts
        # expire with the window so an old incident's tally is never
        # attributed to a new one. The per-trace sub-counts let the next
        # emission say how many suppressed lines belonged to the trace
        # that is active WHEN it finally emits — the line an operator uses
        # to jump from the log stream into /debug/trace.
        self._suppressed: dict[str, tuple[int, float, dict]] = {}

    def _emit(self, level: int, key: str, msg: str, *args, **kwargs) -> None:
        now = self._clock()
        last = self._last_emit.get(key)
        if last is not None and now - last < self._min_interval_s:
            count, _, traces = self._suppressed.get(key, (0, now, {}))
            tid = trace_mod.current_ids()[0]
            if tid is not None and (
                tid in traces or len(traces) < _MAX_TRACES_PER_KEY
            ):
                traces[tid] = traces.get(tid, 0) + 1
            self._suppressed[key] = (count + 1, now, traces)
            return
        dropped, dropped_at, traces = self._suppressed.pop(key, (0, 0.0, {}))
        # Report a tally only if the suppressed burst is recent (within two
        # windows) — a count left over from an incident days ago must not be
        # attributed to a new, unrelated fault.
        if dropped and now - dropped_at <= 2 * self._min_interval_s:
            # Trace breakdown of the suppressed burst: prefer the CURRENT
            # trace when it suppressed any lines (intra-poll bursts), else
            # the trace that suppressed the most — at one poll per second
            # the window spans ~30 traces, and the emitting poll's fresh
            # trace is almost never the one that did the suppressing, so
            # current-trace-only would report nothing exactly when the
            # operator needs a /debug/trace join key.
            tid = trace_mod.current_ids()[0]
            in_trace = traces.get(tid, 0) if tid is not None else 0
            if not in_trace and traces:
                tid, in_trace = max(traces.items(), key=lambda kv: kv[1])
            if in_trace:
                msg = (f"{msg} (+{dropped} similar suppressed, "
                       f"{in_trace} in trace {tid[:8]})")
            else:
                msg = f"{msg} (+{dropped} similar suppressed)"
        self._last_emit[key] = now
        self._logger.log(level, msg, *args, **kwargs)

    def recovery(self, key: str, msg: str, *args, **kwargs) -> None:
        """Log a recovery transition at WARNING, independent of the fault
        lines' rate limit.

        The end of an incident must be as visible as its start: fault
        lines for ``key`` are throttled to one per window while the source
        is down, and a recovery landing inside that suppression window
        must still log — operators would otherwise see incidents open and
        never close. So recovery emits under its OWN window
        (``key + ":recovered"``) rather than the faults': an isolated
        incident's recovery always logs, no matter how recently a fault
        line did. The same window throttles pathological flapping — a
        source failing and recovering every poll logs one fault line and
        one recovery line per window (each later carrying its suppressed
        tally), not two unthrottled WARNINGs per flap cycle."""
        self._emit(logging.WARNING, key + ":recovered", msg, *args, **kwargs)

    def warning(self, key: str, msg: str, *args, **kwargs) -> None:
        self._emit(logging.WARNING, key, msg, *args, **kwargs)

    def error(self, key: str, msg: str, *args, **kwargs) -> None:
        self._emit(logging.ERROR, key, msg, *args, **kwargs)

    def info(self, key: str, msg: str, *args, **kwargs) -> None:
        self._emit(logging.INFO, key, msg, *args, **kwargs)


# --- Process self-resource accounting --------------------------------------
# Shared by the exporter collector and the slice aggregator: both publish
# their own CPU seconds and RSS so the <1% CPU / bounded-memory budgets
# (BASELINE.md) are auditable in production, not just in bench.py. Both
# functions are exception-safe (None on failure) — accounting must never
# fail a poll or an aggregation round.

_PAGE_SIZE: int | None = None


def process_cpu_seconds() -> float | None:
    """Total user+system CPU time of this process, or None off-POSIX."""
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        return ru.ru_utime + ru.ru_stime
    except Exception:  # noqa: BLE001
        return None


def process_rss_bytes() -> float | None:
    """Current RSS from /proc/self/statm (field 2, pages); None off-Linux."""
    global _PAGE_SIZE
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        if _PAGE_SIZE is None:
            import os

            _PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")
        return float(pages * _PAGE_SIZE)
    except Exception:  # noqa: BLE001
        return None


# --- Logging setup ----------------------------------------------------------


class JsonLogFormatter(logging.Formatter):
    """One JSON object per line, Cloud-Logging-shaped.

    ``severity`` (not ``levelname``) is the key GKE's logging agent
    promotes to a first-class field, which makes exporter warnings
    filterable/alertable in a fleet instead of being grepped out of text
    blobs. json.dumps handles every escape (quotes, newlines in tracebacks,
    non-UTF8-able code points) — a malformed pod name can't corrupt the
    log stream's line framing.
    """

    def format(self, record: logging.LogRecord) -> str:
        import json
        from datetime import datetime, timezone

        # RFC3339 with sub-second precision and a colon in the offset
        # ("+00:00") — strftime's %z yields "+0000", which strict Cloud
        # Logging parsers reject, silently falling back to ingestion time
        # exactly when ordering matters (code-review r5). timespec pinned:
        # bare isoformat() OMITS the fractional field when microsecond == 0
        # (~one log line per million), flapping the timestamp shape under
        # strict parsers (advisor r5).
        ts = datetime.fromtimestamp(record.created, timezone.utc).isoformat(
            timespec="microseconds"
        )
        out = {
            "severity": record.levelname,
            "time": ts,
            "logger": record.name,
            "message": record.getMessage(),
        }
        # Trace correlation: a line emitted inside a poll (collector,
        # supervisor, chaos — including supervised worker threads, which
        # inherit the poll's context) carries the active trace/span ids, so
        # `jq 'select(.trace_id == "…")'` reconstructs one poll's log
        # slice and joins it to /debug/trace. Formatting runs synchronously
        # on the emitting thread, so the thread-local context is the line's.
        trace_id, span_id = trace_mod.current_ids()
        if trace_id is not None:
            out["trace_id"] = trace_id
            out["span_id"] = span_id
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out, ensure_ascii=False, default=str)


def setup_logging(level: str, fmt: str = "text") -> None:
    """Root-logger setup shared by the exporter and aggregator CLIs.

    Unknown ``fmt`` or ``level`` raises instead of silently degrading
    (to text / to INFO): an operator who set TPE_LOG_FORMAT=JSONL or
    --log-level=verbose must find out at startup, not mid-incident when
    the logs aren't what they configured."""
    lvl = getattr(logging, level.upper(), None)
    # `not lvl` also rejects NOTSET (0), whose effective root level is
    # WARNING — accepting it would silently drop debug/info, the exact
    # misconfiguration this fail-loud contract exists to prevent.
    if not isinstance(lvl, int) or not lvl:
        raise ValueError(
            "--log-level must be one of debug/info/warning/error/critical, "
            f"got {level!r}"
        )
    fmt = fmt.lower()
    if fmt == "json":
        handler = logging.StreamHandler()
        handler.setFormatter(JsonLogFormatter())
        logging.basicConfig(level=lvl, handlers=[handler])
    elif fmt == "text":
        logging.basicConfig(
            level=lvl,
            format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        )
    else:
        raise ValueError(f"--log-format must be 'text' or 'json', got {fmt!r}")
