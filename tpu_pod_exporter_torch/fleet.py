"""Federated query plane — fleet-wide ``/api/v1`` over the flight recorders.

Every node has a crash-safe flight recorder, but an incident on a
v5p slice spans 64 hosts: answering "when did duty cycle cliff across the
slice" meant 64 separate curls against per-node ``/api/v1/*``. This module
federates the query plane through the aggregator: one
``query_range``/``window_stats``/``series`` request fans out to every
non-quarantined target concurrently, merges per-series results under the
same label-identity keying the rollup publisher uses, and answers with
**partial-result semantics** — a dead or slow target degrades the answer
(``partial: true`` plus per-target status and staleness in the envelope),
it never fails the round.

Design points, mirroring the scrape fan-out's discipline:

- **Bounded pool, per-target deadline.** Fan-out runs on its own worker
  pool (never the scrape pool — a dashboard storm must not delay rounds);
  each target gets the fetch timeout, and an overall wait deadline marks
  stragglers ``timeout`` without blocking the response on them.
- **Breaker-aware skip.** Targets the aggregator's scrape breakers hold
  open are skipped outright (``quarantined`` status) — the query plane
  must not burn the very timeouts the quarantine exists to save; their
  absence still marks the result partial, because missing data is missing.
- **Result cache.** A small LRU keyed by (route, query, grid, generation)
  absorbs dashboard-refresh traffic: one fan-out per generation bump (the
  aggregator bumps per round), not one per panel. Gridded queries align
  start/end to the step so sliding dashboard windows land on the same key.
- **Observability of the plane itself.** Each query is a trace (root
  ``query``, ``fanout``/``merge`` phase spans) riding the aggregator's
  existing Tracer; the fan-out stamps a W3C traceparent so node-side
  ``/api/v1`` handlers join their serve spans to it, exactly like
  ``/metrics`` scrape spans join rounds. Latency/partial/cache counters
  publish under ``tpu_aggregator_fleet_query_*`` (schema.FLEET_QUERY_SPECS).
"""

from __future__ import annotations

import inspect
import json
import logging
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from collections import OrderedDict
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Any, Callable, Mapping, Sequence

from tpu_pod_exporter_torch.metrics import CounterStore, HistogramStore, schema
from tpu_pod_exporter_torch.metrics.registry import SnapshotBuilder
from tpu_pod_exporter_torch.supervisor import CLOSED, CircuitBreaker
from tpu_pod_exporter_torch.trace import PollTrace, Tracer, format_traceparent
from tpu_pod_exporter_torch.utils import RateLimitedLogger

log = logging.getLogger("tpu_pod_exporter_torch.fleet")

# Routes the plane federates; also the pre-seeded label set of
# tpu_aggregator_fleet_queries_total (stable surface from round 1).
FLEET_ROUTES: tuple[str, ...] = ("series", "query_range", "window_stats")

# Per-target terminal states in the response envelope.
OK = "ok"               # target answered with data
NO_DATA = "no_data"     # target answered 404: no samples for this query
ERROR = "error"         # connection/HTTP/parse failure
TIMEOUT = "timeout"     # missed the fan-out deadline (still running)
QUARANTINED = "quarantined"  # breaker open — skipped, not attempted


def target_query_url(target: str, path: str, params: Mapping[str, str]) -> str:
    """``host:port`` (or URL root) + API path + query string."""
    if target.startswith(("http://", "https://")):
        base = target[: -len("/metrics")] if target.endswith("/metrics") else target
    else:
        base = f"http://{target}"
    return f"{base}{path}?{urllib.parse.urlencode(params)}"


def default_api_fetch(url: str, timeout_s: float,
                      traceparent: str | None = None) -> dict:
    """GET one node-side /api/v1 URL, parsed JSON. Raises on HTTP/parse
    failure; the plane classifies HTTP 404 separately (no data is an
    answer, not an outage). ``traceparent`` joins the node-side handler's
    serve span to this query's trace."""
    headers = {}
    if traceparent:
        headers["traceparent"] = traceparent
    req = urllib.request.Request(url, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:  # noqa: S310 — operator-supplied targets
        doc = json.loads(resp.read().decode("utf-8", errors="replace"))
    if not isinstance(doc, dict):
        raise ValueError("api response is not a JSON object")
    return doc


def data_shape(route: str, merged: list) -> Any:
    """Route → response ``data`` shape, mirroring the node-local answers
    exactly so every parser that reads one exporter reads the fleet. THE
    one implementation — the leaf plane, the root plane and the store-
    backed plane all serve through it (shapes must not drift between
    tiers; the cross-tier contract test pins it)."""
    if route == "series":
        return merged
    if route == "query_range":
        return {"resultType": "matrix", "result": merged}
    return {"result": merged}


def rows_of(route: str, env: Mapping[str, Any]) -> list:
    """Inverse of :func:`data_shape`: the row list out of an envelope
    (empty on malformed shapes — a bad upstream answer degrades, never
    raises)."""
    data = env.get("data")
    if route == "series":
        return data if isinstance(data, list) else []
    if isinstance(data, dict):
        rows = data.get("result")
        return rows if isinstance(rows, list) else []
    return []


class _QueryCache:
    """Bounded LRU for query envelopes, keyed by (route, query, grid,
    generation). Entries are treated as immutable by every reader (the
    HTTP layer only serializes them); the lock guards dict order only —
    no I/O or serialization ever runs under it."""

    def __init__(self, entries: int) -> None:
        self.entries = entries
        self._lock = threading.Lock()
        self._data: OrderedDict[tuple, dict] = OrderedDict()
        # key -> estimated envelope bytes, maintained alongside _data so
        # bytes() is O(1): the memory-pressure ladder reads it every check
        # interval, and the shed decision must see the same number
        # /debug/vars reports.
        self._sizes: dict[tuple, int] = {}
        self._bytes = 0
        # Flipped by the memory-pressure ladder's fleet_cache rung: while
        # disabled, put() is a no-op (every query re-fans-out — pure
        # correctness, just slower dashboards).
        self._enabled = True

    @staticmethod
    def _estimate(env: dict) -> int:
        try:
            return len(json.dumps(env, default=str))
        except (TypeError, ValueError):
            return 1024

    def get(self, key: tuple) -> dict | None:
        with self._lock:
            env = self._data.get(key)
            if env is not None:
                self._data.move_to_end(key)
            return env

    def put(self, key: tuple, env: dict) -> None:
        if self.entries <= 0:
            return
        size = self._estimate(env)
        with self._lock:
            # _enabled re-checked INSIDE the lock: a put racing the
            # memory-ladder's set_enabled(False)+clear() must not land
            # after the clear and leave a "disabled" cache serving (and
            # accounting) a stale entry.
            if not self._enabled:
                return
            self._bytes += size - self._sizes.get(key, 0)
            self._sizes[key] = size
            self._data[key] = env
            self._data.move_to_end(key)
            while len(self._data) > self.entries:
                victim, _ = self._data.popitem(last=False)
                self._bytes -= self._sizes.pop(victim, 0)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._sizes.clear()
            self._bytes = 0

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            # Flag + clear under ONE lock hold (see put's re-check).
            self._enabled = bool(enabled)
            if not enabled:
                self._data.clear()
                self._sizes.clear()
                self._bytes = 0

    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)


# Public alias: the root query plane (shard.RootQueryPlane) reuses the
# same bounded LRU + byte-accounting for ITS generation-keyed result
# cache — one cache implementation, one memory-accounting story.
QueryCache = _QueryCache


class FleetQueryPlane:
    """Fan ``/api/v1`` queries out to every target; merge with partial-result
    semantics. Runs entirely on HTTP handler threads + its own pool — the
    aggregator's round loop is never involved beyond sharing breakers."""

    def __init__(
        self,
        targets: Sequence[str],
        timeout_s: float = 2.0,
        fetch: Callable[..., dict] = default_api_fetch,
        breakers: Mapping[str, CircuitBreaker] | None = None,
        tracer: Tracer | None = None,
        max_workers: int = 16,
        cache_entries: int = 128,
        generation_fn: Callable[[], int] | None = None,
        clock: Callable[[], float] = time.monotonic,
        wallclock: Callable[[], float] = time.time,
        targets_fn: Callable[[], Sequence[str]] | None = None,
    ) -> None:
        if not targets and targets_fn is None:
            raise ValueError("fleet query plane needs at least one target")
        self._static_targets = tuple(targets)
        # Live membership (the aggregator's TargetSet view): with a
        # --targets-file or the sharded leaf tier, the target list changes
        # between queries — each query snapshots the callable once so its
        # fan-out, statuses and merge ordering agree within the query.
        self._targets_fn = targets_fn
        self._timeout_s = timeout_s
        self._fetch = fetch
        # Same auto-detection as the scrape fan-out: injected 2-arg test
        # fetches don't get a traceparent kwarg forced on them.
        self._fetch_traceparent = False
        try:
            self._fetch_traceparent = (
                "traceparent" in inspect.signature(fetch).parameters
            )
        except (TypeError, ValueError):
            pass
        self._breakers = breakers
        self._tracer = tracer
        self._clock = clock
        self._wallclock = wallclock
        self._generation_fn = generation_fn
        self._cache = _QueryCache(cache_entries)
        self._rlog = RateLimitedLogger(log)
        self._counters = CounterStore()
        self._hist = HistogramStore(schema.TPU_AGG_FLEET_QUERY_HIST)
        # Pre-seed every counter so the conditional surface is stable from
        # the first exposition after the plane is attached.
        for route in FLEET_ROUTES:
            self._counters.inc(schema.TPU_AGG_FLEET_QUERIES_TOTAL.name,
                               (route,), 0.0)
        self._counters.inc(
            schema.TPU_AGG_FLEET_QUERY_PARTIAL_TOTAL.name, (), 0.0)
        self._counters.inc(
            schema.TPU_AGG_FLEET_QUERY_CACHE_HITS_TOTAL.name, (), 0.0)
        self._counters.inc(
            schema.TPU_AGG_FLEET_QUERY_CACHE_MISSES_TOTAL.name, (), 0.0)
        # The cap alone: workers spawn lazily per pending fan-out leg, so
        # small fleets stay small — and a plane built before a targets
        # file exists (targets_fn membership) still fans a grown fleet
        # out at full width instead of a boot-sized trickle.
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers,
            thread_name_prefix="tpu-fleet-query",
        )

    def _current_targets(self) -> tuple[str, ...]:
        """Membership snapshot for one query (live when targets_fn is
        wired, else the construction-time tuple)."""
        if self._targets_fn is not None:
            try:
                return tuple(self._targets_fn())
            except Exception:  # noqa: BLE001 — a broken hook degrades to static
                return self._static_targets
        return self._static_targets

    # ------------------------------------------------------------- public API

    def series(self) -> dict:
        return self._query("series", "/api/v1/series", {}, key=("series",))

    def query_range(
        self,
        metric: str,
        match: Mapping[str, str] | None = None,
        start: float | None = None,
        end: float | None = None,
        step: float = 0.0,
        agg: str = "last",
    ) -> dict:
        if end is None:
            end = self._wallclock()
        if start is None:
            start = end - 300.0
        if step > 0:
            # Grid alignment: dashboard panels slide start/end continuously;
            # snapping both to the step grid makes successive refreshes of
            # one panel share a cache key (and an actual grid) within a
            # generation, at the cost of answering for up to one step more
            # than asked. The effective range rides the envelope.
            start = (start // step) * step
            end = -((-end) // step) * step
            # Alignment widened the range by up to 2·step; a request that
            # sat exactly at the node-side 11k resolution cap would now be
            # 400'd by every healthy target and read as a fleet-wide
            # outage. Give up grid points at the OLD edge instead.
            if (end - start) / step > 11000:
                start = end - 11000 * step
        match = dict(match or {})
        params = {"metric": metric, "start": f"{start:.3f}",
                  "end": f"{end:.3f}", "step": f"{step:g}", "agg": agg}
        for k, v in match.items():
            params[f"match[{k}]"] = v
        key = ("query_range", metric, tuple(sorted(match.items())),
               round(start, 3), round(end, 3), step, agg)
        env = self._query("query_range", "/api/v1/query_range", params,
                          key=key)
        env.setdefault("start", start)
        env.setdefault("end", end)
        return env

    def window_stats(
        self,
        metric: str,
        match: Mapping[str, str] | None = None,
        window_s: float = 60.0,
    ) -> dict:
        match = dict(match or {})
        params = {"metric": metric, "window": f"{window_s:g}"}
        for k, v in match.items():
            params[f"match[{k}]"] = v
        key = ("window_stats", metric, tuple(sorted(match.items())), window_s)
        return self._query("window_stats", "/api/v1/window_stats", params,
                           key=key)

    # --------------------------------------------------------------- internals

    def _query(self, route: str, path: str, params: Mapping[str, str],
               key: tuple) -> dict:
        self._counters.inc(schema.TPU_AGG_FLEET_QUERIES_TOTAL.name, (route,))
        generation = self._generation_fn() if self._generation_fn else 0
        cache_key = key + (generation,)
        cached = self._cache.get(cache_key)
        if cached is not None:
            self._counters.inc(
                schema.TPU_AGG_FLEET_QUERY_CACHE_HITS_TOTAL.name, ())
            # Shallow copy: the cached envelope is shared and read-only;
            # only the top-level "cached" marker differs per response.
            return {**cached, "cached": True}
        self._counters.inc(
            schema.TPU_AGG_FLEET_QUERY_CACHE_MISSES_TOTAL.name, ())
        t0 = self._clock()
        targets = self._current_targets()
        tracer = self._tracer
        tr = tracer.start_poll() if tracer is not None else None
        statuses, rows_by_target = self._fan_out(route, path, params, tr,
                                                 targets)
        mspan = tr.span("merge") if tr is not None else None
        merged, dup = self._merge(route, rows_by_target, statuses, targets)
        partial = any(
            st["state"] in (ERROR, TIMEOUT, QUARANTINED)
            for st in statuses.values()
        )
        took = self._clock() - t0
        env = {
            "status": "ok",
            "partial": partial,
            "route": route,
            # Source attribution, shared across every /api/v1 tier: a
            # fan-out answer is "live" by definition; the root's
            # store-backed plane (tpu_pod_exporter_torch.store) upgrades this
            # to live|store|merged. One envelope contract — shapes must
            # not drift between tiers (asserted by the shared-contract
            # test in tests/test_store.py).
            "source": "live",
            "data": self._data_shape(route, merged),
            "targets": statuses,
            "fleet": {
                "targets": len(targets),
                "ok": sum(1 for s in statuses.values() if s["state"] == OK),
                "no_data": sum(
                    1 for s in statuses.values() if s["state"] == NO_DATA),
                "errors": sum(
                    1 for s in statuses.values()
                    if s["state"] in (ERROR, TIMEOUT)),
                "quarantined": sum(
                    1 for s in statuses.values()
                    if s["state"] == QUARANTINED),
                "merged_series": len(merged),
                "duplicate_series": dup,
            },
            "generation": generation,
            "took_s": round(took, 6),
        }
        if partial:
            self._counters.inc(
                schema.TPU_AGG_FLEET_QUERY_PARTIAL_TOTAL.name, ())
        self._hist.observe(took)
        if tracer is not None and tr is not None:
            if mspan is not None:
                tr.end_span(mspan, "ok", series=len(merged), duplicates=dup)
            tracer.finish(
                tr, status="ok" if not partial else "err",
                route=route, targets=len(targets),
                ok=env["fleet"]["ok"], partial=partial,
            )
        self._cache.put(cache_key, env)
        return env

    def _fan_out(
        self, route: str, path: str, params: Mapping[str, str],
        tr: PollTrace | None, targets: tuple[str, ...],
    ) -> tuple[dict[str, dict], dict[str, list]]:
        span = tr.span("fanout") if tr is not None else None
        traceparent = (
            format_traceparent(tr.trace_id, span.span_id)
            if tr is not None and span is not None and self._fetch_traceparent
            else None
        )
        now_wall = self._wallclock()
        statuses: dict[str, dict] = {}
        rows_by_target: dict[str, list] = {}
        futures: dict[Future, str] = {}
        for target in targets:
            br = self._breakers.get(target) if self._breakers else None
            if br is not None and br.state != CLOSED:
                # Quarantine is a scrape-plane fact the query plane trusts:
                # the endpoint is the same dead port, and probing it from
                # here would burn the timeout the breaker exists to save.
                statuses[target] = {
                    "state": QUARANTINED,
                    "next_probe_in_s": round(br.seconds_until_probe, 3),
                }
                continue
            fut = self._pool.submit(
                self._fetch_one, target, path, params, traceparent)
            futures[fut] = target
        # One overall deadline on top of the per-fetch socket timeout: a
        # target drip-feeding bytes (or a pool briefly saturated by another
        # query) marks stragglers `timeout` instead of delaying the answer.
        deadline = self._clock() + self._timeout_s + 0.5
        pending = set(futures)
        while pending:
            remaining = deadline - self._clock()
            if remaining <= 0:
                break
            done, pending = wait(pending, timeout=remaining,
                                 return_when=FIRST_COMPLETED)
            for fut in done:
                target = futures[fut]
                state, rows, err, dur = fut.result()
                st: dict[str, Any] = {"state": state,
                                      "duration_s": round(dur, 6)}
                if err:
                    st["error"] = err
                if rows is not None:
                    st["series"] = len(rows)
                    st["staleness_s"] = self._staleness(route, rows, now_wall)
                    rows_by_target[target] = rows
                statuses[target] = st
                if state == ERROR:
                    self._counters.inc(
                        schema.TPU_AGG_FLEET_QUERY_TARGET_ERRORS_TOTAL.name,
                        (target,),
                    )
        for fut in pending:
            target = futures[fut]
            statuses[target] = {"state": TIMEOUT,
                                "error": "missed fan-out deadline"}
            self._counters.inc(
                schema.TPU_AGG_FLEET_QUERY_TARGET_ERRORS_TOTAL.name,
                (target,),
            )
            # Left running on the pool (the fetch's own socket timeout
            # bounds it); cancel() would be a no-op once started.
        if tr is not None and span is not None:
            tr.end_span(
                span, "ok",
                targets=len(targets),
                ok=sum(1 for s in statuses.values() if s["state"] == OK),
                timeouts=len(pending),
            )
        return statuses, rows_by_target

    def _fetch_one(
        self, target: str, path: str, params: Mapping[str, str],
        traceparent: str | None,
    ) -> tuple[str, list | None, str, float]:
        """One target's fan-out leg → (state, rows, error, duration)."""
        t0 = self._clock()
        url = target_query_url(target, path, params)
        try:
            if traceparent is not None:
                doc = self._fetch(url, self._timeout_s,
                                  traceparent=traceparent)
            else:
                doc = self._fetch(url, self._timeout_s)
        except urllib.error.HTTPError as e:
            dur = self._clock() - t0
            if e.code == 404:
                # The node answered: this metric/window simply has no
                # samples there (or history is disabled) — complete, not
                # partial.
                return NO_DATA, [], "", dur
            self._rlog.warning(f"query:{target}",
                               "fleet query to %s failed: %s", target, e)
            return ERROR, None, f"HTTP {e.code}", dur
        except Exception as e:  # noqa: BLE001 — a down host is data, not death
            self._rlog.warning(f"query:{target}",
                               "fleet query to %s failed: %s", target, e)
            return ERROR, None, str(e), self._clock() - t0
        dur = self._clock() - t0
        try:
            if path.endswith("/series"):
                rows = doc["data"]
            else:
                rows = doc["data"]["result"]
            if not isinstance(rows, list):
                raise TypeError("result is not a list")
        except (KeyError, TypeError) as e:
            self._rlog.warning(f"query:{target}",
                               "bad api answer from %s: %s", target, e)
            return ERROR, None, f"bad response shape: {e}", dur
        return OK, rows, "", dur

    @staticmethod
    def _staleness(route: str, rows: list, now_wall: float) -> float | None:
        """Per-target staleness: age of the target's freshest sample across
        the series it returned (None when the route carries no timestamps)."""
        newest = None
        for row in rows:
            try:
                ts = row.get("last_sample_wall_ts")
            except AttributeError:
                continue
            if isinstance(ts, (int, float)) and (
                    newest is None or ts > newest):
                newest = float(ts)
        if newest is None:
            return None
        return round(max(now_wall - newest, 0.0), 3)

    def _merge(
        self, route: str, rows_by_target: Mapping[str, list],
        statuses: dict[str, dict], targets: tuple[str, ...],
    ) -> tuple[list[dict], int]:
        """Label-identity merge — the same keying ``_publish`` uses for
        chips/slices: a series is (metric, label set), whichever host it
        came from. Colliding keys (the same label set from two targets —
        label-less self-metrics like ``tpu_exporter_up`` collide for EVERY
        target pair) are disambiguated with a synthetic ``target`` label
        rather than folded: dropping 63 hosts' up-series because their
        label sets match would silently discard exactly the per-host
        signal a fleet query exists to surface. Collisions are counted in
        ``duplicate_series``."""
        groups: dict[tuple, list[tuple[str, dict]]] = {}
        # Deterministic iteration: target membership order, so output
        # ordering resolves stably round to round.
        for target in targets:
            rows = rows_by_target.get(target)
            if not rows:
                continue
            for row in rows:
                if not isinstance(row, dict):
                    continue
                try:
                    key = (
                        row.get("metric", ""),
                        tuple(sorted((row.get("labels") or {}).items())),
                    )
                except TypeError:
                    continue
                groups.setdefault(key, []).append((target, row))
        merged: list[dict] = []
        duplicates = 0
        for key in sorted(groups):
            entries = groups[key]
            if len(entries) == 1:
                merged.append(entries[0][1])
                continue
            duplicates += len(entries) - 1
            for target, row in entries:
                merged.append({
                    **row,
                    "labels": {**(row.get("labels") or {}),
                               "target": target},
                })
        return merged, duplicates

    _data_shape = staticmethod(data_shape)

    # -------------------------------------------------------------- exposition

    def emit(self, b: SnapshotBuilder) -> None:
        """Publish the plane's self-metrics into one aggregator snapshot
        (called from ``SliceAggregator._publish`` — conditional surface,
        present only while the plane is attached)."""
        for spec in schema.FLEET_QUERY_SPECS:
            b.declare(spec)
        for spec in schema.FLEET_QUERY_SPECS:
            for lv, v in self._counters.items_for(spec.name):
                b.add(spec, v, lv)
        self._hist.emit(b)

    def stats(self) -> dict:
        """Introspection payload for the aggregator's /debug/vars."""
        return {
            "targets": len(self._current_targets()),
            "timeout_s": self._timeout_s,
            "cache_entries": len(self._cache),
            "cache_capacity": self._cache.entries,
            # The SAME estimate the memory-pressure ladder's shed decision
            # sums — /debug/vars and the governor must never disagree.
            "cache_bytes": self._cache.bytes(),
        }

    # ------------------------------------------------- pressure shed hook

    def cache_bytes(self) -> int:
        """Byte estimate of the result cache, for the memory budget's
        component accounting (tpu_pod_exporter_torch.pressure)."""
        return self._cache.bytes()

    def set_cache_enabled(self, enabled: bool) -> None:
        """Memory-ladder rung ``fleet_cache``: clear + disable the result
        cache (queries re-fan-out; correctness unchanged). Reversible."""
        self._cache.set_enabled(enabled)

    def close(self) -> None:
        self._pool.shutdown(wait=False)
