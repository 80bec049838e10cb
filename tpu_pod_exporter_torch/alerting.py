"""Native alerting plane — in-root rule evaluation + exactly-once webhooks.

The reference exporter only *emits* metrics: ``deploy/prometheus-rules.yaml``
ships ~20 alerts that never fire unless an external Prometheus scrapes the
tree. The root already owns every piece a self-contained alerting plane
needs — a per-round merged snapshot (the evaluation input), a TSDB-lite
with recording rules (history for ``rate()`` and durable ``ALERTS``
series), a push plane (transition streaming), and the exactly-once
WAL delivery machinery the egress proved (notification durability).
This module composes them:

- :func:`parse_alert_rules` — an alerting-rule grammar extending the
  recording-rule file format::

      alert TpuRootLeafDown = tpu_root_leaf_up == 0
        for 2m
        keep_firing 1m
        labels(severity="warning")
        annotations(summary="Leaf {{ $labels.leaf }} down")
        suppress(tpu_root_leaf_partition_suspected == 1)

  The expression language is the PromQL subset the shipped rule file
  actually uses: selectors with ``= != =~ !~`` matchers, arithmetic,
  filtering comparisons, ``rate(m[5m])``, ``sum/avg/min/max/count`` with
  ``by``/``without``, ``and/or/unless`` with ``on (...)`` joins,
  ``time()`` and ``histogram_quantile``. Parse errors name the line and
  what would be accepted; metric names are validated against the schema
  at startup (the parse_chaos_spec contract — a typo'd rule file must
  fail at boot, never silently alert on nothing).
- :class:`AlertEvaluator` — attached to the root's merge round. Each
  round it evaluates every rule against the published snapshot (plus the
  store's recording-rule outputs, so alerts can reference precomputed
  rollups), runs per-instance ``pending → firing → keep-firing →
  resolved`` state machines with flap damping, suppresses
  partition-induced false positives via the root's stale-serve suspicion
  gauges, publishes ``ALERTS``-shaped series into the FleetStore
  (post-incident forensics, queryable over ``/api/v1?source=store``),
  feeds the ``route=alerts`` stream shape, and writes the
  ``alert-status.json`` sidecar the ``status --tree`` footer reads.
- :class:`AlertNotifier` — a webhook sender riding
  :class:`~tpu_pod_exporter_torch.persist.WalBuffer` + the egress
  :class:`~tpu_pod_exporter_torch.supervisor.CircuitBreaker`: every firing/
  resolved transition is framed with a durable sequence number, buffered
  on disk, and POSTed exactly-once (2xx acks the fsynced cursor; poison
  4xx are counted and skipped; outages backlog and drain contiguously
  across root restarts — the egress ledger discipline).
- :func:`import_prometheus_rules` — translates
  ``deploy/prometheus-rules.yaml`` into the native grammar so the two
  surfaces cannot drift (``tests/test_rules_equivalence.py`` round-trips
  every shipped alert).

CLI (``python -m tpu_pod_exporter_torch.alerting``): ``--check`` validates a
native rule file, ``--import`` translates the Prometheus rule file.
The end-to-end drill lives in the scenario engine (``make alert-demo``).
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import re
import socket
import sys
import threading
import time
import urllib.error
from collections import deque
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Iterable, Mapping, Sequence

from tpu_pod_exporter_torch.egress import build_breaker, default_send
from tpu_pod_exporter_torch.metrics import registry, schema
from tpu_pod_exporter_torch.persist import WalBuffer, atomic_write
from tpu_pod_exporter_torch.supervisor import (
    DEGRADED_AFTER_REOPENS,
    STATE_VALUES,
    CLOSED,
    CircuitBreaker,
)
from tpu_pod_exporter_torch.utils import RateLimitedLogger

if TYPE_CHECKING:  # typing only — no runtime import cost
    from tpu_pod_exporter_torch.metrics.registry import Snapshot, SnapshotBuilder
    from tpu_pod_exporter_torch.store import FleetStore, RecordingRule

log = logging.getLogger("tpu_pod_exporter_torch.alerting")

# Series name the evaluator publishes alert state under (the Prometheus
# ALERTS convention: labels alertname/alertstate plus the instance labels).
ALERTS_METRIC = "ALERTS"

# Sidecar under --alert-dir: the `status --tree` alerts: footer and the
# notifier's drained-buffer seq recovery both read it. One writer — the
# root's round thread (evaluate_round) — the same single-writer discipline
# as the egress status sidecar.
STATUS_NAME = "alert-status.json"

# Exactly-once bookkeeping: the notification's durable sequence number
# rides a private header (the chaos webhook receiver ledgers it; real
# receivers may use it for idempotency or ignore it).
SEQ_HEADER = "X-Tpe-Alert-Seq"

PENDING = "pending"
FIRING = "firing"
RESOLVED = "resolved"

# External series names accepted by validation although no schema spec
# exists for them: `up` is Prometheus's own scrape-health series (imported
# rules reference it; at the root it simply evaluates empty), ALERTS is
# this module's own output (meta-alerts on alerts are legal).
_EXTERNAL_NAMES = frozenset(("up", ALERTS_METRIC))

# Label identity of one series: sorted (label, value) pairs, empty values
# dropped (the Prometheus missing-label convention).
LabelKey = tuple[tuple[str, str], ...]
Vector = dict[LabelKey, float]


_SPEC_GROUPS: tuple[tuple[Any, ...], ...] = (
    schema.ALL_SPECS, schema.AGGREGATE_SPECS, schema.LEAF_SPECS,
    schema.ROOT_SPECS, schema.HISTORY_SPECS, schema.PERSIST_SPECS,
    schema.PRESSURE_SPECS, schema.EGRESS_SPECS,
    schema.FLEET_QUERY_SPECS, schema.STORE_SPECS, schema.STREAM_SPECS,
    schema.REPLICA_SPECS, schema.ALERT_SPECS, schema.FAMILY_SPECS,
)

# Histograms live as HistogramSpec module attributes (their parent/lines
# child families carry the samples); alerts reference the EXPOSITION
# names — name_bucket / name_sum / name_count.
_HISTOGRAMS: tuple[Any, ...] = tuple(
    obj for obj in vars(schema).values()
    if isinstance(obj, registry.HistogramSpec)
)


def _schema_names() -> frozenset[str]:
    names = set()
    for group in _SPEC_GROUPS:
        for spec in group:
            names.add(spec.name)
    for hist in _HISTOGRAMS:
        base = hist.parent.name
        names.update((base, f"{base}_bucket", f"{base}_sum",
                      f"{base}_count"))
    return frozenset(names)


_SPEC_BY_NAME = {
    spec.name: spec
    for group in _SPEC_GROUPS
    for spec in group
    if not getattr(spec, "raw_lines", False)
}

# Exposition series name → (histogram spec, suffix kind).
_HIST_BY_EXPO_NAME = {
    f"{hist.parent.name}_{kind}": (hist, kind)
    for hist in _HISTOGRAMS
    for kind in ("bucket", "sum", "count")
}

# One pre-rendered raw-lines series prefix: `name_bucket{k="v",le="0.1"}`
# (or a bare `name_count` when the histogram is unlabeled).
_HIST_PREFIX_RE = re.compile(
    r"^(?P<series>[A-Za-z_][A-Za-z0-9_:]*)(?:\{(?P<labels>.*)\})?$")
_HIST_LABEL_RE = re.compile(
    r'(?P<key>[A-Za-z_][A-Za-z0-9_]*)="(?P<val>(?:[^"\\]|\\.)*)"')


# ------------------------------------------------------------ expressions


_TOKEN_RE = re.compile(
    r"""\s*(?:
      (?P<dur>\d+(?:\.\d+)?(?:ms|[smhdwy]))
    | (?P<num>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
    | (?P<name>[A-Za-z_][A-Za-z0-9_:]*)
    | (?P<str>"(?:[^"\\]|\\.)*")
    | (?P<op>=~|!~|==|!=|<=|>=|[()\[\]{},<>+\-*/%=])
    )""",
    re.VERBOSE,
)

_DUR_UNITS = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0,
              "d": 86400.0, "w": 604800.0, "y": 31536000.0}

_AGG_OPS = ("sum", "avg", "min", "max", "count")
_SET_OPS = ("and", "or", "unless")
_CMP_OPS = ("==", "!=", "<=", ">=", "<", ">")


def parse_duration(text: str) -> float:
    """``5m``/``30s``/``1h``/``90`` → seconds; raises ValueError."""
    m = re.fullmatch(r"(\d+(?:\.\d+)?)(ms|[smhdwy])?", text.strip())
    if m is None:
        raise ValueError(
            f"bad duration {text!r} (want <number>[ms|s|m|h|d|w|y])")
    return float(m.group(1)) * _DUR_UNITS.get(m.group(2) or "s", 1.0)


def _fmt_num(v: float) -> str:
    return repr(int(v)) if v == int(v) and abs(v) < 1e15 else repr(v)


def _fmt_dur(seconds: float) -> str:
    return f"{seconds:g}s"


class EvalContext:
    """Evaluation input for one round: the instant vectors plus the rate
    window reader. ``vector(name)`` answers the CURRENT labeled samples of
    one series name; ``rate(name, window_s)`` answers per-second rates
    over the trailing window (counter-reset aware)."""

    def __init__(
        self,
        now: float,
        vector_fn: Callable[[str], Vector],
        rate_fn: Callable[[str, float], Vector],
    ) -> None:
        self.now = now
        self._vector_fn = vector_fn
        self._rate_fn = rate_fn

    def vector(self, name: str) -> Vector:
        return self._vector_fn(name)

    def rate(self, name: str, window_s: float) -> Vector:
        return self._rate_fn(name, window_s)


class Expr:
    """One parsed expression node. ``evaluate`` returns an instant vector
    or a float scalar; ``names`` collects referenced series names (into
    ``out``), ``rate_names`` the subset read through ``rate()``;
    ``render`` emits the canonical text the round-trip tests compare."""

    def evaluate(self, ctx: EvalContext) -> Vector | float:
        raise NotImplementedError

    def names(self, out: set[str]) -> None:  # noqa: B027 — leaves have none
        pass

    def rate_names(self, out: set[str]) -> None:  # noqa: B027
        pass

    def render(self) -> str:
        raise NotImplementedError


@dataclass(frozen=True)
class Num(Expr):
    value: float

    def evaluate(self, ctx: EvalContext) -> float:
        return self.value

    def render(self) -> str:
        return _fmt_num(self.value)


@dataclass(frozen=True)
class TimeFn(Expr):
    def evaluate(self, ctx: EvalContext) -> float:
        return ctx.now

    def render(self) -> str:
        return "time()"


def _match_one(op: str, pattern: str, rx: "re.Pattern[str] | None",
               value: str) -> bool:
    if op == "=":
        return value == pattern
    if op == "!=":
        return value != pattern
    assert rx is not None
    return bool(rx.fullmatch(value)) == (op == "=~")


@dataclass(frozen=True)
class Selector(Expr):
    metric: str
    matchers: tuple[tuple[str, str, str], ...] = ()  # (label, op, value)

    def _regexes(self) -> tuple["re.Pattern[str] | None", ...]:
        return tuple(
            re.compile(val) if op in ("=~", "!~") else None
            for _lbl, op, val in self.matchers
        )

    def _filter(self, vec: Vector) -> Vector:
        if not self.matchers:
            return dict(vec)
        rxs = self._regexes()
        out: Vector = {}
        for key, value in vec.items():
            labels = dict(key)
            ok = True
            for (lbl, op, val), rx in zip(self.matchers, rxs):
                if not _match_one(op, val, rx, labels.get(lbl, "")):
                    ok = False
                    break
            if ok:
                out[key] = value
        return out

    def evaluate(self, ctx: EvalContext) -> Vector:
        return self._filter(ctx.vector(self.metric))

    def names(self, out: set[str]) -> None:
        out.add(self.metric)

    def render(self) -> str:
        if not self.matchers:
            return self.metric
        inner = ",".join(f"{lbl}{op}{json.dumps(val)}"
                         for lbl, op, val in self.matchers)
        return f"{self.metric}{{{inner}}}"


@dataclass(frozen=True)
class Rate(Expr):
    selector: Selector
    window_s: float

    def evaluate(self, ctx: EvalContext) -> Vector:
        vec = ctx.rate(self.selector.metric, self.window_s)
        return self.selector._filter(vec)

    def names(self, out: set[str]) -> None:
        out.add(self.selector.metric)

    def rate_names(self, out: set[str]) -> None:
        out.add(self.selector.metric)

    def render(self) -> str:
        return f"rate({self.selector.render()}[{_fmt_dur(self.window_s)}])"


@dataclass(frozen=True)
class Agg(Expr):
    op: str                      # sum | avg | min | max | count
    mode: str                    # "" | "by" | "without"
    labels: tuple[str, ...]
    arg: Expr

    def evaluate(self, ctx: EvalContext) -> Vector:
        vec = self.arg.evaluate(ctx)
        if isinstance(vec, float):
            raise ValueError(f"{self.op}() needs a vector operand")
        groups: dict[LabelKey, list[float]] = {}
        for key, value in vec.items():
            if self.mode == "by":
                labels = dict(key)
                gkey = tuple(sorted(
                    (lbl, labels[lbl]) for lbl in self.labels
                    if lbl in labels))
            elif self.mode == "without":
                gkey = tuple((k, v) for k, v in key
                             if k not in self.labels)
            else:
                gkey = ()
            groups.setdefault(gkey, []).append(value)
        out: Vector = {}
        for gkey, values in groups.items():
            if self.op == "sum":
                out[gkey] = sum(values)
            elif self.op == "avg":
                out[gkey] = sum(values) / len(values)
            elif self.op == "min":
                out[gkey] = min(values)
            elif self.op == "max":
                out[gkey] = max(values)
            else:
                out[gkey] = float(len(values))
        return out

    def names(self, out: set[str]) -> None:
        self.arg.names(out)

    def rate_names(self, out: set[str]) -> None:
        self.arg.rate_names(out)

    def render(self) -> str:
        grouping = (f" {self.mode} ({', '.join(self.labels)})"
                    if self.mode else "")
        return f"{self.op}{grouping} ({self.arg.render()})"


@dataclass(frozen=True)
class HistogramQuantile(Expr):
    q: float
    arg: Expr

    def evaluate(self, ctx: EvalContext) -> Vector:
        vec = self.arg.evaluate(ctx)
        if isinstance(vec, float):
            raise ValueError("histogram_quantile needs a vector operand")
        groups: dict[LabelKey, list[tuple[float, float]]] = {}
        for key, value in vec.items():
            labels = dict(key)
            le = labels.pop("le", None)
            if le is None:
                continue
            try:
                bound = float("inf") if le in ("+Inf", "Inf") else float(le)
            except ValueError:
                continue
            gkey = tuple(sorted(labels.items()))
            groups.setdefault(gkey, []).append((bound, value))
        out: Vector = {}
        for gkey, buckets in groups.items():
            buckets.sort()
            total = buckets[-1][1] if buckets else 0.0
            if not buckets or not math.isinf(buckets[-1][0]) or total <= 0:
                continue
            rank = self.q * total
            lo_bound, lo_count = 0.0, 0.0
            result = buckets[-2][0] if len(buckets) > 1 else 0.0
            for bound, count in buckets:
                if count >= rank:
                    if math.isinf(bound):
                        result = buckets[-2][0] if len(buckets) > 1 else 0.0
                    elif count > lo_count:
                        result = lo_bound + (bound - lo_bound) * (
                            (rank - lo_count) / (count - lo_count))
                    else:
                        result = bound
                    break
                lo_bound, lo_count = bound, count
            out[gkey] = result
        return out

    def names(self, out: set[str]) -> None:
        self.arg.names(out)

    def rate_names(self, out: set[str]) -> None:
        self.arg.rate_names(out)

    def render(self) -> str:
        return f"histogram_quantile({_fmt_num(self.q)}, {self.arg.render()})"


def _on_key(key: LabelKey, on: tuple[str, ...]) -> LabelKey:
    labels = dict(key)
    return tuple((lbl, labels.get(lbl, "")) for lbl in on)


def _arith(op: str, a: float, b: float) -> float:
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return a / b if b != 0 else float("nan")
    return math.fmod(a, b) if b != 0 else float("nan")


def _cmp(op: str, a: float, b: float) -> bool:
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == "<=":
        return a <= b
    if op == ">=":
        return a >= b
    if op == "<":
        return a < b
    return a > b


@dataclass(frozen=True)
class Binary(Expr):
    """Arithmetic, filtering comparison, or set op. ``on`` carries the
    join labels when the rule wrote ``on (...)`` — None means match on
    the full label identity (the PromQL default). ``on == ()`` is the
    explicit ``on ()`` match-everything join."""

    op: str
    lhs: Expr
    rhs: Expr
    on: tuple[str, ...] | None = None

    def evaluate(self, ctx: EvalContext) -> Vector | float:
        lv = self.lhs.evaluate(ctx)
        rv = self.rhs.evaluate(ctx)
        if self.op in _SET_OPS:
            return self._set_op(lv, rv)
        if isinstance(lv, float) and isinstance(rv, float):
            if self.op in _CMP_OPS:
                raise ValueError(
                    f"scalar {self.op} scalar needs a vector operand")
            return _arith(self.op, lv, rv)
        if isinstance(lv, float) or isinstance(rv, float):
            return self._scalar_op(lv, rv)
        return self._vector_op(lv, rv)

    def _scalar_op(self, lv: Vector | float,
                   rv: Vector | float) -> Vector:
        out: Vector = {}
        if isinstance(lv, float):
            assert isinstance(rv, dict)
            for key, value in rv.items():
                if self.op in _CMP_OPS:
                    # Scalar-LHS comparison keeps the VECTOR element —
                    # filter semantics mirror vector-op-scalar.
                    if _cmp(self.op, lv, value):
                        out[key] = value
                else:
                    out[key] = _arith(self.op, lv, value)
            return out
        assert isinstance(rv, float)
        for key, value in lv.items():
            if self.op in _CMP_OPS:
                if _cmp(self.op, value, rv):
                    out[key] = value
            else:
                out[key] = _arith(self.op, value, rv)
        return out

    def _vector_op(self, lv: Vector, rv: Vector) -> Vector:
        on = self.on
        if on is None:
            index: dict[LabelKey, float] = dict(rv)
            rkey = (lambda k: k)
        else:
            index = {}
            for key, value in rv.items():
                k = _on_key(key, on)
                if k in index:
                    raise ValueError(
                        f"many-to-one {self.op} match on "
                        f"({', '.join(on) or 'nothing'})")
                index[k] = value
            rkey = (lambda k: _on_key(k, on))
        out: Vector = {}
        for key, value in lv.items():
            other = index.get(rkey(key))
            if other is None:
                continue
            if self.op in _CMP_OPS:
                if _cmp(self.op, value, other):
                    out[key] = value
            else:
                out[key] = _arith(self.op, value, other)
        return out

    def _set_op(self, lv: Vector | float, rv: Vector | float) -> Vector:
        if isinstance(lv, float) or isinstance(rv, float):
            raise ValueError(f"{self.op} needs vector operands")
        on = self.on
        if self.op == "or":
            out = dict(lv)
            lkeys = ({_on_key(k, on) for k in lv} if on is not None
                     else set(lv))
            for key, value in rv.items():
                k = _on_key(key, on) if on is not None else key
                if k not in lkeys:
                    out[key] = value
            return out
        rkeys = ({_on_key(k, on) for k in rv} if on is not None
                 else set(rv))
        out = {}
        for key, value in lv.items():
            k = _on_key(key, on) if on is not None else key
            present = k in rkeys
            if present == (self.op == "and"):
                out[key] = value
        return out

    def names(self, out: set[str]) -> None:
        self.lhs.names(out)
        self.rhs.names(out)

    def rate_names(self, out: set[str]) -> None:
        self.lhs.rate_names(out)
        self.rhs.rate_names(out)

    def render(self) -> str:
        mod = ""
        if self.on is not None:
            mod = f" on ({', '.join(self.on)})"
        return (f"({self.lhs.render()} {self.op}{mod} "
                f"{self.rhs.render()})")


class _Parser:
    """Recursive-descent parser over the tokenized expression. Precedence
    (loosest first): or · and/unless · comparisons · + - · * / %."""

    def __init__(self, text: str) -> None:
        self.text = text
        self.tokens: list[tuple[str, str]] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if m is None or m.end() == pos:
                if text[pos:].strip():
                    raise ValueError(
                        f"unexpected character {text[pos:].strip()[0]!r} "
                        f"at offset {pos}")
                break
            pos = m.end()
            for kind in ("dur", "num", "name", "str", "op"):
                tok = m.group(kind)
                if tok is not None:
                    self.tokens.append((kind, tok))
                    break
        self.i = 0

    def peek(self) -> tuple[str, str] | None:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self) -> tuple[str, str]:
        tok = self.peek()
        if tok is None:
            raise ValueError("unexpected end of expression")
        self.i += 1
        return tok

    def expect(self, op: str) -> None:
        tok = self.next()
        if tok != ("op", op):
            raise ValueError(f"expected {op!r}, got {tok[1]!r}")

    def _maybe_on(self) -> tuple[str, ...] | None:
        tok = self.peek()
        if tok == ("name", "on"):
            self.next()
            return self._label_list()
        return None

    def _label_list(self) -> tuple[str, ...]:
        self.expect("(")
        labels: list[str] = []
        while True:
            tok = self.next()
            if tok == ("op", ")"):
                break
            if tok == ("op", ","):
                continue
            if tok[0] != "name":
                raise ValueError(
                    f"expected a label name, got {tok[1]!r}")
            labels.append(tok[1])
        return tuple(labels)

    def parse(self) -> Expr:
        expr = self._or()
        tok = self.peek()
        if tok is not None:
            raise ValueError(f"unexpected trailing token {tok[1]!r}")
        return expr

    def _or(self) -> Expr:
        lhs = self._and()
        while self.peek() == ("name", "or"):
            self.next()
            on = self._maybe_on()
            lhs = Binary("or", lhs, self._and(), on)
        return lhs

    def _and(self) -> Expr:
        lhs = self._cmp()
        while self.peek() in (("name", "and"), ("name", "unless")):
            op = self.next()[1]
            on = self._maybe_on()
            lhs = Binary(op, lhs, self._cmp(), on)
        return lhs

    def _cmp(self) -> Expr:
        lhs = self._add()
        tok = self.peek()
        while tok is not None and tok[0] == "op" and tok[1] in _CMP_OPS:
            op = self.next()[1]
            on = self._maybe_on()
            lhs = Binary(op, lhs, self._add(), on)
            tok = self.peek()
        return lhs

    def _add(self) -> Expr:
        lhs = self._mul()
        tok = self.peek()
        while tok is not None and tok[0] == "op" and tok[1] in ("+", "-"):
            op = self.next()[1]
            on = self._maybe_on()
            lhs = Binary(op, lhs, self._mul(), on)
            tok = self.peek()
        return lhs

    def _mul(self) -> Expr:
        lhs = self._atom()
        tok = self.peek()
        while (tok is not None and tok[0] == "op"
               and tok[1] in ("*", "/", "%")):
            op = self.next()[1]
            on = self._maybe_on()
            lhs = Binary(op, lhs, self._atom(), on)
            tok = self.peek()
        return lhs

    def _atom(self) -> Expr:
        tok = self.next()
        kind, text = tok
        if kind == "op" and text == "(":
            expr = self._or()
            self.expect(")")
            return expr
        if kind in ("num", "dur") and kind == "num":
            return Num(float(text))
        if kind == "name":
            if text == "time":
                self.expect("(")
                self.expect(")")
                return TimeFn()
            if text == "rate":
                return self._rate()
            if text == "histogram_quantile":
                return self._quantile()
            if text in _AGG_OPS:
                return self._agg(text)
            return self._selector(text)
        raise ValueError(f"unexpected token {text!r}")

    def _selector(self, metric: str) -> Selector:
        matchers: list[tuple[str, str, str]] = []
        if self.peek() == ("op", "{"):
            self.next()
            while True:
                tok = self.next()
                if tok == ("op", "}"):
                    break
                if tok == ("op", ","):
                    continue
                if tok[0] != "name":
                    raise ValueError(
                        f"expected a matcher label, got {tok[1]!r}")
                lbl = tok[1]
                op_tok = self.next()
                if op_tok[0] != "op" or op_tok[1] not in (
                        "=", "!=", "=~", "!~"):
                    raise ValueError(
                        f"bad matcher operator {op_tok[1]!r} "
                        f"(want = / != / =~ / !~)")
                op = op_tok[1]
                val_tok = self.next()
                if val_tok[0] != "str":
                    raise ValueError(
                        f'matcher value must be quoted, got {val_tok[1]!r}')
                val = json.loads(val_tok[1])
                if op in ("=~", "!~"):
                    try:
                        re.compile(val)
                    except re.error as e:
                        raise ValueError(
                            f"bad matcher regex {val!r}: {e}") from e
                matchers.append((lbl, op, val))
        return Selector(metric, tuple(matchers))

    def _rate(self) -> Rate:
        self.expect("(")
        tok = self.next()
        if tok[0] != "name":
            raise ValueError("rate() wants metric[window]")
        sel = self._selector(tok[1])
        self.expect("[")
        dur = self.next()
        if dur[0] not in ("dur", "num"):
            raise ValueError(f"bad rate window {dur[1]!r}")
        window = parse_duration(dur[1])
        self.expect("]")
        self.expect(")")
        return Rate(sel, window)

    def _quantile(self) -> HistogramQuantile:
        self.expect("(")
        q_tok = self.next()
        if q_tok[0] != "num":
            raise ValueError("histogram_quantile wants a numeric quantile")
        self.expect(",")
        arg = self._or()
        self.expect(")")
        return HistogramQuantile(float(q_tok[1]), arg)

    def _agg(self, op: str) -> Agg:
        mode = ""
        labels: tuple[str, ...] = ()
        tok = self.peek()
        if tok in (("name", "by"), ("name", "without")):
            mode = self.next()[1]
            labels = self._label_list()
        self.expect("(")
        arg = self._or()
        self.expect(")")
        if not mode:
            nxt = self.peek()
            if nxt in (("name", "by"), ("name", "without")):
                mode = self.next()[1]
                labels = self._label_list()
        return Agg(op, mode, labels, arg)


def parse_expr(text: str) -> Expr:
    """Parse one expression; ValueError names the offending token."""
    return _Parser(text).parse()


# ---------------------------------------------------------- rule grammar


@dataclass(frozen=True)
class AlertRule:
    """One parsed alert rule (see module docstring for the grammar)."""

    name: str
    expr: Expr
    expr_text: str
    for_s: float
    keep_firing_s: float
    labels: tuple[tuple[str, str], ...]
    annotations: tuple[tuple[str, str], ...]
    suppress: Expr | None
    suppress_text: str
    line_no: int


def _alert_err(line_no: int, line: str, msg: str) -> ValueError:
    return ValueError(f"alert rule line {line_no} ({line!r}): {msg}")


_ALERT_HEAD_RE = re.compile(
    r"^alert\s+(?P<name>[A-Za-z_][A-Za-z0-9_]*)\s*=\s*(?P<expr>.+)$")
_CLAUSE_DUR_RE = re.compile(r"^(?P<kw>for|keep_firing)\s+(?P<dur>\S+)$")
_CLAUSE_PAREN_RE = re.compile(
    r"^(?P<kw>labels|annotations|suppress)\s*\((?P<body>.*)\)$")
_KV_RE = re.compile(
    r'(?P<key>[A-Za-z_][A-Za-z0-9_]*)\s*=\s*'
    r'(?P<val>"(?:[^"\\]|\\.)*")')


def _parse_kv(line_no: int, raw: str, body: str) -> tuple[
        tuple[str, str], ...]:
    pairs: list[tuple[str, str]] = []
    rest = body
    while rest.strip():
        m = _KV_RE.match(rest.strip())
        if m is None:
            raise _alert_err(line_no, raw,
                             f'bad {rest.strip()[:40]!r}: want '
                             f'key="value"[, ...]')
        pairs.append((m.group("key"), json.loads(m.group("val"))))
        rest = rest.strip()[m.end():].lstrip()
        if rest.startswith(","):
            rest = rest[1:]
        elif rest.strip():
            raise _alert_err(line_no, raw,
                             f"expected ',' between pairs, got "
                             f"{rest.strip()[:20]!r}")
    return tuple(pairs)


def _validate_names(rule_name: str, line_no: int, raw: str, expr: Expr,
                    known: frozenset[str]) -> None:
    referenced: set[str] = set()
    expr.names(referenced)
    for name in sorted(referenced):
        if name in known or name in _EXTERNAL_NAMES or ":" in name:
            continue  # colon names are recording-rule outputs
        raise _alert_err(
            line_no, raw,
            f"alert {rule_name!r} references unknown metric {name!r}: "
            f"alerts evaluate over schema-registered families, "
            f"recording-rule outputs (names with ':'), or "
            f"{'/'.join(sorted(_EXTERNAL_NAMES))}")


def parse_alert_rules(
    text: str, known_names: frozenset[str] | None = None
) -> tuple[AlertRule, ...]:
    """Parse an alert-rule file body. Raises ValueError naming the
    offending line and what would be accepted — a typo'd rule file must
    fail at startup, never silently alert on nothing (the store's
    parse_rules contract). ``known_names`` overrides the schema-name set
    the validator accepts (drill harnesses inject synthetic families)."""
    known = known_names if known_names is not None else _schema_names()
    rules: list[AlertRule] = []
    seen: dict[str, int] = {}
    current: dict[str, Any] | None = None

    def finish() -> None:
        nonlocal current
        if current is None:
            return
        c = current
        current = None
        rules.append(AlertRule(
            name=c["name"], expr=c["expr"], expr_text=c["expr_text"],
            for_s=c.get("for_s", 0.0),
            keep_firing_s=c.get("keep_firing_s", 0.0),
            labels=c.get("labels", ()),
            annotations=c.get("annotations", ()),
            suppress=c.get("suppress"),
            suppress_text=c.get("suppress_text", ""),
            line_no=c["line_no"],
        ))

    for line_no, raw_line in enumerate(text.splitlines(), start=1):
        line = raw_line.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indented = line[0] in (" ", "\t")
        stripped = line.strip()
        if not indented:
            finish()
            m = _ALERT_HEAD_RE.match(stripped)
            if m is None:
                raise _alert_err(
                    line_no, stripped,
                    "want `alert NAME = <expr>` with indented clause "
                    "lines (for/keep_firing/labels/annotations/suppress)")
            name = m.group("name")
            if name in seen:
                raise _alert_err(
                    line_no, stripped,
                    f"duplicate alert name {name!r} "
                    f"(first defined on line {seen[name]})")
            seen[name] = line_no
            expr_text = m.group("expr").strip()
            try:
                expr = parse_expr(expr_text)
            except ValueError as e:
                raise _alert_err(line_no, stripped, str(e)) from e
            _validate_names(name, line_no, stripped, expr, known)
            current = {"name": name, "expr": expr,
                       "expr_text": expr_text, "line_no": line_no}
            continue
        if current is None:
            raise _alert_err(line_no, stripped,
                             "clause line outside any alert block")
        md = _CLAUSE_DUR_RE.match(stripped)
        if md is not None:
            try:
                seconds = parse_duration(md.group("dur"))
            except ValueError as e:
                raise _alert_err(line_no, stripped, str(e)) from e
            key = "for_s" if md.group("kw") == "for" else "keep_firing_s"
            current[key] = seconds
            continue
        mp = _CLAUSE_PAREN_RE.match(stripped)
        if mp is None:
            raise _alert_err(
                line_no, stripped,
                "want one of: for <dur> | keep_firing <dur> | "
                'labels(k="v", ...) | annotations(k="v", ...) | '
                "suppress(<expr>)")
        kw = mp.group("kw")
        body = mp.group("body")
        if kw == "suppress":
            try:
                sup = parse_expr(body)
            except ValueError as e:
                raise _alert_err(line_no, stripped, str(e)) from e
            _validate_names(current["name"], line_no, stripped, sup, known)
            current["suppress"] = sup
            current["suppress_text"] = body.strip()
        else:
            current[kw] = _parse_kv(line_no, stripped, body)
    finish()
    return tuple(rules)


def load_alert_rules_file(
    path: str, known_names: frozenset[str] | None = None
) -> tuple[AlertRule, ...]:
    """Read + parse an alert rule file; OSError/ValueError propagate (a
    missing or malformed rule file is a startup error, not a no-op)."""
    with open(path, encoding="utf-8") as f:
        return parse_alert_rules(f.read(), known_names=known_names)


def render_rules(rules: Sequence[AlertRule]) -> str:
    """Canonical native-grammar rendering — the round-trip the importer
    equivalence tests pin: parse(render(parse(x))) == parse(x)."""
    out: list[str] = []
    for r in rules:
        out.append(f"alert {r.name} = {r.expr.render()}")
        if r.for_s:
            out.append(f"  for {_fmt_dur(r.for_s)}")
        if r.keep_firing_s:
            out.append(f"  keep_firing {_fmt_dur(r.keep_firing_s)}")
        if r.labels:
            kv = ", ".join(f"{k}={json.dumps(v)}" for k, v in r.labels)
            out.append(f"  labels({kv})")
        if r.annotations:
            kv = ", ".join(f"{k}={json.dumps(v)}"
                           for k, v in r.annotations)
            out.append(f"  annotations({kv})")
        if r.suppress is not None:
            out.append(f"  suppress({r.suppress.render()})")
        out.append("")
    return "\n".join(out)


_TMPL_LABEL_RE = re.compile(
    r"\{\{\s*\$labels\.([A-Za-z_][A-Za-z0-9_]*)\s*\}\}")
_TMPL_VALUE_RE = re.compile(r"\{\{\s*\$value[^}]*\}\}")


def render_template(text: str, labels: Mapping[str, str],
                    value: float) -> str:
    """Annotation interpolation: ``{{ $labels.x }}`` and ``{{ $value }}``
    (format pipelines collapse to %g — notification bodies, not Go
    templates)."""
    out = _TMPL_LABEL_RE.sub(lambda m: labels.get(m.group(1), ""), text)
    return _TMPL_VALUE_RE.sub(f"{value:g}", out)


# ------------------------------------------------------------- notifier


class AlertNotifier:
    """Exactly-once webhook delivery for alert transitions.

    Two threads touch it, with the egress shipper's exact coupling: the
    root's ROUND thread calls :meth:`enqueue` (frames one notification
    with a durable seq and appends it to the
    :class:`~tpu_pod_exporter_torch.persist.WalBuffer` — it is the buffer's one
    appender), and the SENDER thread drains oldest-first behind the
    breaker (2xx acks the fsynced cursor — never re-sent, even across a
    root restart; timeout/connection/5xx/429 are failures that open the
    breaker; other 4xx are poison, counted and acked-without-delivery so
    one rejected body cannot wedge every alert behind it). The sender is
    the buffer's ONE cursor-mover.

    Seq recovery mirrors the egress shipper: the newest pending record
    carries the highest issued seq; a drained buffer recovers it from the
    alert-status.json sidecar the evaluator writes each round."""

    def __init__(
        self,
        url: str,
        alert_dir: str,
        timeout_s: float = 5.0,
        max_backlog_mb: float = 16.0,
        breaker: CircuitBreaker | None = None,
        send: Callable[[str, bytes, Mapping[str, str], float], int] = default_send,
        clock: Callable[[], float] = time.monotonic,
        wallclock: Callable[[], float] = time.time,
    ) -> None:
        self.url = url
        self.alert_dir = alert_dir
        self.timeout_s = timeout_s
        self.max_backlog_bytes = int(max_backlog_mb * (1 << 20))
        self.breaker = (breaker if breaker is not None
                        else build_breaker(3, 0.5, 30.0))
        self._send = send
        self._clock = clock
        self._wallclock = wallclock
        self.buffer = WalBuffer(alert_dir)
        self._rlog = RateLimitedLogger(log)
        self._work = threading.Event()
        self._stop = threading.Event()
        self._sender: threading.Thread | None = None
        self._stats_lock = threading.Lock()
        self._seq = 0
        self._boot_seq = 0  # seqs <= this predate this process
        # (seq, wall, mono) of the head record — backlog age without
        # touching buffer files from foreign threads (egress discipline).
        self._head_meta: tuple[int, float, float] | None = None
        self._stats: dict[str, Any] = {
            "enqueued": 0,
            "sent": 0,
            "failed": 0,
            "dropped": {"backlog": 0, "poison": 0, "corrupt": 0,
                        "append": 0},
            "last_send_ok_wall": 0.0,
            "last_error": "",
        }
        self._open_errors: list[str] = []

    # ------------------------------------------------------------------ boot

    def load(self) -> dict:
        """Open + replay the notification buffer; resumes the durable
        seq. Never refuses to start: a hopeless dir records the error and
        the notifier runs degraded (every enqueue drops, counted)."""
        try:
            info = self.buffer.open()
        except OSError as e:
            self._open_errors.append(str(e))
            log.error("alert dir %s unusable (%s); notifications will "
                      "drop until it recovers", self.alert_dir, e)
            return {"pending": 0, "errors": [str(e)]}
        dropped = 0
        max_seq = 0
        tail = self.buffer.peek_last()
        if tail is not None:
            try:
                max_seq = int(json.loads(tail).get("seq", 0))
            except (ValueError, KeyError, TypeError):
                pass
        while self.buffer.pending():
            payload = self.buffer.peek()
            if payload is None:
                break
            try:
                head = json.loads(payload)
                with self._stats_lock:
                    self._head_meta = (int(head.get("seq", 0)),
                                       float(head.get("wall", 0.0)),
                                       float(head.get("mono", 0.0)))
                break
            except (ValueError, KeyError, TypeError):
                self.buffer.drop_oldest(1)
                dropped += 1
        # The sidecar covers the drained-buffer restart (no pending
        # record left to read the seq from) — same belt the egress wears.
        try:
            with open(os.path.join(self.alert_dir, STATUS_NAME),
                      encoding="utf-8") as f:
                doc = json.load(f)
            notif = doc.get("notifier") or {}
            max_seq = max(max_seq, int(notif.get("seq", 0)))
        except FileNotFoundError:
            pass
        except Exception:  # noqa: BLE001 — a torn sidecar restarts from the scan
            pass
        with self._stats_lock:
            self._seq = self._boot_seq = max_seq
            if dropped:
                self._stats["dropped"]["corrupt"] += dropped
        if info.get("pending"):
            log.info("alert notification backlog restored from %s: %d "
                     "record(s) pending (resuming at seq %d)",
                     self.alert_dir, info["pending"], max_seq)
        return info

    def start(self) -> None:
        if self._sender is not None:
            return
        self._sender = threading.Thread(
            target=self._sender_run, name="tpu-alert-sender", daemon=True
        )
        self._sender.start()

    # ------------------------------------------------------------ round side

    def enqueue(self, record: dict[str, Any]) -> int:
        """Frame one notification durably; called ONLY by the root's
        round thread (the buffer's single appender). Returns the assigned
        seq, or 0 when the append failed (counted)."""
        with self._stats_lock:
            self._seq += 1
            seq = self._seq
        doc = dict(record)
        doc["seq"] = seq
        doc["wall"] = self._wallclock()
        doc["mono"] = self._clock()
        payload = json.dumps(doc, separators=(",", ":")).encode()
        try:
            self.buffer.append(payload)
        except OSError as e:
            with self._stats_lock:
                self._stats["dropped"]["append"] += 1
            self._rlog.warning("alert_append",
                               "alert notification append failed: %s", e)
            return 0
        with self._stats_lock:
            self._stats["enqueued"] += 1
            if self._head_meta is None:
                self._head_meta = (seq, doc["wall"], doc["mono"])
        self._work.set()
        return seq

    # ----------------------------------------------------------- sender side

    def _peek_meta(self) -> None:
        payload = self.buffer.peek()
        meta: tuple[int, float, float] | None = None
        if payload is not None:
            try:
                head = json.loads(payload)
                meta = (int(head.get("seq", 0)),
                        float(head.get("wall", 0.0)),
                        float(head.get("mono", 0.0)))
            except (ValueError, KeyError, TypeError):
                meta = None
        with self._stats_lock:
            self._head_meta = meta

    def _enforce_caps(self) -> None:
        dropped = 0
        while (self.buffer.pending_bytes() > self.max_backlog_bytes
               and self.buffer.pending() > 1):
            if not self.buffer.drop_oldest(1):
                break
            dropped += 1
        if dropped:
            with self._stats_lock:
                self._stats["dropped"]["backlog"] += dropped
            self._peek_meta()
            self._rlog.warning(
                "alert_backlog",
                "alert notification backlog over %d bytes; dropped %d "
                "oldest record(s) (bounded loss by policy)",
                self.max_backlog_bytes, dropped)

    def _sender_run(self) -> None:
        while not self._stop.is_set():
            if self.buffer.pending() == 0:
                self._work.clear()
                self._work.wait(0.25)
                continue
            self._enforce_caps()
            if self.buffer.pending() == 0:
                continue
            if self.breaker.decide() == "skip":
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
                    self._stats["failed"] += 1
                    self._stats["last_error"] = f"unexpected: {e}"
                self._rlog.warning("alert_send", "alert webhook send "
                                   "failed unexpectedly: %s", e)
            if not progressed and self.breaker.state == CLOSED:
                # Failure floor (the egress rule): a connection-refused
                # receiver fails in microseconds; with a disabled breaker
                # a zero-delay retry loop would spin a core.
                self._stop.wait(0.05)

    def _send_one(self) -> bool:
        """One webhook attempt against the head record. EVERY exit leaves
        the breaker with a recorded outcome — decide() already consumed
        this turn (possibly the single half-open probe), and an
        outcome-less return would park it in HALF_OPEN forever."""
        payload = self.buffer.peek()
        if payload is None:
            if self.breaker.state != CLOSED:
                self.breaker.record_failure()
            return False
        try:
            head = json.loads(payload)
            seq = int(head.get("seq", 0))
        except (ValueError, KeyError, TypeError):
            self.buffer.drop_oldest(1)
            with self._stats_lock:
                self._stats["dropped"]["corrupt"] += 1
            self._peek_meta()
            if self.breaker.state != CLOSED:
                self.breaker.record_failure()
            return True
        headers = {
            "Content-Type": "application/json",
            SEQ_HEADER: str(seq),
        }
        status: int | None = None
        error = ""
        try:
            status = self._send(self.url, payload, headers, self.timeout_s)
        except urllib.error.HTTPError as e:
            status = e.code
            error = f"HTTP {e.code}"
        except (urllib.error.URLError, TimeoutError, socket.timeout,
                ConnectionError, OSError) as e:
            error = f"{type(e).__name__}: {e}"
        if status is not None and 200 <= status < 300:
            self.breaker.record_success()
            self.buffer.ack()
            self._peek_meta()
            wall = self._wallclock()
            with self._stats_lock:
                self._stats["sent"] += 1
                self._stats["last_send_ok_wall"] = wall
                self._stats["last_error"] = ""
            return True
        if status is not None and 400 <= status < 500 and status != 429:
            # Poison: the receiver is UP and rejects this body. Retrying
            # forever would wedge every notification behind it. 429 is
            # deliberate backpressure → failure/retry below.
            self.breaker.record_success()
            self.buffer.ack()
            self._peek_meta()
            with self._stats_lock:
                self._stats["dropped"]["poison"] += 1
                self._stats["last_error"] = f"poison: HTTP {status}"
            self._rlog.warning(
                "alert_poison",
                "webhook rejected notification seq=%d with HTTP %d; "
                "skipping it (poison must not wedge the queue)",
                seq, status)
            return True
        self.breaker.record_failure()
        with self._stats_lock:
            self._stats["failed"] += 1
            self._stats["last_error"] = error or f"HTTP {status}"
        if self.breaker.state != CLOSED:
            self._rlog.warning(
                "alert_fail",
                "alert webhook send failed (%s); breaker %s, next probe "
                "in %.1fs, %d notification(s) buffered on disk",
                error or f"HTTP {status}", self.breaker.state,
                self.breaker.seconds_until_probe, self.buffer.pending())
        return False

    # ----------------------------------------------------------------- state

    @property
    def degraded(self) -> bool:
        """/readyz degraded predicate — the egress reopen threshold."""
        return (self.breaker.state != CLOSED
                and self.breaker.reopens >= DEGRADED_AFTER_REOPENS)

    def backlog_age_s(self) -> float:
        """Age of the oldest pending notification, from CACHED head
        metadata (round-thread safe: no buffer file reads). Records from
        this process age on their monotonic stamp (clock-step fenced);
        pre-restart records age on wall time (their mono stamp belongs
        to a dead clock) — the egress _batch_age rule."""
        if self.buffer.pending() == 0:
            return 0.0
        with self._stats_lock:
            meta = self._head_meta
            boot_seq = self._boot_seq
        if meta is None:
            return 0.0
        seq, wall, mono = meta
        if mono > 0 and seq > boot_seq:
            return max(self._clock() - mono, 0.0)
        return max(self._wallclock() - wall, 0.0)

    def stats(self) -> dict:
        with self._stats_lock:
            out: dict[str, Any] = dict(self._stats)
            out["dropped"] = dict(self._stats["dropped"])
            out["seq"] = self._seq
        out["url"] = self.url
        out["backlog_records"] = self.buffer.pending()
        out["backlog_bytes"] = self.buffer.pending_bytes()
        out["backlog_age_s"] = self.backlog_age_s()
        out["breaker_state"] = self.breaker.state
        out["breaker_state_value"] = STATE_VALUES[self.breaker.state]
        out["breaker_reopens"] = self.breaker.reopens
        out["degraded"] = self.degraded
        if self._open_errors:
            out["open_errors"] = list(self._open_errors)
        return out

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._work.set()
        if self._sender is not None:
            self._sender.join(timeout)
            self._sender = None
        self.buffer.close()


# ------------------------------------------------------------- evaluator


class _Instance:
    """One alert instance's state machine (keyed by rule + label set)."""

    __slots__ = ("labels", "state", "active_since", "state_since",
                 "last_true", "value")

    def __init__(self, labels: dict[str, str], now: float,
                 value: float) -> None:
        self.labels = labels
        self.state = PENDING
        self.active_since = now
        self.state_since = now
        self.last_true = now
        self.value = value


class AlertEvaluator:
    """Per-round alert evaluation at the root.

    Thread contract: :meth:`evaluate_round` is called by ONE thread (the
    root's round loop — the same single-appender seat the FleetStore
    holds); the read surfaces (:meth:`rows`, :meth:`stats`,
    :meth:`emit`, :meth:`ready_detail`) come from HTTP handler / stream
    pump threads and copy state out under the evaluator lock. All
    evaluation work and every I/O (store append, notifier enqueue,
    sidecar write) happens OUTSIDE the lock; only the commit of the new
    state is under it."""

    def __init__(
        self,
        rules: Sequence[AlertRule],
        alert_dir: str | None = None,
        notifier: AlertNotifier | None = None,
        store: "FleetStore | None" = None,
        recording_rules: "Sequence[RecordingRule]" = (),
        suppression: bool = True,
        history_slack_s: float = 60.0,
        max_transitions: int = 512,
        wallclock: Callable[[], float] = time.time,
    ) -> None:
        self.rules = tuple(rules)
        self.alert_dir = alert_dir
        self.notifier = notifier
        self._store = store
        self._recording_rules = tuple(recording_rules)
        self.suppression_enabled = suppression
        self._wallclock = wallclock
        self._rlog = RateLimitedLogger(log)
        referenced: set[str] = set()
        rated: set[str] = set()
        for r in self.rules:
            r.expr.names(referenced)
            r.expr.rate_names(rated)
            if r.suppress is not None:
                r.suppress.names(referenced)
                r.suppress.rate_names(rated)
        self._referenced = frozenset(referenced)
        self._rated = frozenset(rated)
        # Rate history window: the widest rate() window any rule uses,
        # plus slack for round jitter. Bounded deques per series.
        max_window = 60.0
        for r in self.rules:
            max_window = max(max_window, _max_rate_window(r.expr))
            if r.suppress is not None:
                max_window = max(max_window, _max_rate_window(r.suppress))
        self._hist_window_s = max_window + history_slack_s
        self._hist: dict[str, dict[LabelKey, deque[tuple[float, float]]]] = {
            name: {} for name in self._rated
        }
        self._lock = threading.Lock()
        self._active: dict[tuple[str, LabelKey], _Instance] = {}
        self._transitions: deque[dict[str, Any]] = deque(
            maxlen=max_transitions)
        self._transitions_total: dict[tuple[str, str], int] = {}
        self._suppressed_total: dict[str, int] = {}
        self._eval_failures = 0
        self._last_round_failures = 0
        self._rounds = 0
        self._last_transition_wall = 0.0
        self._generation = 0

    # ------------------------------------------------------------ round side

    def evaluate_round(self, snapshot: "Snapshot",
                       now_wall: float | None = None) -> dict[str, Any]:
        """Evaluate every rule against one published snapshot; runs the
        state machines, appends ALERTS series to the store, enqueues
        notifications, and writes the status sidecar. Called once per
        root merge round, on the round thread."""
        now = self._wallclock() if now_wall is None else now_wall
        vectors = self._ingest(snapshot, now)
        ctx = EvalContext(now, lambda name: vectors.get(name, {}),
                          self._rate_vector_fn(now))
        round_failures = 0
        transitions: list[dict[str, Any]] = []
        notifications: list[dict[str, Any]] = []
        suppressed_counts: dict[str, int] = {}
        with self._lock:
            active = {k: v for k, v in self._active.items()}
        for rule in self.rules:
            try:
                result = rule.expr.evaluate(ctx)
                if isinstance(result, float):
                    raise ValueError("top-level expression is a scalar")
                sup_vec: Vector | None = None
                if (rule.suppress is not None
                        and self.suppression_enabled):
                    sup = rule.suppress.evaluate(ctx)
                    sup_vec = sup if isinstance(sup, dict) else None
            except Exception as e:  # noqa: BLE001 — one bad rule must not stop the round
                round_failures += 1
                self._rlog.warning(f"rule:{rule.name}",
                                   "alert rule %s failed: %s",
                                   rule.name, e)
                continue
            self._step_rule(rule, result, sup_vec, active, now,
                            transitions, notifications,
                            suppressed_counts)
        firing = sum(1 for inst in active.values()
                     if inst.state == FIRING)
        pending = sum(1 for inst in active.values()
                      if inst.state == PENDING)
        with self._lock:
            self._active = active
            self._rounds += 1
            self._generation += 1
            self._last_round_failures = round_failures
            self._eval_failures += round_failures
            for t in transitions:
                self._transitions.append(t)
                key = (str(t["alert"]), str(t["to"]))
                self._transitions_total[key] = (
                    self._transitions_total.get(key, 0) + 1)
                self._last_transition_wall = now
            for name, n in suppressed_counts.items():
                self._suppressed_total[name] = (
                    self._suppressed_total.get(name, 0) + n)
        # I/O strictly outside the lock (lock-io discipline).
        if self.notifier is not None:
            for notif in notifications:
                self.notifier.enqueue(notif)
        if self._store is not None:
            rows = [
                (ALERTS_METRIC,
                 {"alertname": name, "alertstate": inst.state,
                  **inst.labels},
                 1.0)
                for (name, _key), inst in active.items()
            ]
            if rows:
                try:
                    self._store.append_samples(rows, now_wall=now)
                except Exception as e:  # noqa: BLE001 — store trouble must not stop alerting
                    self._rlog.warning("store_append",
                                       "ALERTS store append failed: %s", e)
        self._write_status(now, firing, pending)
        return {"firing": firing, "pending": pending,
                "transitions": len(transitions),
                "eval_failures": round_failures}

    def _step_rule(
        self,
        rule: AlertRule,
        result: Vector,
        sup_vec: Vector | None,
        active: dict[tuple[str, LabelKey], _Instance],
        now: float,
        transitions: list[dict[str, Any]],
        notifications: list[dict[str, Any]],
        suppressed_counts: dict[str, int],
    ) -> None:
        sup_keys = (tuple(sup_vec.keys()) if sup_vec else ())
        true_now: set[LabelKey] = set()
        for key, value in result.items():
            if sup_keys and _suppressed(key, sup_keys):
                suppressed_counts[rule.name] = (
                    suppressed_counts.get(rule.name, 0) + 1)
                continue  # held down as a presumed false positive
            true_now.add(key)
            ikey = (rule.name, key)
            inst = active.get(ikey)
            if inst is None:
                inst = _Instance(dict(key), now, value)
                active[ikey] = inst
                transitions.append(self._transition(
                    rule, inst, PENDING, now))
                if rule.for_s <= 0:
                    inst.state = FIRING
                    inst.state_since = now
                    transitions.append(self._transition(
                        rule, inst, FIRING, now))
                    notifications.append(self._notification(
                        rule, inst, FIRING, now))
                continue
            inst.last_true = now
            inst.value = value
            if (inst.state == PENDING
                    and now - inst.active_since >= rule.for_s):
                inst.state = FIRING
                inst.state_since = now
                transitions.append(self._transition(
                    rule, inst, FIRING, now))
                notifications.append(self._notification(
                    rule, inst, FIRING, now))
        for ikey in [k for k in active if k[0] == rule.name]:
            if ikey[1] in true_now:
                continue
            inst = active[ikey]
            if inst.state == PENDING:
                # Pending that recovers (or is suppressed) simply drops —
                # the Prometheus pending→inactive convention: no
                # notification, no resolved transition.
                del active[ikey]
                continue
            if now - inst.last_true <= rule.keep_firing_s:
                continue  # keep-firing: flap damping absorbs the dip
            inst.state = RESOLVED
            transitions.append(self._transition(rule, inst, RESOLVED, now))
            notifications.append(self._notification(
                rule, inst, RESOLVED, now))
            del active[ikey]

    def _transition(self, rule: AlertRule, inst: _Instance, to: str,
                    now: float) -> dict[str, Any]:
        return {"alert": rule.name, "to": to, "wall": now,
                "labels": dict(inst.labels), "value": inst.value}

    def _notification(self, rule: AlertRule, inst: _Instance, state: str,
                      now: float) -> dict[str, Any]:
        labels = {"alertname": rule.name, **dict(rule.labels),
                  **inst.labels}
        annotations = {
            k: render_template(v, labels, inst.value)
            for k, v in rule.annotations
        }
        return {"alert": rule.name, "state": state, "labels": labels,
                "annotations": annotations, "value": inst.value,
                "active_since": inst.active_since}

    # ------------------------------------------------------------- data feed

    def _ingest(self, snapshot: "Snapshot",
                now: float) -> dict[str, Vector]:
        vectors: dict[str, Vector] = {}
        for name in self._referenced:
            if ":" in name:
                continue  # recording-rule outputs handled below
            hist = _HIST_BY_EXPO_NAME.get(name)
            if hist is not None:
                vec = self._hist_vector(snapshot, name, *hist)
                if vec:
                    vectors[name] = vec
                continue
            spec = _SPEC_BY_NAME.get(name)
            if spec is None:
                continue  # external names (`up`) evaluate empty here
            view = snapshot.samples_view(name)
            if not view:
                continue
            label_names = spec.label_names
            vec = {}
            for lvs, value in view.items():
                key = tuple(sorted(
                    (ln, lv) for ln, lv in zip(label_names, lvs) if lv))
                vec[key] = float(value)
            vectors[name] = vec
        self._ingest_recording(snapshot, vectors)
        self._trim_history(vectors, now)
        return vectors

    def _hist_vector(self, snapshot: "Snapshot", wanted: str,
                     hist: Any, kind: str) -> Vector:
        """Recover one histogram exposition series (_bucket/_sum/_count)
        from its raw-lines child family: each sample's label 'tuple' is a
        1-tuple holding the fully pre-rendered series prefix."""
        view = snapshot.samples_view(hist.lines.name)
        if not view:
            return {}
        vec: Vector = {}
        for lvs, value in view.items():
            if not lvs:
                continue
            m = _HIST_PREFIX_RE.match(lvs[0])
            if m is None or m.group("series") != wanted:
                continue
            labels = {
                lm.group("key"): json.loads(f'"{lm.group("val")}"')
                for lm in _HIST_LABEL_RE.finditer(m.group("labels") or "")
            }
            key = tuple(sorted(
                (k, v) for k, v in labels.items() if v))
            vec[key] = float(value)
        return vec

    def _ingest_recording(self, snapshot: "Snapshot",
                          vectors: dict[str, Vector]) -> None:
        if self._recording_rules:
            from tpu_pod_exporter_torch.store import evaluate_rule
            wanted = {name for name in self._referenced if ":" in name}
            for rrule in self._recording_rules:
                if rrule.name not in wanted:
                    continue
                try:
                    vec = {}
                    for labels, value in evaluate_rule(rrule, snapshot):
                        vec[tuple(sorted(labels.items()))] = value
                    vectors[rrule.name] = vec
                except Exception as e:  # noqa: BLE001 — rule series degrade to absent
                    self._rlog.warning(f"rrule:{rrule.name}",
                                       "recording rule %s failed during "
                                       "alert ingest: %s", rrule.name, e)

    def _trim_history(self, vectors: dict[str, Vector],
                      now: float) -> None:
        horizon = now - self._hist_window_s
        for name in self._rated:
            series = self._hist[name]
            vec = vectors.get(name, {})
            for key, value in vec.items():
                dq = series.get(key)
                if dq is None:
                    dq = deque()
                    series[key] = dq
                dq.append((now, value))
            for key in list(series):
                dq = series[key]
                while dq and dq[0][0] < horizon:
                    dq.popleft()
                if not dq:
                    del series[key]

    def _rate_vector_fn(
        self, now: float
    ) -> Callable[[str, float], Vector]:
        def rate(name: str, window_s: float) -> Vector:
            out: Vector = {}
            for key, dq in self._hist.get(name, {}).items():
                pts = [(t, v) for t, v in dq if t >= now - window_s]
                if len(pts) < 2:
                    continue
                increase = 0.0
                prev = pts[0][1]
                for _t, v in pts[1:]:
                    increase += (v - prev) if v >= prev else v
                    prev = v
                span = pts[-1][0] - pts[0][0]
                if span > 0:
                    out[key] = increase / span
            return out

        return rate

    def backfill(self, samples: Iterable[tuple[str, Mapping[str, str],
                                               float, float]]) -> int:
        """Seed the rate history from stored pre-restart samples:
        ``(metric, labels, wall, value)`` tuples, oldest first. Called
        once at boot, before the round loop starts — rates stay
        continuous across a root restart (the live+store contract)."""
        n = 0
        for name, labels, wall, value in samples:
            series = self._hist.get(name)
            if series is None:
                continue
            key = tuple(sorted(
                (k, v) for k, v in labels.items() if v))
            dq = series.get(key)
            if dq is None:
                dq = deque()
                series[key] = dq
            dq.append((float(wall), float(value)))
            n += 1
        return n

    # ------------------------------------------------------------- sidecar

    def _write_status(self, now: float, firing: int,
                      pending: int) -> None:
        if not self.alert_dir:
            return
        with self._lock:
            doc: dict[str, Any] = {
                "wall": now,
                "rules": len(self.rules),
                "firing": firing,
                "pending": pending,
                "rounds": self._rounds,
                "eval_failures": self._eval_failures,
                "last_round_failures": self._last_round_failures,
                "suppressed_total": sum(self._suppressed_total.values()),
                "last_transition_wall": self._last_transition_wall,
                "suppression": self.suppression_enabled,
            }
        if self.notifier is not None:
            s = self.notifier.stats()
            doc["notifier"] = {
                "seq": s["seq"],
                "url": s["url"],
                "sent": s["sent"],
                "failed": s["failed"],
                "backlog_records": s["backlog_records"],
                "backlog_bytes": s["backlog_bytes"],
                "backlog_age_s": round(s["backlog_age_s"], 3),
                "breaker": s["breaker_state"],
                "last_error": s["last_error"],
            }
        try:
            atomic_write(os.path.join(self.alert_dir, STATUS_NAME),
                         json.dumps(doc).encode())
        except OSError:
            pass

    # --------------------------------------------------------- read surfaces

    def rows(self) -> list[dict[str, Any]]:
        """Active alert instances as stream/query rows — label identity
        is the stable row key (state rides the row body, so a transition
        is a changed row and a resolution a removed key: exactly the
        delta semantics the stream plane ships)."""
        with self._lock:
            snap = [(name, inst.labels, inst.state, inst.value,
                     inst.state_since, inst.active_since)
                    for (name, _key), inst in self._active.items()]
        out = [
            {"metric": ALERTS_METRIC,
             "labels": {"alertname": name, **labels},
             "state": state, "value": value,
             "state_since": state_since, "active_since": active_since}
            for name, labels, state, value, state_since, active_since
            in snap
        ]
        out.sort(key=lambda r: sorted(r["labels"].items()))
        return out

    def transitions(self, limit: int = 100) -> list[dict[str, Any]]:
        with self._lock:
            items = list(self._transitions)
        return items[-limit:]

    def generation(self) -> int:
        with self._lock:
            return self._generation

    def counts(self) -> tuple[int, int]:
        with self._lock:
            firing = sum(1 for i in self._active.values()
                         if i.state == FIRING)
            pending = sum(1 for i in self._active.values()
                          if i.state == PENDING)
        return firing, pending

    def suppressed_names(self) -> tuple[str, ...]:
        """Rule names whose instances suppression held down at least once
        over this evaluator's lifetime. The scenario fuzzer's suppress-
        aware verdict reads this: on a GENERATED timeline an alert may
        legitimately fire OR be suppressed, but either way its name must
        sit inside the derived expected∪allowed envelope — a rule
        engaging (even silently) outside that envelope means the
        generator's alert model and the evaluator disagree."""
        with self._lock:
            return tuple(sorted(
                name for name, n in self._suppressed_total.items() if n))

    @property
    def degraded(self) -> bool:
        """Evaluator errors in the last round, or a notifier whose
        breaker keeps reopening — the /readyz `alerting:` predicate
        (still HTTP 200: a down webhook must not pull the root from
        scrape rotation)."""
        with self._lock:
            failing = self._last_round_failures > 0
        if failing:
            return True
        return self.notifier is not None and self.notifier.degraded

    def ready_detail(self) -> dict[str, Any]:
        firing, pending = self.counts()
        with self._lock:
            detail: dict[str, Any] = {
                "rules": len(self.rules),
                "firing": firing,
                "pending": pending,
                "eval_failures": self._eval_failures,
            }
        if self.notifier is not None:
            s = self.notifier.stats()
            detail["notifier_breaker"] = s["breaker_state"]
            detail["notifier_backlog"] = s["backlog_records"]
        detail["status"] = "degraded" if self.degraded else "ok"
        return detail

    def stats(self) -> dict[str, Any]:
        firing, pending = self.counts()
        with self._lock:
            out: dict[str, Any] = {
                "rules": len(self.rules),
                "rounds": self._rounds,
                "firing": firing,
                "pending": pending,
                "eval_failures": self._eval_failures,
                "suppressed_total": dict(self._suppressed_total),
                "transitions_total": {
                    f"{alert}/{to}": n
                    for (alert, to), n in self._transitions_total.items()
                },
                "last_transition_wall": self._last_transition_wall,
                "suppression": self.suppression_enabled,
            }
        if self.notifier is not None:
            out["notifier"] = self.notifier.stats()
        return out

    def emit(self, b: "SnapshotBuilder") -> None:
        """Publish the alerting self-metric surface into a
        SnapshotBuilder (the root's publish path; one-round lag for the
        round's own transitions, the fleet_store.emit convention)."""
        for spec in schema.ALERT_SPECS:
            b.declare(spec)
        firing, pending = self.counts()
        with self._lock:
            transitions = dict(self._transitions_total)
            suppressed = dict(self._suppressed_total)
            eval_failures = self._eval_failures
        b.add(schema.TPU_ROOT_ALERTS_FIRING, float(firing))
        b.add(schema.TPU_ROOT_ALERTS_PENDING, float(pending))
        b.add(schema.TPU_ROOT_ALERT_RULES, float(len(self.rules)))
        b.add(schema.TPU_ROOT_ALERT_EVAL_FAILURES_TOTAL,
              float(eval_failures))
        for (alert, to), n in transitions.items():
            b.add(schema.TPU_ROOT_ALERT_TRANSITIONS_TOTAL, float(n),
                  (alert, to))
        for alert, n in suppressed.items():
            b.add(schema.TPU_ROOT_ALERT_SUPPRESSED_TOTAL, float(n),
                  (alert,))
        if self.notifier is not None:
            s = self.notifier.stats()
            b.add(schema.TPU_ROOT_ALERT_NOTIFICATIONS_SENT_TOTAL,
                  float(s["sent"]))
            b.add(schema.TPU_ROOT_ALERT_NOTIFICATIONS_FAILED_TOTAL,
                  float(s["failed"]))
            b.add(schema.TPU_ROOT_ALERT_NOTIFIER_BACKLOG_BYTES,
                  float(s["backlog_bytes"]))
            b.add(schema.TPU_ROOT_ALERT_NOTIFIER_BACKLOG_AGE_SECONDS,
                  s["backlog_age_s"])
            b.add(schema.TPU_ROOT_ALERT_NOTIFIER_BREAKER_STATE,
                  s["breaker_state_value"])

    def close(self) -> None:
        if self.notifier is not None:
            self.notifier.close()


def _suppressed(key: LabelKey, sup_keys: tuple[LabelKey, ...]) -> bool:
    """One suppression entry covers an instance when every label the two
    SHARE agrees (an empty-labeled entry covers everything — the
    scalar-truth case); disjoint label dimensions never suppress."""
    labels = dict(key)
    for skey in sup_keys:
        if not skey:
            return True
        shared = [(k, v) for k, v in skey if k in labels]
        if shared and all(labels[k] == v for k, v in shared):
            return True
    return False


def _max_rate_window(expr: Expr) -> float:
    if isinstance(expr, Rate):
        return expr.window_s
    if isinstance(expr, Binary):
        return max(_max_rate_window(expr.lhs), _max_rate_window(expr.rhs))
    if isinstance(expr, (Agg, HistogramQuantile)):
        return _max_rate_window(expr.arg)
    return 0.0


# ------------------------------------------------------------- importer


# Imported rules whose Prometheus shape has a partition-suppression twin
# in the native plane: the root's stale-serve suspicion gauge marks a
# leaf that LOOKS down but is being stale-served while its HA twin
# answers — exactly the false positive TpuRootLeafDown would page on.
DEFAULT_SUPPRESSIONS: Mapping[str, str] = {
    "TpuRootLeafDown": "tpu_root_leaf_partition_suspected == 1",
}


def import_prometheus_rules(
    yaml_text: str,
    suppressions: Mapping[str, str] = DEFAULT_SUPPRESSIONS,
) -> str:
    """Translate a Prometheus alerting-rules YAML body into the native
    grammar (alerts only; recording rules stay with --store-rules).
    Needs pyyaml (a test dependency) — the importer runs at dev/deploy
    time, never on the serving path."""
    try:
        import yaml
    except ImportError as e:  # pragma: no cover — present in CI/test envs
        raise RuntimeError(
            "the rule importer needs pyyaml (pip install pyyaml); "
            "native rule files need no yaml at runtime") from e
    doc = yaml.safe_load(yaml_text)
    out: list[str] = [
        "# Generated by `python -m tpu_pod_exporter_torch.alerting --import` —",
        "# the native twin of deploy/prometheus-rules.yaml (alerts only).",
        "",
    ]
    for group in (doc or {}).get("groups", ()):
        for rule in group.get("rules", ()):
            name = rule.get("alert")
            if not name:
                continue  # recording rule
            expr = " ".join(str(rule.get("expr", "")).split())
            out.append(f"alert {name} = {expr}")
            if rule.get("for"):
                out.append(
                    f"  for {_fmt_dur(parse_duration(str(rule['for'])))}")
            labels = rule.get("labels") or {}
            if labels:
                kv = ", ".join(f"{k}={json.dumps(str(v))}"
                               for k, v in labels.items())
                out.append(f"  labels({kv})")
            annotations = rule.get("annotations") or {}
            if annotations:
                kv = ", ".join(f"{k}={json.dumps(str(v))}"
                               for k, v in annotations.items())
                out.append(f"  annotations({kv})")
            sup = suppressions.get(str(name))
            if sup:
                out.append(f"  suppress({sup})")
            out.append("")
    return "\n".join(out)


# ------------------------------------------------------- status footer


def alert_status_summary(alert_dir: str) -> dict[str, Any] | None:
    """Read the alert-status.json sidecar for ``status``'s ``alerts:``
    footer (None when missing/unreadable — the caller renders an explicit
    error line, the store-footer discipline)."""
    try:
        with open(os.path.join(alert_dir, STATUS_NAME),
                  encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


# ------------------------------------------------------------------- CLI


def main(argv: Sequence[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_pod_exporter_torch.alerting",
        description="Native alerting plane tools: validate rule files, "
                    "import Prometheus rule YAML.",
    )
    p.add_argument("--check", metavar="FILE",
                   help="parse + validate a native alert rule file")
    p.add_argument("--import", dest="import_yaml", metavar="YAML",
                   help="translate a Prometheus rules YAML into the "
                        "native grammar (stdout)")
    ns = p.parse_args(argv)
    if ns.check:
        try:
            rules = load_alert_rules_file(ns.check)
        except (OSError, ValueError) as e:
            print(f"FAIL: {e}", file=sys.stderr)
            return 1
        print(f"ok: {len(rules)} alert rule(s)")
        for r in rules:
            clauses = []
            if r.for_s:
                clauses.append(f"for {_fmt_dur(r.for_s)}")
            if r.keep_firing_s:
                clauses.append(f"keep_firing {_fmt_dur(r.keep_firing_s)}")
            if r.suppress is not None:
                clauses.append("suppressed")
            print(f"  {r.name}"
                  + (f" [{', '.join(clauses)}]" if clauses else ""))
        return 0
    if ns.import_yaml:
        with open(ns.import_yaml, encoding="utf-8") as f:
            text = import_prometheus_rules(f.read())
        # Prove the translation parses before handing it to an operator.
        parse_alert_rules(text)
        print(text)
        return 0
    p.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
