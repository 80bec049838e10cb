"""Prometheus text-exposition parser (format 0.0.4).

The inverse of the renderer in :mod:`tpu_pod_exporter_torch.metrics.registry`,
used by the slice aggregator to consume per-host exporters' ``/metrics``
bodies. Kept dependency-free and strict about the things that matter for
aggregation correctness (label-value escape sequences, NaN/Inf, optional
timestamps) while tolerating unknown families — an aggregator must not
break when a newer exporter adds metrics.
"""

from __future__ import annotations

import logging
import re
import threading
from typing import Iterator, NamedTuple

log = logging.getLogger("tpu_pod_exporter_torch.metrics.parse")

# Oversize-body warnings are rate-limited globally (not once-per-layout):
# a body flapping across the cache cap re-arms the per-layout flag every
# other round, and at a 1 s poll interval an unthrottled warning is ~1800
# lines/hour (code-review r5). One line per 60 s across all targets is
# plenty — debug_vars' layout_oversize carries the per-target state.
_rlog = None


def _warn_oversize(n_lines: int, cap: int) -> None:
    global _rlog
    if _rlog is None:
        from tpu_pod_exporter_torch.utils import RateLimitedLogger

        _rlog = RateLimitedLogger(log, min_interval_s=60.0)
    _rlog.warning(
        "layout-oversize",
        "exposition body has %d lines (> layout cache cap %d); "
        "parsing uncached every round for this target",
        n_lines, cap,
    )


class ParsedSample(NamedTuple):
    name: str
    labels: dict[str, str]
    value: float


class ParseError(ValueError):
    """A metric line was structurally malformed."""


# One label pair: name="value" with the exposition escapes (\\ \" \n)
# allowed inside the value, followed by any run of comma/whitespace
# separators ([,\s]* — matching the historical parser's leniency: space-
# separated pairs, doubled commas, and trailing separators all parse).
# The value uses the *unrolled* form [^"\\]*(?:\\.[^"\\]*)* — the naive
# (?:[^"\\]+|\\.)* has a nested-quantifier ambiguity that backtracks
# exponentially on an unterminated value (a ~30-char bad line would hang
# the aggregator instead of raising ParseError). Validation is positional:
# every match must start exactly where the previous one ended.
_PAIR_RE = re.compile(r'\s*([^=,\s{}]+)\s*=\s*"([^"\\]*(?:\\.[^"\\]*)*)"[,\s]*')
# Key charset for the fast path — must stay equivalent to _PAIR_RE's key
# class (plus the no-quote rule the regex applies via the value grammar).
_FAST_KEY_RE = re.compile(r'[^=,\s{}"]+')
_GOOD_KEYS: dict[str, bool] = {}
_UNESCAPE_RE = re.compile(r"\\(.)")
_ESCAPE_MAP = {"n": "\n", '"': '"', "\\": "\\"}


def _unescape(value: str) -> str:
    return _UNESCAPE_RE.sub(
        lambda m: _ESCAPE_MAP.get(m.group(1), "\\" + m.group(1)), value
    )


def _parse_block_fast(block: str) -> dict[str, str] | None:
    """Non-regex parse of the overwhelmingly common strict shape:
    ``k="v",k2="v2"`` with NO backslash anywhere in the block.

    Soundness of the ``",`` split: the exposition format requires ``"``
    inside a value to be escaped as ``\\"``, so an escape-free block cannot
    contain a quote inside any key or value — every quote-comma sequence
    really ends a pair. Any residual quote after splitting (embedded
    ``="`` in a value, stray separators, spaces) rejects to the lenient
    regex parser, so the accepted grammar is unchanged. ~6x faster than
    the regex walk; at aggregator scale the block working set can exceed
    the cache budget and parses run uncached, where this is the
    difference between a sub-second and a multi-second 64-host round.
    """
    if "\\" in block or not block.endswith('"'):
        return None
    labels: dict[str, str] = {}
    good_keys = _GOOD_KEYS
    memo = _memo_str
    for part in block[:-1].split('",'):
        k, sep, v = part.partition('="')
        if not sep or '"' in v:
            return None
        if k not in good_keys:
            # Same key charset the regex enforces (no =,{}/whitespace/");
            # memoized because real bodies reuse a handful of label names.
            if not _FAST_KEY_RE.fullmatch(k):
                return None
            if len(good_keys) < 4096:
                good_keys[k] = True
        labels[memo(k)] = memo(v)
    return labels


def _parse_block_uncached(block: str, line: str) -> dict[str, str]:
    labels: dict[str, str] = {}
    pos = 0
    memo = _memo_str
    for m in _PAIR_RE.finditer(block):
        if m.start() != pos:
            raise ParseError(f"malformed label block: {line!r}")
        pos = m.end()
        value = m.group(2)
        labels[memo(m.group(1))] = memo(
            _unescape(value) if "\\" in value else value
        )
    if pos != len(block):
        raise ParseError(f"malformed label block: {line!r}")
    return labels


# Label-string memo: at slice scale the same short strings recur across
# thousands of distinct label blocks — chip_id="7" appears once per
# family per target, pod/namespace/host values repeat across every series
# of a host — but each block parse sliced fresh copies, and the layout
# caches then pinned ~108 MiB of duplicate strings at the 64x256 stress
# shape. Deduplicating through one table cuts aggregator RSS ~19% and is
# slightly FASTER (fewer live objects). Deliberately NOT sys.intern: the
# CPython intern table holds its strings forever, which under pod-name
# churn is a slow leak in a long-running sidecar; this table is bounded
# and wholesale-cleared (same policy as the block cache below), so the
# worst case is one round of re-warming. Oversized strings skip the memo
# — a degenerate label value must not occupy the budget.
_STR_MEMO: dict[str, str] = {}
_STR_MEMO_MAX = 65536
_STR_MEMO_MAX_LEN = 256


def _memo_str(s: str) -> str:
    # Deliberately unlocked, unlike the block cache's clear/accounting
    # path: this runs once per label string on the hot parse path, and
    # every individual dict op here is atomic under the GIL. A concurrent
    # miss race can only (a) overshoot the bound by the thread count for
    # one round or (b) clear() away another thread's just-inserted entry —
    # both cost one lost dedup, never a wrong parse result.
    r = _STR_MEMO.get(s)
    if r is not None:
        return r
    if len(s) <= _STR_MEMO_MAX_LEN:
        if len(_STR_MEMO) >= _STR_MEMO_MAX:
            _STR_MEMO.clear()
        _STR_MEMO[s] = s
    return s


# Parsed-block memo: exposition bodies repeat their label blocks verbatim
# every scrape (only sample *values* change), so in steady state label
# parsing collapses to one dict lookup + shallow copy per line. This is
# what keeps the aggregator's round cost flat at slice scale — the
# replaced per-character loop was ~85% of a 64-host round. Bounded by a
# byte budget (keys dominate memory) with wholesale clear — series-churn
# workloads just re-warm in one round — and a per-entry length guard so
# adversarial/degenerate blocks can't occupy the budget.
_BLOCK_CACHE: dict[str, dict[str, str]] = {}
_BLOCK_CACHE_MAX_BYTES = 32 << 20  # approximate *resident* bytes
_BLOCK_CACHE_MAX_ENTRY = 1 << 10
_block_cache_bytes = 0
# The cache is module-global shared mutable state; parsers can run from
# multiple threads (aggregator publish thread today, potentially a scrape
# pool tomorrow), so clear()/byte-accounting mutations are guarded. The
# lock is only taken on cache MISS — the hit path (steady state) stays a
# lock-free dict read, safe under the GIL because entries are immutable
# once inserted.
_block_cache_lock = threading.Lock()


def _entry_cost(block: str) -> int:
    """Approximate resident cost of one cache entry. The parsed value dict
    dominates (measured ~8x the key length: dict header + per-label key and
    value string objects), so counting key characters alone would let the
    'budget' admit ~8x its nominal size."""
    return 200 + 8 * len(block)


def _parse_label_block(block: str, line: str) -> dict[str, str]:
    """``name="value",…`` (no surrounding braces) → dict, honoring the
    exposition escapes inside values: ``\\\\``, ``\\"``, ``\\n``."""
    global _block_cache_bytes
    cached = _BLOCK_CACHE.get(block)
    if cached is None:
        cached = _parse_block_fast(block)
        if cached is None:
            cached = _parse_block_uncached(block, line)
        if len(block) <= _BLOCK_CACHE_MAX_ENTRY:
            with _block_cache_lock:
                if _block_cache_bytes >= _BLOCK_CACHE_MAX_BYTES:
                    _BLOCK_CACHE.clear()
                    _block_cache_bytes = 0
                if block not in _BLOCK_CACHE:  # a racing miss already paid
                    _BLOCK_CACHE[block] = cached
                    _block_cache_bytes += _entry_cost(block)
    # SHARED return: the same dict object serves every line with this
    # block (across targets, too). The layout path's contract already
    # declares labels shared-and-frozen, and the per-line dict(cached)
    # copies were ~45 MiB at the 64x256 stress shape; the one public
    # copy-owning API (parse_exposition / ParsedSample) copies at its own
    # boundary instead.
    return cached


def _parse_line(line: str, names: "set[str] | frozenset[str] | None") -> tuple:
    """One stripped, non-empty, non-comment line → layout entry tuple:
    ``(1, prefix)`` when ``names`` filters the line out, else
    ``(2, prefix, name, labels, value)``. Raises ParseError. The SINGLE
    definition of the line grammar — both :func:`parse_exposition` and
    :func:`parse_exposition_layout`'s slow path call it, so the two
    parsers cannot drift apart (code-review r5). ``labels`` is SHARED
    with the block cache (and with every other line using the same
    block): treat as frozen; copy at any boundary that hands ownership
    out."""
    if line[-1] == "{":
        raise ParseError(f"truncated line: {line!r}")
    brace = line.find("{")
    if brace >= 0:
        close = line.rfind("}")
        if close < brace:
            raise ParseError(f"unbalanced braces: {line!r}")
        name = line[:brace].strip()
        prefix = line[: close + 1]
        if names is not None and name not in names:
            return (1, prefix)
        # Family names repeat on nearly every line of a body; memoized so
        # 290k cached entries at slice scale share a handful of strings.
        # After the filter: a kind-1 entry drops the name, and dead
        # memo slots would hasten the wholesale clear (code-review r5).
        name = _memo_str(name)
        labels = _parse_label_block(line[brace + 1 : close], line)
        rest = line[close + 1 :].strip()
    else:
        parts = line.split(None, 1)
        if len(parts) < 2:
            raise ParseError(f"missing value: {line!r}")
        name, rest = parts[0], parts[1]
        prefix = name
        if names is not None and name not in names:
            return (1, prefix)
        name = _memo_str(name)  # post-filter, same rationale as above
        labels = {}
    if not name:
        raise ParseError(f"missing metric name: {line!r}")
    value_str = rest.split()[0] if rest else ""
    if not value_str:
        raise ParseError(f"missing value: {line!r}")
    try:
        value = float(value_str)
    except ValueError as e:
        raise ParseError(f"bad value {value_str!r}: {line!r}") from e
    return (2, prefix, name, labels, value)


def parse_exposition(
    text: str, names: "frozenset[str] | set[str] | None" = None
) -> Iterator[ParsedSample]:
    """Yield every sample in an exposition body. ``# HELP``/``# TYPE``/other
    comments are skipped; trailing timestamps are accepted and dropped.

    ``names``: optional sample-name filter. Lines whose name is not in the
    set are skipped BEFORE label/value parsing — a consumer that folds a
    handful of families out of a 4k-line body (the slice aggregator reads
    6) skips ~half its parse cost. Malformed *skipped* lines are therefore
    not diagnosed; the aggregator trades that for round latency.

    Lines split on ``\\n`` ONLY — ``str.splitlines()`` also breaks on
    \\v/\\f/U+0085/U+2028…, all of which may legally appear *unescaped*
    inside a label value (the exposition format escapes only ``\\n``,
    ``\\"`` and ``\\\\``)."""
    for raw in text.split("\n"):
        line = raw.strip()
        if not line or line[0] == "#":
            continue
        ent = _parse_line(line, names)
        if ent[0] == 2:
            # Copy here, at the public boundary: ParsedSample callers own
            # their labels dict; _parse_line's is shared with the block
            # cache and with other lines using the same block.
            yield ParsedSample(ent[2], dict(ent[3]), ent[4])


class LayoutCache:
    """One scrape target's parsed line structure, reused across rounds.

    Exposition bodies are layout-stable between churn events: the same
    lines in the same order, only sample VALUES changing (the insight the
    exporter's PrefixCache exploits on the render side — VERDICT r4 #6
    applies it to the parse side). :func:`parse_exposition_layout` compares
    each line's prefix to the previous round's and, on match, re-parses
    only the value — no label-block parsing, no global cache contention,
    no per-round dict building. Memory: holds roughly one body's worth of
    strings + label dicts per target.

    ``entries`` is a list of per-line tuples:
      ``(0, line)``                 verbatim line (comment/blank) — skip
      ``(1, prefix)``               name-filtered sample line — skip
      ``(2, prefix, name, labels)`` consumed sample — labels dict SHARED

    The ``native_*`` slots cache the ctypes views libtpumon's whole-body
    fast path needs (see ``metrics/native.py::parse_layout``); they are
    rebuilt whenever ``entries`` is swapped (``native_built_for`` tracks
    the list identity) and the ``samples_template`` gives the (name,
    labels) pair for each kind-2 entry in order.
    """

    __slots__ = (
        "entries", "max_entries", "oversize_logged", "native_built_for",
        "native_keybytes", "native_keys", "native_klens", "native_kinds",
        "native_out", "samples_template",
    )

    def __init__(self, max_entries: int = 32768) -> None:
        self.entries: list[tuple] = []
        # Memory ceiling: a cached layout holds roughly the body's strings
        # plus per-line tuples (~60 KB per 1k lines measured), so an
        # unbounded cache lets one pathological target grow a sidecar
        # without limit. Bodies beyond the cap simply parse the slow path
        # every round (correct, just uncached). 32k lines ≈ 7× a
        # 256-chip exporter body.
        self.max_entries = max_entries
        self.oversize_logged = False
        self.samples_template: list[tuple] | None = None
        self.drop_native()

    def drop_native(self) -> None:
        """Release the native fast-path buffers + template.

        The single place that knows the full ``native_*`` field list (the
        builder in ``metrics/native.py::parse_layout`` is the other); an
        oversize transition or any future invalidation site calls this so
        a forgotten field can't silently retain a body's worth of encoded
        prefixes."""
        self.native_built_for = None
        self.native_keybytes = None
        self.native_keys = None
        self.native_klens = None
        self.native_kinds = None
        self.native_out = None
        self.samples_template = None


def _native_parse_layout(layout: "LayoutCache", text: str) -> "list[float] | None":
    try:
        from tpu_pod_exporter_torch.metrics import native
    except ImportError:  # partial deployment: the parser must not die
        return None
    return native.parse_layout(layout, text)


def parse_exposition_layout(
    text: str,
    names: "frozenset[str] | set[str]",
    layout: LayoutCache,
) -> "list[tuple[str, dict[str, str], float]]":
    """Like ``list(parse_exposition(text, names))`` but layout-cached via
    ``layout`` (see :class:`LayoutCache`), returning plain
    ``(name, labels, value)`` tuples (ParsedSample construction is
    measurable at 164k samples/round) whose ``labels`` dicts are SHARED
    with the cache: callers must treat them as frozen. Any line that
    diverges from the cached layout (churn, a new exporter version, the
    first round) falls back to the full parser for the rest of the body;
    the rebuilt layout serves the next round. On ParseError the cache is
    left untouched (the next round re-parses)."""
    # Oversize pre-check: the rebuilt entry list would hold exactly one
    # tuple per line, so the line count alone decides cacheability. Bodies
    # over the cap parse a bare loop with NO layout maintenance — the old
    # path built the full new_entries list every round only to throw it
    # away at the cap check (code-review r5). A body that later shrinks
    # under the cap re-enters the cache on its next round.
    if text.count("\n") + 1 > layout.max_entries:
        # Parse FIRST (delegating to parse_exposition keeps the line
        # grammar in one place; ParsedSample is a tuple subclass, and a
        # micro-optimized plain tuple matters least on this once-per-round
        # fallback), touch the cache only on success — a ParseError here
        # must leave the warm layout intact per this function's contract.
        out = list(parse_exposition(text, names))
        if not layout.oversize_logged:
            layout.oversize_logged = True
            _warn_oversize(text.count("\n") + 1, layout.max_entries)
        if layout.entries:
            # Transition small->oversize: drop the cached layout AND the
            # native ctypes buffers/template — they hold a body's worth
            # of encoded prefixes, exactly what the cap bounds.
            layout.entries = []
            layout.drop_native()
        return out
    entries = layout.entries
    if entries:
        # Whole-body native fast path: on a perfect byte-level match of
        # every line (values aside), C returns just the values and the
        # cached (name, labels) template supplies the rest — no per-line
        # Python at all. Any divergence returns None and this function's
        # own per-line hit path (below) takes over.
        values = _native_parse_layout(layout, text)
        if values is not None:
            tmpl = layout.samples_template
            return [
                (name, labels, v)
                for (name, labels), v in zip(tmpl, values)
            ]
    n_cached = len(entries)
    # Lazily materialized: a fully-aligned round (the steady state) never
    # builds a new list at all — entries[:kept] stays the layout.
    new_entries: list[tuple] | None = None
    out: list[tuple[str, dict[str, str], float]] = []
    kept = 0  # entries[:kept] verified against this body so far
    aligned = True
    for raw in text.split("\n"):
        line = raw.strip()
        if aligned and kept < n_cached:
            ent = entries[kept]
            kind = ent[0]
            if kind == 0:
                if line == ent[1]:
                    kept += 1
                    continue
            else:
                pfx = ent[1]
                lp = len(pfx)
                # startswith + a boundary check: the char after the prefix
                # must be whitespace, so name "m" can never claim "m2 1"
                # and a labeled prefix only matches its exact series.
                if (
                    len(line) > lp
                    and (line[lp] == " " or line[lp] == "\t")
                    and line.startswith(pfx)
                ):
                    if kind == 1:
                        kept += 1
                        continue
                    tail = line[lp + 1 :]
                    value = None
                    try:
                        value = float(tail)  # common case: no timestamp
                    except ValueError:
                        # A brace in the tail changes the line's brace
                        # grammar entirely (the reference parser's rfind
                        # would pick a different block) — never a hit.
                        if "{" not in tail and "}" not in tail:
                            vs = tail.split()
                            if vs:
                                try:
                                    value = float(vs[0])  # timestamp dropped
                                except ValueError:
                                    value = None  # slow path diagnoses
                    if value is not None:
                        out.append((ent[2], ent[3], value))
                        kept += 1
                        continue
            # Mismatch: the body's shape changed at this line. Positional
            # alignment is gone for good (an inserted/deleted line shifts
            # everything), so slow-parse the rest of the body this round.
            aligned = False

        # ---- slow path: full parse of this line + entry rebuild --------
        if new_entries is None:
            new_entries = list(entries[:kept])
        if not line or line[0] == "#":
            new_entries.append((0, line))
            continue
        ent = _parse_line(line, names)
        if ent[0] == 2:
            out.append((ent[2], ent[3], ent[4]))
            new_entries.append((2, ent[1], ent[2], ent[3]))
        else:
            new_entries.append(ent)
    if new_entries is not None:
        # The oversize pre-check above guarantees len(new_entries) — one
        # tuple per line — is within layout.max_entries here.
        layout.entries = new_entries
    elif kept != n_cached:
        layout.entries = entries[:kept]  # body shrank, still aligned
    if layout.oversize_logged:
        # Body shrank back under the cap AND this round parsed cleanly
        # (a ParseError above must leave all cache state untouched, flag
        # included): clear the state here, at the success point, so
        # debug_vars' layout_oversize reports the CURRENT condition and a
        # later genuine re-oversize warns again (code-review r5 — a
        # sticky flag sent operators chasing a slow-path problem that no
        # longer existed; an early clear misreported a torn under-cap
        # scrape as recovery).
        layout.oversize_logged = False
    return out


def parse_families(text: str) -> dict[str, list[ParsedSample]]:
    """Samples grouped by family name (counter samples keep their ``_total``
    suffix — this is the text format's sample name, not the OpenMetrics
    family abstraction)."""
    out: dict[str, list[ParsedSample]] = {}
    for s in parse_exposition(text):
        out.setdefault(s.name, []).append(s)
    return out
