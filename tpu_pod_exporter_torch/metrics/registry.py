"""Snapshot-based metrics model with Prometheus text exposition.

Design (deliberate delta from the reference, ``main.go:21-42``):

The reference mutates long-lived ``GaugeVec`` cells in place and never deletes
them, so a series for a dead pod persists at its last value forever
(``main.go:147-150``; no ``Delete``/``Reset`` anywhere). Here the collector
builds a complete :class:`Snapshot` every poll and atomically swaps it in.
Stale-series garbage collection is therefore *structural*: a series that is
not re-emitted simply does not exist in the next snapshot. This is the
series-lifecycle semantics the pod-churn config requires.

The snapshot also pre-renders the Prometheus text format once, at poll time.
A scrape serves the cached bytes — O(1), no label formatting, no float
rendering, no lock contention with the poll loop beyond one reference swap.
This preserves (and sharpens) the reference's one good architectural
property: collection decoupled from scraping (``main.go:67-72`` vs the poll
loop at ``main.go:74-157``).

Counters are supported for monotonic device counters (e.g. ICI transferred
bytes); their *state* lives with the owner (the collector), the snapshot just
renders current values.
"""

from __future__ import annotations

import math
import threading
import time
from array import array
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence

try:  # C-speed value-vector diff for the splice render; optional.
    import numpy as _np
except ImportError:  # pragma: no cover - numpy is a declared dependency
    _np = None  # type: ignore[assignment]

GAUGE = "gauge"
COUNTER = "counter"
HISTOGRAM = "histogram"

_VALID_TYPES = (GAUGE, COUNTER, HISTOGRAM)


@dataclass(frozen=True)
class MetricSpec:
    """Static definition of one metric family (name, help, type, label names).

    Analog of the reference's ``prometheus.NewGaugeVec`` options
    (``main.go:22-35``), except label names are part of a frozen schema and
    validated once.
    """

    name: str
    help: str
    type: str = GAUGE
    label_names: tuple[str, ...] = ()
    # Histogram child families (_bucket/_sum/_count) render their sample
    # lines under the PARENT family's single `# TYPE <name> histogram`
    # header, so their own HELP/TYPE lines are suppressed. Everything else
    # about them (layout cache, native render, value formatting) is the
    # ordinary family machinery — that is the point of this representation.
    suppress_header: bool = False
    # Raw-lines family: each sample's label "tuple" is a 1-tuple holding the
    # FULLY pre-rendered series prefix (``name_bucket{phase="x",le="0.1"}``).
    # This is what lets one family carry a histogram's _bucket/_count/_sum
    # lines in the per-label-set order OpenMetrics requires (MetricPoints of
    # one label set must be contiguous) while still riding the FamilyLayout
    # and native render paths, which only ever see opaque prefix bytes.
    raw_lines: bool = False

    def __post_init__(self) -> None:
        if self.type not in _VALID_TYPES:
            raise ValueError(f"metric type must be one of {_VALID_TYPES}: {self.type}")
        if not _valid_metric_name(self.name):
            raise ValueError(f"invalid metric name: {self.name!r}")
        for ln in self.label_names:
            if not _valid_label_name(ln):
                raise ValueError(f"invalid label name: {ln!r}")
        if len(set(self.label_names)) != len(self.label_names):
            raise ValueError(f"duplicate label names in {self.name}")


def _valid_metric_name(name: str) -> bool:
    if not name:
        return False
    head = name[0]
    if not (head.isascii() and (head.isalpha() or head in "_:")):
        return False
    return all(c.isascii() and (c.isalnum() or c in "_:") for c in name[1:])


def _valid_label_name(name: str) -> bool:
    if not name or name.startswith("__"):
        return False
    head = name[0]
    if not (head.isascii() and (head.isalpha() or head == "_")):
        return False
    return all(c.isascii() and (c.isalnum() or c == "_") for c in name[1:])


def escape_label_value(value: str) -> str:
    # NUL would truncate the line in the native (C-string) render path and
    # is meaningless in a label; strip it from untrusted input.
    return (
        value.replace("\x00", "")
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def escape_help(value: str) -> str:
    return value.replace("\x00", "").replace("\\", "\\\\").replace("\n", "\\n")


def format_value(value: float) -> str:
    """Render a sample value the way Prometheus expects."""
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if value == int(value) and abs(value) < 2**53:
        return str(int(value))
    return repr(float(value))


@dataclass
class _Family:
    spec: MetricSpec
    # label-values-tuple -> value; insertion order is emission order
    samples: dict[tuple[str, ...], float] = field(default_factory=dict)


def render_prefix(spec: MetricSpec, lvs: tuple[str, ...]) -> bytes:
    """The `metric{label="…"}` part of one exposition line — the single
    source of truth for both the cached and uncached render paths."""
    if spec.raw_lines:
        return lvs[0].encode()
    if not spec.label_names and not lvs:
        return spec.name.encode()
    if len(lvs) != len(spec.label_names):
        raise ValueError(
            f"{spec.name}: got {len(lvs)} label values, "
            f"want {len(spec.label_names)}"
        )
    for lv in lvs:
        if type(lv) is not str:
            raise TypeError(f"{spec.name}: label value {lv!r} is not str")
    pairs = ",".join(
        f'{ln}="{escape_label_value(lv)}"'
        for ln, lv in zip(spec.label_names, lvs)
    )
    return f"{spec.name}{{{pairs}}}".encode()


class FamilyLayout:
    """One family's frozen series order plus everything derivable from it.

    Between churn events the key sequence of a family is identical poll to
    poll, so the per-series prefixes, the ctypes pointer array the native
    renderer needs, and even the fully rendered text block (when the values
    did not change either — HBM totals, chip counts, info series) can all be
    reused byte-for-byte. Mutated only by the poll thread (inside
    ``Snapshot.encode`` at swap time), never by scrape threads.
    """

    __slots__ = (
        "keys", "prefixes", "native_arr", "plens_arr", "prefix_total",
        "last_values", "last_block", "out_buf",
    )

    def __init__(self, keys: tuple[tuple[str, ...], ...], prefixes: list[bytes]) -> None:
        self.keys = keys
        self.prefixes = prefixes
        self.native_arr = None  # lazily-built ctypes c_char_p array
        self.plens_arr = None   # lazily-built ctypes c_int array of prefix lengths
        self.prefix_total = sum(map(len, prefixes))
        self.last_values: list[float] | None = None
        self.last_block: bytes | None = None
        self.out_buf = None  # reused ctypes render buffer (native path)


class PrefixCache:
    """Rendered `metric{labels}` byte-prefixes, shared across polls.

    Label sets are stable between churn events, so escaping + joining each
    series' label block every poll is pure waste — the dominant CPU cost at
    256 chips. Keyed by (metric name, label values tuple). Bounded: when the
    cache outgrows ``max_entries`` it is cleared wholesale (churned-away
    label sets would otherwise accumulate forever).

    Also home of the per-family :class:`FamilyLayout` records (the next
    caching tier up): per-series prefixes answer "how does this label set
    render", layouts answer "what is this family's exact series order".
    """

    def __init__(self, max_entries: int = 65536, splice: bool = True) -> None:
        self._cache: dict[tuple[str, tuple[str, ...]], bytes] = {}
        self._layouts: dict[str, FamilyLayout] = {}
        self._max = max_entries
        # Incremental exposition render: one template of the
        # whole body is kept across polls and only changed value cells are
        # spliced per snapshot. splice=False restores the per-family
        # layout-block render (the pre-splice behaviour).
        self.template: ExpositionTemplate | None = (
            ExpositionTemplate(self) if splice else None
        )

    def prefix(self, spec: MetricSpec, lvs: tuple[str, ...]) -> bytes:
        key = (spec.name, lvs)
        p = self._cache.get(key)
        if p is None:
            p = render_prefix(spec, lvs)
            if len(self._cache) >= self._max:
                self._cache.clear()
            self._cache[key] = p
        return p

    def layout(self, spec: MetricSpec, keys: tuple[tuple[str, ...], ...]) -> FamilyLayout:
        rec = self._layouts.get(spec.name)
        if rec is not None and rec.keys == keys:
            return rec
        pfx = self.prefix
        rec = FamilyLayout(keys, [pfx(spec, k) for k in keys])
        self._layouts[spec.name] = rec
        return rec


class BodySet:
    """Per-encoding rendered bodies for ONE splice revision of the template.

    A new BodySet is minted every time the template's bytes actually change
    (a cell splice, a block rebuild, a layout churn) — that is the whole
    invalidation story for the per-encoding caches: gzip and OpenMetrics
    variants are derived lazily on first request and live exactly as long
    as the identity body they encode. When consecutive polls produce
    byte-identical expositions the SAME BodySet is handed to each snapshot,
    so a gzip compressed for poll N is still served at poll N+k.

    Lock-free by design: the optional fields are filled by plain attribute
    stores (GIL-atomic). Two scrape threads racing the first gzip may both
    compress; the results are byte-identical and the second store wins —
    duplicate work once, never a lock held across compression (this
    supersedes the old lazy-compress-under-lock idiom and its lock-io
    lint escapes).
    """

    __slots__ = ("text", "revision", "generation", "openmetrics",
                 "text_gzip", "openmetrics_gzip")

    def __init__(self, text: bytes, revision: int, generation: int) -> None:
        self.text = text
        self.revision = revision
        self.generation = generation
        self.openmetrics: bytes | None = None
        self.text_gzip: bytes | None = None
        self.openmetrics_gzip: bytes | None = None


class _TemplateFamily:
    """One family's slice of the exposition template: the rendered sample
    block plus everything needed to splice new values into it in place."""

    __slots__ = ("spec", "layout", "header", "values", "cells", "offsets",
                 "buf")

    def __init__(self, spec: MetricSpec, layout: FamilyLayout | None,
                 header: bytes) -> None:
        self.spec = spec
        self.layout = layout
        self.header = header
        self.values: array = array("d")
        # Formatted value bytes per series, aligned with layout.keys.
        self.cells: list[bytes] = []
        # Byte offset of each value cell inside ``buf``.
        self.offsets: list[int] = []
        self.buf = bytearray()

    def rebuild(self, values: array) -> None:
        """Re-render the block from prefixes + current cell bytes. Called
        when the layout changed or a cell's formatted width changed; cells
        for unchanged values are reused, so the cost is the byte join, not
        re-formatting every float."""
        layout = self.layout
        assert layout is not None
        cells = self.cells
        parts: list[bytes] = []
        offsets: list[int] = []
        off = 0
        for prefix, cell in zip(layout.prefixes, cells):
            parts.append(prefix)
            parts.append(b" ")
            parts.append(cell)
            parts.append(b"\n")
            off += len(prefix) + 1
            offsets.append(off)
            off += len(cell) + 1
        self.buf = bytearray(b"".join(parts))
        self.offsets = offsets
        self.values = values


class ExpositionTemplate:
    """Pre-rendered exposition bytes spliced incrementally across polls.

    The template holds the full text-format body as per-family blocks keyed
    by the layout generation: between churn events the series set and order
    of every family are identical poll to poll, so the only bytes that can
    differ are the float cells. Per poll the value vector of each family is
    diffed (C-level via numpy when available), changed cells are formatted
    and spliced into the block bytearray in place when the width matches,
    and a block is re-joined from cached line fragments when a width
    changed. A layout change (labels added/evicted, a conditional surface
    appearing) bumps ``generation`` and rebuilds the affected family from
    its prefixes.

    Thread contract: mutated only by the thread that calls
    :meth:`Snapshot.encode` at swap time (the poll loop) — the same
    single-writer rule the FamilyLayout cache always had. Scrape threads
    only ever see the immutable bytes handed out through a :class:`BodySet`.
    """

    __slots__ = ("_cache", "_records", "_headers", "_bodyset", "generation",
                 "revision", "polls", "spliced_cells", "rebuilt_blocks",
                 "reused_blocks", "family_rebuilds")

    # numpy wins over the Python zip-loop diff from roughly this many
    # series (measured; below it the frombuffer overhead dominates).
    _NUMPY_DIFF_MIN = 64

    def __init__(self, cache: PrefixCache) -> None:
        self._cache = cache
        self._records: list[_TemplateFamily] = []
        self._headers: dict[str, bytes] = {}
        self._bodyset: BodySet | None = None
        self.generation = 0   # bumped on any layout/family-set change
        self.revision = 0     # bumped whenever the body bytes change
        self.polls = 0
        self.spliced_cells = 0
        self.rebuilt_blocks = 0
        self.reused_blocks = 0
        self.family_rebuilds = 0

    def stats(self) -> dict[str, int]:
        """Render-cache counters for /debug/vars (RUNBOOK 'render')."""
        return {
            "generation": self.generation,
            "revision": self.revision,
            "polls": self.polls,
            "families": len(self._records),
            "spliced_cells": self.spliced_cells,
            "rebuilt_blocks": self.rebuilt_blocks,
            "reused_blocks": self.reused_blocks,
            "family_rebuilds": self.family_rebuilds,
        }

    def _header_for(self, spec: MetricSpec) -> bytes:
        if spec.suppress_header:
            return b""
        h = self._headers.get(spec.name)
        if h is None:
            h = (f"# HELP {spec.name} {escape_help(spec.help)}\n"
                 f"# TYPE {spec.name} {spec.type}\n").encode()
            self._headers[spec.name] = h
        return h

    def _build_family(self, spec: MetricSpec,
                      samples: dict[tuple[str, ...], float]) -> _TemplateFamily:
        self.family_rebuilds += 1
        if not samples:
            return _TemplateFamily(spec, None, self._header_for(spec))
        layout = self._cache.layout(spec, tuple(samples))
        rec = _TemplateFamily(spec, layout, self._header_for(spec))
        values = array("d", samples.values())
        rec.cells = [format_value(v).encode() for v in values]
        rec.rebuild(values)
        return rec

    def _changed_indices(self, old: array, new: array) -> list[int]:
        if _np is not None and len(new) >= self._NUMPY_DIFF_MIN:
            a = _np.frombuffer(old, dtype=_np.float64)
            b = _np.frombuffer(new, dtype=_np.float64)
            # NaN cells compare unequal every poll; _splice_family skips
            # them once their formatted bytes come out identical.
            return _np.nonzero(a != b)[0].tolist()  # type: ignore[no-any-return]
        return [i for i, (x, y) in enumerate(zip(old, new)) if x != y]

    def _splice_family(self, rec: _TemplateFamily,
                       samples: dict[tuple[str, ...], float]) -> bool:
        """Fold one family's new values into its block. True if bytes
        changed."""
        new_values = array("d", samples.values())
        if new_values == rec.values:
            self.reused_blocks += 1
            return False
        idxs = self._changed_indices(rec.values, new_values)
        if not idxs:
            # Only representation-stable differences (NaN vs NaN compares
            # unequal in the array fallback; numpy path returns them).
            rec.values = new_values
            self.reused_blocks += 1
            return False
        cells = rec.cells
        resize = False
        dirty = []
        for i in idxs:
            cell = format_value(new_values[i]).encode()
            if cell == cells[i]:
                # Representation-stable difference: a NaN cell compares
                # unequal every poll but renders the same "NaN" bytes.
                # Counting it as a change would mint a new BodySet per
                # poll and discard the gzip/OpenMetrics caches for a
                # byte-identical body.
                continue
            if len(cell) != len(cells[i]):
                resize = True
            cells[i] = cell
            dirty.append(i)
        if not dirty:
            rec.values = new_values
            self.reused_blocks += 1
            return False
        if resize:
            rec.rebuild(new_values)
            self.rebuilt_blocks += 1
            return True
        buf = rec.buf
        offsets = rec.offsets
        for i in dirty:
            off = offsets[i]
            buf[off:off + len(cells[i])] = cells[i]
        rec.values = new_values
        self.spliced_cells += len(dirty)
        return True

    def render(self, snapshot: "Snapshot") -> tuple[bytes, BodySet]:
        """Produce the full text body for ``snapshot``, reusing the
        template. Returns the immutable body plus the BodySet carrying its
        per-encoding caches."""
        self.polls += 1
        families = snapshot._families
        records = self._records
        specs = [f.spec for f in families.values()]
        aligned = (
            len(records) == len(specs)
            and all(
                r.spec is s or r.spec == s
                for r, s in zip(records, specs)
            )
        )
        changed = False
        if not aligned:
            # Family set or order changed: new layout generation, rebuild
            # the whole record list (prefixes still come from the cache).
            self.generation += 1
            records = [
                self._build_family(fam.spec, fam.samples)
                for fam in families.values()
            ]
            self._records = records
            changed = True
        else:
            for idx, fam in enumerate(families.values()):
                rec = records[idx]
                if not fam.samples:
                    if rec.layout is not None or rec.buf:
                        # Series all churned away: header-only block now.
                        self.generation += 1
                        records[idx] = self._build_family(fam.spec, {})
                        changed = True
                    continue
                layout = self._cache.layout(fam.spec, tuple(fam.samples))
                if layout is not rec.layout:
                    self.generation += 1
                    records[idx] = self._build_family(fam.spec, fam.samples)
                    changed = True
                    continue
                if self._splice_family(rec, fam.samples):
                    changed = True
        bodyset = self._bodyset
        if changed or bodyset is None:
            parts: list[bytes | bytearray] = []
            for rec in records:
                if rec.header:
                    parts.append(rec.header)
                if rec.buf:
                    parts.append(rec.buf)
            self.revision += 1
            bodyset = BodySet(b"".join(parts), self.revision, self.generation)
            self._bodyset = bodyset
        return bodyset.text, bodyset


class SnapshotBuilder:
    """Accumulates one poll's worth of samples, then freezes into a Snapshot.

    ``add`` replaces on duplicate label sets (last write wins within a poll,
    which the collector avoids by construction but must not crash on —
    contrast with the reference silently collapsing multi-device series,
    ``main.go:141-155``).
    """

    def __init__(self, prefix_cache: PrefixCache | None = None) -> None:
        self._families: dict[str, _Family] = {}
        self._order: list[str] = []
        self._prefix_cache = prefix_cache

    def declare(self, spec: MetricSpec) -> None:
        """Register a family so it appears (possibly sample-less) in output."""
        existing = self._families.get(spec.name)
        if existing is not None:
            # identity first: specs are module-level singletons on the hot path
            if existing.spec is not spec and existing.spec != spec:
                raise ValueError(f"conflicting redeclaration of {spec.name}")
            return
        self._families[spec.name] = _Family(spec)
        self._order.append(spec.name)

    def add(
        self,
        spec: MetricSpec,
        value: float,
        labels: Mapping[str, str] | Sequence[str] = (),
    ) -> None:
        fam = self._families.get(spec.name)
        if fam is None:
            self.declare(spec)
            fam = self._families[spec.name]
        elif fam.spec is not spec and fam.spec != spec:
            raise ValueError(f"conflicting redeclaration of {spec.name}")
        if type(labels) is tuple:
            # Hot path: pre-ordered tuple of label values. Contract: elements
            # are already strings — enforced where it's cheap, at the first
            # render of a new label set (PrefixCache miss), not per add.
            values = labels
            if len(values) != len(spec.label_names):
                raise ValueError(
                    f"{spec.name}: got {len(values)} label values, "
                    f"want {len(spec.label_names)}"
                )
        elif isinstance(labels, Mapping):
            try:
                values = tuple(str(labels[ln]) for ln in spec.label_names)
            except KeyError as e:
                raise ValueError(f"missing label {e} for {spec.name}") from e
            extra = set(labels) - set(spec.label_names)
            if extra:
                raise ValueError(f"unknown labels {sorted(extra)} for {spec.name}")
        else:
            values = tuple(str(v) for v in labels)
            if len(values) != len(spec.label_names):
                raise ValueError(
                    f"{spec.name}: got {len(values)} label values, "
                    f"want {len(spec.label_names)}"
                )
        fam.samples[values] = float(value)

    def series(self, spec: MetricSpec) -> dict[tuple[str, ...], float]:
        """Direct handle on a family's samples dict, for the collector's hot
        loop: ``series(SPEC)[label_tuple] = value`` is one dict store, vs the
        per-call family lookup + shape checks of :meth:`add`. Caller contract
        (same as the tuple fast path of ``add``): keys are pre-ordered tuples
        of ``str`` matching ``spec.label_names`` — enforced at first render
        of each new label set."""
        self.declare(spec)
        return self._families[spec.name].samples

    @property
    def series_count(self) -> int:
        return sum(len(f.samples) for f in self._families.values())

    def build(self, timestamp: float | None = None, *, transfer: bool = False) -> "Snapshot":
        """Freeze into a Snapshot. With ``transfer=True`` the family dicts are
        handed off instead of copied (the builder resets to empty) — for the
        poll loop, which discards its builder after every poll anyway."""
        if transfer:
            families = {n: self._families[n] for n in self._order}
            self._families = {}
            self._order = []
        else:
            families = {
                n: _Family(self._families[n].spec, dict(self._families[n].samples))
                for n in self._order
            }
        return Snapshot(
            families=families,
            timestamp=time.time() if timestamp is None else timestamp,
            prefix_cache=self._prefix_cache,
        )


class Snapshot:
    """An immutable, pre-rendered view of all series at one poll instant."""

    def __init__(
        self,
        families: dict[str, _Family],
        timestamp: float,
        prefix_cache: "PrefixCache | None" = None,
    ) -> None:
        self._families = families
        self.timestamp = timestamp
        self._prefix_cache = prefix_cache
        self._text: bytes | None = None
        self._gzipped: bytes | None = None
        self._openmetrics: bytes | None = None
        self._openmetrics_gzipped: bytes | None = None
        # Set by the template render path: shares per-encoding bodies
        # (gzip, OpenMetrics) across snapshots whose bytes did not change.
        self._bodyset: BodySet | None = None

    @property
    def series_count(self) -> int:
        return sum(len(f.samples) for f in self._families.values())

    def families(self) -> Iterable[MetricSpec]:
        return (f.spec for f in self._families.values())

    def value(
        self, name: str, labels: Mapping[str, str] | Sequence[str] = ()
    ) -> float | None:
        """Test/introspection helper: value of one series, or None."""
        fam = self._families.get(name)
        if fam is None:
            return None
        if isinstance(labels, Mapping):
            key = tuple(str(labels.get(ln, "")) for ln in fam.spec.label_names)
        else:
            key = tuple(str(v) for v in labels)
        return fam.samples.get(key)

    def samples(self, name: str) -> dict[tuple[str, ...], float]:
        fam = self._families.get(name)
        return dict(fam.samples) if fam is not None else {}

    def samples_view(self, name: str) -> dict[tuple[str, ...], float] | None:
        """Zero-copy handle on one family's samples dict (None when the
        family is absent). Snapshots are immutable after ``build``, so the
        persistence writer thread reads these without copies or locks —
        callers MUST NOT mutate the returned dict."""
        fam = self._families.get(name)
        return fam.samples if fam is not None else None

    def encode(self) -> bytes:
        """Prometheus text exposition format (rendered once, then cached).

        Called by the poll thread at swap time, so scrapes always see cached
        bytes. With a PrefixCache attached, rendering is layout-aware: the
        family's series order is matched against the previous poll's
        :class:`FamilyLayout`; on a hit, per-series prefix lookups and the
        ctypes marshalling are skipped, and when the value vector is also
        unchanged (constant families: HBM totals, chip counts, info) the
        previous rendered block is reused outright. Sample lines go through
        the native renderer (libtpumon) when available; both paths produce
        parser-equivalent output.
        """
        if self._text is not None:
            return self._text
        cache = self._prefix_cache
        if cache is not None and cache.template is not None:
            # Incremental path: splice changed cells into the shared
            # template instead of re-rendering ~1 MB per poll. Single
            # writer (the poll thread) by the template's thread contract.
            self._text, self._bodyset = cache.template.render(self)
            return self._text
        try:
            from tpu_pod_exporter_torch.metrics import native
        except ImportError:  # partial deployment: never let encode() die
            native = None

        chunks: list[bytes] = []
        for fam in self._families.values():
            spec = fam.spec
            if not spec.suppress_header:
                chunks.append(
                    f"# HELP {spec.name} {escape_help(spec.help)}\n"
                    f"# TYPE {spec.name} {spec.type}\n".encode()
                )
            if not fam.samples:
                continue
            if cache is not None:
                layout = cache.layout(spec, tuple(fam.samples))
                # array('d') packs the value vector at C speed; comparison
                # against the previous poll's vector is likewise C-level.
                values = array("d", fam.samples.values())
                if layout.last_block is not None and layout.last_values == values:
                    chunks.append(layout.last_block)
                    continue
                rendered = native.render_layout(layout, values) if native else None
                if rendered is None:
                    rendered = b"".join(
                        p + b" " + format_value(v).encode() + b"\n"
                        for p, v in zip(layout.prefixes, values)
                    )
                layout.last_values = values
                layout.last_block = rendered
                chunks.append(rendered)
                continue
            prefixes = [render_prefix(spec, lvs) for lvs in fam.samples]
            values = list(fam.samples.values())
            rendered = native.render_lines(prefixes, values) if native else None
            if rendered is None:
                rendered = b"".join(
                    p + b" " + format_value(v).encode() + b"\n"
                    for p, v in zip(prefixes, values)
                )
            chunks.append(rendered)
        self._text = b"".join(chunks)
        return self._text

    def encode_openmetrics(self) -> bytes:
        """OpenMetrics 1.0 exposition, derived lazily from the cached 0.0.4
        body. The sample lines are byte-identical between the two formats for
        gauge/counter families; only two things differ: counter HELP/TYPE
        header lines name the family *without* its ``_total`` suffix, and the
        body ends with ``# EOF``. So this is a handful of header rewrites on
        the cached bytes, not a second render."""
        om = self._openmetrics
        if om is not None:
            return om
        bs = self._bodyset
        if bs is not None and bs.openmetrics is not None:
            self._openmetrics = bs.openmetrics
            return bs.openmetrics

        def _rewrite(body: bytes, old: bytes, new: bytes) -> bytes:
            # Anchor the needle on a line start so a HELP text that happens
            # to *contain* "# HELP <name> " can never be rewritten instead
            # of the real header line; the first family's header has no
            # preceding newline and is handled via startswith.
            if body.startswith(old):
                return new + body[len(old):]
            return body.replace(b"\n" + old, b"\n" + new, 1)

        om = self.encode()
        for fam in self._families.values():
            spec = fam.spec
            if spec.type == COUNTER and spec.name.endswith("_total"):
                base = spec.name[: -len("_total")]
                om = _rewrite(
                    om,
                    f"# HELP {spec.name} ".encode(),
                    f"# HELP {base} ".encode(),
                )
                om = _rewrite(
                    om,
                    f"# TYPE {spec.name} counter".encode(),
                    f"# TYPE {base} counter".encode(),
                )
        om = om + b"# EOF\n"
        # Lock-free publish (GIL-atomic stores): two scrape threads racing
        # here both derive byte-identical bodies; the second store wins.
        self._openmetrics = om
        if bs is not None:
            bs.openmetrics = om
        return om

    def encode_openmetrics_gzip(self) -> bytes:
        gz = self._openmetrics_gzipped
        if gz is not None:
            return gz
        bs = self._bodyset
        if bs is not None and bs.openmetrics_gzip is not None:
            self._openmetrics_gzipped = bs.openmetrics_gzip
            return bs.openmetrics_gzip
        import gzip

        gz = gzip.compress(self.encode_openmetrics(), compresslevel=1)
        self._openmetrics_gzipped = gz
        if bs is not None:
            bs.openmetrics_gzip = gz
        return gz

    def encode_gzip(self) -> bytes:
        """Gzipped exposition, compressed lazily on the first gzip-accepting
        scrape of this snapshot (then cached). Compressing eagerly at swap
        time would cost ~2 ms per poll even when Prometheus scrapes far less
        often than the 1 s poll interval; lazily, the cost lands once per
        SPLICE REVISION: the BodySet carries the compressed bytes across
        snapshots whose exposition did not change. Thread-safe without a
        lock — racing scrapers may both compress once (identical output,
        GIL-atomic publish), and no thread ever holds a lock across the
        compression."""
        gz = self._gzipped
        if gz is not None:
            return gz
        bs = self._bodyset
        if bs is not None and bs.text_gzip is not None:
            self._gzipped = bs.text_gzip
            return bs.text_gzip
        import gzip

        gz = gzip.compress(self.encode(), compresslevel=1)
        self._gzipped = gz
        if bs is not None:
            bs.text_gzip = gz
        return gz

    def cached_exposition(self, openmetrics: bool = False,
                          gzipped: bool = False) -> bytes | None:
        """Already-rendered body for one (format, encoding) pair, or None.

        The event-loop server's inline fast path: a scrape whose body is
        already cached (the common case — the poll thread pre-encodes the
        identity body at swap, and gzip/OpenMetrics variants persist on the
        BodySet across unchanged revisions) is served straight off the
        loop with zero blocking work; a None sends the request to a worker
        thread, which may render."""
        bs = self._bodyset
        if openmetrics:
            if gzipped:
                if self._openmetrics_gzipped is not None:
                    return self._openmetrics_gzipped
                return bs.openmetrics_gzip if bs is not None else None
            if self._openmetrics is not None:
                return self._openmetrics
            return bs.openmetrics if bs is not None else None
        if gzipped:
            if self._gzipped is not None:
                return self._gzipped
            return bs.text_gzip if bs is not None else None
        return self._text


EMPTY_SNAPSHOT = Snapshot({}, timestamp=0.0)


class SnapshotStore:
    """The single cross-thread handoff point between poll loop and scrapes.

    The reference relies on prometheus GaugeVec's internal locking for its
    loop-writes/scrape-reads overlap (``main.go:68-72`` vs ``main.go:147-150``).
    Here *all* shared state is one reference guarded by a lock; scrapes never
    observe a half-written poll.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._snapshot: Snapshot = EMPTY_SNAPSHOT

    def swap(self, snapshot: Snapshot) -> None:
        snapshot.encode()  # render once, off the scrape path (gzip is lazy)
        with self._lock:
            self._snapshot = snapshot

    def current(self) -> Snapshot:
        with self._lock:
            return self._snapshot


class HistogramSpec:
    """One histogram family: a header-only parent spec (``TYPE histogram``)
    plus a single raw-lines child family carrying every ``_bucket`` /
    ``_count`` / ``_sum`` sample in OpenMetrics order.

    Exposition shape (Prometheus text format / OpenMetrics 1.0)::

        # HELP name help
        # TYPE name histogram
        name_bucket{...,le="0.005"} 3
        ...
        name_bucket{...,le="+Inf"} 9
        name_count{...} 9
        name_sum{...} 0.123

    One raw-lines family (not three suffix families) because OpenMetrics
    requires a label set's MetricPoints to be contiguous — bucket/count/sum
    must interleave PER LABEL SET, which per-suffix family blocks cannot
    express. The child's samples still ride the existing fast paths
    (FamilyLayout, native renderer) untouched: those only ever see opaque
    prefix bytes. ``buckets`` are finite upper bounds, strictly increasing;
    the ``+Inf`` bucket is implicit (always emitted, equal to ``_count``).
    Strict OpenMetrics additionally forbids ``_sum`` alongside negative
    buckets or observations — every histogram here is a duration, so keep
    bounds and observed values non-negative.
    """

    __slots__ = ("parent", "lines", "label_names", "buckets", "le_values")

    def __init__(
        self,
        name: str,
        help: str,  # noqa: A002 — mirrors MetricSpec
        buckets: Sequence[float],
        label_names: tuple[str, ...] = (),
    ) -> None:
        bs = tuple(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        if any(math.isinf(b) or math.isnan(b) for b in bs):
            raise ValueError(f"{name}: buckets must be finite (+Inf is implicit)")
        if any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(f"{name}: buckets must be strictly increasing")
        if "le" in label_names:
            raise ValueError(f"{name}: 'le' is reserved for the bucket label")
        self.label_names = tuple(label_names)
        self.buckets = bs
        self.le_values = tuple(format_value(b) for b in bs) + ("+Inf",)
        self.parent = MetricSpec(
            name=name, help=help, type=HISTOGRAM, label_names=self.label_names
        )
        # "_lines" is an internal family key, never rendered (header
        # suppressed, prefixes pre-rendered) — it cannot collide with a real
        # exposition name.
        self.lines = MetricSpec(
            name=name + "_lines", help=help, type=GAUGE,
            label_names=("line",), suppress_header=True, raw_lines=True,
        )


class HistogramStore:
    """Observation state for one histogram family, accumulated across polls.

    Like :class:`CounterStore`, state outlives individual snapshots: the
    snapshot model rebuilds every series each poll, so distributions must
    live with an owner. ``observe`` is safe from any thread (scrape handler
    threads observe while the poll thread emits) and cheap enough for the
    scrape path: a bisect plus three adds under a lock.
    """

    def __init__(self, spec: HistogramSpec) -> None:
        self.spec = spec
        self._lock = threading.Lock()
        # label values tuple -> [per-bucket counts (non-cumulative,
        # +Inf last), sum, count]
        self._data: dict[tuple[str, ...], list] = {}
        # label values tuple -> (bucket key-tuples, count key, sum key):
        # the fully rendered series prefixes, built once per label set.
        # Reusing the same key-tuple OBJECTS every emit keeps the
        # FamilyLayout comparison on its fast path.
        self._line_keys: dict[tuple[str, ...], tuple] = {}

    def observe(self, value: float, labels: tuple[str, ...] = ()) -> None:
        idx = bisect_left(self.spec.buckets, value)  # le: value == bound counts
        with self._lock:
            rec = self._data.get(labels)
            if rec is None:
                rec = self._data[labels] = [
                    [0] * (len(self.spec.buckets) + 1), 0.0, 0,
                ]
            rec[0][idx] += 1
            rec[1] += value
            rec[2] += 1

    def _keys_for(self, lvs: tuple[str, ...]) -> tuple:
        cached = self._line_keys.get(lvs)
        if cached is not None:
            return cached
        spec = self.spec
        name = spec.parent.name
        base = ",".join(
            f'{ln}="{escape_label_value(v)}"'
            for ln, v in zip(spec.label_names, lvs)
        )
        sep = base + "," if base else ""
        bucket_keys = tuple(
            (f'{name}_bucket{{{sep}le="{le}"}}',) for le in spec.le_values
        )
        count_key = (f"{name}_count{{{base}}}" if base else f"{name}_count",)
        sum_key = (f"{name}_sum{{{base}}}" if base else f"{name}_sum",)
        cached = (bucket_keys, count_key, sum_key)
        self._line_keys[lvs] = cached
        return cached

    def emit(self, builder: "SnapshotBuilder") -> None:
        """Declare parent + lines families (adjacent, so the sample lines
        sit under the parent's header) and add every label set's current
        cumulative state in OpenMetrics order: per label set, buckets
        ascending, then count, then sum."""
        spec = self.spec
        builder.declare(spec.parent)
        builder.declare(spec.lines)
        with self._lock:
            snap = {
                lvs: (list(rec[0]), rec[1], rec[2])
                for lvs, rec in self._data.items()
            }
        lines_s = builder.series(spec.lines)
        for lvs, (counts, total, n) in snap.items():
            bucket_keys, count_key, sum_key = self._keys_for(lvs)
            cum = 0
            for key, c in zip(bucket_keys, counts):
                cum += c
                lines_s[key] = float(cum)
            lines_s[count_key] = float(n)
            lines_s[sum_key] = total


class CounterStore:
    """Monotonic counter state that outlives individual snapshots.

    Keyed by (metric name, label values). ``observe_total`` accepts an
    absolute device counter (handles resets by clamping to monotonic);
    ``inc`` adds a delta. Stale keys can be pruned by the collector when the
    underlying entity (chip/link) disappears.
    """

    def __init__(self) -> None:
        self._values: dict[tuple[str, tuple[str, ...]], float] = {}
        self._raw: dict[tuple[str, tuple[str, ...]], float] = {}

    def inc(self, name: str, labels: tuple[str, ...], delta: float = 1.0) -> float:
        key = (name, labels)
        self._values[key] = self._values.get(key, 0.0) + max(delta, 0.0)
        return self._values[key]

    def observe_total(self, name: str, labels: tuple[str, ...], raw_total: float) -> float:
        """Fold an absolute monotonic reading into the exported counter.

        If the raw counter goes backwards (device reset, runtime restart) the
        exported counter holds instead of regressing.
        """
        key = (name, labels)
        prev_raw = self._raw.get(key)
        if prev_raw is None:
            self._values.setdefault(key, raw_total if raw_total >= 0 else 0.0)
        else:
            delta = raw_total - prev_raw
            if delta > 0:
                self._values[key] = self._values.get(key, 0.0) + delta
        self._raw[key] = raw_total
        return self._values[key]

    def get(self, name: str, labels: tuple[str, ...]) -> float:
        return self._values.get((name, labels), 0.0)

    def items_for(self, name: str) -> list[tuple[tuple[str, ...], float]]:
        return [(k[1], v) for k, v in self._values.items() if k[0] == name]

    def prune(self, keep: set[tuple[str, tuple[str, ...]]]) -> int:
        """Drop counter state for entities that no longer exist."""
        stale = [k for k in self._values if k not in keep]
        for k in stale:
            self._values.pop(k, None)
            self._raw.pop(k, None)
        return len(stale)
