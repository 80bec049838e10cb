"""The cases of tests/test_render_splice.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

Incremental exposition render: splice correctness.

The ExpositionTemplate keeps the whole text body as pre-rendered per-family
byte blocks and splices only changed float cells per poll. These tests pin
the one contract everything rests on: the spliced body is BYTE-IDENTICAL to
a from-scratch full render of the same snapshot — across value changes,
cell-width changes, layout-generation changes (labels added/evicted,
conditional families appearing and emptying), special float values, and a
seeded randomized sweep — and the per-encoding (gzip / OpenMetrics) caches
are invalidated exactly when the identity bytes change and shared exactly
when they do not.
"""

from __future__ import annotations

import gzip
import random

from tpu_pod_exporter_torch.metrics.registry import (
    COUNTER,
    MetricSpec,
    PrefixCache,
    SnapshotBuilder,
)

GAUGE_SPEC = MetricSpec(
    name="splice_test_gauge",
    help="a labeled gauge",
    label_names=("chip", "pod"),
)
SCALAR_SPEC = MetricSpec(name="splice_test_scalar", help="an unlabeled gauge")
COUNTER_SPEC = MetricSpec(
    name="splice_test_ops_total",
    help="a counter (OpenMetrics header rewrite path)",
    type=COUNTER,
    label_names=("kind",),
)
CONDITIONAL_SPEC = MetricSpec(
    name="splice_test_conditional",
    help="a family that appears mid-run",
    label_names=("reason",),
)


def build(data, cache=None, timestamp=1.0):
    """One poll's snapshot from ``data``: a list of (spec, samples) pairs
    in family order, samples keyed by pre-ordered label-value tuples."""
    b = SnapshotBuilder(prefix_cache=cache)
    for spec, samples in data:
        b.declare(spec)
        fam = b.series(spec)
        for lvs, v in samples.items():
            fam[lvs] = v
    return b.build(timestamp=timestamp)


def assert_matches_full_render(data, cache):
    """The core invariant: the spliced body equals a from-scratch render of
    the same data, in every (format, encoding) pair."""
    spliced = build(data, cache)
    reference = build(data)  # no cache: the full re-render path
    assert spliced.encode() == reference.encode()
    assert spliced.encode_openmetrics() == reference.encode_openmetrics()
    assert gzip.decompress(spliced.encode_gzip()) == reference.encode()
    assert (
        gzip.decompress(spliced.encode_openmetrics_gzip())
        == reference.encode_openmetrics()
    )
    return spliced


class TestSpliceByteIdentical:
    def test_value_changes_steady_layout(self):
        cache = PrefixCache()
        data = [
            (GAUGE_SPEC, {("0", "a"): 1.5, ("1", "a"): 2.0}),
            (SCALAR_SPEC, {(): 7.0}),
        ]
        assert_matches_full_render(data, cache)
        # Same layout, same-width new values: pure cell splices.
        data = [
            (GAUGE_SPEC, {("0", "a"): 2.5, ("1", "a"): 2.0}),
            (SCALAR_SPEC, {(): 8.0}),
        ]
        assert_matches_full_render(data, cache)
        tmpl = cache.template
        assert tmpl is not None and tmpl.spliced_cells >= 2

    def test_cell_width_change_rebuilds_block(self):
        cache = PrefixCache()
        data = [(GAUGE_SPEC, {("0", "a"): 1.0, ("1", "a"): 2.0})]
        assert_matches_full_render(data, cache)
        # 1 -> 123456.75: wider cell, the block must re-join cleanly.
        data = [(GAUGE_SPEC, {("0", "a"): 123456.75, ("1", "a"): 2.0})]
        assert_matches_full_render(data, cache)
        # and narrower again
        data = [(GAUGE_SPEC, {("0", "a"): 3.0, ("1", "a"): 2.0})]
        assert_matches_full_render(data, cache)
        assert cache.template.rebuilt_blocks >= 1

    def test_labels_added_and_evicted(self):
        cache = PrefixCache()
        gen0 = cache.template.generation
        data = [(GAUGE_SPEC, {("0", "a"): 1.0})]
        assert_matches_full_render(data, cache)
        # Series added (pod churn: a new label set appears).
        data = [(GAUGE_SPEC, {("0", "a"): 1.0, ("0", "b"): 2.0})]
        assert_matches_full_render(data, cache)
        # Series evicted (structural GC: the old pod's series vanish).
        data = [(GAUGE_SPEC, {("0", "b"): 2.5})]
        assert_matches_full_render(data, cache)
        assert cache.template.generation > gen0

    def test_conditional_family_appears_and_empties(self):
        cache = PrefixCache()
        base = [(GAUGE_SPEC, {("0", "a"): 1.0})]
        assert_matches_full_render(base, cache)
        # A conditional surface appears mid-run (declared + sampled).
        data = base + [(CONDITIONAL_SPEC, {("oom",): 1.0})]
        assert_matches_full_render(data, cache)
        # It stays declared but loses all samples: header-only block.
        data = base + [(CONDITIONAL_SPEC, {})]
        assert_matches_full_render(data, cache)
        # And comes back.
        data = base + [(CONDITIONAL_SPEC, {("evict",): 2.0})]
        assert_matches_full_render(data, cache)

    def test_special_float_values(self):
        cache = PrefixCache()
        data = [(GAUGE_SPEC, {("0", "a"): 1.0, ("1", "a"): 2.0})]
        assert_matches_full_render(data, cache)
        data = [(GAUGE_SPEC, {
            ("0", "a"): float("nan"), ("1", "a"): float("inf"),
        })]
        assert_matches_full_render(data, cache)
        data = [(GAUGE_SPEC, {
            ("0", "a"): float("-inf"), ("1", "a"): -0.0,
        })]
        assert_matches_full_render(data, cache)

    def test_escaped_label_values(self):
        cache = PrefixCache()
        data = [(GAUGE_SPEC, {
            ('quo"te', "a"): 1.0,
            ("back\\slash", "a"): 2.0,
            ("new\nline", "a"): 3.0,
        })]
        assert_matches_full_render(data, cache)
        data = [(GAUGE_SPEC, {
            ('quo"te', "a"): 4.0,
            ("back\\slash", "a"): 2.0,
            ("new\nline", "a"): 3.0,
        })]
        assert_matches_full_render(data, cache)

    def test_splice_disabled_still_identical(self):
        cache = PrefixCache(splice=False)
        assert cache.template is None
        data = [
            (GAUGE_SPEC, {("0", "a"): 1.0}),
            (COUNTER_SPEC, {("x",): 10.0}),
        ]
        assert_matches_full_render(data, cache)
        data = [
            (GAUGE_SPEC, {("0", "a"): 2.0}),
            (COUNTER_SPEC, {("x",): 11.0}),
        ]
        assert_matches_full_render(data, cache)


class TestEncodingCacheInvalidation:
    def test_unchanged_polls_share_the_bodyset(self):
        """Byte-identical consecutive polls reuse the SAME BodySet: the
        gzip compressed at poll N is served verbatim at poll N+k."""
        cache = PrefixCache()
        data = [(GAUGE_SPEC, {("0", "a"): 1.0})]
        s1 = build(data, cache)
        s1.encode()
        gz1 = s1.encode_gzip()
        om1 = s1.encode_openmetrics()
        s2 = build(data, cache)
        s2.encode()
        assert s2._bodyset is s1._bodyset
        # Derived encodings are already cached — identical objects, no
        # recompression.
        assert s2.encode_gzip() is gz1
        assert s2.encode_openmetrics() is om1
        assert s2.cached_exposition(gzipped=True) is gz1

    def test_changed_bytes_mint_a_new_bodyset(self):
        cache = PrefixCache()
        data = [(GAUGE_SPEC, {("0", "a"): 1.0})]
        s1 = build(data, cache)
        s1.encode()
        gz1 = s1.encode_gzip()
        om1 = s1.encode_openmetrics()
        data = [(GAUGE_SPEC, {("0", "a"): 2.0})]
        s2 = build(data, cache)
        s2.encode()
        assert s2._bodyset is not s1._bodyset
        assert s2._bodyset.revision > s1._bodyset.revision
        # Fresh revision: stale encodings must not be served.
        assert s2.cached_exposition(gzipped=True) is None
        gz2 = s2.encode_gzip()
        assert gz2 is not gz1
        assert gzip.decompress(gz2) == s2.encode()
        assert s2.encode_openmetrics() != om1
        # The earlier snapshot still serves ITS revision untouched.
        assert gzip.decompress(gz1) == s1.encode()

    def test_nan_cells_do_not_churn_the_bodyset(self):
        """A NaN value compares unequal to itself every poll but renders
        the same 'NaN' bytes — it must NOT mint a new BodySet per poll
        (that would silently discard the gzip/OpenMetrics caches for a
        byte-identical body)."""
        cache = PrefixCache()
        data = [(GAUGE_SPEC, {("0", "a"): float("nan"), ("1", "a"): 1.0})]
        s1 = build(data, cache)
        s1.encode()
        gz1 = s1.encode_gzip()
        s2 = build(data, cache)
        s2.encode()
        assert s2._bodyset is s1._bodyset
        assert s2.encode_gzip() is gz1

    def test_layout_churn_bumps_generation_and_invalidates(self):
        cache = PrefixCache()
        data = [(GAUGE_SPEC, {("0", "a"): 1.0})]
        s1 = build(data, cache)
        s1.encode()
        s1.encode_gzip()
        g1 = s1._bodyset.generation
        data = [(GAUGE_SPEC, {("0", "a"): 1.0, ("9", "z"): 5.0})]
        s2 = build(data, cache)
        s2.encode()
        assert s2._bodyset.generation > g1
        assert s2.cached_exposition(gzipped=True) is None
        assert gzip.decompress(s2.encode_gzip()) == s2.encode()

    def test_identity_body_cached_at_encode(self):
        """The event-loop inline fast path: after swap-time encode() the
        identity body is served from cache with no render work."""
        cache = PrefixCache()
        s = build([(GAUGE_SPEC, {("0", "a"): 1.0})], cache)
        assert s.cached_exposition() is None  # not yet encoded
        body = s.encode()
        assert s.cached_exposition() is body
        assert s.cached_exposition(openmetrics=True) is None
        om = s.encode_openmetrics()
        assert s.cached_exposition(openmetrics=True) == om


def _random_label(rng: random.Random) -> str:
    pool = ["plain", 'quo"te', "back\\slash", "new\nline", "ünicode", ""]
    return rng.choice(pool) + str(rng.randrange(4))


def _random_value(rng: random.Random) -> float:
    r = rng.random()
    if r < 0.05:
        return float("nan")
    if r < 0.08:
        return float("inf")
    if r < 0.10:
        return float("-inf")
    if r < 0.40:
        return float(rng.randrange(-1000, 1000))  # integer-formatted
    return rng.uniform(-1e12, 1e12)


def test_seeded_property_sweep():
    """Randomized poll sequence (seeded, so failures reproduce): random
    value churn, series add/evict, family appear/empty — every poll's
    spliced body must equal the full re-render, in all four encodings."""
    rng = random.Random(0xC0FFEE)
    cache = PrefixCache()
    specs = [GAUGE_SPEC, SCALAR_SPEC, COUNTER_SPEC, CONDITIONAL_SPEC]
    # Mutable model state the polls evolve.
    samples: dict[str, dict[tuple[str, ...], float]] = {
        GAUGE_SPEC.name: {("0", "a"): 1.0},
        SCALAR_SPEC.name: {(): 0.0},
        COUNTER_SPEC.name: {("x",): 0.0},
        CONDITIONAL_SPEC.name: {},
    }

    def lvs_for(spec: MetricSpec) -> tuple[str, ...]:
        return tuple(_random_label(rng) for _ in spec.label_names)

    for poll in range(60):
        for spec in specs:
            fam = samples[spec.name]
            # value churn on some existing series
            for k in list(fam):
                if rng.random() < 0.5:
                    fam[k] = _random_value(rng)
            # occasional series add / evict (not for the scalar family)
            if spec.label_names:
                if rng.random() < 0.25:
                    fam[lvs_for(spec)] = _random_value(rng)
                if fam and rng.random() < 0.15:
                    fam.pop(rng.choice(list(fam)))
        data = [(spec, dict(samples[spec.name])) for spec in specs]
        spliced = assert_matches_full_render(data, cache)
        assert spliced._bodyset is not None
    stats = cache.template.stats()
    # The sweep must actually exercise the incremental machinery, not
    # fall through to full rebuilds every poll.
    assert stats["polls"] == 60  # the no-cache reference renders bypass it
    assert stats["spliced_cells"] > 0
    assert stats["generation"] > 0
