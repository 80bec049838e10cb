"""The cases of tests/test_properties.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

Property-based tests (hypothesis) for the exposition and counter layers.

SURVEY.md §4 calls for a pytest+hypothesis harness; these lock the two most
corruption-prone invariants:
- any label value / any float survives encode → Prometheus-parser roundtrip,
- CounterStore never regresses regardless of the raw counter sequence.
"""

import math

from hypothesis import HealthCheck, given, settings, strategies as st
from prometheus_client.parser import text_string_to_metric_families

from tpu_pod_exporter_torch.metrics.registry import (
    CounterStore,
    MetricSpec,
    SnapshotBuilder,
    format_value,
)

# Any printable-ish text, plus the escape-relevant characters; NULs are
# stripped by design (they would truncate the native render path).
label_values = st.text(
    alphabet=st.characters(blacklist_categories=("Cs",), blacklist_characters="\x00"),
    max_size=50,
)

finite_floats = st.floats(allow_nan=False, allow_infinity=False, width=64)


class TestExpositionRoundtrip:
    @given(value=label_values, metric_value=finite_floats)
    @settings(max_examples=200, deadline=None)
    def test_any_label_value_roundtrips(self, value, metric_value):
        spec = MetricSpec(name="m", help="h", label_names=("l",))
        b = SnapshotBuilder()
        b.add(spec, metric_value, (value,))
        text = b.build().encode().decode()
        fams = {f.name: f for f in text_string_to_metric_families(text)}
        (sample,) = fams["m"].samples
        assert sample.labels["l"] == value
        assert sample.value == metric_value or (
            math.isnan(sample.value) and math.isnan(metric_value)
        )

    @given(values=st.lists(finite_floats, min_size=1, max_size=20, unique=True))
    @settings(max_examples=100, deadline=None)
    def test_distinct_series_all_survive(self, values):
        spec = MetricSpec(name="m", help="h", label_names=("i",))
        b = SnapshotBuilder()
        for i, v in enumerate(values):
            b.add(spec, v, (str(i),))
        text = b.build().encode().decode()
        fams = {f.name: f for f in text_string_to_metric_families(text)}
        assert len(fams["m"].samples) == len(values)

    @given(v=st.floats(width=64))
    @settings(max_examples=300, deadline=None)
    def test_format_value_roundtrips_every_float(self, v):
        s = format_value(v)
        parsed = float(s.replace("+Inf", "inf").replace("-Inf", "-inf"))
        if math.isnan(v):
            assert math.isnan(parsed)
        else:
            assert parsed == v

    @given(help_text=label_values)
    @settings(max_examples=100, deadline=None)
    def test_any_help_text_parses(self, help_text):
        spec = MetricSpec(name="m", help=help_text)
        b = SnapshotBuilder()
        b.add(spec, 1.0)
        list(text_string_to_metric_families(b.build().encode().decode()))


class TestCounterMonotonicity:
    @given(raws=st.lists(st.floats(min_value=0, max_value=1e15), min_size=1, max_size=50))
    @settings(max_examples=200, deadline=None)
    def test_observe_total_never_regresses(self, raws):
        c = CounterStore()
        prev = 0.0
        for raw in raws:
            out = c.observe_total("n", (), raw)
            assert out >= prev
            prev = out

    @given(
        deltas=st.lists(
            st.floats(min_value=-100, max_value=1e9, allow_nan=False), max_size=50
        )
    )
    @settings(max_examples=100, deadline=None)
    def test_inc_never_regresses(self, deltas):
        c = CounterStore()
        prev = 0.0
        for d in deltas:
            out = c.inc("n", (), d)
            assert out >= prev
            prev = out


class TestOwnParserRoundtrip:
    """Our renderer → OUR parser (metrics/parse.py, the aggregator's input
    path) must agree for any label value and any float — the same invariant
    the prometheus_client parser locks above, now for the in-house parser."""

    @given(value=label_values, metric_value=finite_floats)
    @settings(max_examples=200, deadline=None)
    def test_any_label_value_roundtrips_through_own_parser(self, value, metric_value):
        from tpu_pod_exporter_torch.metrics.parse import parse_exposition

        spec = MetricSpec(name="m", help="h", label_names=("l",))
        b = SnapshotBuilder()
        b.add(spec, metric_value, (value,))
        text = b.build().encode().decode()
        (sample,) = parse_exposition(text)
        assert sample.labels["l"] == value
        assert sample.value == metric_value or (
            math.isnan(sample.value) and math.isnan(metric_value)
        )

    @given(v=st.floats(width=64))
    @settings(max_examples=200, deadline=None)
    def test_every_float_roundtrips_through_own_parser(self, v):
        from tpu_pod_exporter_torch.metrics.parse import parse_exposition

        (sample,) = parse_exposition(f"m {format_value(v)}\n")
        assert sample.value == v or (math.isnan(sample.value) and math.isnan(v))


class TestFastBlockParseEquivalence:
    """The non-regex fast path must be a strict subset of the regex parser:
    wherever it answers at all, the answer is byte-identical; anything it
    declines falls back (so overall accepted grammar never widens)."""

    @given(
        pairs=st.lists(
            st.tuples(
                st.from_regex(r"[A-Za-z_][A-Za-z0-9_]{0,15}", fullmatch=True),
                label_values,
            ),
            min_size=0, max_size=6,
        )
    )
    @settings(max_examples=300)
    def test_fast_path_matches_regex_on_rendered_blocks(self, pairs):
        from tpu_pod_exporter_torch.metrics.parse import (
            _parse_block_fast,
            _parse_block_uncached,
        )

        def esc(v):
            return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")

        block = ",".join(f'{k}="{esc(v)}"' for k, v in pairs)
        want = _parse_block_uncached(block, block)
        got = _parse_block_fast(block)
        if got is not None:
            assert got == want
        # A decline is always safe: the caller falls back to the regex
        # parser (asserted by `want` parsing above), so accepted grammar
        # and results are unchanged. Declines beyond the obvious ones
        # (escapes, no trailing quote) exist — e.g. a value ending in a
        # comma makes the quote-comma split ambiguous, and the fast path
        # correctly refuses rather than guess.

    def test_fast_path_actually_accepts_the_common_shape(self):
        """Guard that the optimization applies at all: the exact block
        shape the collector renders must take the fast path (a regression
        to always-decline would silently lose the perf the path exists
        for)."""
        from tpu_pod_exporter_torch.metrics.parse import _parse_block_fast

        block = (
            'chip_id="0",device_path="/dev/accel0",accelerator="v5p-64",'
            'slice_name="s",host="h0",worker_id="0",pod="p",namespace="ml",'
            'container="main"'
        )
        assert _parse_block_fast(block) == {
            "chip_id": "0", "device_path": "/dev/accel0",
            "accelerator": "v5p-64", "slice_name": "s", "host": "h0",
            "worker_id": "0", "pod": "p", "namespace": "ml",
            "container": "main",
        }

    @given(block=st.text(max_size=60))
    @settings(max_examples=300)
    def test_fast_path_never_accepts_what_regex_rejects(self, block):
        from tpu_pod_exporter_torch.metrics.parse import (
            ParseError,
            _parse_block_fast,
            _parse_block_uncached,
        )

        got = _parse_block_fast(block)
        if got is None:
            return
        try:
            want = _parse_block_uncached(block, block)
        except ParseError:
            raise AssertionError(
                f"fast path accepted a block the regex rejects: {block!r}"
            ) from None
        assert got == want


class TestHistogramInvariants:
    """Histogram exposition invariants for ANY observation sequence:
    buckets cumulative non-decreasing, +Inf bucket == _count, _sum == the
    float sum, and the strict OpenMetrics parser accepts the output."""

    # Non-negative domain: strict OpenMetrics forbids a histogram _sum with
    # negative buckets or observations, and every histogram this exporter
    # defines is a duration (>= 0 by construction).
    @given(
        observations=st.lists(
            st.floats(min_value=0.0, max_value=1e6, allow_nan=False),
            min_size=1, max_size=100,
        )
    )
    @settings(max_examples=100, deadline=None)
    def test_histogram_invariants_hold(self, observations):
        from prometheus_client.openmetrics.parser import (
            text_string_to_metric_families as om_parse,
        )

        from tpu_pod_exporter_torch.metrics.registry import (
            HistogramSpec,
            HistogramStore,
        )

        spec = HistogramSpec(
            name="h", help="h", buckets=(0.0, 0.5, 100.0)
        )
        store = HistogramStore(spec)
        for v in observations:
            store.observe(v)
        b = SnapshotBuilder()
        store.emit(b)
        om = b.build(timestamp=1.0).encode_openmetrics().decode()
        fams = {f.name: f for f in om_parse(om)}
        fam = fams["h"]
        assert fam.type == "histogram"
        buckets = [s for s in fam.samples if s.name == "h_bucket"]
        counts = [s.value for s in buckets]
        assert counts == sorted(counts)  # cumulative, non-decreasing
        count = next(s.value for s in fam.samples if s.name == "h_count")
        assert buckets[-1].labels["le"] == "+Inf"
        assert buckets[-1].value == count == len(observations)
        total = next(s.value for s in fam.samples if s.name == "h_sum")
        assert math.isclose(total, math.fsum(observations), rel_tol=1e-9, abs_tol=1e-6)
        # Exact bucket math, recomputed independently: each le bucket holds
        # the number of observations <= bound.
        for s, bound in zip(buckets[:-1], spec.buckets):
            assert s.value == sum(1 for v in observations if v <= bound)


class TestLayoutParserDifferential:
    """parse_exposition_layout must agree with parse_exposition on EVERY
    body — including corrupted ones — through any warm/cold cache state
    (the hit path once accepted brace-corrupted lines the
    reference parser rejects; the NATIVE whole-body path once accepted
    strtod's nan(123) payloads Python float() rejects). Parametrized over
    both parse paths so native coverage never depends on test order."""

    import pytest as _pytest

    @_pytest.fixture(params=["native", "pure"], autouse=True)
    def _parse_path(self, request, monkeypatch):
        if request.param == "pure":
            monkeypatch.setattr(
                "tpu_pod_exporter_torch.metrics.parse._native_parse_layout",
                lambda layout, text: None,
            )
        else:
            from tpu_pod_exporter_torch import nativelib

            if nativelib.load() is None:
                self._pytest.skip("native lib unavailable")

    _names = st.sampled_from(["m", "tpu_x", "other", "sk"])
    _line = st.one_of(
        # well-formed samples, labeled and bare, with/without timestamps
        st.tuples(
            _names,
            st.lists(
                st.tuples(
                    st.sampled_from(["a", "b", "host"]),
                    st.text(
                        alphabet=st.characters(
                            blacklist_categories=("Cs",),
                            blacklist_characters='\x00"\\\n',
                        ),
                        max_size=8,
                    ),
                ),
                max_size=3,
            ),
            st.floats(allow_nan=False, width=32),
            st.booleans(),
        ).map(
            lambda t: (
                t[0]
                + (
                    "{"
                    + ",".join(f'{k}="{v}"' for k, v in t[1])
                    + "}"
                    if t[1]
                    else ""
                )
                + f" {t[2]!r}"
                + (" 1700000000" if t[3] else "")
            )
        ),
        # comments / blanks
        st.sampled_from(["# HELP m h", "# TYPE m gauge", "", "# EOF"]),
        # junk/corruption shapes (incl. the brace-in-tail repro)
        st.sampled_from(
            [
                'm{a="1"} 5 m{a="2"} 6',
                "m",
                'm{a="x} 1',
                "m2 1",
                'tpu_x 5 {oops} 1',
                "m nope",
                # strtod-wider-than-float() shapes the native path must
                # decline (it did not always):
                "m nan(123)",
                "m 0x1p3",
                "m 1_0",
                "m 1,5",
                "m Infinity",
                "tpu_x -inf 1700000000",
            ]
        ),
    )

    @given(bodies=st.lists(st.lists(_line, max_size=12), min_size=1, max_size=4))
    @settings(
        max_examples=150, deadline=None,
        suppress_health_check=[HealthCheck.function_scoped_fixture],
    )
    def test_layout_parser_matches_reference_through_any_cache_state(
        self, bodies
    ):
        from tpu_pod_exporter_torch.metrics.parse import (
            LayoutCache,
            ParseError,
            parse_exposition,
            parse_exposition_layout,
        )

        names = frozenset({"m", "tpu_x"})
        layout = LayoutCache()
        for lines in bodies:
            text = "\n".join(lines) + "\n"
            try:
                want = [
                    (s.name, s.labels, s.value)
                    for s in parse_exposition(text, names=names)
                ]
                want_err = None
            except ParseError as e:
                want, want_err = None, e
            if want_err is None:
                got = parse_exposition_layout(text, names, layout)
                assert got == want, text
            else:
                entries_before = layout.entries
                try:
                    parse_exposition_layout(text, names, layout)
                except ParseError:
                    pass
                else:
                    raise AssertionError(
                        f"layout parser accepted what reference rejects: {text!r}"
                    )
                assert layout.entries is entries_before  # cache untouched

    @given(
        bodies=st.lists(st.lists(_line, max_size=12), min_size=1, max_size=4),
        cap=st.integers(min_value=1, max_value=10),
    )
    @settings(
        max_examples=150, deadline=None,
        suppress_health_check=[HealthCheck.function_scoped_fixture],
    )
    def test_layout_parser_matches_reference_under_tiny_cache_cap(
        self, bodies, cap
    ):
        """Same differential, but with a cap small enough that bodies cross
        it freely — the oversize fast path, the small↔oversize transitions,
        and the flag state machine all get fuzzed. Invariants after every
        successful round: results equal the reference parser's regardless
        of cache state; oversize_logged mirrors whether THIS body was over
        the cap; an oversize round leaves nothing cached. After a
        ParseError round: every piece of cache state is untouched."""
        from tpu_pod_exporter_torch.metrics.parse import (
            LayoutCache,
            ParseError,
            parse_exposition,
            parse_exposition_layout,
        )

        names = frozenset({"m", "tpu_x"})
        layout = LayoutCache(max_entries=cap)
        for lines in bodies:
            text = "\n".join(lines) + "\n"
            over = text.count("\n") + 1 > cap
            try:
                want = [
                    (s.name, s.labels, s.value)
                    for s in parse_exposition(text, names=names)
                ]
                want_err = None
            except ParseError as e:
                want, want_err = None, e
            if want_err is None:
                got = parse_exposition_layout(text, names, layout)
                assert [tuple(s) for s in got] == want, text
                assert layout.oversize_logged == over, text
                if over:
                    assert layout.entries == []
                    assert layout.native_built_for is None
                    assert layout.samples_template is None
            else:
                entries_before = layout.entries
                flag_before = layout.oversize_logged
                with self._pytest.raises(ParseError):
                    parse_exposition_layout(text, names, layout)
                assert layout.entries is entries_before
                assert layout.oversize_logged == flag_before
