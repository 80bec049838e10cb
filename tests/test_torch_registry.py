"""The cases of tests/test_registry.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

Unit tests for the snapshot registry (SURVEY.md §4.1)."""

import math

import pytest
from prometheus_client.parser import text_string_to_metric_families

from tpu_pod_exporter_torch.metrics.registry import (
    COUNTER,
    CounterStore,
    HistogramSpec,
    HistogramStore,
    MetricSpec,
    SnapshotBuilder,
    SnapshotStore,
    escape_label_value,
    format_value,
)

G = MetricSpec(name="test_gauge", help="a gauge", label_names=("a", "b"))
PLAIN = MetricSpec(name="test_plain", help="no labels")


class TestMetricSpec:
    def test_valid(self):
        MetricSpec(name="tpu_hbm_used_bytes", help="h", label_names=("pod",))

    @pytest.mark.parametrize("bad", ["", "1abc", "a-b", "a b", "abé"])
    def test_invalid_name(self, bad):
        with pytest.raises(ValueError):
            MetricSpec(name=bad, help="h")

    @pytest.mark.parametrize("bad", ["", "__reserved", "1a", "a-b"])
    def test_invalid_label(self, bad):
        with pytest.raises(ValueError):
            MetricSpec(name="ok", help="h", label_names=(bad,))

    def test_duplicate_labels(self):
        with pytest.raises(ValueError):
            MetricSpec(name="ok", help="h", label_names=("x", "x"))

    def test_bad_type(self):
        with pytest.raises(ValueError):
            MetricSpec(name="ok", help="h", type="summary")


class TestFormatting:
    def test_format_value(self):
        assert format_value(0.0) == "0"
        assert format_value(42.0) == "42"
        assert format_value(1.5) == "1.5"
        assert format_value(math.nan) == "NaN"
        assert format_value(math.inf) == "+Inf"
        assert format_value(-math.inf) == "-Inf"
        assert format_value(2**60) == str(float(2**60)) or "e" in format_value(2**60)

    def test_escape(self):
        assert escape_label_value('a"b\\c\nd') == 'a\\"b\\\\c\\nd'


class TestSnapshotBuilder:
    def test_roundtrip_via_prometheus_parser(self):
        b = SnapshotBuilder()
        b.add(G, 1.25, {"a": "x", "b": 'quo"te'})
        b.add(G, 2.0, ("y", "line\nbreak"))
        b.add(PLAIN, 7)
        snap = b.build()
        text = snap.encode().decode()
        fams = {f.name: f for f in text_string_to_metric_families(text)}
        assert fams["test_gauge"].type == "gauge"
        samples = {tuple(sorted(s.labels.items())): s.value for s in fams["test_gauge"].samples}
        assert samples[(("a", "x"), ("b", 'quo"te'))] == 1.25
        assert samples[(("a", "y"), ("b", "line\nbreak"))] == 2.0
        assert fams["test_plain"].samples[0].value == 7

    def test_counter_type_rendered(self):
        c = MetricSpec(name="test_total", help="h", type=COUNTER)
        b = SnapshotBuilder()
        b.add(c, 3)
        text = b.build().encode().decode()
        assert "# TYPE test_total counter" in text

    def test_duplicate_label_set_last_wins(self):
        b = SnapshotBuilder()
        b.add(G, 1, ("x", "y"))
        b.add(G, 2, ("x", "y"))
        assert b.build().value("test_gauge", ("x", "y")) == 2

    def test_label_arity_mismatch(self):
        b = SnapshotBuilder()
        with pytest.raises(ValueError):
            b.add(G, 1, ("only-one",))

    def test_unknown_label_rejected(self):
        b = SnapshotBuilder()
        with pytest.raises(ValueError):
            b.add(G, 1, {"a": "x", "b": "y", "zzz": "?"})

    def test_missing_label_rejected(self):
        b = SnapshotBuilder()
        with pytest.raises(ValueError):
            b.add(G, 1, {"a": "x"})

    def test_conflicting_redeclare(self):
        b = SnapshotBuilder()
        b.add(G, 1, ("x", "y"))
        other = MetricSpec(name="test_gauge", help="different", label_names=("a", "b"))
        with pytest.raises(ValueError):
            b.declare(other)

    def test_declared_family_appears_without_samples(self):
        b = SnapshotBuilder()
        b.declare(G)
        text = b.build().encode().decode()
        assert "# HELP test_gauge" in text
        assert b.build().series_count == 0

    def test_series_count(self):
        b = SnapshotBuilder()
        b.add(G, 1, ("x", "y"))
        b.add(G, 1, ("x", "z"))
        b.add(PLAIN, 1)
        assert b.build().series_count == 3

    def test_encode_cached(self):
        b = SnapshotBuilder()
        b.add(PLAIN, 1)
        snap = b.build()
        assert snap.encode() is snap.encode()


class TestSnapshotStore:
    def test_swap_and_current(self):
        store = SnapshotStore()
        assert store.current().series_count == 0
        b = SnapshotBuilder()
        b.add(PLAIN, 5)
        snap = b.build()
        store.swap(snap)
        assert store.current() is snap
        # swap pre-renders so the scrape path never encodes
        assert snap._text is not None


class TestSnapshotStoreConcurrency:
    def test_swap_current_race(self):
        """All cross-thread state is one locked reference (SURVEY.md §5 race
        strategy): hammer swap() and current() from threads; every observed
        snapshot must be complete and internally consistent."""
        import threading

        store = SnapshotStore()
        stop = threading.Event()
        failures: list[str] = []

        def writer():
            i = 0
            while not stop.is_set():
                i += 1
                b = SnapshotBuilder()
                # generation encoded in both value and series: a torn
                # snapshot would disagree with itself
                b.add(G, i, (str(i), "x"))
                b.add(PLAIN, i)
                store.swap(b.build())

        def reader():
            while not stop.is_set():
                snap = store.current()
                text = snap.encode()
                if snap.series_count == 0:
                    continue
                plain = snap.value("test_plain")
                gen = int(plain)
                if snap.value("test_gauge", (str(gen), "x")) != gen:
                    failures.append(f"torn snapshot at gen {gen}")
                if text != snap.encode():  # cached render must be stable
                    failures.append("encode not stable")

        threads = [threading.Thread(target=writer)] + [
            threading.Thread(target=reader) for _ in range(3)
        ]
        for t in threads:
            t.start()
        import time

        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=5)
        assert not failures, failures[:5]


class TestCounterStore:
    def test_inc(self):
        c = CounterStore()
        assert c.inc("n", ("a",)) == 1
        assert c.inc("n", ("a",), 2.5) == 3.5
        assert c.get("n", ("a",)) == 3.5
        assert c.get("n", ("other",)) == 0

    def test_negative_delta_ignored(self):
        c = CounterStore()
        c.inc("n", (), 5)
        assert c.inc("n", (), -3) == 5

    def test_observe_total_monotonic(self):
        c = CounterStore()
        assert c.observe_total("n", (), 100) == 100
        assert c.observe_total("n", (), 150) == 150
        # device counter reset: exported value holds, then resumes
        assert c.observe_total("n", (), 10) == 150
        assert c.observe_total("n", (), 60) == 200

    def test_prune(self):
        c = CounterStore()
        c.inc("n", ("a",))
        c.inc("n", ("b",))
        assert c.prune({("n", ("a",))}) == 1
        assert c.get("n", ("b",)) == 0
        assert c.get("n", ("a",)) == 1

    def test_items_for(self):
        c = CounterStore()
        c.inc("n", ("a",))
        c.inc("m", ("b",))
        assert c.items_for("n") == [(("a",), 1.0)]


HIST = HistogramSpec(
    name="test_duration_seconds",
    help="a histogram",
    buckets=(0.1, 1.0, 10.0),
    label_names=("phase",),
)


class TestHistogramSpec:
    def test_bad_buckets(self):
        with pytest.raises(ValueError):
            HistogramSpec(name="h", help="h", buckets=())
        with pytest.raises(ValueError):
            HistogramSpec(name="h", help="h", buckets=(1.0, 1.0))
        with pytest.raises(ValueError):
            HistogramSpec(name="h", help="h", buckets=(2.0, 1.0))
        with pytest.raises(ValueError):
            HistogramSpec(name="h", help="h", buckets=(1.0, math.inf))

    def test_le_label_reserved(self):
        with pytest.raises(ValueError):
            HistogramSpec(name="h", help="h", buckets=(1.0,), label_names=("le",))

    def test_le_values_include_inf(self):
        assert HIST.le_values == ("0.1", "1", "10", "+Inf")


def _render(store):
    b = SnapshotBuilder()
    store.emit(b)
    return b.build(timestamp=1.0).encode().decode()


class TestHistogramStore:
    def test_observe_and_emit_exact(self):
        s = HistogramStore(HIST)
        for v in (0.05, 0.1, 5.0, 100.0):  # 0.1 lands IN le="0.1" (le = <=)
            s.observe(v, ("total",))
        text = _render(s)
        want = [
            'test_duration_seconds_bucket{phase="total",le="0.1"} 2',
            'test_duration_seconds_bucket{phase="total",le="1"} 2',
            'test_duration_seconds_bucket{phase="total",le="10"} 3',
            'test_duration_seconds_bucket{phase="total",le="+Inf"} 4',
            'test_duration_seconds_count{phase="total"} 4',
            'test_duration_seconds_sum{phase="total"} 105.15',
        ]
        body = [l for l in text.splitlines() if not l.startswith("#")]
        assert body == want
        assert "# TYPE test_duration_seconds histogram" in text
        # The internal raw-lines family name must never leak into output.
        assert "_lines" not in text

    def test_openmetrics_strict_parser_and_per_labelset_grouping(self):
        from prometheus_client.openmetrics.parser import (
            text_string_to_metric_families as om_parse,
        )

        s = HistogramStore(HIST)
        s.observe(0.5, ("a",))
        s.observe(2.0, ("b",))
        s.observe(0.01, ("a",))
        b = SnapshotBuilder()
        s.emit(b)
        om = b.build(timestamp=1.0).encode_openmetrics().decode()
        fams = {f.name: f for f in om_parse(om)}
        fam = fams["test_duration_seconds"]
        assert fam.type == "histogram"
        by_name = {}
        for sample in fam.samples:
            by_name.setdefault(sample.name, []).append(sample)
        assert len(by_name["test_duration_seconds_bucket"]) == 8  # 2 sets x 4
        a_inf = [
            x for x in by_name["test_duration_seconds_bucket"]
            if x.labels == {"phase": "a", "le": "+Inf"}
        ]
        assert a_inf[0].value == 2.0

    def test_cumulative_across_emits(self):
        s = HistogramStore(HIST)
        s.observe(0.5)
        _render(s)
        s.observe(0.6)
        text = _render(s)
        assert "test_duration_seconds_count 2" in text

    def test_unlabeled_histogram_renders_bare_names(self):
        s = HistogramStore(HistogramSpec(name="h2", help="h", buckets=(1.0,)))
        s.observe(0.5)
        text = _render(s)
        assert 'h2_bucket{le="1"} 1' in text
        assert "h2_count 1" in text
        assert "h2_sum 0.5" in text

    def test_empty_store_emits_headers_only(self):
        text = _render(HistogramStore(HIST))
        assert "# TYPE test_duration_seconds histogram" in text
        assert "_bucket" not in text

    def test_thread_hammer_loses_no_observations(self):
        import threading

        s = HistogramStore(HIST)
        n_threads, per = 8, 1000

        def work():
            for i in range(per):
                s.observe(i % 20, ("t",))

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        text = _render(s)
        assert f'test_duration_seconds_count{{phase="t"}} {n_threads * per}' in text

    def test_identical_output_with_and_without_prefix_cache(self):
        from tpu_pod_exporter_torch.metrics.registry import PrefixCache

        s = HistogramStore(HIST)
        for v in (0.05, 0.7, 3.0, 50.0):
            s.observe(v, ("x",))
        cache = PrefixCache()
        b1 = SnapshotBuilder(prefix_cache=cache)
        s.emit(b1)
        cached_text = b1.build(timestamp=1.0).encode()
        b2 = SnapshotBuilder()
        s.emit(b2)
        plain_text = b2.build(timestamp=1.0).encode()
        assert cached_text == plain_text
        # Second emit through the same cache (layout fast path) agrees too.
        b3 = SnapshotBuilder(prefix_cache=cache)
        s.emit(b3)
        assert b3.build(timestamp=1.0).encode() == plain_text
