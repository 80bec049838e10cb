"""The cases of tests/test_tiers.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

Multi-resolution history tiers.

Property-style tests (seeded random walks, deterministic — no hypothesis
dependency) asserting the downsample contract: tier answers must AGREE
with recomputation from the raw samples the test itself retains — gauge
min/max/mean/first/last exactly, and counter rates with the same
reset-tolerant monotonic-fold semantics. Plus tier selection at every step
boundary, coverage escalation past raw retention, and the ≥30× retention
acceptance criterion.
"""

import random

import pytest

from tpu_pod_exporter_torch.history import (
    DEFAULT_TIER_SPEC,
    HistoryStore,
    parse_tier_spec,
)


class FakeClock:
    def __init__(self, t0: float = 0.0) -> None:
        self.t = t0

    def __call__(self) -> float:
        return self.t


BASE_WALL = 1_700_000_000.0  # aligned to 10 and 60 (multiple of 600)


def make_store(capacity=8, tiers=((10.0, 6), (60.0, 8)), **kw):
    clock = FakeClock()
    store = HistoryStore(
        capacity=capacity, max_series=64, retention_s=0.0,
        clock=clock, wallclock=lambda: BASE_WALL + clock.t,
        tiers=tiers, **kw,
    )
    return store, clock


def feed(store, clock, metric, values, labels=None, dt=1.0):
    """Append one value per dt tick; returns [(mono, wall, v), ...]."""
    out = []
    for i, v in enumerate(values):
        clock.t = i * dt
        store.append(metric, labels or {}, v)
        out.append((clock.t, BASE_WALL + clock.t, v))
    return out


class TestTierSpec:
    def test_parse_defaults(self):
        assert parse_tier_spec(DEFAULT_TIER_SPEC) == ((10.0, 60), (60.0, 240))

    def test_off_disables(self):
        for spec in ("", "off", "none", "0"):
            assert parse_tier_spec(spec) == ()

    @pytest.mark.parametrize("bad", ["10", "x:5", "10:x", "0:5", "10:1",
                                     "10:60,10:90"])
    def test_bad_specs_raise(self, bad):
        with pytest.raises(ValueError):
            parse_tier_spec(bad)

    def test_sorted_finest_first(self):
        assert parse_tier_spec("60:4,10:4") == ((10.0, 4), (60.0, 4))


class TestGaugeAgreement:
    """Tier bucket stats must recompute exactly from raw samples."""

    def test_bucket_stats_match_recomputation(self):
        rng = random.Random(42)
        h, clock = make_store(capacity=512, tiers=((10.0, 64),))
        samples = feed(h, clock, "tpu_hbm_used_bytes",
                       [rng.uniform(0, 100) for _ in range(120)])
        # Per grid point at step=10 with agg=X, the answer must equal X
        # over the raw samples of that point's bucket.
        for agg, fold in (("min", min), ("max", max), ("last", lambda v: v[-1]),
                          ("mean", lambda v: sum(v) / len(v))):
            [row] = h.query_range(
                "tpu_hbm_used_bytes",
                start=BASE_WALL, end=BASE_WALL + 119, step=10.0, agg=agg,
            )
            assert row["tier"] == 10.0
            for t, v in row["values"]:
                # The grid point carries the most recent BUCKET point at or
                # before t (a bucket's point sits at its last sample's wall
                # time); the value must equal agg over that whole bucket's
                # raw samples.
                buckets: dict[float, list[float]] = {}
                for (_m, w, sv) in samples:
                    buckets.setdefault((w // 10.0) * 10.0, []).append(sv)
                eligible = [lo for lo, _vs in buckets.items()
                            if max(w for (_m, w, _v) in samples
                                   if (w // 10.0) * 10.0 == lo) <= t]
                if not eligible:
                    continue
                raw = buckets[max(eligible)]
                assert v == pytest.approx(fold(raw)), (agg, t)

    def test_window_stats_fold_matches_raw(self):
        # Raw ring too small to cover the window; the tier fold must
        # reproduce the stats over ALL samples in the window.
        rng = random.Random(7)
        h, clock = make_store(capacity=8, tiers=((10.0, 64),))
        samples = feed(h, clock, "tpu_hbm_used_bytes",
                       [rng.uniform(0, 100) for _ in range(200)])
        [row] = h.window_stats("tpu_hbm_used_bytes", window_s=200.0)
        assert row["tier"] == 10.0  # escalated: raw holds 8 of 200 samples
        s = row["stats"]
        vals = [v for (_m, _w, v) in samples]
        assert s["samples"] == len(vals)
        assert s["min"] == pytest.approx(min(vals))
        assert s["max"] == pytest.approx(max(vals))
        assert s["mean"] == pytest.approx(sum(vals) / len(vals))
        assert s["first"] == pytest.approx(vals[0])
        assert s["last"] == pytest.approx(vals[-1])

    def test_last_sample_wall_ts_on_rows(self):
        h, clock = make_store()
        feed(h, clock, "tpu_hbm_used_bytes", [1.0, 2.0, 3.0])
        for rows in (
            h.query_range("tpu_hbm_used_bytes", start=BASE_WALL,
                          end=BASE_WALL + 10),
            h.window_stats("tpu_hbm_used_bytes", window_s=60.0),
        ):
            assert rows[0]["last_sample_wall_ts"] == BASE_WALL + 2.0


class TestCounterAgreement:
    def _raw_rate(self, vals, dt_total):
        gained = sum(d for d in (b - a for a, b in zip(vals, vals[1:]))
                     if d > 0)
        return gained / dt_total

    def test_reset_tolerant_rate_matches_raw(self):
        # Counter with resets at random positions: tier-folded rate over a
        # bucket-aligned window must equal raw recomputation exactly.
        rng = random.Random(1234)
        h, clock = make_store(capacity=8, tiers=((10.0, 64),))
        vals, v = [], 0.0
        for i in range(200):
            if rng.random() < 0.05:
                v = 0.0  # device reset
            else:
                v += rng.uniform(0, 1000)
            vals.append(v)
        feed(h, clock, "tpu_ici_transferred_bytes_total", vals,
             labels={"link": "0"})
        [row] = h.window_stats("tpu_ici_transferred_bytes_total",
                               window_s=200.0)
        assert row["tier"] == 10.0
        assert row["stats"]["rate"] == pytest.approx(
            self._raw_rate(vals, 199.0))

    def test_rate_agrees_at_many_seeds(self):
        # Property sweep: 20 seeds, resets and plateaus included; always
        # exact on full-history windows.
        for seed in range(20):
            rng = random.Random(seed)
            h, clock = make_store(capacity=4, tiers=((10.0, 64),))
            vals, v = [], 0.0
            for _ in range(100):
                r = rng.random()
                if r < 0.08:
                    v = rng.uniform(0, 10)  # reset to non-zero floor
                elif r < 0.3:
                    pass  # plateau
                else:
                    v += rng.uniform(0, 50)
                vals.append(v)
            feed(h, clock, "tpu_dcn_transferred_bytes_total", vals,
                 labels={"link": "1"})
            [row] = h.window_stats("tpu_dcn_transferred_bytes_total",
                                   window_s=100.0)
            assert row["stats"]["rate"] == pytest.approx(
                self._raw_rate(vals, 99.0)), f"seed {seed}"


class TestTierSelection:
    @pytest.mark.parametrize("step,expected", [
        (0.0, 0.0),     # raw samples
        (1.0, 0.0),     # finer than every tier → raw
        (9.9, 0.0),
        (10.0, 10.0),   # boundary: 10 s tier satisfies step 10
        (30.0, 10.0),   # coarsest tier ≤ 30 is 10
        (59.9, 10.0),
        (60.0, 60.0),   # boundary: 60 s tier
        (600.0, 60.0),  # coarsest available
    ])
    def test_step_boundaries(self, step, expected):
        h, clock = make_store(capacity=512, tiers=((10.0, 64), (60.0, 64)))
        feed(h, clock, "tpu_hbm_used_bytes", [float(i) for i in range(130)])
        # end past the data so even a 600 s grid has a point with data
        # at-or-before it (within the bucket-width-aware lookback).
        [row] = h.query_range("tpu_hbm_used_bytes", start=BASE_WALL,
                              end=BASE_WALL + 720, step=step)
        assert row["tier"] == expected, f"step {step}"

    def test_escalation_past_raw_retention(self):
        # Raw holds the last 8 s; a gridded query starting 100 s ago must
        # escalate to the 10 s tier even though step=1 prefers raw.
        h, clock = make_store(capacity=8, tiers=((10.0, 64),))
        feed(h, clock, "tpu_hbm_used_bytes", [float(i) for i in range(120)])
        [row] = h.query_range("tpu_hbm_used_bytes", start=BASE_WALL,
                              end=BASE_WALL + 119, step=1.0)
        assert row["tier"] == 10.0
        # ... but a query the raw ring CAN cover stays raw.
        [row] = h.query_range("tpu_hbm_used_bytes", start=BASE_WALL + 113,
                              end=BASE_WALL + 119, step=1.0)
        assert row["tier"] == 0.0

    def test_step_zero_never_escalates(self):
        # Raw-sample queries mean "the raw ring, whatever it holds" — the
        # pre-tier contract, bit for bit.
        h, clock = make_store(capacity=4, tiers=((10.0, 64),))
        feed(h, clock, "tpu_hbm_used_bytes", [float(i) for i in range(50)])
        [row] = h.query_range("tpu_hbm_used_bytes", start=BASE_WALL,
                              end=BASE_WALL + 50)
        assert row["tier"] == 0.0
        assert len(row["values"]) == 4  # raw ring capacity

    def test_tiers_off_is_raw_only(self):
        h, clock = make_store(capacity=8, tiers=())
        feed(h, clock, "tpu_hbm_used_bytes", [float(i) for i in range(50)])
        [row] = h.query_range("tpu_hbm_used_bytes", start=BASE_WALL,
                              end=BASE_WALL + 50, step=10.0)
        assert row["tier"] == 0.0
        assert h.stats()["tiers"] == []


class TestRetentionAcceptance:
    def test_retention_extends_30x_at_same_series_bound(self):
        # The criterion: answerable query_range retention grows
        # ≥30× at an unchanged --history-max-series bound. Shape mirrors
        # production: raw 301×1 s, default tiers, long-running series.
        h, clock = make_store(capacity=301,
                              tiers=parse_tier_spec(DEFAULT_TIER_SPEC))
        n = 16000  # ~4.4 h at 1 Hz
        for i in range(n):
            clock.t = float(i)
            h.append("tpu_tensorcore_duty_cycle_percent", {"chip_id": "0"},
                     float(i % 100))
        raw_span = 301.0
        [row] = h.query_range(
            "tpu_tensorcore_duty_cycle_percent",
            start=BASE_WALL, end=BASE_WALL + n, step=60.0,
        )
        answered_span = row["values"][-1][0] - row["values"][0][0]
        assert answered_span >= 30.0 * raw_span
        # max_series untouched; memory stays hard-bounded and accounted.
        st = h.stats()
        assert st["max_series"] == 64
        per_series = st["memory_bytes"] / st["series"]
        assert per_series == 301 * 24 + (60 + 240) * 88

    def test_tier_stats_and_eviction(self):
        h, clock = make_store(capacity=8, tiers=((10.0, 4),))
        feed(h, clock, "tpu_hbm_used_bytes", [float(i) for i in range(35)])
        st = h.stats()
        [tier] = st["tiers"]
        assert tier["step_s"] == 10.0
        # 35 samples → buckets 0..3 flushed or open; ring cap 4 (+1 open)
        assert 1 <= tier["buckets"] <= 5
        assert tier["span_s"] > 0
        # Eviction drops the series' tiers with it.
        for i in range(200):
            h.append("tpu_hbm_used_bytes", {"chip_id": str(i)}, 1.0)
        assert h.stats()["series"] <= 64


class TestCollectorIntegration:
    def test_tier_metrics_reach_exposition(self):
        from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
        from tpu_pod_exporter_torch.backend.fake import FakeBackend
        from tpu_pod_exporter_torch.collector import Collector
        from tpu_pod_exporter_torch.metrics import SnapshotStore

        store = SnapshotStore()
        history = HistoryStore(capacity=16, tiers=((10.0, 4),))
        c = Collector(FakeBackend(chips=2), FakeAttribution(), store,
                      history=history)
        c.poll_once()
        c.poll_once()
        text = store.current().encode().decode()
        assert 'tpu_exporter_history_tier_buckets{tier="10"}' in text
        assert 'tpu_exporter_history_tier_span_seconds{tier="10"}' in text
        c.close()
