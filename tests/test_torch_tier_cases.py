"""The aggregation tiers' cases from the node-side oracle files, against
the port.

tests/test_history.py, test_pressure.py, test_trace.py, test_churn.py and
test_backend_nvml.py each hold a few cases that reach ``aggregate``,
``shard``, ``fleet``, ``store`` or ``status``. They run here against
``tpu_pod_exporter_torch`` with the imports renamed, case for case: the
history fallback and the status watch trends (history), the pressure
sidecar's status line, dead state dirs under a leaf and a root, the fleet
cache's and the root's stale-view byte accounting, the scenario DSL's
pressure kinds (pressure), the
traceparent join of a round trace and a node scrape span (trace), the
parse caches under label churn (churn), and the mixed-fleet rollups that
keep the GPU family apart from the TPU family (NVML backend).
"""

import os
import time
import urllib.error

import pytest

from tpu_pod_exporter_torch.history import HistoryStore
from tpu_pod_exporter_torch.metrics import SnapshotStore
from tpu_pod_exporter_torch.pressure import PressureGovernor, pressure_status_summary
from tpu_pod_exporter_torch.trace import Tracer, TraceStore, format_traceparent


# ------------------------------------------------------------- history


class FakeClock:
    def __init__(self, t0: float = 0.0) -> None:
        self.t = t0

    def __call__(self) -> float:
        return self.t


def make_store(capacity=4, max_series=8, retention_s=0.0, t0=0.0):
    clock = FakeClock(t0)
    store = HistoryStore(
        capacity=capacity, max_series=max_series, retention_s=retention_s,
        clock=clock, wallclock=lambda: 1000.0 + clock.t,
    )
    return store, clock


class TestAggregatorFallback:
    HOST_BODY = (
        "# HELP tpu_chip_info x\n"
        "# TYPE tpu_chip_info gauge\n"
        'tpu_chip_info{chip_id="0",device_path="",accelerator="v5p-8",'
        'slice_name="s",host="h0",worker_id="0",pod="",namespace="",'
        'container="",device_kind="",coords=""} 1\n'
        'tpu_hbm_used_bytes{chip_id="0",device_path="",accelerator="v5p-8",'
        'slice_name="s",host="h0",worker_id="0",pod="",namespace="",'
        'container=""} 100\n'
    )

    @staticmethod
    def _hist_fetch(url, timeout_s):
        labels = {"chip_id": "0", "host": "h1", "slice_name": "s",
                  "accelerator": "v5p-8"}
        if "tpu_chip_info" in url:
            return {"data": {"result": [
                {"labels": labels, "stats": {"last": 1.0, "rate": None}}
            ]}}
        if "tpu_hbm_used_bytes" in url:
            return {"data": {"result": [
                {"labels": labels, "stats": {"last": 77.0, "rate": None}}
            ]}}
        if "tpu_ici_transferred_bytes_total" in url:
            return {"data": {"result": [
                {"labels": {**labels, "link": "0"},
                 "stats": {"last": 1e6, "rate": 1234.0}}
            ]}}
        if "tpu_pod_chip_count" in url:
            return {"data": {"result": [
                {"labels": {"pod": "train", "namespace": "ml",
                            "slice_name": "s", "host": "h1"},
                 "stats": {"last": 4.0, "rate": None}}
            ]}}
        raise urllib.error.HTTPError(url, 404, "no samples", None, None)

    def _aggregate(self, history_fetch, window=15.0):
        from tpu_pod_exporter_torch.aggregate import SliceAggregator

        def fetch(target, timeout_s):
            if target == "h1:8000":
                raise ConnectionError("down")
            return self.HOST_BODY

        store = SnapshotStore()
        agg = SliceAggregator(
            ("h0:8000", "h1:8000"), store, fetch=fetch,
            history_fallback_window_s=window, history_fetch=history_fetch,
        )
        try:
            agg.poll_once()
        finally:
            agg.close()
        return store.current()

    def test_missed_round_keeps_slice_continuity(self):
        snap = self._aggregate(self._hist_fetch)
        key = ("s", "v5p-8", "tpu")
        # h1's chips stay in the rollups via its flight recorder...
        assert snap.value("tpu_slice_hosts_reporting", key) == 2.0
        assert snap.value("tpu_slice_chip_count", key) == 2.0
        assert snap.value("tpu_slice_hbm_used_bytes", key) == 177.0
        # ...counter history contributes its window rate as bandwidth...
        assert snap.value("tpu_slice_ici_bytes_per_second", key) == 1234.0
        # ...and workload rollups stay continuous too, not just slice ones
        assert snap.value(
            "tpu_workload_chip_count", ("train", "ml", "s")
        ) == 4.0
        # ...but the target still honestly reports down, and the
        # substitution is counted.
        assert snap.value("tpu_aggregator_target_up", ("h1:8000",)) == 0.0
        assert snap.value(
            "tpu_aggregator_history_fallbacks_total", ("h1:8000",)
        ) == 1.0

    def test_fallback_failure_degrades_to_plain_miss(self):
        def dead(url, timeout_s):
            raise ConnectionError("history down too")

        snap = self._aggregate(dead)
        key = ("s", "v5p-8", "tpu")
        assert snap.value("tpu_slice_hosts_reporting", key) == 1.0
        assert snap.value("tpu_slice_chip_count", key) == 1.0
        assert snap.value(
            "tpu_aggregator_history_fallbacks_total", ("h1:8000",)
        ) is None

    def test_connection_failure_aborts_after_one_fetch(self):
        # a black-holed target must cost ONE history
        # timeout, not six — the fallback bails on the first
        # connection-level failure instead of probing every metric.
        calls = []

        def dead(url, timeout_s):
            calls.append(url)
            raise ConnectionError("black hole")

        self._aggregate(dead)
        assert len(calls) == 1

    def test_http_404_keeps_probing_remaining_metrics(self):
        # ...while an ANSWERED 404 (family has no samples) is cheap and the
        # loop keeps going: partial history beats none.
        calls = []

        def sparse(url, timeout_s):
            calls.append(url)
            if "tpu_hbm_used_bytes" in url:
                return self._hist_fetch(url, timeout_s)
            raise urllib.error.HTTPError(url, 404, "no samples", None, None)

        snap = self._aggregate(sparse)
        assert len(calls) == 8  # every TPU fallback metric probed (gpu_* probes are gated on the target having ever served a gpu_ family)
        key = ("s", "v5p-8", "tpu")
        assert snap.value("tpu_slice_hbm_used_bytes", key) == 177.0

    def test_disabled_by_default(self):
        from tpu_pod_exporter_torch.aggregate import SliceAggregator

        def fetch(target, timeout_s):
            raise ConnectionError("down")

        def exploding(url, timeout_s):  # must never be called when off
            raise AssertionError("history fetch called with window=0")

        store = SnapshotStore()
        agg = SliceAggregator(("h1:8000",), store, fetch=fetch,
                              history_fetch=exploding)
        try:
            agg.poll_once()
        finally:
            agg.close()
        assert store.current().value(
            "tpu_aggregator_target_up", ("h1:8000",)
        ) == 0.0

    def test_aggregator_cli_has_debug_addr_flag(self):
        # the loopback-only /debug/* default applies to
        # the aggregator's server too, so its CLI must expose the same
        # escape hatch as the exporter.
        import subprocess
        import sys

        out = subprocess.run(
            [sys.executable, "-m", "tpu_pod_exporter_torch.aggregate", "--help"],
            capture_output=True, text=True, timeout=60,
        )
        assert out.returncode == 0
        assert "--debug-addr" in out.stdout

    def test_target_base_url(self):
        from tpu_pod_exporter_torch.aggregate import target_base_url

        assert target_base_url("h0:8000") == "http://h0:8000"
        assert target_base_url("http://h0:8000/metrics") == "http://h0:8000"
        assert target_base_url("https://h0:9000") == "https://h0:9000"


class TestStatusWatchTrends:
    def test_trend_cell_arrows(self):
        from tpu_pod_exporter_torch.status import _fmt_delta_bytes, trend_cell

        h, clock = make_store(capacity=16)
        assert trend_cell(h, "tpu_hbm_used_bytes", 0, 60.0,
                          _fmt_delta_bytes, 1.0) == "-"
        h.append("tpu_hbm_used_bytes", {"chip_id": "0"}, 1024.0**3)
        assert trend_cell(h, "tpu_hbm_used_bytes", 0, 60.0,
                          _fmt_delta_bytes, 1.0) == "-"  # one sample: no delta
        clock.t = 1.0
        h.append("tpu_hbm_used_bytes", {"chip_id": "0"}, 3 * 1024.0**3)
        cell = trend_cell(h, "tpu_hbm_used_bytes", 0, 60.0,
                          _fmt_delta_bytes, 1024.0**2)
        assert cell == "↑+2.0GiB"
        clock.t = 2.0
        h.append("tpu_hbm_used_bytes", {"chip_id": "0"}, 1024.0**3)
        cell = trend_cell(h, "tpu_hbm_used_bytes", 0, 60.0,
                          _fmt_delta_bytes, 1024.0**2)
        assert cell.startswith("→")  # net zero over the window

    def test_watch_table_includes_delta_columns(self, capsys):
        from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
        from tpu_pod_exporter_torch.backend.fake import FakeBackend, FakeChipScript
        from tpu_pod_exporter_torch.config import ExporterConfig
        from tpu_pod_exporter_torch.status import _run
        from tpu_pod_exporter_torch.topology import detect_host_topology

        backend = FakeBackend(
            chips=1,
            script=FakeChipScript(
                hbm_total_bytes=8e9,
                hbm_used_bytes=lambda step: 1e9 * (step + 1),
                duty_cycle_percent=lambda step: 10.0 * (step + 1),
            ),
        )
        h, _ = make_store(capacity=16)
        cfg = ExporterConfig()
        topo = detect_host_topology()
        for _ in range(2):
            rc = _run(cfg, topo, backend, FakeAttribution(),
                      history=h, trend_window_s=60.0)
            assert rc == 0
        out = capsys.readouterr().out
        assert "Δhbm" in out and "Δduty" in out
        assert "↑" in out


# ------------------------------------------------------------ pressure


class TestGovernor:
    def test_sidecar_roundtrip_and_status_line(self, tmp_path):
        gov = PressureGovernor(memory_budget_bytes=100,
                               sidecar_dir=str(tmp_path))
        gov.register_memory_component("x", lambda: 500)
        gov.add_memory_rung("cache_off", lambda: None, lambda: None)
        gov.tick()
        doc = pressure_status_summary(str(tmp_path))
        assert doc is not None
        assert doc["memory"]["level"] == 1
        assert doc["memory"]["rung"] == "cache_off"
        from tpu_pod_exporter_torch.status import pressure_line

        line = pressure_line(str(tmp_path))
        assert line is not None and "memory rung 1 (cache_off)" in line
        assert pressure_status_summary(str(tmp_path / "nope")) is None


BAD_DIR = "/proc/1/nonexistent"


def _bad_dir_is_bad() -> bool:
    try:
        os.makedirs(BAD_DIR, exist_ok=True)
        return False
    except OSError:
        return True


class TestBootOnFullDisk:
    """Every --state-dir / egress-dir consumer must START SERVING with
    persistence shed when the disk refuses everything — never crash-loop
    (the hopeless-dir flavor; the mid-flight ENOSPC flavor is covered by
    the persist/egress error paths above)."""

    pytestmark = pytest.mark.skipif(
        not _bad_dir_is_bad(), reason="no unwritable directory available"
    )

    def test_leaf_and_root_serve_with_dead_state_dirs(self):
        from tpu_pod_exporter_torch.persist import BreakerStateFile, ShardMapFile
        from tpu_pod_exporter_torch.shard import (
            RootAggregator,
            ShardMap,
            default_shards,
        )

        smap = ShardMap(default_shards(2))
        store = SnapshotStore()
        root = RootAggregator(
            {"s0": ("127.0.0.1:9",)},  # unreachable leaf: degrades, fine
            store,
            timeout_s=0.2,
            shard_map=smap,
            shard_map_store=ShardMapFile(
                os.path.join(BAD_DIR, "root-map.json")),
            breaker_store=BreakerStateFile(
                os.path.join(BAD_DIR, "root-breakers.json")),
        )
        root.poll_once()  # must not raise; publishes a (degraded) round
        body = store.current().encode().decode()
        assert "tpu_root_leaf_up" in body
        root.close()


class TestFleetCacheBytes:
    def test_bytes_clear_disable(self):
        from tpu_pod_exporter_torch.fleet import _QueryCache

        c = _QueryCache(4)
        env = {"status": "ok", "data": ["x" * 100]}
        c.put(("a",), env)
        assert c.bytes() >= 100
        c.put(("a",), env)  # re-put same key: no double count
        one = c.bytes()
        c.put(("b",), env)
        assert c.bytes() == 2 * one
        for i in range(10):
            c.put((f"k{i}",), env)
        assert len(c) == 4 and c.bytes() == 4 * one  # LRU eviction accounted
        c.set_enabled(False)
        assert c.bytes() == 0 and len(c) == 0
        c.put(("z",), env)  # disabled: no-op
        assert len(c) == 0
        c.set_enabled(True)
        c.put(("z",), env)
        assert len(c) == 1


class TestStaleViewBytes:
    def test_estimate_and_shed(self):
        from tpu_pod_exporter_torch.shard import LeafView, RootAggregator

        store = SnapshotStore()
        root = RootAggregator({"s0": ("leaf:a",)}, store, timeout_s=0.1)
        assert root.stale_view_bytes() == 0
        view = LeafView(leaf="leaf:a", round_ts=1.0,
                        target_up={"t1": 1.0, "t2": 0.0})
        root._last_views["leaf:a"] = (view, 1.0)
        est = root.stale_view_bytes()
        assert est == 3 * 160  # 1 base + 2 target_up entries
        assert root.debug_vars()["stale_view_bytes"] == est
        assert root.shed_stale_views() == 1
        assert root.stale_view_bytes() == 0
        root.close()


# --------------------------------------------------------------- trace


def wait_for(predicate, timeout_s=5.0):
    """Poll until the predicate returns truthy. The node-side scrape span
    is recorded by the handler thread AFTER the response body is on the
    wire, so a client that just read the body can observe it a beat later."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        out = predicate()
        if out:
            return out
        time.sleep(0.01)
    return predicate()


class TestTraceparentJoin:
    """Acceptance: the aggregator's round trace links to the node
    scrape span via the propagated trace context."""

    def test_round_trace_joins_node_scrape_span(self):
        from tpu_pod_exporter_torch.aggregate import SliceAggregator
        from tpu_pod_exporter_torch.app import ExporterApp
        from tpu_pod_exporter_torch.config import ExporterConfig

        cfg = ExporterConfig(port=0, host="127.0.0.1", backend="fake",
                             fake_chips=2, attribution="none",
                             history_retention_s=0.0)
        app = ExporterApp(cfg)
        app.start()
        agg = None
        try:
            ts = TraceStore()
            tracer = Tracer(ts, slow_poll_s=0.0, root_name="round")
            agg = SliceAggregator((f"127.0.0.1:{app.port}",), SnapshotStore(),
                                  tracer=tracer)
            agg.poll_once()
            rt = ts.last(1)[0]
            assert rt.root.name == "round"
            scrape = next(s for s in rt.spans if s.name == "scrape")
            assert scrape.status == "ok"
            assert scrape.attrs["bytes"] > 0
            match = wait_for(lambda: [
                s for s in app.trace.scrapes(10)
                if s.trace_id == rt.trace_id
                and s.parent_id == scrape.span_id
            ])
            assert match, (
                f"node recorded no scrape span under the round trace "
                f"(have {[(s.trace_id, s.parent_id) for s in app.trace.scrapes(10)]})"
            )
            assert match[0].dur_s > 0
        finally:
            if agg is not None:
                agg.close()
            app.stop()

    def test_injected_two_arg_fetch_still_works(self):
        # Tests and ReplayFetch inject (target, timeout_s) fetches; the
        # tracer must not force a signature change on them.
        from tpu_pod_exporter_torch.aggregate import SliceAggregator

        seen = {}

        def fetch(target, timeout_s):
            seen["target"] = target
            return 'tpu_chip_info{chip_id="0",host="h"} 1\n'

        ts = TraceStore()
        agg = SliceAggregator(("h0:8000",), SnapshotStore(), fetch=fetch,
                              tracer=Tracer(ts, slow_poll_s=0,
                                            root_name="round"))
        try:
            agg.poll_once()
        finally:
            agg.close()
        assert seen["target"] == "h0:8000"
        scrape = next(s for s in ts.last(1)[0].spans if s.name == "scrape")
        assert scrape.status == "ok"

    def test_default_fetch_sends_traceparent_header(self):
        from tpu_pod_exporter_torch.app import ExporterApp
        from tpu_pod_exporter_torch.aggregate import default_fetch
        from tpu_pod_exporter_torch.config import ExporterConfig

        cfg = ExporterConfig(port=0, host="127.0.0.1", backend="fake",
                             fake_chips=1, attribution="none",
                             history_retention_s=0.0)
        app = ExporterApp(cfg)
        app.start()
        try:
            tid, sid = "c" * 32, "d" * 16
            default_fetch(f"127.0.0.1:{app.port}", 5.0,
                          traceparent=format_traceparent(tid, sid))
            assert wait_for(lambda: [
                s for s in app.trace.scrapes(10)
                if s.trace_id == tid and s.parent_id == sid
            ])
            # A plain scrape (no header) records nothing new.
            n = len(app.trace.scrapes(100))
            default_fetch(f"127.0.0.1:{app.port}", 5.0)
            time.sleep(0.05)  # give the handler thread its post-write beat
            assert len(app.trace.scrapes(100)) == n
        finally:
            app.stop()


# --------------------------------------------------------------- churn


class TestParseCacheChurnBounds:
    """The round-5 parse-path caches under sustained worst-case churn:
    label VALUES change every round (fresh pod names — the string memo's
    worst case) while one target flaps across the layout-cache cap. A
    5-minute live soak (12.5k rounds) showed flat RSS; this fast version
    pins the bounded-invariant behavior that makes that true."""

    def test_caches_stay_bounded_and_rollups_stay_exact(self, monkeypatch):
        from tests.test_torch_aggregate import make_host_text

        import tpu_pod_exporter_torch.metrics.parse as parse_mod
        from tpu_pod_exporter_torch.aggregate import SliceAggregator
        from tpu_pod_exporter_torch.metrics import SnapshotStore

        # Shrink the global cache caps so 200 churn rounds actually CROSS
        # them (at production caps this workload never would, making the
        # closing asserts vacuous): every wholesale-clear
        # path runs many times during the loop, and correctness of the
        # rollups is asserted every round on top of it.
        monkeypatch.setattr(parse_mod, "_STR_MEMO_MAX", 64)
        monkeypatch.setattr(parse_mod, "_BLOCK_CACHE_MAX_BYTES", 4000)
        parse_mod._STR_MEMO.clear()

        base = make_host_text(0, chips=8)

        class ChurnFetch:
            round = 0

            def __call__(self, target, timeout_s):
                body = base.replace(
                    'pod="llm-train-0"', f'pod="job-{self.round}"'
                )
                if target == "flap:8000" and self.round % 2:
                    body = body * 3  # over the cap
                return body

        fetch = ChurnFetch()
        store = SnapshotStore()
        agg = SliceAggregator(("h0:8000", "flap:8000"), store, fetch=fetch)
        flap_layout = agg._parse_layouts["flap:8000"]
        for lo in agg._parse_layouts.values():
            lo.max_entries = base.count("\n") + 10
        key = {"slice_name": "slice-a", "accelerator": "v5p-64", "family": "tpu"}
        try:
            for r in range(200):
                fetch.round = r
                agg.poll_once()
                snap = store.current()
                # Rollups exact every round regardless of which parse path
                # (cached / uncached / re-cached) served each target:
                # h0 contributes 8 chips; flap contributes 8, or 24 when
                # its body is tripled (duplicate rows fold per-sample).
                expect = 8.0 + (24.0 if r % 2 else 8.0)
                assert snap.value("tpu_slice_chip_count", key) == expect, r
                assert flap_layout.oversize_logged == bool(r % 2), r
            fetch.round = 200  # one final under-cap round: flap re-caches
            agg.poll_once()
        finally:
            agg.close()
        # Bounded invariants that keep long-run RSS flat — non-vacuous
        # because the shrunken caps above were crossed repeatedly. The
        # block-cache invariant the code actually guarantees is "cleared
        # BEFORE the insert that would exceed the cap", so the counter may
        # legitimately sit one max-cost entry above it after an insert
        # (asserting <= cap exactly would pass only by
        # luck of the fixture's label widths).
        assert len(parse_mod._STR_MEMO) <= parse_mod._STR_MEMO_MAX
        max_entry_cost = 200 + 8 * parse_mod._BLOCK_CACHE_MAX_ENTRY
        assert parse_mod._block_cache_bytes <= (
            parse_mod._BLOCK_CACHE_MAX_BYTES + max_entry_cost
        )
        assert flap_layout.entries and not flap_layout.oversize_logged  # re-cached


# ------------------------------------------------ mixed-fleet rollups


class TestMixedFleetRollups:
    def host_text(self, family: str, slice_name: str, host: str,
                  used: float, total: float) -> str:
        p = family
        duty = ("gpu_utilization_percent" if family == "gpu"
                else "tpu_tensorcore_duty_cycle_percent")
        accel = "a100" if family == "gpu" else "v5p"
        cl = (f'chip_id="0",device_path="",accelerator="{accel}",'
              f'slice_name="{slice_name}",host="{host}",worker_id="0",'
              f'pod="p-{family}",namespace="ns",container="c"')
        return (
            f'{p}_chip_info{{{cl},device_kind="",coords=""}} 1\n'
            f'{p}_hbm_used_bytes{{{cl}}} {used}\n'
            f'{p}_hbm_total_bytes{{{cl}}} {total}\n'
            f'{duty}{{{cl}}} 50\n'
        )

    def aggregate(self, bodies: dict):
        from tpu_pod_exporter_torch.aggregate import SliceAggregator

        store = SnapshotStore()
        agg = SliceAggregator(
            tuple(bodies), store, fetch=lambda t, timeout_s: bodies[t],
        )
        agg.poll_once()
        agg.close()
        return store.current()

    def test_families_never_sum_together(self):
        snap = self.aggregate({
            "t0": self.host_text("tpu", "s-t", "h0", 100.0, 200.0),
            "g0": self.host_text("gpu", "s-g", "g0", 40.0, 80.0),
        })
        assert snap.value("tpu_slice_hbm_used_bytes",
                          ("s-t", "v5p", "tpu")) == 100.0
        assert snap.value("tpu_slice_hbm_used_bytes",
                          ("s-g", "a100", "gpu")) == 40.0
        assert snap.value("tpu_fleet_family_chip_count", ("tpu",)) == 1.0
        assert snap.value("tpu_fleet_family_chip_count", ("gpu",)) == 1.0
        assert snap.value("tpu_fleet_family_hbm_used_bytes",
                          ("tpu",)) == 100.0
        assert snap.value("tpu_fleet_family_hbm_used_bytes",
                          ("gpu",)) == 40.0

    def test_gpu_utilization_folds_into_duty_rollup(self):
        snap = self.aggregate({
            "g0": self.host_text("gpu", "s-g", "g0", 40.0, 80.0),
        })
        assert snap.value(
            "tpu_slice_tensorcore_duty_cycle_avg_percent",
            ("s-g", "a100", "gpu"),
        ) == 50.0

    def test_leaf_component_family_roundtrips_to_root(self):
        from tpu_pod_exporter_torch.metrics import schema
        from tpu_pod_exporter_torch.shard import fold_leaf_body

        samples = [
            (schema.TPU_LEAF_SLICE_COMPONENT.name,
             {"slice_name": "s", "accelerator": "a100", "family": "gpu",
              "field": "chips"}, 4.0),
            # A pre-family leaf's components default to the TPU family.
            (schema.TPU_LEAF_SLICE_COMPONENT.name,
             {"slice_name": "s", "accelerator": "v5p", "field": "chips"},
             2.0),
        ]
        view = fold_leaf_body("leaf-0", samples)
        assert view.slice_fields[("s", "a100", "gpu")]["chips"] == 4.0
        assert view.slice_fields[("s", "v5p", "tpu")]["chips"] == 2.0

    def test_history_fallback_probes_gpu_only_for_gpu_targets(self):
        import urllib.error

        from tpu_pod_exporter_torch.aggregate import SliceAggregator

        bodies = {
            "t0": self.host_text("tpu", "s-t", "h0", 100.0, 200.0),
            "g0": self.host_text("gpu", "s-g", "g0", 40.0, 80.0),
        }
        down: set = set()
        calls: list[str] = []

        def fetch(t, timeout_s):
            if t in down:
                raise ConnectionError("down")
            return bodies[t]

        def hist_fetch(url, timeout_s):
            calls.append(url)
            raise urllib.error.HTTPError(url, 404, "no samples", None, None)

        store = SnapshotStore()
        agg = SliceAggregator(("t0", "g0"), store, fetch=fetch,
                              history_fallback_window_s=15.0,
                              history_fetch=hist_fetch,
                              breaker_failures=0)
        try:
            agg.poll_once()  # both up: the gpu-target latch learns g0
            down.update(("t0", "g0"))
            agg.poll_once()
        finally:
            agg.close()
        by_target = {
            "t0": [u for u in calls if "//t0" in u],
            "g0": [u for u in calls if "//g0" in u],
        }
        assert not any("gpu_" in u for u in by_target["t0"])
        assert any("gpu_hbm_used_bytes" in u for u in by_target["g0"])
        assert len(by_target["t0"]) == 8
        assert len(by_target["g0"]) == 14

    def test_store_rules_aggregate_by_family(self):
        from tpu_pod_exporter_torch.metrics import SnapshotBuilder, schema
        from tpu_pod_exporter_torch.store import evaluate_rule, parse_rules

        (rule,) = parse_rules(
            "fleet:chips:by_family = sum(tpu_slice_chip_count) by (family)")
        b = SnapshotBuilder()
        b.declare(schema.TPU_SLICE_CHIP_COUNT)
        b.add(schema.TPU_SLICE_CHIP_COUNT, 8.0, ("s0", "v5p", "tpu"))
        b.add(schema.TPU_SLICE_CHIP_COUNT, 4.0, ("s1", "v5p", "tpu"))
        b.add(schema.TPU_SLICE_CHIP_COUNT, 2.0, ("s2", "a100", "gpu"))
        out = dict(
            (labels["family"], value)
            for labels, value in evaluate_rule(rule, b.build(timestamp=0.0))
        )
        assert out == {"tpu": 12.0, "gpu": 2.0}


class TestScenarioDsl:
    def test_new_kinds_parse(self):
        from tpu_pod_exporter_torch.scenario import parse_event, parse_scenario

        ev = parse_event("disk_full()@3+4")
        assert ev.kind == "disk_full" and ev.duration == 4
        ev = parse_event("mem_pressure()@2")
        assert ev.kind == "mem_pressure" and ev.duration == 1
        ev = parse_event("scrape_storm(120)@3+2")
        assert ev.kind == "scrape_storm" and ev.count == 120
        ev = parse_event("clock_step(-45)@2")
        assert ev.kind == "clock_step" and ev.step_s == -45.0
        ev = parse_event("clock_step(+3600)@1")
        assert ev.step_s == 3600.0
        evs = parse_scenario("clock_step(-45)@2; disk_full()@3+4")
        assert [e.kind for e in evs] == ["clock_step", "disk_full"]

    def test_new_kind_errors_are_actionable(self):
        from tpu_pod_exporter_torch.scenario import parse_event

        with pytest.raises(ValueError, match="takes no arguments"):
            parse_event("disk_full(3)@1")
        with pytest.raises(ValueError, match="takes no arguments"):
            parse_event("mem_pressure(x)@1")
        with pytest.raises(ValueError, match="connection count"):
            parse_event("scrape_storm(zero)@1")
        with pytest.raises(ValueError, match="must be >= 1"):
            parse_event("scrape_storm(0)@1")
        with pytest.raises(ValueError, match="signed seconds"):
            parse_event("clock_step(fast)@1")
        with pytest.raises(ValueError, match="injects nothing"):
            parse_event("clock_step(0)@1")
        with pytest.raises(ValueError, match="instantaneous"):
            parse_event("clock_step(-45)@1+3")

    def test_named_pressure_scenarios_registered(self):
        from tpu_pod_exporter_torch.scenario import SCENARIOS

        for name in ("disk_full", "mem_pressure", "scrape_storm"):
            assert name in SCENARIOS
            SCENARIOS[name].events()  # timelines parse
