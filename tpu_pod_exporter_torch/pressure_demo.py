"""The ``make pressure-demo`` drills — resource pressure, end to end.

Three drills against REAL components (the chaos-demo/egress-demo
pattern: build the thing, hurt it deterministically, assert the policy):

1. **disk** — a live in-process :class:`~tpu_pod_exporter_torch.app.ExporterApp`
   (fake backend, real persister + WAL + checkpoints, real egress into a
   ledgered :class:`~tpu_pod_exporter_torch.chaos.ChaosReceiver`) on a disk
   budget its steady state cannot fit: the governor must climb the WHOLE
   ladder in order (WAL thinning → egress compaction → checkpoint halving
   → WAL off), usage must stop growing, scraping must keep serving, every
   rung must be attributable from ``/metrics`` alone, the egress
   exactly-once ledger must end intact — and when the budget is raised,
   the ladder must step back down rung by rung with hysteresis.
2. **memory** — history rings + trace ring + a fleet query cache under a
   byte budget half their filled size: sheds must land coarse-tiers-last
   (fleet cache → trace halving → raw-ring cut), the accounted bytes must
   converge under the budget, the raw rings must keep their NEWEST
   samples, and recovery must restore every knob.
3. **storm** — a :class:`~tpu_pod_exporter_torch.server.MetricsServer` with
   admission control vs a 500-connection keep-alive storm: a polite
   scraper's p99 stays within the budget of its pre-storm baseline, the
   storm costs rejected requests (counted per cause), and open
   connections never exceed the cap.

``run_disk_drill(governor=False)`` is the NEGATIVE CONTROL: the same
workload with no budget configured must visibly break the disk invariant
(usage grows past the budget the governed run respected) — proving the
drill can fail. ``make pressure-demo`` runs all three plus the control.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
import urllib.request


def _p99(lat: list[float]) -> float:
    lat = sorted(lat)
    return lat[min(int(len(lat) * 0.99), len(lat) - 1)]


def _metric_values(body: str, name: str) -> dict[str, float]:
    """``name{labels} value`` lines → {labels-part: value} (labels-part
    "" for label-less series)."""
    out: dict[str, float] = {}
    for line in body.splitlines():
        if not line.startswith(name):
            continue
        rest = line[len(name):]
        if rest.startswith("{"):
            labels, _, val = rest[1:].partition("} ")
            try:
                out[labels] = float(val)
            except ValueError:
                continue
        elif rest.startswith(" "):
            try:
                out[""] = float(rest[1:])
            except ValueError:
                continue
    return out


# ------------------------------------------------------------------ disk


DISK_BUDGET_BYTES = 48 << 10   # deliberately below the steady working set


def run_disk_drill(state_dir: str, governor: bool) -> int:
    """The disk-full ladder against a real exporter (see module doc).
    ``governor=False`` is the negative control: same workload, no budget —
    returns 0 only when the invariant VISIBLY breaks."""
    from tpu_pod_exporter_torch.app import ExporterApp
    from tpu_pod_exporter_torch.chaos import ChaosReceiver
    from tpu_pod_exporter_torch.config import ExporterConfig
    from tpu_pod_exporter_torch.pressure import dir_usage_bytes

    what = "disk drill" if governor else "disk drill NEGATIVE CONTROL"
    own_dir = not state_dir
    root = state_dir or tempfile.mkdtemp(prefix="tpe-pressure-demo-")
    sdir = os.path.join(root, "state")
    edir = os.path.join(root, "egress")
    receiver = ChaosReceiver([], seed=3)
    receiver.start()
    cfg = ExporterConfig(
        port=0, host="127.0.0.1", interval_s=0.1,
        backend="fake", fake_chips=4, attribution="none",
        history_retention_s=5.0,
        state_dir=sdir,
        state_snapshot_interval_s=1.0,
        state_fsync_interval_s=0.0,
        egress_url=receiver.url, egress_dir=edir, egress_interval_s=0.0,
        state_max_disk_mb=(DISK_BUDGET_BYTES / (1 << 20)) if governor
        else 0.0,
        log_level="warning",
    )
    app = ExporterApp(cfg)
    rc = 1
    try:
        if governor:
            assert app.governor is not None
            # Demo pacing: production hysteresis is 30 s; the drill wants
            # the whole shed+recover cycle inside ~20 s.
            app.governor.check_interval_s = 0.2
            app.governor.hysteresis_s = 0.5
        app.start()
        base = f"http://127.0.0.1:{app.port}"
        print(f"{what}: exporter on {base}, budget "
              f"{DISK_BUDGET_BYTES // 1024} KiB over {sdir} + {edir}"
              if governor else
              f"{what}: exporter on {base}, NO budget (reference "
              f"{DISK_BUDGET_BYTES // 1024} KiB)")

        seen_levels: list[int] = []
        deadline = time.monotonic() + 25.0
        while time.monotonic() < deadline:
            time.sleep(0.4)
            if app.governor is not None:
                lvl = app.governor.stats()["disk"]["level"]
                if not seen_levels or seen_levels[-1] != lvl:
                    seen_levels.append(lvl)
                if governor and lvl >= 4:
                    break
        usage = dir_usage_bytes(sdir) + dir_usage_bytes(edir)
        with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
            body = r.read().decode()
        states = _metric_values(body, "tpu_exporter_pressure_state")
        disk_state = states.get('resource="disk"')

        if not governor:
            # Negative control: the invariant must VISIBLY break — usage
            # over the budget the governed run respected, with the ladder
            # flat at 0 (nothing shed, nothing reclaimed).
            print(f"         usage {usage}B vs the governed run's budget "
                  f"{DISK_BUDGET_BYTES}B; published disk ladder level: "
                  f"{disk_state}")
            if usage > DISK_BUDGET_BYTES and not disk_state:
                print("negative control OK: without the governor the disk "
                      "budget invariant visibly breaks (usage over budget, "
                      "zero shedding)")
                rc = 0
            else:
                print("NEGATIVE CONTROL FAILED: the invariant did not "
                      "break without the governor — the drill proves "
                      "nothing")
            return rc

        gs = app.governor.stats()["disk"]
        print(f"         ladder levels over time: {seen_levels}; usage "
              f"{usage}B; exposition pressure_state[disk]={disk_state}")
        problems: list[str] = []
        if gs["level"] < 4:
            problems.append(f"ladder never reached wal_off (level "
                            f"{gs['level']}, rungs {gs['rungs']})")
        if sorted(set(seen_levels)) != seen_levels_monotone(seen_levels):
            problems.append(f"ladder did not climb monotonically: "
                            f"{seen_levels}")
        if disk_state != float(gs["level"]):
            problems.append(
                f"exposition disagrees with the governor: "
                f"pressure_state={disk_state} vs level {gs['level']}")
        ps = app.persister.stats()
        if ps["dropped_by_reason"]["shed"] == 0:
            problems.append("no WAL records were shed (stride/off rungs "
                            "inert?)")
        if not ps["wal_enabled"]:
            pass  # wal_off applied — expected at level 4
        else:
            problems.append("wal_off rung did not disable the WAL")
        # Serving never stopped: a scrape right now answers 200 with data.
        with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
            if r.status != 200:
                problems.append(f"/metrics answered {r.status} under "
                                f"pressure")

        # Relief: raise the budget; the ladder must step back to 0 rung
        # by rung (hysteresis) and the WAL must resume.
        app.governor.set_disk_budget_bytes(64 << 20)
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            if app.governor.stats()["disk"]["level"] == 0:
                break
            time.sleep(0.3)
        gs = app.governor.stats()["disk"]
        if gs["level"] != 0:
            problems.append(f"ladder stuck at level {gs['level']} after "
                            f"the budget was raised")
        if gs["recovers"] < 4:
            problems.append(f"expected >= 4 rung-by-rung recoveries, got "
                            f"{gs['recovers']}")
        ps = app.persister.stats()
        if not (ps["wal_enabled"] and ps["wal_stride"] == 1
                and ps["snapshot_factor"] == 1.0):
            problems.append(f"persister not fully restored after "
                            f"recovery: {ps['wal_enabled']=} "
                            f"{ps['wal_stride']=} {ps['snapshot_factor']=}")
        print(f"         recovery: level {gs['level']}, "
              f"{gs['sheds']} shed(s) / {gs['recovers']} recover(s)")

        # The egress exactly-once ledger survived the whole window.
        app.stop()  # final flush before reading the ledger
        stats = app.shipper.stats()
        ledger = receiver.stats()
        seqs = sorted(ledger["accepted_seqs"])
        if ledger["duplicate_seqs"] or ledger["duplicate_samples"]:
            problems.append(f"ledger saw duplicates: "
                            f"{len(ledger['duplicate_seqs'])} batches / "
                            f"{ledger['duplicate_samples']} samples")
        if seqs != list(range(1, len(seqs) + 1)):
            problems.append(f"ledger not contiguous: {seqs[:5]}…")
        print(f"         ledger: {len(seqs)} batches delivered "
              f"exactly-once (enqueued {stats['enqueued_batches']})")
        if problems:
            for p in problems:
                print(f"FAIL: {p}")
            return 1
        print("disk drill OK: full ladder climb, bounded usage, serving "
              "throughout, exactly-once ledger, rung-by-rung recovery")
        rc = 0
        return rc
    finally:
        try:
            app.stop()
        except Exception:  # noqa: BLE001 — teardown must finish
            pass
        receiver.stop()
        if own_dir and rc == 0:
            shutil.rmtree(root, ignore_errors=True)
        elif rc != 0:
            print(f"state kept for inspection: {root}")


def seen_levels_monotone(levels: list[int]) -> list[int]:
    """Helper for the climb-order assertion: the distinct levels seen,
    in first-seen order (a monotone climb sees them sorted)."""
    out: list[int] = []
    for lvl in levels:
        if lvl not in out:
            out.append(lvl)
    return out


# ---------------------------------------------------------------- memory


def run_memory_drill() -> int:
    """Memory-budget shedding over real components: fleet cache → trace
    ring halving → raw-ring cut, in that order, converging under budget
    while the raw rings keep their newest samples."""
    from tpu_pod_exporter_torch.fleet import _QueryCache
    from tpu_pod_exporter_torch.history import HistoryStore
    from tpu_pod_exporter_torch.pressure import PressureGovernor
    from tpu_pod_exporter_torch.trace import PollTrace, TraceStore

    # Raw rings only: the drill's convergence arithmetic is exact on the
    # 24-bytes-per-slot raw arrays (the downsample tiers are precisely the
    # memory the ladder REFUSES to shed — coarse data is cheapest).
    history = HistoryStore(capacity=256, max_series=4096, retention_s=0.0,
                           tiers=())
    base_wall = 1_700_000_000.0
    for i in range(200):
        for s in range(40):
            history.append("tpu_hbm_used_bytes", {"chip_id": str(s)},
                           float(i), t_mono=float(i),
                           t_wall=base_wall + i)
    trace_store = TraceStore(max_traces=256)
    for i in range(256):
        tr = PollTrace("poll", time.monotonic, time.time)
        for phase in ("device_read", "publish"):
            tr.begin(phase)
            tr.end("ok")
        trace_store.append(tr)
    cache = _QueryCache(512)
    fat = {"status": "ok", "data": {"result": ["x" * 64] * 16}}
    for i in range(300):
        cache.put(("window_stats", f"q{i}", 0, i), dict(fat))

    gov = PressureGovernor(check_interval_s=0.05, hysteresis_s=0.2)
    gov.register_memory_component("fleet_cache", cache.bytes)
    gov.register_memory_component("trace", trace_store.memory_bytes)
    gov.register_memory_component(
        "history", lambda: int(history.stats()["memory_bytes"]))
    shed_order: list[str] = []

    def shed(name, fn):
        def _apply():
            shed_order.append(name)
            fn()
        return _apply

    gov.add_memory_rung(
        "fleet_cache", shed("fleet_cache",
                            lambda: cache.set_enabled(False)),
        lambda: cache.set_enabled(True))
    gov.add_memory_rung(
        "trace_halved",
        shed("trace_halved",
             lambda: trace_store.set_max_traces(
                 max(trace_store.max_traces // 2, 8))),
        lambda: trace_store.set_max_traces(256))
    gov.add_memory_rung(
        "history_cut",
        shed("history_cut",
             lambda: history.set_capacity(max(history.capacity // 2, 16))),
        lambda: history.set_capacity(256))

    filled = gov._memory_usage()
    hist_bytes = int(history.stats()["memory_bytes"])
    trace_bytes = trace_store.memory_bytes()
    # Between (trace/2 + hist/2) and (trace/2 + hist): every rung must
    # fire before the accounted bytes fit, and the full ladder suffices.
    budget = int(trace_bytes / 2 + hist_bytes * 0.75)
    gov.set_memory_budget_bytes(budget)
    print(f"memory drill: accounted {filled}B (history {hist_bytes}B), "
          f"budget {budget}B")
    for _ in range(12):
        gov.tick()
        if gov._memory_usage() <= budget and gov.stats()["memory"]["level"] >= 3:
            break
        time.sleep(0.02)
    problems: list[str] = []
    accounted = gov._memory_usage()
    gs = gov.stats()["memory"]
    print(f"         shed order {shed_order}; accounted {accounted}B; "
          f"level {gs['level']}")
    if shed_order != ["fleet_cache", "trace_halved", "history_cut"]:
        problems.append(f"shed order wrong: {shed_order} (coarse tiers "
                        f"must shed LAST)")
    if accounted > budget:
        problems.append(f"accounted {accounted}B still over budget "
                        f"{budget}B after the full ladder")
    if cache.bytes() != 0:
        problems.append("fleet cache not cleared")
    rows = history.query_range("tpu_hbm_used_bytes",
                               {"chip_id": "0"},
                               start=base_wall, end=base_wall + 300)
    if not rows or rows[0]["values"][-1][1] != 199.0:
        problems.append("history lost its NEWEST samples in the cut")
    # The exposition view agrees with the governor.
    from tpu_pod_exporter_torch.metrics import SnapshotBuilder

    b = SnapshotBuilder()
    gov.emit(b)
    body = b.build(timestamp=time.time()).encode().decode()
    states = _metric_values(body, "tpu_exporter_pressure_state")
    if states.get('resource="memory"') != float(gs["level"]):
        problems.append(f"exposition pressure_state disagrees: {states}")
    # Relief: budget off; the ladder must unwind fully.
    gov.set_memory_budget_bytes(0)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        gov.tick()
        if gov.stats()["memory"]["level"] == 0:
            break
        time.sleep(0.05)
    gs = gov.stats()["memory"]
    if gs["level"] != 0:
        problems.append(f"memory ladder stuck at {gs['level']} after "
                        f"relief")
    if history.capacity != 256 or trace_store.max_traces != 256:
        problems.append("recovery did not restore capacities")
    if problems:
        for p in problems:
            print(f"FAIL: {p}")
        return 1
    print("memory drill OK: coarse-tiers-last shedding, budget "
          "convergence, newest samples kept, full recovery")
    return 0


# ----------------------------------------------------------------- storm


class _ProcessStorm:
    """:class:`~tpu_pod_exporter_torch.chaos.ScrapeStorm` run in a child
    process, with the same ``start``/``stop``/``stats`` calls. In this
    process its worker threads would share the interpreter lock with the
    server and the polite scraper, and the drill would time that lock
    instead of the server's admission control."""

    def __init__(self, host: str, port: int, conns: int, pause_s: float,
                 reject_pause_s: float) -> None:
        self._argv = [host, str(port), str(conns), str(pause_s),
                      str(reject_pause_s)]
        self._proc = None
        self._stats: dict | None = None

    def start(self) -> None:
        import subprocess
        import sys

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH", "")) if p))
        self._proc = subprocess.Popen(
            [sys.executable, "-c",
             "from tpu_pod_exporter_torch.pressure_demo import _storm_child; "
             "_storm_child()", *self._argv],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env)

    def stop(self) -> None:
        if self._proc is None:
            return
        proc, self._proc = self._proc, None
        out, _ = proc.communicate("", timeout=60)
        self._stats = json.loads(out)

    def stats(self) -> dict:
        return self._stats


def _storm_child() -> None:
    """The storm's process: runs until its stdin closes, then prints its
    stats as one JSON line."""
    import sys

    from tpu_pod_exporter_torch.chaos import ScrapeStorm

    host, port, conns, pause_s, reject_pause_s = sys.argv[1:6]
    storm = ScrapeStorm(host, int(port), conns=int(conns),
                        pause_s=float(pause_s),
                        reject_pause_s=float(reject_pause_s))
    storm.start()
    sys.stdin.read()
    storm.stop()
    print(json.dumps(storm.stats()), flush=True)


def run_storm_drill(conns: int, slack_frac: float, slack_s: float) -> int:
    """Scrape-storm admission control: a polite scraper's p99 stays within
    ``baseline * (1 + slack_frac) + slack_s`` while ``conns`` aggressive
    keep-alive connections hammer the same server."""
    import http.client

    from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
    from tpu_pod_exporter_torch.backend.fake import FakeBackend
    from tpu_pod_exporter_torch.collector import Collector
    from tpu_pod_exporter_torch.metrics import SnapshotStore
    from tpu_pod_exporter_torch.server import MetricsServer

    store = SnapshotStore()
    collector = Collector(FakeBackend(chips=64), FakeAttribution(), store)
    collector.poll_once()
    conn_cap = 16
    server = MetricsServer(
        store, host="127.0.0.1", port=0,
        max_concurrent_scrapes=4,
        # The drill isolates ADMISSION control; the token-bucket rate cap
        # (a different, earlier defense) would 429 the polite scraper and
        # the storm alike and mask what is being measured here.
        max_scrapes_per_s=0.0,
        max_open_connections=conn_cap,
        max_requests_per_client=8,
    )
    server.start()
    rc = 1
    storm = None
    try:
        # ONE long-lived keep-alive connection, established BEFORE the
        # storm — the shape of a real Prometheus scraper. Its admitted
        # connection slot is held for the duration, which is exactly how
        # admission control protects an incumbent scraper from a storm
        # (a NEW connection during a full-cap storm is indistinguishable
        # from the storm and gets the same 429).
        polite = http.client.HTTPConnection("127.0.0.1", server.port,
                                            timeout=10)

        def polite_p99(n: int) -> float:
            lat: list[float] = []
            for _ in range(n):
                t0 = time.perf_counter()
                polite.request("GET", "/metrics")
                resp = polite.getresponse()
                body = resp.read()
                if resp.status != 200 or not body:
                    raise RuntimeError(
                        f"polite scrape failed: {resp.status}")
                lat.append(time.perf_counter() - t0)
            return _p99(lat)

        baseline = polite_p99(150)
        storm = _ProcessStorm("127.0.0.1", server.port, conns=conns,
                              pause_s=0.02, reject_pause_s=1.0)
        storm.start()
        time.sleep(1.0)  # let the storm reach steady state
        try:
            during = polite_p99(150)
        except (OSError, RuntimeError) as e:
            # The incumbent scraper being rejected/disconnected IS the
            # drill failing — report it, never a traceback.
            print(f"FAIL: polite scraper failed during the storm: {e}")
            return 1
        finally:
            storm.stop()
            polite.close()
        st = storm.stats()
        peak = server.conn_stats["peak"]
        budget = baseline * (1.0 + slack_frac) + slack_s
        print(f"storm drill: {conns} conns; polite p99 "
              f"{1e3 * baseline:.2f}ms -> {1e3 * during:.2f}ms "
              f"(budget {1e3 * budget:.2f}ms); storm served "
              f"{st['served']} / rejected {st['rejected']} "
              f"(errors {st['errors']}); open-conn peak {peak} "
              f"(cap {conn_cap})")
        problems: list[str] = []
        if during > budget:
            problems.append(f"polite p99 {1e3 * during:.2f}ms blew the "
                            f"budget {1e3 * budget:.2f}ms")
        if st["rejected"] == 0:
            problems.append("storm drew zero 429s — admission control "
                            "inert")
        if peak > conn_cap:
            problems.append(f"open connections peaked at {peak} over the "
                            f"{conn_cap} cap")
        rejects = dict(server.scrape_rejects)
        if rejects.get("connections", 0) + rejects.get("client", 0) == 0:
            problems.append(f"no admission rejects counted: {rejects}")
        if problems:
            for p in problems:
                print(f"FAIL: {p}")
            return 1
        print(f"storm drill OK: rejects by cause {rejects}")
        rc = 0
        return rc
    finally:
        if storm is not None:
            storm.stop()
        server.stop()


def _write_result(path: str, doc: dict) -> None:
    try:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
    except OSError:
        pass
