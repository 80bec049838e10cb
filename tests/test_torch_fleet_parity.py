"""The port's fleet plane held against the JAX package's on the same inputs.

The port's own exporters make the scrape bodies: two hosts of eight
simulated NVML cards in one pool (one card's memory rises by 20 GiB in the
middle rounds) beside a fake TPU host, a mixed fleet; and the recorded
real TPU body ``tests/fixtures/real-metrics-r5.txt`` and the H100's
``tests/fixtures/h100-metrics.txt`` (the port's node exporter on the card
under a 16 GiB fill, as ``chip_smoke.py`` captured it). The same bodies go
through both packages' flat aggregators (an injected fetch, and a
``ReplayFetch`` of one recorded round file) and through both packages'
leaf -> root trees, whose roots keep a ``FleetStore`` under one recording
rule and evaluate one alert rule with a webhook notifier. The tolerance is
equality: this is host code on the same floats. Outside the families that
time a round or measure the process (``VOLATILE_FAMILIES``), the
expositions have the same lines in the same order and the same values; the
stores answer ``query_range`` the same, and a store dir written by either
package opens in the other; the alert transitions, webhook bodies and seqs
are the same; the stream hubs send the same frames; ``status --tree
--json`` gives the same document outside its timing fields.
"""

import json
import re
import time
from pathlib import Path

import pytest
from test_torch_exporter import without_port_instrumentation

from tpu_pod_exporter import aggregate as jax_aggregate
from tpu_pod_exporter import alerting as jax_alerting
from tpu_pod_exporter import shard as jax_shard
from tpu_pod_exporter import status as jax_status
from tpu_pod_exporter import store as jax_store
from tpu_pod_exporter import stream as jax_stream
from tpu_pod_exporter.metrics import SnapshotStore as JaxSnapshotStore
from tpu_pod_exporter.server import MetricsServer as JaxMetricsServer
from tpu_pod_exporter_torch import aggregate as port_aggregate
from tpu_pod_exporter_torch import alerting as port_alerting
from tpu_pod_exporter_torch import shard as port_shard
from tpu_pod_exporter_torch import status as port_status
from tpu_pod_exporter_torch import store as port_store
from tpu_pod_exporter_torch import stream as port_stream
from tpu_pod_exporter_torch.app import ExporterApp
from tpu_pod_exporter_torch.backend.nvml import GpuScript, NvmlBackend, SimulatedNvmlDriver
from tpu_pod_exporter_torch.config import ExporterConfig
from tpu_pod_exporter_torch.metrics import SnapshotStore as PortSnapshotStore
from tpu_pod_exporter_torch.server import MetricsServer as PortMetricsServer

GIB = 1 << 30
ROUNDS = 6
BASE_WALL = 1_700_000_000.0
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "real-metrics-r5.txt"
H100_FIXTURE = FIXTURE.parent / "h100-metrics.txt"

# Families whose values time a round or measure this process: round and
# scrape durations, round timestamps, leaf staleness, CPU and RSS.
VOLATILE_FAMILIES = (
    "tpu_aggregator_scrape_duration_seconds",
    "tpu_aggregator_last_round_timestamp_seconds",
    "tpu_aggregator_round_duration_seconds",
    "tpu_aggregator_round_seconds",
    "tpu_aggregator_target_scrape_seconds",
    "tpu_aggregator_cpu_seconds_total",
    "tpu_aggregator_rss_bytes",
    "tpu_root_round_duration_seconds",
    "tpu_root_round_seconds",
    "tpu_root_leaf_staleness_seconds",
)

STORE_RULES = 'h100:hbm:by_slice = sum(tpu_slice_hbm_used_bytes{family="gpu"}) by (slice_name)\n'
ALERT_RULES = """\
alert PoolHbmHigh = tpu_slice_hbm_used_bytes{family="gpu",slice_name="h100-pool-a"} > 45e9
    for 10s
    labels(severity="info")
    annotations(summary="{{ $labels.slice_name }} at {{ $value }} B")
"""

PACKAGES = {
    "jax": dict(aggregate=jax_aggregate, alerting=jax_alerting, shard=jax_shard,
                status=jax_status, store=jax_store, stream=jax_stream,
                SnapshotStore=JaxSnapshotStore, MetricsServer=JaxMetricsServer),
    "port": dict(aggregate=port_aggregate, alerting=port_alerting, shard=port_shard,
                 status=port_status, store=port_store, stream=port_stream,
                 SnapshotStore=PortSnapshotStore, MetricsServer=PortMetricsServer),
}


def _gpu_app(host: int) -> ExporterApp:
    def used(card):
        def at(step):
            base = (host * 8 + card + 1) * GIB / 4
            return base + (20 * GIB if (host, card) == (0, 0) and 2 <= step <= 3 else 0.0)
        return at

    scripts = [GpuScript(mem_total_bytes=80 * GIB, mem_used_bytes=used(card),
                         utilization_percent=float(10 * card), name="NVIDIA H100 80GB HBM3",
                         uuid=f"GPU-h{host}-{card}") for card in range(8)]
    cfg = ExporterConfig(port=0, host="127.0.0.1", backend="nvml", attribution="none",
                         slice_name="h100-pool-a", node_name=f"gpu-{host}",
                         accelerator="nvidia-h100-80gb")
    return ExporterApp(cfg, backend=NvmlBackend(driver=SimulatedNvmlDriver(scripts)))


@pytest.fixture(scope="module")
def mixed_rounds() -> list:
    """ROUNDS rounds of {target: /metrics body} from the port's exporters."""
    apps = {"gpu-0:8000": _gpu_app(0), "gpu-1:8000": _gpu_app(1),
            "tpu-0:8000": ExporterApp(ExporterConfig(
                port=0, host="127.0.0.1", backend="fake", fake_chips=4,
                attribution="none", accelerator="v4-8", slice_name="tpu-slice",
                node_name="tpu-0"))}
    rounds = []
    try:
        for _ in range(ROUNDS):
            for app in apps.values():
                app.collector.poll_once()
            rounds.append({t: app.store.current().encode().decode()
                           for t, app in apps.items()})
    finally:
        for app in apps.values():
            app.stop()
    return rounds


def _fixture_rounds(path: Path = FIXTURE) -> list:
    return [{"h0:8000": path.read_text()}] * 2


def _split(line: str) -> tuple:
    if line.startswith("#"):
        return line, None
    key, value = line.rsplit(" ", 1)
    return key, value


def _family(key: str) -> str:
    name = re.split(r"[{ ]", key, maxsplit=1)[0]
    return re.sub(r"_(bucket|sum|count)$", "", name)


def assert_same_exposition(jax_body: str, port_body: str) -> int:
    """Same lines in the same order, equal values outside VOLATILE_FAMILIES,
    once the port's own instrumentation families are dropped (the JAX
    package has none; a port body may stand on either side); returns the
    number of sample lines compared."""
    jax_lines = [_split(ln) for ln in without_port_instrumentation(jax_body).splitlines()
                 if ln]
    port_lines = [_split(ln) for ln in without_port_instrumentation(port_body).splitlines()
                  if ln]
    assert [k for k, _ in jax_lines] == [k for k, _ in port_lines]
    compared = 0
    for (key, jv), (_, pv) in zip(jax_lines, port_lines):
        if jv is None or _family(key) in VOLATILE_FAMILIES:
            continue
        assert jv == pv, key
        compared += 1
    return compared


def _rounds_fetch(rounds: list, index: list):
    def fetch(target, timeout_s):
        return rounds[index[0]][target]
    return fetch


def flat_bodies(pkg: dict, rounds: list, replay_path: str | None = None) -> list:
    """One flat aggregator over ``rounds``: its exposition after each round."""
    index = [0]
    fetch = (pkg["aggregate"].ReplayFetch(replay_path, loop=False) if replay_path
             else _rounds_fetch(rounds, index))
    store = pkg["SnapshotStore"]()
    agg = pkg["aggregate"].SliceAggregator(tuple(rounds[0]), store, fetch=fetch)
    bodies = []
    try:
        for i in range(len(rounds)):
            index[0] = i
            agg.poll_once()
            bodies.append(store.current().encode().decode())
    finally:
        agg.close()
    return bodies


class TestFlatAggregator:
    @pytest.mark.parametrize("source", ["mixed", "fixture", "h100"])
    def test_same_bodies_same_exposition(self, mixed_rounds, source):
        rounds = {"mixed": lambda: mixed_rounds, "fixture": _fixture_rounds,
                  "h100": lambda: _fixture_rounds(H100_FIXTURE)}[source]()
        jax_bodies = flat_bodies(PACKAGES["jax"], rounds)
        port_bodies = flat_bodies(PACKAGES["port"], rounds)
        for jb, pb in zip(jax_bodies, port_bodies):
            assert assert_same_exposition(jb, pb) > 0
        if source == "mixed":
            last = port_bodies[-1]
            assert 'family="gpu"' in last and 'family="tpu"' in last
            assert ('tpu_fleet_family_chip_count{family="gpu"} 16' in last
                    and 'tpu_fleet_family_chip_count{family="tpu"} 4' in last)
        if source == "h100":
            assert 'tpu_fleet_family_chip_count{family="gpu"} 1' in port_bodies[-1]

    def test_replay_of_one_recorded_round_file(self, mixed_rounds, tmp_path):
        path = tmp_path / "rounds.jsonl"
        recorder = port_aggregate.RoundRecorder(str(path))
        for bodies in mixed_rounds:
            recorder.record([(t, text, 0.0) for t, text in bodies.items()])
        recorder.close()
        jax_bodies = flat_bodies(PACKAGES["jax"], mixed_rounds, str(path))
        port_bodies = flat_bodies(PACKAGES["port"], mixed_rounds, str(path))
        for jb, pb, direct in zip(jax_bodies, port_bodies,
                                  flat_bodies(PACKAGES["port"], mixed_rounds)):
            assert_same_exposition(jb, pb)
            assert_same_exposition(direct, pb)


class FixedClock:
    """The root's wall clock, stepped one interval a round."""

    def __init__(self) -> None:
        self.t = BASE_WALL

    def __call__(self) -> float:
        return self.t


class Tree:
    """One package's leaf -> root tree in-process over the same bodies: two
    leaves, a root with a FleetStore (one recording rule) and an
    AlertEvaluator whose notifier posts through an injected send."""

    def __init__(self, pkg: dict, rounds: list, tmp: Path) -> None:
        sh = pkg["shard"]
        self.pkg, self.rounds, self.tmp = pkg, rounds, tmp
        self.index = [0]
        self.clock = FixedClock()
        fetch = _rounds_fetch(rounds, self.index)
        smap = sh.ShardMap(sh.default_shards(2))
        self.leaves = {}
        topology = {}
        for i in range(2):
            store = pkg["SnapshotStore"]()
            agg = sh.LeafAggregator(f"shard-{i}", f"{i}a", smap, targets=tuple(rounds[0]),
                                    store=store, fetch=fetch)
            self.leaves[f"leaf-{i}:9100"] = (agg, store)
            topology[f"shard-{i}"] = (f"leaf-{i}:9100",)
        self.store_dir, self.alert_dir = tmp / "store", tmp / "alerts"
        self.fleet_store = pkg["store"].FleetStore(
            str(self.store_dir), tiers="10:64,60:64",
            rules=pkg["store"].parse_rules(STORE_RULES))
        self.fleet_store.open()
        self.posts = []

        def send(url, body, headers, timeout_s):
            self.posts.append((headers[pkg["alerting"].SEQ_HEADER], json.loads(body)))
            return 200

        self.notifier = pkg["alerting"].AlertNotifier(
            "http://alerts.invalid/hook", str(self.alert_dir), send=send,
            clock=lambda: 0.0, wallclock=self.clock)
        self.notifier.load()
        self.notifier.start()
        self.evaluator = pkg["alerting"].AlertEvaluator(
            pkg["alerting"].parse_alert_rules(ALERT_RULES), alert_dir=str(self.alert_dir),
            notifier=self.notifier, store=self.fleet_store,
            recording_rules=self.fleet_store.rules, wallclock=self.clock)
        self.root_store = pkg["SnapshotStore"]()
        self.root = sh.RootAggregator(
            topology, self.root_store, wallclock=self.clock,
            fetch=lambda addr, timeout_s: self.leaves[addr][1].current().encode().decode(),
            fleet_store=self.fleet_store, alert_evaluator=self.evaluator)

    def run(self) -> list:
        bodies = []
        for i in range(len(self.rounds)):
            self.index[0] = i
            self.clock.t = BASE_WALL + 10.0 * i
            for agg, _ in self.leaves.values():
                agg.poll_once()
            self.root.poll_once()
            bodies.append(self.root_store.current().encode().decode())
        return bodies

    def delivered(self, n: int) -> list:
        deadline = time.monotonic() + 10
        while len(self.posts) < n and time.monotonic() < deadline:
            time.sleep(0.01)
        return list(self.posts)

    def close(self) -> None:
        self.root.close()
        for agg, _ in self.leaves.values():
            agg.close()
        self.evaluator.close()
        self.fleet_store.close()


@pytest.fixture
def trees(mixed_rounds, tmp_path):
    built = {name: Tree(pkg, mixed_rounds, tmp_path / name) for name, pkg in PACKAGES.items()}
    bodies = {name: tree.run() for name, tree in built.items()}
    try:
        yield built, bodies
    finally:
        for tree in built.values():
            tree.close()


class TestShardTree:
    def test_roots_publish_the_same_rollups(self, trees):
        _, bodies = trees
        for jb, pb in zip(bodies["jax"], bodies["port"]):
            assert assert_same_exposition(jb, pb) > 0
        assert 'tpu_fleet_family_chip_count{family="gpu"} 16' in bodies["port"][-1]

    def test_root_equals_the_flat_aggregator(self, trees, mixed_rounds):
        _, bodies = trees
        flat = flat_bodies(PACKAGES["port"], mixed_rounds)[-1]

        def rollups(text):
            return sorted(ln for ln in text.splitlines()
                          if ln.startswith(("tpu_slice_", "tpu_fleet_family_")))

        assert rollups(flat) and rollups(flat) == rollups(bodies["port"][-1])

    def test_h100_body_through_both_trees(self, tmp_path):
        rounds = _fixture_rounds(H100_FIXTURE)
        built = {name: Tree(pkg, rounds, tmp_path / name) for name, pkg in PACKAGES.items()}
        try:
            bodies = {name: tree.run() for name, tree in built.items()}
        finally:
            for tree in built.values():
                tree.close()
        for jb, pb in zip(bodies["jax"], bodies["port"]):
            assert assert_same_exposition(jb, pb) > 0
        assert 'tpu_fleet_family_chip_count{family="gpu"} 1' in bodies["port"][-1]


class TestStoreAndAlerts:
    def _answers(self, store_mod, store_dir: Path) -> dict:
        st = store_mod.FleetStore(str(store_dir), tiers="10:64,60:64",
                                  rules=store_mod.parse_rules(STORE_RULES))
        st.open()
        try:
            return {metric: st.query_range(metric, start=BASE_WALL - 60,
                                           end=BASE_WALL + 10 * ROUNDS)
                    for metric in ("h100:hbm:by_slice", "tpu_slice_hbm_used_bytes",
                                   "tpu_fleet_family_chip_count", "ALERTS")}
        finally:
            st.close()

    def test_query_range_answers_are_equal(self, trees):
        built, _ = trees
        answers = {name: {metric: tree.fleet_store.query_range(
            metric, start=BASE_WALL - 60, end=BASE_WALL + 10 * ROUNDS)
            for metric in ("h100:hbm:by_slice", "tpu_slice_hbm_used_bytes")}
            for name, tree in built.items()}
        assert answers["jax"] == answers["port"]
        (row,) = [r for r in answers["port"]["h100:hbm:by_slice"]
                  if r["labels"] == {"slice_name": "h100-pool-a"}]
        assert max(v for _, v in row["values"]) - min(v for _, v in row["values"]) == 20 * GIB

    def test_store_dirs_open_in_the_other_package(self, trees):
        built, _ = trees
        for tree in built.values():
            tree.close()
        for writer in PACKAGES:
            own = self._answers(PACKAGES[writer]["store"], built[writer].store_dir)
            for reader in PACKAGES:
                assert self._answers(PACKAGES[reader]["store"],
                                     built[writer].store_dir) == own, (writer, reader)
            assert own["ALERTS"] and own["h100:hbm:by_slice"]

    def test_same_transitions_webhook_bodies_and_seqs(self, trees):
        built, _ = trees
        transitions = {name: tree.evaluator.transitions() for name, tree in built.items()}
        assert transitions["jax"] == transitions["port"]
        assert [t["to"] for t in transitions["port"]] == ["pending", "firing", "resolved"]
        posts = {name: tree.delivered(2) for name, tree in built.items()}
        assert posts["jax"] == posts["port"]
        assert [(seq, body["state"]) for seq, body in posts["port"]] == [
            ("1", "firing"), ("2", "resolved")]


class TestStream:
    @staticmethod
    def frames(pkg: dict, rounds_bodies: list) -> list:
        """A stream hub over the tier's tpu_slice_hbm_used_bytes rows, one
        round per body; the SSE frames a subscriber gets, without ``ts``."""
        st = pkg["stream"]
        from tpu_pod_exporter_torch.metrics.parse import parse_exposition

        current = {"gen": 0}

        def poll(shape, gen):
            rows = [{"metric": s.name, "labels": dict(s.labels), "value": s.value}
                    for s in parse_exposition(rounds_bodies[current["gen"]])
                    if s.name == "tpu_slice_hbm_used_bytes"]
            return {"status": "ok", "partial": False, "source": "live",
                    "data": {"result": rows}}

        hub = st.StreamHub(poll, lambda: current["gen"], heartbeat_s=3600.0,
                           full_sync_s=3600.0, wallclock=lambda: BASE_WALL)
        chunks = []
        shape = st.QueryShape(route="window_stats", metric="tpu_slice_hbm_used_bytes",
                              window_s=30.0)
        _sub, first = hub.subscribe(shape, chunks.append, lambda: None)
        chunks.append(first)
        for gen in range(1, len(rounds_bodies)):
            current["gen"] = gen
            hub.on_round(gen)
        hub.close()
        parser = st.SseParser()
        frames = [f for chunk in chunks for f in parser.feed(chunk)]
        for f in frames:
            f.pop("ts", None)
        return frames

    def test_same_snapshot_and_deltas(self, mixed_rounds):
        per_pkg = {name: self.frames(pkg, flat_bodies(pkg, mixed_rounds))
                   for name, pkg in PACKAGES.items()}
        assert per_pkg["jax"] == per_pkg["port"]
        types = [f["type"] for f in per_pkg["port"]]
        assert types[0] == "snapshot" and "delta" in types
        assert [f["seq"] for f in per_pkg["port"]] == list(range(len(types)))


class TestStatusTree:
    # Timing fields, and the webhook sender's progress, which its own thread
    # makes after the round that wrote the alert sidecar.
    TIMING = ("staleness_s", "last_round_ts", "round_duration_s", "wall",
              "last_append_wall", "memory_bytes", "sent", "failed",
              "backlog_records", "backlog_bytes", "backlog_age_s")

    def _strip(self, doc):
        if isinstance(doc, dict):
            return {k: self._strip(v) for k, v in doc.items() if k not in self.TIMING}
        if isinstance(doc, list):
            return [self._strip(v) for v in doc]
        return doc

    def test_status_tree_json_is_equal(self, trees, capsys):
        built, _ = trees
        docs = {}
        for name, tree in built.items():
            server = tree.pkg["MetricsServer"](tree.root_store, host="127.0.0.1", port=0)
            server.start()
            try:
                rc = tree.pkg["status"].main([
                    "--tree", f"127.0.0.1:{server.port}", "--store-dir", str(tree.store_dir),
                    "--alert-dir", str(tree.alert_dir), "--json"])
            finally:
                server.stop()
            out = capsys.readouterr().out
            assert rc == 0, out
            docs[name] = json.loads(out)
        for doc in docs.values():  # each package's own root port and store dir
            doc.pop("root")
            doc["store"].pop("dir")
        assert self._strip(docs["jax"]) == self._strip(docs["port"])
        assert docs["port"]["fleet"]["family_chips"] == {"gpu": 16.0, "tpu": 4.0}


class TestStatusNode:
    def test_gpu_holders_found_where_the_reference_scans_accel_only(
            self, tmp_path, capsys):
        """``status --process-metrics`` on a GPU node: the JAX doctor walks
        /dev/accel and /dev/vfio whatever the backend and lists no holder;
        the port's walks /dev/nvidia<minor>, as both exporters' GPU scans
        should, and finds the process that holds the card."""
        import os

        fd = tmp_path / "77" / "fd"
        fd.mkdir(parents=True)
        os.symlink("/dev/nvidia0", fd / "3")
        os.symlink("/dev/nvidiactl", fd / "4")
        (tmp_path / "77" / "comm").write_text("python\n")
        (tmp_path / "77" / "cgroup").write_text("0::/user.slice\n")
        argv = ["--backend", "nvml", "--nvml-sim-gpus", "1", "--attribution", "none",
                "--process-metrics", "--proc-root", str(tmp_path), "--json"]
        holders = {}
        for name, pkg in PACKAGES.items():
            assert pkg["status"].main(argv) == 0
            (chip,) = json.loads(capsys.readouterr().out)["chips"]
            assert chip["device_path"] == "/dev/nvidia0"
            holders[name] = chip["holders"]
        assert holders == {"jax": [],
                           "port": [{"pid": 77, "comm": "python", "pod_uid": ""}]}
