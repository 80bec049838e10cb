"""What decides ``correct``: the plain reference on hand-worked inputs, the
controls, and whole runs with the timed path broken underneath (on the
CPU, through ``--rehearse``), each of which must come out not correct."""

from __future__ import annotations

import numpy as np

from portbench.reference import fleet, node, nvml
from portbench.tests.conftest import rehearse


def test_the_fleet_reference_on_two_nodes_by_hand():
    nodes = [
        {"host": "a", "slice_name": "s", "accelerator": "h",
         "gpus": [{"used": 10, "total": 100, "pod": {"name": "p1", "namespace": "n"}},
                  {"used": 20, "total": 100, "pod": {"name": "p1", "namespace": "n"}}]},
        {"host": "b", "slice_name": "s", "accelerator": "h",
         "gpus": [{"used": 30, "total": 100, "pod": {"name": "p2", "namespace": "n"}}]},
    ]
    want = fleet.expected(nodes)
    key = ("s", "h", "gpu")
    assert want["tpu_slice_hosts_reporting"] == {key: 2.0}
    assert want["tpu_slice_chip_count"] == {key: 3.0}
    assert want["tpu_slice_hbm_used_bytes"] == {key: 60.0}
    assert want["tpu_slice_hbm_total_bytes"] == {key: 300.0}
    assert want["tpu_slice_hbm_used_percent"] == {key: 20.0}
    assert want["tpu_fleet_family_chip_count"] == {("gpu",): 3.0}
    assert want["tpu_fleet_family_hosts_reporting"] == {("gpu",): 2.0}
    assert want["tpu_workload_chip_count"] == {("p1", "n", "s"): 2.0, ("p2", "n", "s"): 1.0}
    assert want["tpu_workload_hbm_used_bytes"] == {("p1", "n", "s"): 30.0, ("p2", "n", "s"): 30.0}
    assert want["tpu_workload_hosts"] == {("p1", "n", "s"): 1.0, ("p2", "n", "s"): 1.0}
    text = "\n".join([
        'tpu_slice_hosts_reporting{slice_name="s",accelerator="h",family="gpu"} 2',
        'tpu_slice_chip_count{slice_name="s",accelerator="h",family="gpu"} 3',
        'tpu_slice_hbm_used_bytes{slice_name="s",accelerator="h",family="gpu"} 61',
        'tpu_slice_hbm_used_percent{slice_name="s",accelerator="h",family="gpu"} 20.5'])
    got, _worst = fleet.judge([(0.0, text)], lambda t: [want])
    assert got["rollup_gap"] == 1.0
    assert got["percent_gap"] == 0.5 / 20.0
    assert got["rows_off"] == sum(len(r) for r in want.values()) - 4


def test_the_node_reference_by_hand():
    gpus = [nvml.Gpu(0, "GPU-a", 3, "H100", 1000, 8000, [(1, 900)])]
    pods = [{"name": "p", "namespace": "n", "container": "c", "cards": [0]}]
    topo = {"accelerator": "", "slice_name": "", "host": "h", "worker_id": ""}
    want = node.expected(gpus, pods, topo)
    chip = ("0", "/dev/nvidia3", "", "", "h", "", "p", "n", "c")
    assert want["gpu_hbm_used_bytes"] == {chip: 1000.0}
    assert want["gpu_process_memory_used_bytes"] == {chip + ("1",): 900.0}
    assert want["gpu_pod_memory_used_bytes"] == {("p", "n", "", "", "h", ""): 1000.0}
    assert want["gpu_pod_chip_count"] == {("p", "n", "", "", "h", ""): 1.0}
    mib = node.expected([nvml.Gpu(0, "GPU-a", 3, "H100", 3 << 19, 8 << 20, [])], pods, topo,
                        unit=node.MIB)
    assert mib["gpu_hbm_used_bytes"][chip] == 2 << 20


def test_the_float32_control_misses_whole_bytes():
    rng = np.random.default_rng(0)
    nodes = [{"host": f"n{j}", "slice_name": "s", "accelerator": "h",
              "gpus": [{"used": int(rng.integers(4 << 30, 78 << 30)), "total": 85520809984,
                        "pod": None} for _ in range(8)]} for j in range(32)]
    want = fleet.expected(nodes)
    low = fleet.expected(nodes, dtype=np.float32)
    assert low["tpu_slice_hbm_used_bytes"] != want["tpu_slice_hbm_used_bytes"]


def test_the_node_cell_judges_its_answers():
    line = rehearse("node-1g-scrape")
    assert line["correct"], line
    assert [c["name"] for c in line["checks"]] == ["rows_off", "mem_gap_bytes", "stale_s"]
    assert line["judged"] > 0


def test_the_node_control_is_not_correct():
    line = rehearse("node-1g-scrape", control=True)
    gap = {c["name"]: c["value"] for c in line["checks"]}["mem_gap_bytes"]
    assert not line["correct"] and gap > 0


PLANT = """
import os
import sys
if "-m" in sys.orig_argv and sys.orig_argv[sys.orig_argv.index("-m") + 1] == "{module}":
    sys.path.insert(0, os.getcwd())
{body}
"""


def _plant(monkeypatch, tmp_path, module: str, body: str) -> None:
    """Break the program underneath, in the process that runs ``module``:
    a ``sitecustomize`` on the children's path patches the port's modules
    there before the module starts."""
    (tmp_path / "sitecustomize.py").write_text(PLANT.format(module=module, body=body))
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))


def _plant_exporter(monkeypatch, tmp_path, body: str) -> None:
    _plant(monkeypatch, tmp_path, "portbench.rehearsal", body)


def _checks(line: dict) -> dict:
    return {c["name"]: c["value"] for c in line["checks"]}


def test_a_node_stuck_on_its_first_answer_is_not_correct(monkeypatch, tmp_path):
    _plant_exporter(monkeypatch, tmp_path, """
    from tpu_pod_exporter_torch import collector
    poll, last = collector.Collector.poll_once, []

    def stuck(self):
        if len(last) < 4:   # the warm polls run; then the state stays
            last.append(poll(self))
        return last[-1]

    collector.Collector.poll_once = stuck
""")
    line = rehearse("node-1g-scrape", seconds=10.0)
    assert not line["correct"] and _checks(line)["stale_s"] > 5.0, line


def test_a_node_that_serves_a_cached_read_under_a_fresh_poll_is_not_correct(
        monkeypatch, tmp_path):
    _plant_exporter(monkeypatch, tmp_path, """
    from tpu_pod_exporter_torch.backend import nvml
    sample, first = nvml.NvmlBackend.sample, []

    def cached(self):
        if not first:
            first.append(sample(self))
        return first[0]

    nvml.NvmlBackend.sample = cached
""")
    line = rehearse("node-1g-scrape", seconds=10.0)
    checks = _checks(line)
    assert not line["correct"] and checks["mem_gap_bytes"] > 0, line
    assert checks["stale_s"] < 5.0 and checks["rows_off"] == 0


def test_a_node_that_leaves_out_its_process_rows_is_not_correct(monkeypatch, tmp_path):
    _plant_exporter(monkeypatch, tmp_path, """
    from tpu_pod_exporter_torch.backend import nvml
    sample = nvml.NvmlBackend.sample

    def without(self):
        got = sample(self)
        return got._replace(chips=tuple(c._replace(processes=()) for c in got.chips))

    nvml.NvmlBackend.sample = without
""")
    line = rehearse("node-1g-scrape")
    assert not line["correct"] and _checks(line)["rows_off"] > 0, line


def test_a_node_that_alters_an_answer_where_it_is_read_is_not_correct(monkeypatch, tmp_path):
    _plant_exporter(monkeypatch, tmp_path, """
    from tpu_pod_exporter_torch.backend import nvml
    sample = nvml.NvmlBackend.sample

    def altered(self):
        got = sample(self)
        return got._replace(chips=tuple(c._replace(hbm_used_bytes=c.hbm_used_bytes + 1)
                                        for c in got.chips))

    nvml.NvmlBackend.sample = altered
""")
    line = rehearse("node-1g-scrape")
    assert not line["correct"] and _checks(line)["mem_gap_bytes"] == 1.0, line


def test_the_fleet_cell_judges_its_rounds():
    line = rehearse("fleet-su32-rounds")
    assert line["correct"], line
    assert line["judged"] > 0 and line["failed"] == 0


def test_the_fleet_control_is_not_correct():
    line = rehearse("fleet-su32-rounds", control=True)
    assert not line["correct"]


def _plant_rounds(monkeypatch, tmp_path, body: str) -> None:
    _plant(monkeypatch, tmp_path, "portbench.traffic.rounds",
           "    from tpu_pod_exporter_torch import aggregate\n" + body)


def test_a_round_that_publishes_nothing_is_not_correct(monkeypatch, tmp_path):
    _plant_rounds(monkeypatch, tmp_path, """
    publish, calls = aggregate.SliceAggregator._publish, []

    def stuck(self, *a, **kw):
        calls.append(1)
        if len(calls) <= 20:  # the warm rounds publish; then the state stays
            publish(self, *a, **kw)

    aggregate.SliceAggregator._publish = stuck
""")
    line = rehearse("fleet-su32-rounds")
    assert not line["correct"] and {c["name"]: c["value"] for c in line["checks"]}["stale_rounds"]


def test_a_round_that_leaves_out_half_its_targets_is_not_correct(monkeypatch, tmp_path):
    _plant_rounds(monkeypatch, tmp_path, """
    import zlib
    fetch = aggregate.default_fetch

    def half(target, timeout_s, traceparent=None):
        if zlib.crc32(target.encode()) % 2:
            raise OSError("left out")
        return fetch(target, timeout_s, traceparent=traceparent)

    aggregate.default_fetch = half
""")
    assert not rehearse("fleet-su32-rounds")["correct"]


def test_a_round_that_alters_a_rollup_is_not_correct(monkeypatch, tmp_path):
    _plant_rounds(monkeypatch, tmp_path, """
    emit = aggregate.emit_rollups

    def altered(b, slices, *a, **kw):
        for agg in slices.values():
            agg.hbm_used += 1.0
        return emit(b, slices, *a, **kw)

    aggregate.emit_rollups = altered
""")
    assert not rehearse("fleet-su32-rounds")["correct"]


def test_a_round_that_reuses_a_body_it_fetched_before_is_not_correct(monkeypatch, tmp_path):
    _plant_rounds(monkeypatch, tmp_path, """
    fetch, seen = aggregate.default_fetch, {}

    def reused(target, timeout_s, traceparent=None):
        body = fetch(target, timeout_s, traceparent=traceparent)
        return seen.setdefault(target, body)

    aggregate.default_fetch = reused
""")
    line = rehearse("fleet-su32-rounds")
    checks = _checks(line)
    assert not line["correct"] and checks["rollup_gap"] > 0, line
    assert checks["fetched_off"] == 0 and checks["stale_rounds"] == 0


def test_a_round_that_fetches_nothing_new_is_not_correct(monkeypatch, tmp_path):
    _plant_rounds(monkeypatch, tmp_path, """
    fetch, seen = aggregate.default_fetch, {}

    def cached(target, timeout_s, traceparent=None):
        if target not in seen:
            seen[target] = fetch(target, timeout_s, traceparent=traceparent)
        return seen[target]

    aggregate.default_fetch = cached
""")
    line = rehearse("fleet-su32-rounds")
    assert not line["correct"] and _checks(line)["fetched_off"] > 0, line


def test_an_answer_is_judged_against_the_cards_states_around_its_poll():
    pods = [{"name": "p", "namespace": "n", "container": "c", "cards": [0]}]
    topo = {"accelerator": "", "slice_name": "", "host": "h", "worker_id": ""}
    steady = [nvml.Gpu(0, "GPU-a", 3, "H100", 1000, 8000, [(1, 900)])]
    moved = [nvml.Gpu(0, "GPU-a", 3, "H100", 1500, 8000, [(1, 900)])]

    def body(gpus, polled):
        lines = [f"tpu_exporter_last_poll_timestamp_seconds {polled}"]
        for name, rows in node.expected(gpus, pods, topo).items():
            for key, value in rows.items():
                labels = ",".join(f'{k}="{v}"' for k, v in zip(node.KEYS[name], key))
                lines.append(f"{name}{{{labels}}} {value}")
        return "\n".join(lines)

    def wants(t):   # the card moved for a moment around t = 10
        states = (steady, moved) if 9.0 <= t <= 11.0 else (steady,)
        return [node.expected(g, pods, topo) for g in states]

    near, _ = node.judge([(10.5, body(moved, 10.0))], wants)
    assert near == {"rows_off": 0, "mem_gap_bytes": 0.0, "stale_s": 0.5}
    far, worst = node.judge([(20.5, body(moved, 20.0))], wants)
    assert far["mem_gap_bytes"] == 500.0 and worst


def test_an_answer_read_while_the_card_moved_may_lie_between_its_states():
    pods = [{"name": "p", "namespace": "n", "container": "c", "cards": [0]}]
    topo = {"accelerator": "", "slice_name": "", "host": "h", "worker_id": ""}
    wants = [node.expected([nvml.Gpu(0, "GPU-a", 3, "H100", used, 8000, [])], pods, topo)
             for used in (1000, 1500)]
    between = node.expected([nvml.Gpu(0, "GPU-a", 3, "H100", 1200, 8000, [])], pods, topo)
    beyond = node.expected([nvml.Gpu(0, "GPU-a", 3, "H100", 1600, 8000, [])], pods, topo)
    assert node.compare(between, wants) == (0, 0.0)
    assert node.compare(beyond, wants) == (0, 100.0)
    assert node.compare(between, wants[:1]) == (0, 200.0)


def test_a_poll_read_the_card_after_the_poll_before_it_was_stamped():
    from portbench.drivers.node import FIRST_BEFORE_S, READ_SLACK_S, read_window

    stamps = [10.0, 11.0, 14.5]     # the third poll ran long
    assert read_window(stamps, 11.0) == (1.0 + READ_SLACK_S, READ_SLACK_S)
    assert read_window(stamps, 14.5) == (3.5 + READ_SLACK_S, READ_SLACK_S)
    assert read_window(stamps, 10.0) == (FIRST_BEFORE_S + READ_SLACK_S, READ_SLACK_S)
