"""The harness on the CPU: what it finds by name, how it times and reads,
and the benchmark's data generators."""

from __future__ import annotations

import http.server
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import pytest

from portbench import moves, procs, spec
from portbench.traffic import bodies, openloop

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_the_index_keeps_the_contracts_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["kind"] in ("node", "fleet")
    assert (ROOT / "portbench" / "drivers" / f"{c.config['kind']}.py").exists()
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_a_cell_and_a_metric_added_as_files_alone_run(tmp_path):
    """A copy of the benchmark gains a traffic mix (Prometheus's real rate)
    and a metric reader as new files, and entries in BENCHMARK.json; the
    new cell runs and reports."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "tpu_pod_exporter_torch", tmp_path / "tpu_pod_exporter_torch")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    mix = json.loads((ROOT / "portbench/traffic/scrape-openloop.json").read_text())
    mix.update(rate_per_s=2.4, connections=4, warm_requests=5, judged_answers=8)
    (tmp_path / "portbench/traffic/prom-real-rate.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/metrics/exporter_cpu_pct.py").write_text(
        "def read(window):\n"
        "    return window['cpu_s'] / window['window_s'] * 100.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "node-1g-prom", "config": "gke-a3-highgpu-1g",
                               "traffic": "prom-real-rate", "chips": 1, "why": "a test cell"})
    bench["end_to_end"].insert(0, {"name": "exporter_cpu_pct", "unit": "%", "better": "lower",
                                   "bound": 0.25, "source": "host_clock",
                                   "workloads": ["node-1g-prom"]})
    for m in bench["per_layer"]:
        if m["name"] == "poll_total_ms.scrape":
            m["workloads"].append("node-1g-prom")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    lines = {}
    for trace in ("0", "1"):
        done = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload", "node-1g-prom", "--seed",
             "4294967311", "--seconds", "3", "--trace", trace, "--rehearse"],
            cwd=tmp_path, capture_output=True, text=True, timeout=240)
        assert done.returncode == 0, done.stderr[-3000:]
        lines[trace] = json.loads(done.stdout.strip().splitlines()[-1])
    assert set(lines["0"]["metrics"]) == {"exporter_cpu_pct", "setup_s"}
    assert set(lines["1"]["metrics"]) == {"poll_total_ms.scrape"}
    assert lines["0"]["correct"] and lines["1"]["correct"]
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    done = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "node-1g-scrape", "--seed", "3",
         "--seconds", "2", "--rehearse"], cwd=tmp_path, capture_output=True, text=True,
        timeout=240)
    assert done.returncode != 0 and done.stdout.strip() == ""


class _Slow(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_GET(self):  # noqa: N802
        time.sleep(0.02)
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"ok")

    def log_message(self, *args):
        pass


def test_the_open_loop_times_each_request_from_its_due_instant():
    server = http.server.HTTPServer(("127.0.0.1", 0), _Slow)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        dues = [0.005 * k for k in range(20)]       # due faster than served
        loop = openloop.OpenLoop("127.0.0.1", server.server_address[1], "/", {}, 1)
        res = sorted(loop.run(dues, time.perf_counter()), key=lambda r: r.due)
    finally:
        server.shutdown()
        server.server_close()
    assert [r.status for r in res] == [200] * 20
    last = res[-1]
    assert last.done - last.sent < 0.1              # served in one service time
    assert last.done - last.due > 0.25              # but late by the queue ahead of it
    waits = [r.sent - r.due for r in res]
    assert waits[-1] > waits[1]


def test_arrivals_are_one_set_in_another_order_for_every_seed():
    a = openloop.due_instants(80.0, 30.0, 1)
    b = openloop.due_instants(80.0, 30.0, 2**31 + 7)
    assert len(a) == len(b) == 2400 and a != b
    gaps = sorted(y - x for x, y in zip([0.0] + a, a))
    gaps_b = sorted(y - x for x, y in zip([0.0] + b, b))
    assert max(abs(x - y) for x, y in zip(gaps, gaps_b)) < 0.02
    assert 0 < a[0] and a[-1] < 30.0


def test_cpu_is_read_from_proc():
    child = subprocess.Popen([sys.executable, "-c",
                              "import time\nt=time.process_time()\n"
                              "while time.process_time()-t<0.6: pass\n"
                              "print('done', flush=True)\ntime.sleep(30)"],
                             stdout=subprocess.PIPE, text=True)
    try:
        assert child.stdout.readline().strip() == "done"
        with open(f"/proc/{child.pid}/stat") as f:
            raw = f.read().rsplit(")", 1)[1].split()
        ticks = (int(raw[11]) + int(raw[12])) / os.sysconf("SC_CLK_TCK")
        assert procs.cpu_seconds(child.pid) == ticks
        assert 0.5 <= ticks < 5.0
    finally:
        child.kill()
        child.wait()


def test_the_fleet_bodies_follow_the_seed():
    fleet = json.loads((ROOT / "portbench/configs/dgx-superpod-su32.json").read_text())["fleet"]
    one, again, other = (bodies.make_nodes(s, fleet) for s in (5, 5, 2**32 + 5))
    assert one == again and one != other
    texts = [bodies.render(n) for n in one]
    assert texts == [bodies.render(n) for n in again]
    sizes = sorted(len(t) for t in texts)
    other_sizes = sorted(len(bodies.render(n)) for n in other)
    assert abs(sum(sizes) - sum(other_sizes)) < 0.01 * sum(sizes)
    from portbench.reference import expo
    samples = expo.parse(texts[0])
    assert len(expo.family(samples, "gpu_chip_info")) == 8
    assert len(expo.family(samples, "gpu_process_memory_used_bytes")) == 8
    shapes = {len(expo.family(expo.parse(t), "gpu_pod_chip_count")) for t in texts}
    assert shapes == {1, 8}
    assert sum(len(expo.family(expo.parse(t), "gpu_pod_chip_count")) == 8
               for t in texts) == 31 - round(31 * 0.75)


def test_a_nodes_variants_keep_its_series_and_change_its_values():
    fleet = json.loads((ROOT / "portbench/configs/dgx-superpod-su32.json").read_text())["fleet"]
    every = bodies.variants(7, fleet)
    assert len(every) == fleet["variants"] and every[0] == bodies.make_nodes(7, fleet)
    from portbench.reference import expo

    def series(node):
        return {(n, frozenset(lab.items())) for n, lab, _v in expo.parse(bodies.render(node))}

    for a, b in zip(every[0], every[1]):
        assert series(a) == series(b)
        assert [g["used"] for g in a["gpus"]] != [g["used"] for g in b["gpus"]]
    used = [sorted(g["used"] >> 21 for n in v for g in n["gpus"]) for v in every]
    assert all(u == used[0] for u in used)


def test_the_body_server_answers_each_node_with_its_variants_in_turn(tmp_path):
    for v in range(3):
        (tmp_path / f"n1.{v}.txt").write_text(f"m {v}\n")
    child = procs.Child(["-m", "portbench.traffic.bodyserver", str(tmp_path)],
                        tmp_path / "server.log")
    try:
        port = child.expect("ports", 60)["ports"]["n1"]
        got = [procs.http_get(f"http://127.0.0.1:{port}/metrics")[1] for _ in range(5)]
    finally:
        child.close()
    assert got == [b"m 0\n", b"m 1\n", b"m 2\n", b"m 0\n", b"m 1\n"]
    times = json.loads((tmp_path / "served.json").read_text())["n1"]
    assert len(times) == 5 and times == sorted(times)


def test_the_cards_walk_follows_the_seed():
    conf = json.loads((ROOT / "portbench/configs/gke-a3-highgpu-1g.json").read_text())
    spec_ = conf["stimulus"]["moves"]
    one, again, other = (moves.walk(s, spec_) for s in (5, 5, 2**32 + 5))
    assert one == again and one != other
    for part in (0, 1):
        assert sorted(x[part] for x in one) == sorted(x[part] for x in other)
    assert [size for _h, size in one[::2]] == [0] * spec_["blocks"]
    assert all(size > 0 for _h, size in one[1::2])
    lo, hi = spec_["hold_s"]
    assert all(lo <= h <= hi for h, _s in one)
    cycle = sum(h for h, _s in one)
    assert moves.block_at(one, 0.0) == 0
    assert moves.block_at(one, one[0][0] + 0.01) == one[1][1]
    assert moves.block_at(one, cycle + one[0][0] + 0.01) == one[1][1]


def test_the_top_level_name_check_compares_whole_names():
    loaded = ["tpu_pod_exporter_torch", "tpu_pod_exporter_torch.app", "tpu_pod_exporter.app",
              "jax", "jaxlib.xla_client", "jaxtyping", "flax.linen", "flaxen"]
    assert procs.forbidden(loaded) == ["flax.linen", "jax", "jaxlib.xla_client",
                                       "tpu_pod_exporter.app"]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|tpu_pod_exporter)\b(?!_)",
                         re.M)
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not pattern.search(path.read_text()), path
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert "tpu_pod_exporter" not in path.read_text(), path


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_runs_correct_on_the_card(card, cell):
    done = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", "2147483659",
         "--seconds", "5", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["kind"] == card
