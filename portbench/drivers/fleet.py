"""A fleet: the slice aggregator's rounds over every node of a unit.

Set-up starts the card's job, the reference's sampler and the live node
exporter as ``drivers/node`` does, makes the other nodes' bodies from the
seed (``traffic/bodies.py``), each in a few variants, and serves them, one
port a node, from a few processes of their own
(``traffic/bodyserver.py``), which answer a node's requests with its
variants in turn and log when each was served. Then it starts the rounds,
the generator the traffic's ``generator`` names (``traffic/rounds.py``), in
another process, which builds and warms the port's ``SliceAggregator``.
The window is its rounds back to back. Then the reference works the
rollups out again, for each round of a sample drawn from the seed, from
the variants the nodes served in that round and the live card's states
around it, and judges the exposition the round published.
"""

from __future__ import annotations

import bisect
import json
import time

import numpy as np

from portbench import procs
from portbench.drivers.node import READ_SLACK_S, Node
from portbench.reference import expo, fleet as ref_fleet
from portbench.traffic import bodies
from portbench.window import percentile

# A round's live body carries the exporter's last poll, which read the
# card up to an interval (1 s) and a poll (its device read's deadline is
# 4 s) before the round's fetch.
LIVE_BEFORE_S = 5.0


def live_node(gpus, node: Node, labels: dict) -> dict:
    """The live node in the reference's terms, from its own read of the card."""
    owner = {c: p for p in node.pods for c in p["cards"]}
    return {"host": labels["host"], "slice_name": labels["slice_name"],
            "accelerator": labels["accelerator"],
            "gpus": [{"used": g.used, "total": g.total, "pod": owner.get(g.index)}
                     for g in gpus]}


def run(run) -> dict:
    conf = run.cell.config
    node = Node(run, conf["live_node"]["exporter"], conf["live_node"]["pods"])
    servers: list[procs.Child] = []
    try:
        node.start()
        every = bodies.variants(run.seed, conf["fleet"])
        nodes = every[0]
        # The frozen nodes are dealt out over a few server processes, so
        # that no one process answers a whole round in turn, as nodes that
        # each run their own exporter would not.
        ports: dict[str, int] = {}
        dirs = []
        for i in range(conf["fleet"]["body_servers"]):
            body_dir = run.dir / f"bodies-{i}"
            body_dir.mkdir()
            dirs.append(body_dir)
            for v, variant in enumerate(every):
                for n in variant[i::conf["fleet"]["body_servers"]]:
                    (body_dir / f"{n['host']}.{v}.txt").write_text(bodies.render(n))
            servers.append(procs.Child(["-m", "portbench.traffic.bodyserver", str(body_dir)],
                                       run.dir / f"bodyserver-{i}.log"))
        for server in servers:
            ports.update(server.expect("ports", 60)["ports"])
        targets = [f"127.0.0.1:{ports[n['host']]}" for n in nodes]
        targets.append(f"127.0.0.1:{node.port}")

        def served() -> dict[str, list[float]]:
            """Stop the body servers; when each node was served."""
            out: dict[str, list[float]] = {}
            for server, body_dir in zip(servers, dirs):
                server.close()
                out.update(json.loads((body_dir / "served.json").read_text()))
            return out

        out = measure(run, node, every, targets, served)
    finally:
        found = node.close()
        for server in servers:
            server.close()
            found += procs.forbidden(procs.imported(server.log))
    out["forbidden"] += found
    return out


def frozen_in_round(every: list[list[dict]], served: dict[str, list[float]],
                    start: float, end: float) -> tuple[list[dict], int]:
    """The frozen nodes as a round from ``start`` to ``end`` (wall times)
    was served them: each node's variant of its last request in the round,
    or before it where the round made none; and how many nodes the round
    did not fetch exactly once."""
    nodes, odd = [], 0
    for j, node in enumerate(every[0]):
        times = served.get(node["host"], [])
        lo, hi = bisect.bisect_left(times, start), bisect.bisect_right(times, end)
        odd += hi - lo != 1
        n = hi - 1 if hi > lo else lo - 1
        nodes.append(every[max(n, 0) % len(every)][j])
    return nodes, odd


def measure(run, node: Node, every: list[list[dict]], targets: list[str], served) -> dict:
    conf, mix = run.cell.config, run.cell.traffic
    spec_path, out_path = run.dir / "rounds-spec.json", run.dir / "rounds.json"
    spec_path.write_text(json.dumps({
        "targets": targets, "flags": conf["aggregator"], "seed": run.seed,
        "seconds": run.seconds, "trace": run.trace, "warm_rounds": mix["warm_rounds"],
        "judged_share": mix["judged_share"]}))
    loop = procs.Child(["-m", f"portbench.traffic.{mix['generator']}", str(spec_path),
                        str(out_path)], run.dir / "rounds.log")
    try:
        loop.expect("ready", 300)
        node.mark_window()
        setup_s = time.perf_counter() - run.t0
        loop.send("go")
        loop.expect("done", run.seconds + 300)
    finally:
        loop.close()
    when = served()
    reads = node.stop_reads()
    device = node.stop_card()
    got = json.loads(out_path.read_text())
    window = {"setup_s": setup_s, "window_s": run.seconds, "rounds_ms": got["rounds_ms"],
              "self_start": expo.parse(got["self_start"]),
              "self_end": expo.parse(got["self_end"])}
    if run.trace:
        window["fetch_wall_ms"] = got["fetch_ms"]
    kept = got["kept"]
    labels = conf["live_node"]["labels"]

    spans = {wall: end for wall, end, _stamp, _text in kept}

    def wants(started: float, dtype=np.float64) -> list[dict]:
        end = spans[started]
        frozen, _odd = frozen_in_round(every, when, started, end)
        live = node.states_around(started, LIVE_BEFORE_S, end - started + READ_SLACK_S)
        return [ref_fleet.expected(frozen + [live_node(g, node, labels)], dtype) for g in live]

    rounds = [(wall, text) for wall, _end, _stamp, text in kept]
    if run.control:
        # The control: the reference's fold in float32 in the program's place.
        rounds = [(wall, render_rows(wants(wall, np.float32)[0])) for wall, _text in rounds]
    checks, worst = ref_fleet.judge(rounds, wants)
    checks["stale_rounds"] = sum(stamp < wall for wall, _end, stamp, _text in kept)
    # A judged round that did not fetch a node once, and only once, did
    # not read what that node served in it.
    checks["fetched_off"] = sum(frozen_in_round(every, when, wall, end)[1]
                                for wall, end in spans.items())
    errors = [expo.total(s, "tpu_aggregator_scrape_errors_total") or 0.0
              for s in (window["self_start"], window["self_end"])]
    rounds_ms = got["rounds_ms"]
    detail = {f"p{q}_ms": percentile(rounds_ms, q, float("inf")) for q in (50, 90, 95, 99)}
    detail["rounds"] = len(rounds_ms)
    detail["card_states"] = len({g[0].used for _t, g in reads.states})
    detail["walk_changes"] = device.get("walk_changes")
    detail["worst_rows"] = worst
    return {"window": window, "checks": checks, "judged": len(kept), "device": device,
            "detail": detail, "attempted": len(rounds_ms) * len(targets),
            "failed": int(errors[1] - errors[0]),
            "forbidden": procs.forbidden(procs.imported(loop.log))}


def render_rows(rows: dict) -> str:
    """Rollup rows as exposition text, for the control's stand-in answer."""
    out = []
    for name, series in rows.items():
        keys = ref_fleet.KEYS[name]
        for labels, value in series.items():
            inner = ",".join(f'{k}="{v}"' for k, v in zip(keys, labels))
            out.append(f"{name}{{{inner}}} {value!r}")
    return "\n".join(out)
