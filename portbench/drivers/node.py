"""A node: the card's job, the node exporter as the DaemonSet runs it, and
an open loop of scrapes against its ``/metrics``.

Set-up starts the job on the card (``portbench.card``), which walks its
memory on a schedule drawn from the seed, and the reference's sampler
(``python -m portbench.reference.nvml``), which reads the card ten times a
second in a process of its own. It writes the kubelet checkpoint and UID
map that give the card to the configuration's pod, starts
``python -m tpu_pod_exporter_torch`` with the configuration's flags, and
waits for it to be ready and to have polled. The window is the traffic's
client, the generator its ``generator`` names, in a process of its own
(``traffic/openloop.py``), which also reads the exporter's CPU from
``/proc`` at the window's two ends. Then each answer of a sample drawn
from the seed is judged against the card's states at its poll.
"""

from __future__ import annotations

import bisect
import json
import time
from pathlib import Path

from portbench import moves, procs
from portbench.reference import expo, node as ref_node, nvml
from portbench.window import hist_mean_ms, percentile

CAPTURE = Path(__file__).resolve().parent.parent / "traffic" / "h100-metrics.txt"
SAMPLE_PERIOD_S = 0.1
# The exporter reads the card in a poll that starts after the previous
# poll's publish and stamps it at its own publish
# (``tpu_exporter_last_poll_timestamp_seconds``). An answer is judged
# against the states the sampler read from READ_SLACK_S before the
# previous poll's stamp (the latest earlier stamp any answer carried; or
# FIRST_BEFORE_S before its own, for the window's first poll) to
# READ_SLACK_S after its own: a change is read by the sampler up to a
# period, and a stall, after it happens. The walk holds each state for
# 3 s or more, against polls a second apart, so a window holds one change
# at most unless a poll ran long.
READ_SLACK_S = 0.5
FIRST_BEFORE_S = 1.5
STAMP = "tpu_exporter_last_poll_timestamp_seconds"


def read_window(stamps: list[float], polled: float) -> tuple[float, float]:
    """``(seconds before, seconds after)`` the stamp ``polled`` in which the
    poll it stamps read the card; ``stamps`` are every stamp the answers
    carried, sorted."""
    at = bisect.bisect_left(stamps, polled)
    before = polled - stamps[at - 1] if at > 0 else FIRST_BEFORE_S
    return before + READ_SLACK_S, READ_SLACK_S


def sim_spec() -> dict:
    """The card as its capture shows it (``traffic/h100-metrics.txt``), as a
    simulated NVML driver's spec, for rehearsals without a card."""
    samples = expo.parse(CAPTURE.read_text())

    def one(name):
        [v] = expo.family(samples, name).values()
        return v

    procs_ = [[int(dict(k)["pid"]), int(v)]
              for k, v in expo.family(samples, "gpu_process_memory_used_bytes").items()]
    return {"gpus": [{"uuid": "GPU-00000000-0000-4000-8000-000000000000",
                      "name": "NVIDIA H100 80GB HBM3",
                      "mem_used": int(one("gpu_hbm_used_bytes")),
                      "mem_total": int(one("gpu_hbm_total_bytes")),
                      "utilization": one("gpu_utilization_percent"),
                      "processes": procs_}]}


def write_kubelet(run_dir: Path, pods: list[dict], gpus) -> list[str]:
    """The kubelet's device-plugin checkpoint and a UID map giving each
    pod its cards (by UUID); returns the exporter flags that read them."""
    by_index = {g.index: g.uuid for g in gpus}
    entries = [{"PodUID": p["uid"], "ContainerName": p["container"],
                "ResourceName": "nvidia.com/gpu",
                "DeviceIDs": {"-1": [by_index[c] for c in p["cards"]]}} for p in pods]
    ckpt, uids = run_dir / "kubelet_internal_checkpoint", run_dir / "uids.json"
    ckpt.write_text(json.dumps({"Data": {"PodDeviceEntries": entries}}))
    uids.write_text(json.dumps({p["uid"]: {"name": p["name"], "namespace": p["namespace"]}
                                for p in pods}))
    return [f"--checkpoint-path={ckpt}", f"--uid-map-file={uids}"]


def exporter_argv(exp: dict, run_dir: Path, port: int, extra: list[str],
                  entry: list[str]) -> list[str]:
    """The configuration's exporter flags as deployed, with the port and the
    state directory moved into the run, and the kubelet files added, after
    ``entry`` (the program's module)."""
    out = []
    for arg in exp["args"] + exp.get("added", []):
        flag = arg.split("=", 1)[0]
        if flag == "--port":
            arg = f"--port={port}"
        elif flag == "--state-dir":
            arg = f"--state-dir={run_dir / 'state'}"
        out.append(arg)
    return [*entry, *out, "--host=127.0.0.1", *extra]


class Node:
    """The card's job, the reference's sampler and one node exporter, from
    start to stop."""

    def __init__(self, run, exp: dict, pods: list[dict]) -> None:
        self.run, self.exp, self.pods = run, exp, pods
        self.card = self.exporter = self.sampler = None
        self.reads: nvml.Reads | None = None
        self.device: dict = {}
        self.port = procs.free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.log = run.dir / "exporter.log"
        self.reads_path = run.dir / "reads.json"

    def start(self) -> None:
        run, exp = self.run, self.exp
        stim = run.cell.config["stimulus"]
        walk = moves.walk(run.seed, stim["moves"])
        entry, extra = ["-m", "tpu_pod_exporter_torch"], []
        sampler = ["-m", "portbench.reference.nvml", str(self.reads_path), str(SAMPLE_PERIOD_S)]
        if run.rehearse:
            spec = sim_spec()
            sim = run.dir / "sim.json"
            sim.write_text(json.dumps({"spec": spec, "walk": walk, "origin": time.time()}))
            (run.dir / "sim-spec.json").write_text(json.dumps(spec))
            entry = ["-m", "portbench.rehearsal", str(sim)]
            extra = [f"--nvml-sim-spec={run.dir / 'sim-spec.json'}"]
            sampler.append(str(sim))
        else:
            self.card = procs.Child(
                ["-m", "portbench.card", f"--seed={run.seed}", f"--chips={run.cell.chips}",
                 f"--fill-gib={stim['fill_gib']}", f"--width={stim['width']}",
                 f"--depth={stim['depth']}", f"--batch={stim['batch']}",
                 f"--moves={json.dumps(stim['moves'])}"]
                + (["--trace"] if run.trace else []),
                run.dir / "card.log")
            self.device = self.card.expect("ready", 900)
        self.sampler = procs.Child(sampler, run.dir / "sampler.log")
        gpus = nvml.from_doc(self.sampler.expect("ready", 120)["gpus"])
        if not run.sampling:
            self.sampler.proc.stdin.close()
        argv = exporter_argv(exp, run.dir, self.port,
                             write_kubelet(run.dir, self.pods, gpus) + extra, entry)
        self.exporter = procs.Child(argv, self.log, env=exp.get("env"), protocol=False)
        procs.wait_for(lambda: procs.http_get(self.url + "/readyz")[0] == 200, 300,
                       "the exporter's /readyz", self.exporter.proc, self.log)
        procs.wait_for(lambda: (self.polls() or 0) >= exp["warm_polls"], 120,
                       "the exporter's first polls", self.exporter.proc, self.log)

    def self_metrics(self):
        status, body = procs.http_get(self.url + "/metrics")
        return expo.parse(body.decode()) if status == 200 else None

    def polls(self) -> float | None:
        samples = self.self_metrics()
        return expo.total(samples, "tpu_exporter_polls_total") if samples else None

    def mark_window(self) -> None:
        if self.card is not None:
            self.card.send("window")

    def stop_reads(self) -> nvml.Reads:
        """End the sampler, a little after the last answer's poll, and load
        every state it read."""
        if not self.sampler.proc.stdin.closed:
            time.sleep(READ_SLACK_S + SAMPLE_PERIOD_S)
            self.sampler.proc.stdin.close()
        self.sampler.expect("done", 120)
        self.sampler.close()
        self.reads = nvml.load(self.reads_path)
        return self.reads

    def stop_card(self) -> dict:
        """End the job's load (the card keeps its memory); the card's
        numbers, busy time among them in a traced run."""
        if self.card is None:
            return {}
        self.card.send("stop")
        return {**self.device, **self.card.expect("stopped", 300)}

    def states_around(self, t: float, before_s: float, after_s: float) -> list:
        """The card's states the reference read around ``t``, the nearest
        one where it read none there."""
        near = self.reads.around(t, before_s, after_s)
        if near:
            return near
        return [min(self.reads.states, key=lambda s: abs(s[0] - t))[1]]

    def close(self) -> list[str]:
        """Stop everything; the forbidden modules any child imported."""
        found = []
        for child in (self.exporter, self.sampler, self.card):
            if child is None:
                continue
            if child is self.exporter:
                procs.stop(child.proc)
            else:
                child.close()
            found += procs.forbidden(procs.imported(child.log))
        return found


def run(run) -> dict:
    node = Node(run, run.cell.config["exporter"], run.cell.config["pods"])
    try:
        node.start()
        out = measure(run, node)
    finally:
        found = node.close()
    out["forbidden"] += found
    return out


def measure(run, node: Node) -> dict:
    mix = run.cell.traffic
    spec_path, out_path = run.dir / "client-spec.json", run.dir / "client.json"
    spec_path.write_text(json.dumps({"host": "127.0.0.1", "port": node.port,
                                     "pid": node.exporter.proc.pid, "traffic": mix,
                                     "seed": run.seed, "seconds": run.seconds,
                                     "stamp": STAMP}))
    client = procs.Child(["-m", f"portbench.traffic.{mix['generator']}", str(spec_path),
                          str(out_path)], run.dir / "client.log")
    try:
        client.expect("ready", 300)
        self_start = node.self_metrics()
        node.mark_window()
        setup_s = time.perf_counter() - run.t0
        client.send("go")
        client.expect("done", run.seconds + 300)
    finally:
        client.close()
    self_end = node.self_metrics()
    reads = node.stop_reads()
    device = node.stop_card()
    got = json.loads(out_path.read_text())
    results = got["results"]    # [due, sent, done, status, wall received]
    ok = [r for r in results if r[3] == 200]
    attempted = got["attempted"]
    cpu = got["cpu"]
    window = {
        "setup_s": setup_s, "window_s": run.seconds,
        "latencies_ms": [(r[2] - r[0]) * 1000.0 if r[3] == 200 else float("inf")
                         for r in results] + [float("inf")] * (attempted - len(results)),
        "attempted": attempted, "failed": attempted - len(ok),
        "cpu_s": cpu["end"] - cpu["start"],
        "self_start": self_start, "self_end": self_end,
    }
    labels = run.cell.config["labels"]
    stamps = sorted({t for _wall, t in got["stamps"] if t is not None})

    def wants(polled: float) -> list[dict]:
        return [ref_node.expected(g, node.pods, labels)
                for g in node.states_around(polled, *read_window(stamps, polled))]

    def at_mib(polled: float) -> dict:
        # The control: the reference at MiB in the program's place.
        return ref_node.expected(node.states_around(polled, *read_window(stamps, polled))[0],
                                 node.pods, labels, ref_node.MIB)

    bodies = [tuple(b) for b in got["bodies"]]
    checks, worst = ref_node.judge(bodies, wants, at_mib if run.control else None)
    lat = window["latencies_ms"]
    detail = {f"p{q}_ms": percentile(lat, q, run.seconds * 1000.0) for q in (50, 90, 99, 99.9)}
    detail["late_max_ms"] = max(((r[1] - r[0]) * 1000.0 for r in results), default=0.0)
    detail["card_states"] = len({g[0].used for _t, g in reads.states})
    detail["walk_changes"] = device.get("walk_changes")
    detail["exporter_cpu_pct"] = window["cpu_s"] / run.seconds * 100.0
    # CPU seconds of each of the exporter's threads across the window, most
    # first; what no live thread holds belongs to threads that ended.
    start_t, end_t = cpu["threads_start"], cpu["threads_end"]
    detail["exporter_thread_cpu_s"] = sorted(
        (d for t in start_t.keys() | end_t.keys() if (d := end_t.get(t, 0.0) - start_t.get(t, 0.0))),
        reverse=True)
    detail["poll_phase_ms"] = {
        phase: hist_mean_ms(window, "tpu_exporter_poll_phase_duration_seconds", {"phase": phase})
        for phase in ("device_read", "attribution", "process_scan", "join", "publish", "total")}
    detail["worst_rows"] = worst
    return {"window": window, "checks": checks, "judged": len(bodies), "device": device,
            "attempted": attempted, "failed": window["failed"], "detail": detail,
            "forbidden": procs.forbidden(procs.imported(client.log))}
