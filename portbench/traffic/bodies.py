"""The fleet cell's frozen node bodies, made from ``--seed``.

Each body is the card's own ``/metrics`` capture (``h100-metrics.txt``
beside this file, a frozen copy of what the H100 served) with its per-card
rows written once for each GPU of the node, its per-pod and per-process
rows for the node's pods, and its identity labels set to the node's. The
exporter's self-metrics stay as captured. The data behind the bodies is
returned too, for the reference.

Every seed draws the same set of memory sizes and utilizations, in
another order, with seeded low bytes: bodies keep their size from seed to
seed, so the work of a round does not move with the seed. A node has
``variants`` bodies: the same pods, processes and series, with the memory
sizes dealt anew over its GPUs and new low bytes in each, as a node's
answer changes from poll to poll. The body server answers a node's
requests with its variants in turn, so a round that reuses a body it
fetched before publishes other sums than the reference's.
"""

from __future__ import annotations

import random
from pathlib import Path

from portbench.reference import expo

TEMPLATE = Path(__file__).with_name("h100-metrics.txt")
PER_CHIP = ("gpu_hbm_used_bytes", "gpu_hbm_total_bytes", "gpu_hbm_used_percent",
            "gpu_utilization_percent", "gpu_chip_info")
PER_PROCESS = ("gpu_process_memory_used_bytes", "tpu_chip_process_info")
PER_POD = ("gpu_pod_chip_count", "gpu_pod_memory_used_bytes")
GIB = 1 << 30


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _line(name: str, labels: dict[str, str], value: float) -> str:
    if float(value).is_integer() and abs(value) < 1e18:
        num = str(int(value))
    else:
        num = repr(float(value))
    if not labels:
        return f"{name} {num}"
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels.items())
    return f"{name}{{{inner}}} {num}"


def make_nodes(seed: int, fleet: dict, variant: int = 0) -> list[dict]:
    """The frozen nodes of a fleet configuration, drawn from ``seed``: their
    pods, processes and utilizations from the seed alone, their memory
    sizes from the seed and ``variant``."""
    rng = random.Random(seed)
    n, per = fleet["frozen_nodes"], fleet["gpus_per_node"]
    gpus = n * per
    ulo, uhi = fleet["utilization"]
    utils = [ulo + (uhi - ulo) * i // max(gpus - 1, 1) for i in range(gpus)]
    rng.shuffle(utils)
    small = set(rng.sample(range(n), n - round(n * fleet["share_one_pod_per_node"])))
    pids = rng.sample(range(10000, 99999), gpus)
    lo, hi = fleet["used_gib"]
    sizes = [int((lo + (hi - lo) * (i + 0.5) / gpus) * GIB) // (2 << 20) * (2 << 20)
             for i in range(gpus)]
    rng = random.Random(f"{seed}-{variant}")
    rng.shuffle(sizes)
    nodes = []
    for j in range(n):
        host = fleet["host_format"].format(j + 1)
        node = {"host": host, "slice_name": fleet["slice_name"],
                "accelerator": fleet["accelerator"], "gpus": []}
        for c in range(per):
            k = j * per + c
            if j in small:
                pod = {"name": f"serve-{host}-{c}", "namespace": "ml-serve", "container": "server"}
            else:
                pod = {"name": f"train-{host}-0", "namespace": "ml-train", "container": "trainer"}
            used = sizes[k] + rng.randrange(1 << 20)
            node["gpus"].append({
                "chip": c, "minor": c, "used": used, "total": fleet["gpu_total_bytes"],
                "util": utils[k], "pod": pod,
                "process": (pids[k], used - fleet["context_bytes"])})
        nodes.append(node)
    return nodes


def variants(seed: int, fleet: dict) -> list[list[dict]]:
    """Every variant of the frozen nodes, ``[variant][node]``."""
    return [make_nodes(seed, fleet, v) for v in range(fleet["variants"])]


def render(node: dict) -> str:
    """One node's body in the captured body's family order."""
    text = TEMPLATE.read_text()
    ident = {"accelerator": node["accelerator"], "slice_name": node["slice_name"],
             "host": node["host"]}
    done: set[str] = set()
    out: list[str] = []
    for raw in text.split("\n"):
        if not raw or raw.startswith("#"):
            out.append(raw)
            continue
        [(name, labels, value)] = expo.parse(raw)
        if name in PER_CHIP + PER_PROCESS + PER_POD:
            if name not in done:
                done.add(name)
                out.extend(_rows(name, labels, node))
            continue
        if "host" in labels:
            labels = {k: ident.get(k, v) for k, v in labels.items()}
            if name == "tpu_kubelet_allocated_chips":
                value = len(node["gpus"])
        out.append(_line(name, labels, value))
    return "\n".join(out)


def _rows(name: str, shape: dict[str, str], node: dict) -> list[str]:
    rows = []
    pods: dict[tuple, list] = {}
    for g in node["gpus"]:
        pod = g["pod"]
        lab = {"chip_id": str(g["chip"]), "device_path": f"/dev/nvidia{g['minor']}",
               "accelerator": node["accelerator"], "slice_name": node["slice_name"],
               "host": node["host"], "worker_id": "", "pod": pod["name"],
               "namespace": pod["namespace"], "container": pod["container"],
               "device_kind": "NVIDIA H100 80GB HBM3", "coords": "", "comm": "",
               "pod_uid": ""}
        pid, pused = g["process"]
        value = {"gpu_hbm_used_bytes": g["used"], "gpu_hbm_total_bytes": g["total"],
                 "gpu_hbm_used_percent": g["used"] / g["total"] * 100.0,
                 "gpu_utilization_percent": g["util"], "gpu_chip_info": 1,
                 "gpu_process_memory_used_bytes": pused, "tpu_chip_process_info": 1}.get(name)
        if name == "tpu_chip_process_info":
            lab.update(pid=str(pid), comm="python3")
        elif name == "gpu_process_memory_used_bytes":
            lab["pid"] = str(pid)
        if value is not None:
            rows.append(_line(name, {k: lab[k] for k in shape}, value))
        acc = pods.setdefault((pod["name"], pod["namespace"]), [0, 0])
        acc[0] += 1
        acc[1] += g["used"]
    if name in PER_POD:
        for (pod, ns), (chips, used) in pods.items():
            lab = {"pod": pod, "namespace": ns, "accelerator": node["accelerator"],
                   "slice_name": node["slice_name"], "host": node["host"], "worker_id": ""}
            rows.append(_line(name, {k: lab[k] for k in shape},
                              chips if name == "gpu_pod_chip_count" else used))
    return rows
