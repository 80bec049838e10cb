"""What one node exporter must serve, worked out again from the card.

Inputs are the reference's own NVML read (``reference/nvml.py``), the pods
the benchmark gave the card to (the kubelet checkpoint and UID map it
wrote) and the node's identity labels. The answer is the five families
whose values the cells compare, keyed by the labels that carry meaning:
the card, its node, the pod that holds it and, for process rows, the pid.
"""

from __future__ import annotations

from portbench.reference import expo

TOPO = ("accelerator", "slice_name", "host", "worker_id")
CHIP = ("chip_id", "device_path") + TOPO + ("pod", "namespace", "container")
POD = ("pod", "namespace") + TOPO
KEYS = {
    "gpu_hbm_used_bytes": CHIP,
    "gpu_hbm_total_bytes": CHIP,
    "gpu_process_memory_used_bytes": CHIP + ("pid",),
    "gpu_pod_memory_used_bytes": POD,
    "gpu_pod_chip_count": POD,
}
MIB = 1 << 20


def owners(pods: list[dict]) -> dict[int, dict]:
    """Card index -> the pod the kubelet gave it to."""
    return {card: pod for pod in pods for card in pod["cards"]}


def expected(gpus, pods: list[dict], topo: dict[str, str],
             unit: int = 1) -> dict[str, dict[tuple, float]]:
    """The compared families, each ``{label values in KEYS order: value}``.
    ``unit`` > 1 rounds every byte count to that unit (the control)."""
    def q(v: int) -> float:
        return float(round(v / unit) * unit)

    own = owners(pods)
    out: dict[str, dict[tuple, float]] = {name: {} for name in KEYS}
    pod_rows: dict[tuple, list[float]] = {}
    for g in gpus:
        pod = own.get(g.index, {})
        labels = {"chip_id": str(g.index), "device_path": f"/dev/nvidia{g.minor}",
                  **topo, "pod": pod.get("name", ""),
                  "namespace": pod.get("namespace", ""),
                  "container": pod.get("container", "")}
        chip = tuple(labels[k] for k in CHIP)
        out["gpu_hbm_used_bytes"][chip] = q(g.used)
        out["gpu_hbm_total_bytes"][chip] = q(g.total)
        for pid, used in g.processes:
            out["gpu_process_memory_used_bytes"][chip + (str(pid),)] = q(used)
        if pod:
            key = tuple(labels[k] for k in POD)
            acc = pod_rows.setdefault(key, [0.0, 0.0])
            acc[0] += 1
            acc[1] += g.used
    for key, (chips, used) in pod_rows.items():
        out["gpu_pod_chip_count"][key] = chips
        out["gpu_pod_memory_used_bytes"][key] = q(int(used))
    return out


def served(samples) -> dict[str, dict[tuple, float]]:
    """The same families as one served body carries them."""
    out: dict[str, dict[tuple, float]] = {name: {} for name in KEYS}
    for name, labels, value in samples:
        keys = KEYS.get(name)
        if keys is not None:
            out[name][tuple(labels.get(k, "") for k in keys)] = value
    return out


def envelope(wants: list[dict]) -> dict[str, dict[tuple, tuple[float, float]]]:
    """Each row's least and greatest value over the answers in ``wants``."""
    out: dict[str, dict[tuple, tuple[float, float]]] = {}
    for name in KEYS:
        rows: dict[tuple, tuple[float, float]] = {}
        for want in wants:
            for key, v in want[name].items():
                lo, hi = rows.get(key, (v, v))
                rows[key] = (min(lo, v), max(hi, v))
        out[name] = rows
    return out


def compare(got: dict, wants: list[dict], worst: list | None = None) -> tuple[int, float]:
    """(rows missing or extra, largest gap of a value in bytes or chips) of
    one answer against the answers for the card's states around its poll:
    a row may be any of theirs, and its value anywhere between their least
    and greatest (the reference reads the card ten times a second; the
    program may read it between two of those reads while it moves).
    ``worst`` gets ``[family, labels, served, (least, greatest)]`` of the
    largest gap and of the first row missing or extra."""
    env = envelope(wants)
    off, gap = 0, 0.0
    for name, rows in env.items():
        have = got.get(name, {})
        required = set.intersection(*(set(w[name]) for w in wants))
        odd = (have.keys() - rows.keys()) | (required - have.keys())
        off += len(odd)
        if odd and worst is not None and len(worst) < 4:
            key = min(odd)
            worst.append([name, list(key), have.get(key), rows.get(key)])
        for key in rows.keys() & have.keys():
            lo, hi = rows[key]
            d = max(lo - have[key], have[key] - hi, 0.0)
            if d > gap:
                gap = d
                if worst is not None:
                    worst.append([name, list(key), have[key], [lo, hi]])
    return off, gap


def judge(bodies: list[tuple[float, str]], wants, stand_in=None) -> tuple[dict, list]:
    """Each sampled body ``(wall time received, text)`` against ``wants(t)``,
    the answers for each state the card was in around ``t``, the instant
    of the poll the body carries (``tpu_exporter_last_poll_timestamp_seconds``).
    Returns the rows missing or extra, the largest gap of a value, and how
    old that poll was when the answer arrived; then the rows that set them.
    ``stand_in(t)`` judges its rows in place of each body's (the control)."""
    off, gap, stale, worst = 0, 0.0, 0.0, []
    for received, text in bodies:
        samples = expo.parse(text)
        polled = expo.total(samples, "tpu_exporter_last_poll_timestamp_seconds") or 0.0
        got = stand_in(polled) if stand_in is not None else served(samples)
        o, g = compare(got, wants(polled), worst)
        off, gap = off + o, max(gap, g)
        worst = worst[-4:]
        stale = max(stale, received - polled)
    return {"rows_off": off, "mem_gap_bytes": gap, "stale_s": stale}, worst
