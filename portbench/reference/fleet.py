"""What a flat slice aggregator must publish, worked out again from the nodes.

Each node is ``{"host", "slice_name", "accelerator", "gpus": [...]}``, a
GPU ``{"used", "total", "pod": {"name", "namespace"} or None}``. Sums run
in node order; every byte count is a whole number far below 2**53, so in
float64 any order gives the same sum. ``dtype`` float32 is the control:
the same fold in single precision. The slice's mean utilization is not
compared: the live card's rate moves under the job, and the reference
cannot read it at the instant the aggregator did.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import expo

SLICE = ("slice_name", "accelerator", "family")
WORKLOAD = ("pod", "namespace", "slice_name")
KEYS = {
    "tpu_slice_hosts_reporting": SLICE,
    "tpu_slice_chip_count": SLICE,
    "tpu_slice_hbm_used_bytes": SLICE,
    "tpu_slice_hbm_total_bytes": SLICE,
    "tpu_slice_hbm_used_percent": SLICE,
    "tpu_fleet_family_hosts_reporting": ("family",),
    "tpu_fleet_family_chip_count": ("family",),
    "tpu_fleet_family_hbm_used_bytes": ("family",),
    "tpu_fleet_family_hbm_total_bytes": ("family",),
    "tpu_workload_chip_count": WORKLOAD,
    "tpu_workload_hbm_used_bytes": WORKLOAD,
    "tpu_workload_hosts": WORKLOAD,
}
PERCENT = ("tpu_slice_hbm_used_percent",)


def expected(nodes: list[dict], dtype=np.float64) -> dict:
    """The compared families as ``{name: {label values: value}}``."""
    f = dtype
    out: dict[str, dict[tuple, float]] = {name: {} for name in KEYS}
    slices: dict[tuple, dict] = {}
    work: dict[tuple, dict] = {}
    for node in nodes:
        key = (node["slice_name"], node["accelerator"], "gpu")
        s = slices.setdefault(key, {"hosts": set(), "chips": 0, "used": f(0), "total": f(0)})
        for g in node["gpus"]:
            s["hosts"].add(node["host"])
            s["chips"] += 1
            s["used"] = f(s["used"] + f(g["used"]))
            s["total"] = f(s["total"] + f(g["total"]))
            if g["pod"]:
                w = work.setdefault((g["pod"]["name"], g["pod"]["namespace"], node["slice_name"]),
                                    {"chips": 0, "used": f(0), "hosts": set()})
                w["chips"] += 1
                w["used"] = f(w["used"] + f(g["used"]))
                w["hosts"].add(node["host"])
    fam = {"hosts": 0, "chips": 0, "used": f(0), "total": f(0)}
    for key, s in slices.items():
        out["tpu_slice_hosts_reporting"][key] = float(len(s["hosts"]))
        out["tpu_slice_chip_count"][key] = float(s["chips"])
        out["tpu_slice_hbm_used_bytes"][key] = float(s["used"])
        out["tpu_slice_hbm_total_bytes"][key] = float(s["total"])
        out["tpu_slice_hbm_used_percent"][key] = float(f(s["used"]) / f(s["total"]) * f(100))
        fam["hosts"] += len(s["hosts"])
        fam["chips"] += s["chips"]
        fam["used"] = f(fam["used"] + s["used"])
        fam["total"] = f(fam["total"] + s["total"])
    out["tpu_fleet_family_hosts_reporting"][("gpu",)] = float(fam["hosts"])
    out["tpu_fleet_family_chip_count"][("gpu",)] = float(fam["chips"])
    out["tpu_fleet_family_hbm_used_bytes"][("gpu",)] = float(fam["used"])
    out["tpu_fleet_family_hbm_total_bytes"][("gpu",)] = float(fam["total"])
    for key, w in work.items():
        out["tpu_workload_chip_count"][key] = float(w["chips"])
        out["tpu_workload_hbm_used_bytes"][key] = float(w["used"])
        out["tpu_workload_hosts"][key] = float(len(w["hosts"]))
    return out


def served(samples) -> dict:
    out: dict[str, dict[tuple, float]] = {name: {} for name in KEYS}
    for name, labels, value in samples:
        keys = KEYS.get(name)
        if keys is not None:
            out[name][tuple(labels.get(k, "") for k in keys)] = value
    return out


def judge(rounds: list[tuple[float, str]], wants) -> tuple[dict[str, float], list]:
    """Each sampled round ``(wall time it started, published exposition)``
    against ``wants(t)``, the answers for each state the live card was in
    around ``t``: a row may be any of theirs, and its value anywhere
    between their least and greatest. Returns rows missing or extra; the
    largest gap of a byte or chip count (whole numbers, summed exactly in
    any order); the largest relative gap of a percentage. Then the rows
    that set them, ``[family, labels, served, [least, greatest]]``."""
    off, gap, pct, worst = 0, 0.0, 0.0, []
    for started, text in rounds:
        got = served(expo.parse(text))
        answers = wants(started)
        for name in KEYS:
            rows: dict[tuple, list[float]] = {}
            for want in answers:
                for key, v in want[name].items():
                    lo_hi = rows.setdefault(key, [v, v])
                    lo_hi[0], lo_hi[1] = min(lo_hi[0], v), max(lo_hi[1], v)
            have = got[name]
            required = set.intersection(*(set(w[name]) for w in answers))
            odd = (have.keys() - rows.keys()) | (required - have.keys())
            off += len(odd)
            if odd and len(worst) < 4:
                key = min(odd)
                worst.append([name, list(key), have.get(key), rows.get(key)])
            for key in rows.keys() & have.keys():
                lo, hi = rows[key]
                d = max(lo - have[key], have[key] - hi, 0.0)
                if name in PERCENT:
                    pct = max(pct, d / hi)
                elif d > gap:
                    gap = d
                    worst.append([name, list(key), have[key], [lo, hi]])
        worst = worst[-4:]
    return {"rows_off": off, "rollup_gap": gap, "percent_gap": pct}, worst
