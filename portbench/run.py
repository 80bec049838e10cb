"""Run one cell of the port's benchmark once.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

loads the cell named in ``BENCHMARK.json``, sets it up, measures for
``--seconds`` seconds, judges the answers the program gave against the
plain reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``; ``checks`` comes last, each number
compared beside its limit, which standard error's last lines repeat.

It runs only on a machine with the cards the cell asks for, and exits
non-zero otherwise. ``--rehearse`` runs the same cell on this machine's
CPU instead, on the card's capture replayed through the exporter's
simulated NVML driver, and prints no device numbers; ``--control`` puts
the reference, one precision down, in the program's place (its answers
must come out not correct). ``--no-sampling`` measures the reference's
own cost: its sampler reads the card once at set-up and stops, so the
answers cannot be judged and the run is not correct.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402 — the clock above starts before anything loads
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import procs, spec  # noqa: E402


@dataclass
class Run:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    rehearse: bool
    control: bool
    dir: Path
    sampling: bool = True
    t0: float = T0


def checks_of(numbers: dict, limits: dict) -> list[dict]:
    return [{"name": k, "value": numbers[k], "limit": limits[k]} for k in limits]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--no-sampling", action="store_true")
    a = p.parse_args(argv)
    cell = spec.load_cell(a.workload)
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    run_dir = Path(tempfile.mkdtemp(prefix="portbench-", dir=base))
    run = Run(cell, a.seed, a.seconds, bool(a.trace), a.rehearse, a.control, run_dir,
              not a.no_sampling)
    driver = importlib.import_module(f"portbench.drivers.{cell.config['kind']}")
    try:
        out = driver.run(run)
    except Exception as e:  # noqa: BLE001 — a run that fails prints no result
        traceback.print_exc()
        print(f"portbench: {cell.name} failed: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

    found = out["forbidden"] + procs.forbidden(sys.modules)
    if found:
        print(f"portbench: JAX or the JAX package was imported: {found}", file=sys.stderr)
        return 2
    chosen = cell.per_layer if a.trace else cell.end_to_end
    metrics = {}
    for m in chosen:
        value = spec.reader(m["name"])(out["window"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = checks_of(out["checks"], cell.config["limits"])
    correct = all(c["value"] <= c["limit"] for c in checks) and out["judged"] > 0
    dev = out["device"]
    if a.rehearse:
        device = {"platform": "cpu", "kind": "rehearsal", "count": 0}
    else:
        device = {"platform": "gpu", "kind": dev["kind"], "count": dev["count"],
                  "memory_peak_bytes": dev["memory_peak_bytes"]}
        if a.trace:
            device.update(busy_s=dev["busy_s"], window_s=dev["window_s"])
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if a.trace and not a.rehearse:
        result["breakdown"] = {"device_ops": dev["device_ops"], "idle_gaps": dev["idle_gaps"]}
    result["detail"] = out["detail"]
    result["judged"] = out["judged"]
    result["checks"] = checks
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
