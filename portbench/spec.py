"""The benchmark's index and the files it finds by name.

``BENCHMARK.json`` at the checkout's root names every configuration, cell
and metric. Everything that belongs to one of them sits in a file of its
own under ``portbench/``, found by that name:

- ``configs/<config>.json``: the deployment (its ``kind`` picks the driver
  in ``drivers/<kind>.py``), its source, what was cut or assumed, and the
  program's flags as users deploy them;
- ``traffic/<traffic>.json``: the parameters of a traffic mix; its
  ``generator`` names the module ``traffic/<generator>.py`` that the
  driver runs, in a process of its own, as the window's load (the open
  loop of scrapes, the aggregator's rounds);
- ``metrics/<metric>.py``: one reader a metric, end-to-end or per-layer,
  with ``read(window) -> float | None``.

A cell or a metric is added with new files and new entries, never by
editing a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _reports(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    """A per-layer metric is read in the cells it lists, or else in every
    cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    base = root / "portbench"
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{work['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, work["chips"], config, traffic, e2e, per_layer)


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
