"""The node exporter of a rehearsal, on a simulated card that walks.

``python -m portbench.rehearsal SIM <exporter flags>`` runs the port's
exporter as ``python -m tpu_pod_exporter_torch <exporter flags>`` would,
over the simulated NVML driver its ``--nvml-sim-spec`` builds, with one
difference: card 0, and its first process, hold the walk's block
(``moves.py``) at the instant each is read, by the wall clock from the
walk's origin in the JSON file ``SIM``, as the job walks the real card. A
rehearsal is a run on a CPU and measures nothing; this is its stand-in for
the card, so that on the CPU too an answer served from an old read
differs from the card.
"""

from __future__ import annotations

import json
import sys
import time

from portbench import moves


def main(argv: list[str]) -> int:
    with open(argv[0]) as f:
        sim = json.load(f)
    phases = [tuple(p) for p in sim["walk"]]

    def block(_step: int) -> int:
        return moves.block_at(phases, time.time() - sim["origin"])

    from tpu_pod_exporter_torch import app
    from tpu_pod_exporter_torch.backend import nvml

    build = nvml.sim_driver_from_spec

    def walking(doc: dict):
        driver = build(doc)
        card = driver.scripts[0]
        used, procs = card.mem_used_bytes, tuple(card.processes)
        card.mem_used_bytes = lambda step: used + block(step)
        if procs:
            (pid, mem, comm), rest = procs[0], procs[1:]
            card.processes = lambda step: ((pid, mem + block(step), comm), *rest)
        return driver

    nvml.sim_driver_from_spec = walking
    return app.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
