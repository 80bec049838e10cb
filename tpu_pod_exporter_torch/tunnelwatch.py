"""Card liveness watchdog: log the GPU node's device-node state over time.

A card can drop off a node with no notice: a driver reload, a GPU that
falls off the bus, a container that loses its device nodes. This watchdog
samples the cheap liveness signals every ``--interval`` seconds and appends
a JSONL record *only on state change* (plus one initial record and a
periodic heartbeat), so a long watch stays a few KiB and the resulting log
is a timeline of the card's availability.

Signals sampled (plain path checks; none can hang):
- ``device_nodes``: any ``/dev/nvidia<digits>`` card node exists;
- ``nvidiactl``: the driver's control node ``/dev/nvidiactl`` exists.

Neither signal loads CUDA or NVML — a wedged driver cannot wedge the
watchdog. Full NVML reads stay manual (``python -m
tpu_pod_exporter_torch.probe``) and are recorded by hwcheck/probe runs.

    python -m tpu_pod_exporter_torch.tunnelwatch --interval 60

Reference contrast: the reference assumes NVML is always present and
fatally exits otherwise (main.go:44-48); here availability is itself a
time-varying observable worth recording.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
from pathlib import Path

DEFAULT_OUT = str(Path(__file__).resolve().parent / "_build" / "card-watch.jsonl")

_CARD_NODE = re.compile(r"^nvidia[0-9]+$")


def sample(root: str = "/") -> dict:
    dev = os.path.join(root, "dev")
    try:
        names = os.listdir(dev)
    except OSError:
        names = []
    return {
        "device_nodes": any(_CARD_NODE.match(n) for n in names),
        "nvidiactl": os.path.exists(os.path.join(dev, "nvidiactl")),
    }


def _positive_int(text: str) -> int:
    # 0 would ZeroDivisionError the heartbeat modulo below;
    # reject it at parse time with a usage error instead of a traceback.
    v = int(text)
    if v < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return v


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--interval", type=float, default=60.0)
    p.add_argument("--heartbeat-every", type=_positive_int, default=60,
                   help="emit a heartbeat record every N samples even without change")
    p.add_argument("--max-seconds", type=float, default=0.0,
                   help="stop after this long (0 = run forever)")
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    deadline = time.monotonic() + args.max_seconds if args.max_seconds else None
    prev = None
    n = 0
    while deadline is None or time.monotonic() < deadline:
        state = sample()
        n += 1
        # `1 % every` (not a bare 1) so --heartbeat-every 1 records every
        # sample instead of never matching.
        if state != prev or (n % args.heartbeat_every) == 1 % args.heartbeat_every:
            rec = {"t": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                   "change": state != prev, **state}
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            prev = state
        time.sleep(args.interval)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
