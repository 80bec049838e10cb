"""The job on the card: a training pod's load, made from the seed.

``python -m portbench.card --seed N --fill-gib G --width W --depth D --batch B
--moves JSON`` is the one process that uses the card. It holds a fill of
``G`` GiB and runs ``h = tanh(h @ w[i])`` over ``D`` layers of width ``W``
at batch ``B`` in bfloat16 (cuBLAS), all made on the card from the seed by
one ``torch.Generator``. It is the benchmark's own load, not the
program's: the exporter is measured while the card is busy, as on a node
whose pod trains. From the moment it is ready it walks its memory
(``moves.py``): it allocates and frees a block on a schedule drawn from
the seed, so that an answer the exporter served from an old read of the
card differs from the card.

It speaks JSON lines: after warming up it prints ``{"ready": ...}`` with the
card's name and count; then it reads commands on standard input:
``window`` marks the measured window's start, ``stop`` ends the load and
prints ``{"stopped": ...}``, and ``exit`` (or the end of input) frees the
card and exits. With ``--trace`` it runs under ``torch.profiler`` from
before its warm-up, so that the profiler's own set-up and device memory
come before anything is measured, and ``stopped`` carries the seconds in
which a kernel ran inside the window. A step is waited for with a blocking
event, one step behind, so the card stays busy and the host thread sleeps.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from portbench import moves

GRAPH_STEPS = 8   # passes over the layers a launch: about 50 ms on an H100


def _say(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _short(name: str) -> str:
    return name.split("(", 1)[0].split("<", 1)[0][:80]


def _busy(prof, t0: int, t1: int) -> tuple[float, list, list]:
    """(seconds in which a kernel ran between ``t0`` and ``t1``, ns of the
    wall clock, the 10 kernels with most time there, the 10 longest gaps
    between kernels there) from a finished profiler."""
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA" and e.duration_ns() > 0:
            s, t = max(e.start_ns(), t0), min(e.start_ns() + e.duration_ns(), t1)
            if t > s:
                spans.append((s, t, _short(e.name())))
    spans.sort()
    busy, gaps, by_name = 0, [], {}
    end, last = None, ""
    for s, t, name in spans:
        by_name[name] = by_name.get(name, 0) + (t - s)
        if end is None or s > end:
            if end is not None:
                gaps.append((f"after {last}", (s - end) / 1e9))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
        last = name
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return (busy / 1e9, [[n, v / 1e9] for n, v in ops],
            [[n, v] for n, v in sorted(gaps, key=lambda kv: -kv[1])[:10]])


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--chips", type=int, default=1)
    p.add_argument("--fill-gib", type=float, required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--depth", type=int, required=True)
    p.add_argument("--batch", type=int, required=True)
    p.add_argument("--moves", required=True, help="the configuration's memory walk, as JSON")
    p.add_argument("--trace", action="store_true")
    a = p.parse_args(argv)
    phases = moves.walk(a.seed, json.loads(a.moves))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < a.chips:
        print(f"card: {a.chips} CUDA device(s) wanted, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(a.seed % (1 << 63))
    fill = torch.empty(int(a.fill_gib * (1 << 30)), dtype=torch.uint8, device=dev)
    fill.random_(0, 256, generator=gen)
    w = torch.empty(a.depth, a.width, a.width, dtype=torch.bfloat16, device=dev)
    w.normal_(0.0, a.width ** -0.5, generator=gen)
    h0 = torch.empty(a.batch, a.width, dtype=torch.bfloat16, device=dev)
    h0.normal_(generator=gen)
    # Every buffer of a step is made here, and the two events a step waits
    # on are reused: once it runs, the job allocates nothing but the walk's
    # block, so the card's memory moves only as the walk says.
    acc = torch.empty_like(h0)
    hs = (torch.empty_like(h0), torch.empty_like(h0))
    events = (torch.cuda.Event(blocking=True), torch.cuda.Event(blocking=True))

    def layers() -> None:
        h = h0
        for i in range(a.depth):
            torch.matmul(h, w[i], out=acc)
            h = torch.tanh(acc, out=hs[i % 2])

    # A step is one CUDA graph of GRAPH_STEPS passes over the layers: one
    # launch where eager calls would make 2 x depth of them a pass, so the
    # job keeps the card busy at little cost to the host's cores, which
    # the exporter shares.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            layers()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_STEPS):
            layers()

    def step(k: int) -> torch.cuda.Event:
        graph.replay()
        ev = events[k % 2]
        ev.record()
        return ev

    prof = None
    if a.trace:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    for k in range(3):
        step(k).synchronize()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _say(ready=True, pid=os.getpid(), kind=torch.cuda.get_device_name(0),
         count=a.chips, reserved_bytes=torch.cuda.memory_reserved(dev))

    commands: list[str] = []
    arrived: dict[str, int] = {}   # command -> wall-clock ns it arrived
    got = threading.Event()

    def read() -> None:
        for line in sys.stdin:
            arrived.setdefault(line.strip(), time.time_ns())
            commands.append(line.strip())
            got.set()
        commands.append("exit")
        got.set()

    threading.Thread(target=read, daemon=True).start()
    steps, prev = 0, None
    # The walk: one allocation (the block) or one release (the cache's
    # only free segment, which is the block) a change, on the job's thread.
    phase, block, changes = 0, None, 0
    change_at = time.monotonic() + phases[0][0]
    while "stop" not in commands and "exit" not in commands:
        ev = step(steps)
        steps += 1
        if prev is not None:
            prev.synchronize()
        prev = ev
        if time.monotonic() >= change_at:
            phase = (phase + 1) % len(phases)
            hold, size = phases[phase]
            if size:
                block = torch.empty(size, dtype=torch.uint8, device=dev)
            else:
                block = None
                torch.cuda.empty_cache()
            changes += 1
            change_at += hold
    torch.cuda.synchronize()
    t_stop = arrived.get("stop", time.time_ns())
    out = {"stopped": True, "steps": steps, "walk_changes": changes,
           "reserved_end_bytes": torch.cuda.memory_reserved(dev),
           "memory_peak_bytes": torch.cuda.max_memory_reserved(dev)}
    if prof is not None:
        prof.__exit__(None, None, None)
        t0 = arrived.get("window", t_stop)
        busy_s, ops, gaps = _busy(prof, t0, t_stop)
        out.update(busy_s=busy_s, window_s=(t_stop - t0) / 1e9, device_ops=ops, idle_gaps=gaps)
    _say(**out)
    while "exit" not in commands:
        got.wait()
        got.clear()
    del graph, fill, w, h0, acc, hs, block
    return 0


if __name__ == "__main__":
    sys.exit(main())
