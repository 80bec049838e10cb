#!/usr/bin/env python3
"""Drive tpu_pod_exporter_torch on one CUDA card and check every phase.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device    — the card's name, and nvidia-smi's name and power limit;
2. build     — one nvcc call builds both tanh_matmul kernels (wgmma and
               wmma) from this checkout, and g++ the native library
               (``libtpumon``) from the port's ``native/tpumon.cc``;
3. kernel    — each kernel against tanh_matmul_plain on the card at the
               shapes that pick it (ragged M, N, K edges; K or N not a
               multiple of 8; a misaligned h), checking which kernel each
               launched; then, at the main-path shape and in turns, the
               times of the wgmma kernel, the wmma kernel (through its C
               entry), the plain version and one cuBLAS call
               (``torch.tanh(h @ w)``, a yardstick the package never calls);
4. workload  — a burn at width 8192, depth 8, batch 4096 (10 forwards per
               step), its TFLOP/s, the chain checked against the plain
               chain, and every launch on the wgmma kernel;
5. closed    — the main path: hwcheck's live exporter on the torch backend,
   loop       scraped over HTTP while a 16 GiB fill and the full-size burn
               load the card; memory must rise under load and fall after,
               and every launch is on the wgmma kernel;
6. sgd       — sgd_update_ against sgd_update_plain on the card, bit for
               bit, at 1, 7, 8 and 4097 elements, misaligned views and the
               full stacked layers (8 x 8192 x 8192); then, in turns, the
               kernel, the plain version and ``p.add_(g, alpha=-lr)`` (the
               nearest one-call update, not the same rounding) at full size
               beside the bound;
7. grad      — the gradient of the loss through the wgmma chain against the
               gradient through the plain chain at width 8192, depth 2,
               batch 4096;
8. train     — the training path: sharded_train_step on a mesh of one card,
               first 5 steps at width 64 that must descend, then the full
               size (width 8192, depth 8, batch 4096) for 10 s: step time,
               TFLOP/s, one step split into forward, backward and update,
               every forward launch on wgmma and one sgd launch a step;
9. cli       — the load CLI's burn, hbm and sharded modes as subprocesses
               (each exits 0 and prints its line), and ``entry()``'s output
               on the card;
10. online    — ring attention's running-softmax kernel against
    softmax     online_softmax_update_plain at its edge cases (the first
               step, Tq = 1, Tkv = 1, ragged Tkv, scores scaled 30x30, a row
               past 48 KiB) and at the ring's shape at --scale 1024; then,
               in turns, the kernel and the plain version beside the bound;
11. parallel  — the collective programs on a world of one card at
               --scale 1024: one step of ring, Ulysses, pipeline, MoE and
               FSDP each against its reference (f32, TF32 off), and a ring
               step with q, k, v drawn apart; each step's time, one ring
               step split into its products and the kernel,
               one kernel launch a ring step; then the numeric selftest
               (``--n 1 --checks all``) as a subprocess, ``entry.
               dryrun_multichip(1)``, and the CLI's ``--mode parallel`` for
               every program (multislice refused: one card is not an even
               count);
12. nvml      — the GPU node path: the ctypes NVML binding against torch and
               nvidia-smi (count, UUID, memory total, and the minor number
               against the /dev/nvidia<N> this process holds); hwcheck's
               live exporter on the NVML backend with --process-metrics,
               --legacy-metrics and checkpoint attribution through a UID map
               (a synthetic kubelet checkpoint gives this card to one pod),
               scraped while the 16 GiB fill and the full-size burn load the
               card: the card's memory rises by the fill and falls, its
               utilization rises, the process table sums to the fill, this
               process holds the card's node, the pod's memory rises by the
               fill, the reference's {pid, pod} series is there, and every
               launch is on the wgmma kernel; ``--backend auto`` picks NVML;
               then NvmlBackend.sample() times over 200 calls idle and under
               the burn, and NVML's used beside the allocator's count.
13. node      — the node's native fast path and durable state under the
    state       16 GiB fill and the full-size burn: nativelib.load() gives the
               libtpumon just built from the port's native/tpumon.cc; the live
               exposition renders the same bytes natively and in Python; the
               native and Python /proc walks give the same holders (this
               process holds the card's node alone); the exporter's poll-phase
               p50/p99 with the library on and off in turns; then the exporter
               as a subprocess with --state-dir and --egress-url to an
               in-process receiver, SIGKILLed mid-poll by chaos and restarted:
               the history holds the filled level from before the kill, the
               receiver's ledger has no gap and no re-sent batch and agrees
               with that history, and three injected NVML errors are counted
               and recovered from.
14. fleet     — the fleet plane over the card's node under the 16 GiB fill and
               the full-size burn: the port's exporter on the card (NVML,
               process scan, checkpoint attribution) and fifteen simulated
               8-card nodes (16 hosts, 121 cards in two pools) scraped by a
               flat aggregator (stream on, rounds recorded) and by two shard
               leaves under a root (store with a recording rule, one alert
               rule, a webhook to an in-process receiver) and a replica, all
               subprocesses of the port; the pool's slice HBM rises by the
               node's rise and falls, chip and host counts, fleet sums and the
               pod's workload rollup hold, no TPU-family series appears; the
               root's rollups equal the flat aggregator's, both leaves up, the
               replica serves them; the root's stream sends a snapshot, then
               deltas with consecutive seqs, one at the filled level; the
               store holds the idle, filled and released levels; the alert
               goes pending, firing, resolved, with webhook seqs 1 and 2;
               ``status --tree`` and ``status`` on the node exit 0 and show
               121 cards, the firing alert and the card; every tier exits 0
               on SIGTERM. Prints the round times, the stream's lag, the
               alert's latency and each process's CPU and RSS.

Then one JSON line with every kernel's numbers, nvidia-smi's line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

# Published dense peaks of one H100 SXM (NVIDIA's data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# Main-path shape: the burn the JAX package ran, width 8192, depth 8,
# batch 4096 (HARDWARE.md), and a 16 GiB fill held beside it.
WIDTH, DEPTH, BATCH, ITERS = 8192, 8, 4096, 10
FILL_BYTES = 16 << 30
MAIN_SHAPE = (BATCH, WIDTH, WIDTH)
# (m, k, n, elements h is shifted off 16-byte alignment, kernel it picks).
KERNEL_CASES = (
    (32, 128, 128, 0, "wgmma"),
    (257, 1000, 4096, 0, "wgmma"),   # ragged M and K tiles
    (1, 64, 8, 0, "wgmma"),          # one row; N and K inside one tile
    (300, 136, 264, 0, "wgmma"),     # ragged M, N and K; a W box wholly past N
    (*MAIN_SHAPE, 0, "wgmma"),
    (257, 1000, 4095, 0, "wmma"),    # N not a multiple of 8
    (300, 136, 264, 1, "wmma"),      # h off 16-byte alignment
)
SOURCES = {"wgmma": "tanh_matmul_sm90.cu", "wmma": "tanh_matmul.cu"}
# One layer: the kernel and the plain version both sum bf16 products in f32,
# in different orders, and take tanh in f32 (tanhf against torch.tanh); the
# two f32 results may then round to neighbouring bf16 values. One bf16 step
# in [0.5, 1) is 2**-8; allow two.
LAYER_ATOL = 2.0**-7
# The depth-8 chain: each layer may round differently, and later layers
# carry an earlier difference on (tanh and the sqrt(2/width) weights keep
# its size about the same per layer).
CHAIN_ATOL = 2.0**-4
BURN_SECONDS = 10.0
# Training: SGD at the JAX step's learning rate; the gradient checked at
# depth 2 against the plain chain (f32 products and tanh, as in JAX). The
# kernels' backward takes 1 - y**2 from the bf16 y, which puts the two
# gradients under 1% of max|grad| apart on the CPU at small widths.
LR = 1e-2
GRAD_DEPTH = 2
GRAD_RTOL = 2.0**-6
TRAIN_SECONDS = 10.0
# (elements, p offset, g offset): vector body and scalar tail, misaligned
# views (element by element), and the full stacked layers.
SGD_CASES = (
    (1, 0, 0), (7, 0, 0), (8, 0, 0), (4097, 0, 0),
    (4097, 1, 0), (4097, 3, 3), (1 << 20, 0, 1),
    (DEPTH * WIDTH * WIDTH, 0, 0),
)
# Ring attention's running softmax: (Tq, Tkv, D, d, first step, score
# scale). The ring's shape at --scale 1024 on one card is T = 4096, d = 8192.
RING_T, RING_D = 4096, 8192
SOFTMAX_CASES = (
    (64, 256, 64, 64, True, 1.0),        # the first step: m = -inf, l = 0
    (1, 4096, 8192, 8192, False, 1.0),   # Tq = 1
    (33, 1, 16, 16, True, 1.0),          # Tkv = 1
    (17, 1000, 48, 16, False, 1.0),      # Tkv not a multiple of the block
    (40, 4097, 24, 4, True, 900.0),      # q and k scaled 30x: scores 900x
    (8, 20000, 32, 64, False, 1.0),      # a row past 48 KiB of shared memory
    (RING_T, RING_T, RING_D, RING_D, True, RING_D**0.5),
    (RING_T, RING_T, RING_D, RING_D, False, RING_D**0.5),
)
# m is a max of the same f32 quotients (true division by the same correctly
# rounded sqrt): equal. p and l differ by expf against torch.exp and the
# order of the row sum, a few f32 ulps; o is scaled by the same corr. The
# absolute floor lies far below any p that matters (p underflows near 1e-38).
SOFTMAX_RTOL, SOFTMAX_ATOL = 1e-5, 1e-30
# The collective programs on one card, at the scale that gives the
# pipeline the flagship's width 8192 and batch 4096; each is held against
# its reference in f32 (TF32 off) at the numeric selftest's tolerances
# (rtol = atol), the FSDP loss in absolute terms.
PAR_SCALE = 1024
PAR_TOL = {"ring": 2e-5, "ulysses": 2e-5, "pipeline": 2e-4, "moe": 2e-4, "fsdp": 2e-5}
FSDP_LOSS_ATOL = 1e-5
# The programs draw q = k = v, as the JAX package does, which makes each
# row's softmax one-hot at d = 8192; one more ring step at the same shape
# draws them apart (scores of unit spread), at the ring's tolerance.
REPO = Path(__file__).resolve().parent
# The NVML phase: NvmlBackend.sample() timed over this many calls, and the
# pod a synthetic kubelet checkpoint gives the card to.
NVML_SAMPLES = 200
SMOKE_POD, SMOKE_POD_UID = "burn-0", "8a1d3f50-0c4e-4b6e-9f21-5d7c2b9e4a10"
# The node state phase: the live exporter's poll phases in segments of this
# length, with the native library on and off in turns; then a subprocess
# exporter that chaos SIGKILLs on this device call, restarted on the same
# state with three NVML errors from this call on.
NODE_STATE_MODES = ("native", "python", "python", "native")
NODE_STATE_SEGMENT_S = 4.0
NODE_STATE_INTERVAL_S = 0.1
NODE_STATE_RUN_INTERVAL_S = 0.25
NODE_STATE_KILL_AT = 16
NODE_STATE_ERRORS_AT = 12
POLL_PHASES = ("device_read", "process_scan", "attribution", "publish", "total")
# The fleet phase: the real node and FLEET_HOSTS_PER_POOL * 2 - 1 simulated
# ones (FLEET_SIM_GPUS cards each) in two pools, every tier at this interval;
# at least FLEET_IDLE_ROUNDS idle root rounds, FLEET_LOAD_S under the fill
# and the burn, FLEET_RELEASE_S after; the tiers scraped every
# FLEET_OBSERVE_S. The store keeps 0.5 s buckets, so the run's levels stay
# apart in it.
FLEET_INTERVAL_S = 0.5
FLEET_POOLS = ("h100-pool-a", "h100-pool-b")
FLEET_REAL_NODE = ("node-00", "h100-pool-a")
FLEET_HOSTS_PER_POOL = 8
FLEET_SIM_GPUS = 8
FLEET_ACCELERATOR = "nvidia-h100-80gb"
FLEET_IDLE_ROUNDS = 3
FLEET_LOAD_S = 10.0
FLEET_RELEASE_S = 5.0
FLEET_OBSERVE_S = 0.1
FLEET_STORE_TIERS = "0.5:720,10:360"
FLEET_STORE_METRIC = "h100:hbm:by_slice"
FLEET_STORE_RULE = (f"{FLEET_STORE_METRIC} = "
                    'sum(tpu_slice_hbm_used_bytes{family="gpu"}) by (slice_name)')
FLEET_ALERT = "H100PoolHbmFilled"
FLEET_ALERT_RULE = (
    f"alert {FLEET_ALERT} = "
    'tpu_slice_hbm_used_bytes{{family="gpu",slice_name="{pool}"}} > {threshold}\n'
    "    for 1s\n"
    '    labels(severity="info")\n'
    '    annotations(summary="{{{{ $labels.slice_name }}}} HBM above {threshold} B")\n')
FLEET_STREAM = ("tpu_slice_hbm_used_bytes", 30.0)  # metric, window (s)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip().splitlines()[0]


def time_in_turns(fns: dict, reps: int = 20, calls: int = 5) -> dict:
    """Median ms a call of each function, timed in turns: every round times
    each function once, as CUDA events around ``calls`` back-to-back calls
    (so the host's launch cost of the first hides behind the others)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times: dict = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / calls)
    return {name: statistics.median(t) for name, t in times.items()}


def reset_counts(tm, sgd=None, osm=None) -> None:
    tm.tanh_matmul.launches = 0
    for kernel in tm.tanh_matmul.launches_by_kernel:
        tm.tanh_matmul.launches_by_kernel[kernel] = 0
    if sgd is not None:
        sgd.sgd_update_.launches = 0
    if osm is not None:
        osm.online_softmax_update_.launches = 0


def layer_bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time for one layer: operations at the bf16 tensor-core peak or
    bytes (h and w read once, y written once) at the memory rate."""
    ops_ms = 2.0 * m * n * k / PEAK_BF16_FLOPS * 1e3
    bytes_ms = 2.0 * (m * k + k * n + m * n) / PEAK_HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def operands(dev, gen, m, k, n, offset=0):
    """h (m,k) and w (k,n) bf16; ``offset`` elements shift h off 16-byte
    alignment while keeping it contiguous."""
    h = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    if offset:
        buf = torch.empty((m * k + offset,), dtype=torch.bfloat16, device=dev)
        h = buf[offset:].view(m, k).copy_(h)
    w = (torch.randn((k, n), generator=gen, device=dev) * k**-0.5).to(torch.bfloat16)
    return h, w


def phase_kernel(dev, tm) -> dict:
    """Each kernel against the plain version; then the times at the main
    shape. Returns {kernel: its numbers for the kernels line}."""
    gen = torch.Generator(device=dev).manual_seed(0)
    errs: dict = {}
    for m, k, n, offset, kernel in KERNEL_CASES:
        h, w = operands(dev, gen, m, k, n, offset)
        before = dict(tm.tanh_matmul.launches_by_kernel)
        y = tm.tanh_matmul(h, w)
        ref = tm.tanh_matmul_plain(h, w)
        torch.cuda.synchronize()
        moved = {name: tm.tanh_matmul.launches_by_kernel[name] - before[name]
                 for name in before}
        err = (y.float() - ref.float()).abs().max().item()
        emit("kernel", kernel=kernel, shape=[m, k, n], h_offset=offset,
             launched=moved, max_abs_err=err, atol=LAYER_ATOL)
        if moved != {name: int(name == kernel) for name in moved}:
            raise AssertionError(f"{m}x{k}x{n} offset {offset}: expected one "
                                 f"{kernel} launch, counted {moved}")
        if not (torch.isfinite(y.float()).all() and err <= LAYER_ATOL):
            raise AssertionError(f"{kernel} {m}x{k}x{n}: max_abs_err {err} > {LAYER_ATOL}")
        if (m, k, n) == MAIN_SHAPE:
            errs[kernel] = err
        del h, w, y, ref

    m, k, n = MAIN_SHAPE
    h, w = operands(dev, gen, m, k, n)
    wmma_err = (tm.launch("wmma", h, w).float()
                - tm.tanh_matmul_plain(h, w).float()).abs().max().item()
    if wmma_err > LAYER_ATOL:
        raise AssertionError(f"wmma {m}x{k}x{n}: max_abs_err {wmma_err} > {LAYER_ATOL}")
    errs["wmma"] = wmma_err
    ms = time_in_turns({
        "wgmma": lambda: tm.tanh_matmul(h, w),
        "library": lambda: torch.tanh(h @ w),
        "wmma": lambda: tm.launch("wmma", h, w),
        "plain": lambda: tm.tanh_matmul_plain(h, w),
    })
    bound, bound_by = layer_bound_ms(m, k, n)
    flops = 2.0 * m * n * k
    emit("kernel_time", shape=[m, k, n], ms=ms, bound_ms=bound, bound_by=bound_by,
         tflops={name: flops / t / 1e9 for name, t in ms.items()},
         share_of_bound={name: bound / t for name, t in ms.items()})
    del h, w
    return {kernel: {
        "max_abs_err": errs[kernel],
        "ms": ms[kernel],
        "plain_ms": ms["plain"],
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": ms["library"],
    } for kernel in SOURCES}


def check_all_wgmma(tm, phase: str, launches: int) -> None:
    by_kernel = tm.tanh_matmul.launches_by_kernel
    if by_kernel["wgmma"] != launches or by_kernel["wmma"] != 0:
        raise AssertionError(f"{phase}: {launches} launches, by kernel {by_kernel}")


def phase_workload(dev, tm, wl) -> None:
    params = wl.init_params(width=WIDTH, depth=DEPTH, seed=0, device=dev)
    x = torch.ones((BATCH, WIDTH), dtype=torch.bfloat16, device=dev)
    out = wl.forward(params, x)
    plain = x
    for w in params["layers"]:
        plain = tm.tanh_matmul_plain(plain, w)
    torch.cuda.synchronize()
    chain_err = (out.float() - plain.float()).abs().max().item()
    if not (out.shape == (BATCH, WIDTH) and torch.isfinite(out.float()).all()
            and chain_err <= CHAIN_ATOL):
        raise AssertionError(f"forward chain: shape {tuple(out.shape)}, "
                             f"max_abs_err {chain_err} > {CHAIN_ATOL}")
    del out, plain
    reset_counts(tm)
    steps = 0
    t0 = time.monotonic()
    while time.monotonic() - t0 < BURN_SECONDS:
        x = wl.burn_step(params, x, iters=ITERS)
        torch.cuda.synchronize()
        steps += 1
    dt = time.monotonic() - t0
    # The card's clock and draw just after 10 s of load: under its power
    # limit the clock falls below what a short timing sees.
    clocks_power = nvidia_smi("clocks.sm,power.draw")
    launches = tm.tanh_matmul.launches
    if launches != steps * ITERS * DEPTH or not torch.isfinite(x.float()).all():
        raise AssertionError(f"burn: {launches} launches for {steps} steps")
    check_all_wgmma(tm, "burn", launches)
    flops = 2 * BATCH * WIDTH * WIDTH * DEPTH * ITERS * steps
    emit("workload", width=WIDTH, depth=DEPTH, batch=BATCH, iters=ITERS,
         steps=steps, seconds=dt, tflops=flops / dt / 1e12,
         launches=launches, launches_by_kernel=tm.tanh_matmul.launches_by_kernel,
         chain_max_abs_err=chain_err, chain_atol=CHAIN_ATOL,
         clocks_sm_power_draw=clocks_power)


def phase_closed_loop(dev, tm, hwcheck, uuid: str) -> dict:
    stim = hwcheck.TorchStimulus(hbm_bytes=FILL_BYTES, width=WIDTH, depth=DEPTH,
                                 batch=BATCH, iters=ITERS, device=dev)
    reset_counts(tm)
    report = hwcheck.run_check(backend="torch", idle_s=2.0, load_s=8.0,
                               stimulus=stim)
    launches = tm.tanh_matmul.launches
    by_kernel = dict(tm.tanh_matmul.launches_by_kernel)
    emit("closed_loop", report=report, launches=launches,
         launches_by_kernel=by_kernel, burn_steps=stim.steps)
    checks = report["checks"]
    if not (report["ok"] and checks["hbm_rises_under_load"]
            and checks["hbm_falls_after_release"]):
        raise AssertionError(f"closed loop failed: {checks}")
    if report["family"] != "gpu" or report["phases"]["load"]["hbm_total_bytes"] <= 0:
        raise AssertionError("closed loop did not read gpu_hbm_* series")
    rise = (report["phases"]["load"]["hbm_used_bytes"]
            - report["phases"]["idle"]["hbm_used_bytes"])
    if rise < FILL_BYTES:
        raise AssertionError(f"gpu_hbm_used_bytes rose {rise} B, less than the fill")
    if launches <= 0:
        raise AssertionError("no tanh_matmul launch during the load phase")
    check_all_wgmma(tm, "closed loop", launches)
    from tpu_pod_exporter_torch.backend.torchdev import TorchCudaBackend

    (chip,) = TorchCudaBackend().sample().chips
    if chip.info.device_ids[0] != uuid:
        raise AssertionError(f"device id {chip.info.device_ids} != nvidia-smi {uuid}")
    return by_kernel


def misaligned(t, offset: int):
    """A contiguous copy of 1-D ``t`` starting ``offset`` elements into a buffer."""
    buf = torch.empty((t.numel() + offset,), dtype=t.dtype, device=t.device)
    return buf[offset:].copy_(t)


def phase_sgd(dev, sgd) -> dict:
    """sgd_update_ against the plain version, bit for bit; then the times at
    full size. Returns its numbers for the kernels line."""
    gen = torch.Generator(device=dev).manual_seed(5)
    for n, p_offset, g_offset in SGD_CASES:
        p = torch.randn((n,), generator=gen, device=dev).to(torch.bfloat16)
        g = (0.05 * torch.randn((n,), generator=gen, device=dev)).to(torch.bfloat16)
        want = sgd.sgd_update_plain(p.clone(), g, LR)
        p, g = misaligned(p, p_offset), misaligned(g, g_offset)
        before = sgd.sgd_update_.launches
        sgd.sgd_update_(p, g, LR)
        torch.cuda.synchronize()
        launched = sgd.sgd_update_.launches - before
        equal = bool(torch.equal(p, want))
        err = (p.float() - want.float()).abs().max().item()
        emit("sgd", n=n, p_offset=p_offset, g_offset=g_offset, launched=launched,
             bit_equal=equal, max_abs_err=err)
        if launched != 1 or not equal:
            raise AssertionError(f"sgd n={n} offsets {p_offset},{g_offset}: "
                                 f"{launched} launches, bit_equal={equal}")
        del p, g, want
    p = torch.randn((DEPTH, WIDTH, WIDTH), generator=gen, device=dev).to(torch.bfloat16)
    g = (0.05 * torch.randn((DEPTH, WIDTH, WIDTH), generator=gen, device=dev)).to(torch.bfloat16)
    ms = time_in_turns({
        "kernel": lambda: sgd.sgd_update_(p, g, LR),
        "plain": lambda: sgd.sgd_update_plain(p, g, LR),
        "yardstick": lambda: p.add_(g, alpha=-LR),
    })
    # p read and written, g read, each once.
    moved = 3 * p.numel() * p.element_size()
    bound = moved / PEAK_HBM_BYTES_PER_S * 1e3
    emit("sgd_time", shape=list(p.shape), ms=ms, bound_ms=bound, bound_by="bytes",
         bytes=moved, share_of_bound={name: bound / t for name, t in ms.items()},
         yardstick="p.add_(g, alpha=-lr): the nearest one-call update, not the same rounding")
    del p, g
    return {"max_abs_err": 0.0, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": "bytes",
            # No one PyTorch call computes this update (the yardstick rounds
            # neither lr nor lr * g to bf16).
            "library_ms": None}


def chain_grad(layers, x, y, layer_fn):
    """(loss, gradient of the stacked layers) of the f32 MSE through
    ``layer_fn`` applied layer by layer."""
    layers = layers.detach().clone().requires_grad_()
    h = x
    for w in layers.unbind(0):
        h = layer_fn(h, w)
    loss = torch.mean((h.float() - y.float()) ** 2)
    loss.backward()
    return loss.detach(), layers.grad


def phase_grad(dev, tm, wl) -> None:
    params = wl.init_params(width=WIDTH, depth=GRAD_DEPTH, seed=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((BATCH, WIDTH), generator=gen, device=dev).to(torch.bfloat16)
    y = torch.zeros_like(x)
    reset_counts(tm)
    loss, grad = chain_grad(params["layers"], x, y, tm.tanh_matmul)
    check_all_wgmma(tm, "grad", GRAD_DEPTH)
    ref_loss, ref = chain_grad(params["layers"], x, y, tm.tanh_matmul_plain)
    torch.cuda.synchronize()
    scale = ref.float().abs().max().item()
    rel = (grad.float() - ref.float()).abs().max().item() / scale
    per_layer = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                 for a, b in zip(grad, ref)]
    emit("grad", width=WIDTH, depth=GRAD_DEPTH, batch=BATCH, loss=loss.item(),
         plain_loss=ref_loss.item(), rel_err=rel, rel_err_by_layer=per_layer,
         rtol=GRAD_RTOL, max_abs_grad=scale)
    if not (torch.isfinite(grad.float()).all() and rel <= GRAD_RTOL):
        raise AssertionError(f"grad: max|dgrad| / max|grad| = {rel} > {GRAD_RTOL}")


def phase_train(dev, tm, sgd, sharded) -> dict:
    """The training path on a mesh of one card. Returns the launches by
    kernel of the full-size run."""
    import torch.distributed as dist

    mesh = sharded.make_mesh(1)
    step, params, (x, y) = sharded.sharded_train_step(mesh, width=64, depth=2, batch=16,
                                                       lr=LR)
    losses = []
    for _ in range(5):
        params, loss = step(params, x, y)
        losses.append(loss.item())
    descends = all(b < a for a, b in zip(losses, losses[1:]))
    emit("train_descent", width=64, depth=2, batch=16, losses=losses, descends=descends)
    if not (all(map(math.isfinite, losses)) and descends):
        raise AssertionError(f"losses do not descend: {losses}")

    torch.cuda.reset_peak_memory_stats(dev)
    step, params, (x, y) = sharded.sharded_train_step(mesh, WIDTH, DEPTH, BATCH, LR)
    params, loss = step(params, x, y)
    torch.cuda.synchronize()
    # One step split into its phases by CUDA events.
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    layers = params["layers"].detach().requires_grad_()
    events[0].record()
    share = step.forward(layers, x, y)
    events[1].record()
    share.backward()
    events[2].record()
    step.update(params, layers.grad)
    events[3].record()
    events[3].synchronize()
    split = {name: events[i].elapsed_time(events[i + 1])
             for i, name in enumerate(("forward", "backward", "update"))}
    del layers, share

    reset_counts(tm, sgd)
    losses, steps = [], 0
    t0 = time.monotonic()
    while time.monotonic() - t0 < TRAIN_SECONDS:
        params, loss = step(params, x, y)
        losses.append(loss.item())
        steps += 1
    dt = time.monotonic() - t0
    clocks_power = nvidia_smi("clocks.sm,power.draw")
    by_kernel = {**tm.tanh_matmul.launches_by_kernel, "sgd": sgd.sgd_update_.launches}
    flops_per_step = 2 * BATCH * WIDTH * WIDTH * (3 * DEPTH - 1)
    emit("train", width=WIDTH, depth=DEPTH, batch=BATCH, lr=LR, steps=steps, seconds=dt,
         step_ms=dt / steps * 1e3, tflops=flops_per_step * steps / dt / 1e12,
         flops_per_step="2*B*W^2*(3D-1): D forward and 2D-1 backward products",
         split_ms=split, first_loss=losses[0], last_loss=losses[-1],
         peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
         launches_by_kernel=by_kernel, clocks_sm_power_draw=clocks_power)
    if not all(map(math.isfinite, losses)):
        raise AssertionError("train: a loss is not finite")
    check_all_wgmma(tm, "train", steps * DEPTH)
    if by_kernel["sgd"] != steps:
        raise AssertionError(f"train: {by_kernel['sgd']} sgd launches for {steps} steps")
    del step, params, x, y
    dist.destroy_process_group()
    return by_kernel


def run_cli(*args: str) -> str:
    """The load CLI as a subprocess; returns its output, raising unless it
    exits 0."""
    proc = subprocess.run([sys.executable, "-m", "tpu_pod_exporter_torch.loadgen", *args],
                          capture_output=True, text=True, timeout=180, cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"loadgen {' '.join(args)}: rc={proc.returncode}\n"
                             f"{proc.stderr[-2000:]}")
    return proc.stdout.strip()


def phase_cli(dev) -> None:
    from tpu_pod_exporter_torch.entry import entry

    width, batch, depth = str(WIDTH), str(BATCH), str(DEPTH)
    lines = {
        "burn": run_cli("--mode", "burn", "--width", width, "--batch", batch,
                        "--iters", str(ITERS), "--seconds", "3"),
        "hbm": run_cli("--mode", "hbm", "--gib", "1", "--seconds", "1"),
        "sharded": run_cli("--mode", "sharded", "--devices", "1", "--width", width,
                           "--depth", depth, "--batch", batch, "--seconds", "3"),
    }
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    emit("cli", lines=lines, entry_shape=list(out.shape), entry_device=str(out.device))
    patterns = {
        "burn": r"^\d+ steps in [\d.]+s → [\d.]+ TFLOP/s$",
        "hbm": r"^holding 1\.00 GiB on cuda:0$",
        "sharded": r"^mesh \{'data': 1, 'model': 1\} \| \d+ steps in [\d.]+s \| loss [\d.]+$",
    }
    for mode, pattern in patterns.items():
        if not re.match(pattern, lines[mode].splitlines()[-1]):
            raise AssertionError(f"loadgen --mode {mode} printed {lines[mode]!r}")
    if out.shape != (32, 128) or out.device.type != "cuda" or not torch.isfinite(out.float()).all():
        raise AssertionError(f"entry(): {tuple(out.shape)} on {out.device}")


def softmax_bound_ms(tq: int, tkv: int, dv: int) -> float:
    """Least time for one running-softmax step: r, o, m and l each read
    once and written once, f32, at the memory rate."""
    return 2 * 4 * (tq * tkv + tq * dv + 2 * tq) / PEAK_HBM_BYTES_PER_S * 1e3


def softmax_operands(dev, gen, tq, tkv, dv, first, scale):
    """r, m, l, o for one step; ``first`` starts from m = -inf, l = 0."""
    r = scale * torch.randn((tq, tkv), generator=gen, device=dev)
    o = torch.randn((tq, dv), generator=gen, device=dev)
    if first:
        m = torch.full((tq,), -math.inf, device=dev)
        l = torch.zeros((tq,), device=dev)
    else:
        m = scale * torch.randn((tq,), generator=gen, device=dev)
        l = torch.rand((tq,), generator=gen, device=dev) + 0.5
    return r, m, l, o


def phase_online_softmax(dev, osm) -> dict:
    """The running-softmax kernel against the plain version at every case;
    then the times at the ring's shape. Returns its numbers for the
    kernels line."""
    gen = torch.Generator(device=dev).manual_seed(8)
    main_err = None
    for tq, tkv, dv, d, first, scale in SOFTMAX_CASES:
        got = softmax_operands(dev, gen, tq, tkv, dv, first, scale)
        want = [t.clone() for t in got]
        osm.online_softmax_update_plain(*want, d)
        before = osm.online_softmax_update_.launches
        osm.online_softmax_update_(*got, d)
        torch.cuda.synchronize()
        launched = osm.online_softmax_update_.launches - before
        errs = {name: (a - b).abs().max().item()
                for name, a, b in zip(("p", "m", "l", "o"), got, want)}
        close = all(torch.allclose(a, b, rtol=SOFTMAX_RTOL, atol=SOFTMAX_ATOL)
                    and bool(torch.isfinite(a).all()) for a, b in zip(got, want))
        m_equal = bool(torch.equal(got[1], want[1]))
        emit("online_softmax", shape={"Tq": tq, "Tkv": tkv, "D": dv, "d": d},
             first_step=first, score_scale=scale, launched=launched, m_equal=m_equal,
             max_abs_err=errs, rtol=SOFTMAX_RTOL, atol=SOFTMAX_ATOL)
        if launched != 1 or not (close and m_equal):
            raise AssertionError(f"online_softmax {tq}x{tkv}x{dv}: {launched} launches, "
                                 f"m_equal={m_equal}, errors {errs}")
        if (tq, tkv, dv) == (RING_T, RING_T, RING_D):
            main_err = max(errs.values())
        del got, want
    r, m, l, o = softmax_operands(dev, gen, RING_T, RING_T, RING_D, False, RING_D**0.5)
    ms = time_in_turns({
        "kernel": lambda: osm.online_softmax_update_(r, m, l, o, RING_D),
        "plain": lambda: osm.online_softmax_update_plain(r, m, l, o, RING_D),
    })
    bound = softmax_bound_ms(RING_T, RING_T, RING_D)
    emit("online_softmax_time", shape={"Tq": RING_T, "Tkv": RING_T, "D": RING_D},
         ms=ms, bound_ms=bound, bound_by="bytes",
         share_of_bound={name: bound / t for name, t in ms.items()})
    del r, m, l, o
    return {"max_abs_err": main_err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": "bytes",
            # No one PyTorch call computes this step.
            "library_ms": None}


def reference_of(par, name: str, args):
    return {"ring": par.reference_attention, "ulysses": par.reference_mha,
            "pipeline": par.reference_pipeline, "moe": par.reference_moe,
            "fsdp": par.reference_fsdp}[name](*args)


def phase_parallel(dev, tm, sgd, osm, par) -> dict:
    """The five programs that run on one card at --scale 1024, each held
    against its reference; then the selftest, the dry run and the CLI.
    Returns the launches by kernel of the programs' run."""
    import torch.distributed as dist

    from tpu_pod_exporter_torch.entry import dryrun_multichip

    reset_counts(tm, sgd, osm)
    ring_steps = 0
    results: dict = {}
    for name in PAR_TOL:
        step, args, _feed = par.build_parallel_program(name, 1, scale=PAR_SCALE)
        out = step(*args)
        ref = reference_of(par, name, args)
        if name == "fsdp":
            (out, loss), (ref, ref_loss) = out, ref
            loss_err = abs(loss.item() - ref_loss.item())
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        ok = bool(torch.isfinite(out).all()) and torch.allclose(
            out, ref, rtol=PAR_TOL[name], atol=PAR_TOL[name])
        ms = time_in_turns({name: lambda: step(*args)}, reps=5, calls=1)[name]
        ring_steps += 7 if name == "ring" else 0  # the step, time_in_turns' 1 + 5
        results[name] = {"shape": {a: list(t.shape) for a, t in zip(par.ARGS[name], args)},
                         "max_abs_err": err, "tol": PAR_TOL[name], "step_ms": ms}
        if name == "fsdp":
            results[name]["loss_abs_err"] = loss_err
            ok = ok and loss_err < FSDP_LOSS_ATOL
        if not ok:
            raise AssertionError(f"parallel {name} x{PAR_SCALE}: {results[name]}")
        del step, args, out, ref
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn((RING_T, RING_D), generator=gen, device=dev) for _ in range(3))
    fn, _shard = par.ring_attention_fn(par.make_1d_mesh(1, "seq"))
    out, ref = fn(q, k, v), par.reference_attention(q, k, v)
    ring_steps += 1
    err = (out - ref).abs().max().item()
    results["ring_apart"] = {"max_abs_err": err, "tol": PAR_TOL["ring"]}
    if not (bool(torch.isfinite(out).all())
            and torch.allclose(out, ref, rtol=PAR_TOL["ring"], atol=PAR_TOL["ring"])):
        raise AssertionError(f"ring with q, k, v drawn apart: max_abs_err {err}")
    del q, k, v, out, ref
    by_kernel = {**tm.tanh_matmul.launches_by_kernel, "sgd": sgd.sgd_update_.launches,
                 "online_softmax": osm.online_softmax_update_.launches}
    if by_kernel["online_softmax"] != ring_steps:
        raise AssertionError(f"parallel: {by_kernel['online_softmax']} online_softmax "
                             f"launches for {ring_steps} ring steps")

    # One ring step on one card, split by CUDA events: r = q @ k.T, the
    # kernel, o += p @ v (the program's body, n = 1).
    step, (q, k, v), _feed = par.build_parallel_program("ring", 1, scale=PAR_SCALE)
    step(q, k, v)
    o = torch.zeros_like(q)
    m = torch.full((q.shape[0],), -math.inf, device=dev)
    l = torch.zeros_like(m)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    events[0].record()
    p = torch.mm(q, k.t())
    events[1].record()
    osm.online_softmax_update_(p, m, l, o, q.shape[1])
    events[2].record()
    o.addmm_(p, v)
    events[3].record()
    events[3].synchronize()
    split = {part: events[i].elapsed_time(events[i + 1])
             for i, part in enumerate(("qk_product", "online_softmax", "pv_product"))}
    flops = 4.0 * q.shape[0] * k.shape[0] * q.shape[1]
    del step, q, k, v, o, m, l, p
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    emit("parallel", scale=PAR_SCALE, devices=1, programs=results,
         ring_split_ms=split, ring_product_tflops=flops / (split["qk_product"]
                                                            + split["pv_product"]) / 1e9,
         launches_by_kernel=by_kernel, ring_steps=ring_steps)

    selftest = subprocess.run(
        [sys.executable, "-m", "tpu_pod_exporter_torch.loadgen.selftest", "--n", "1",
         "--checks", "all"], capture_output=True, text=True, timeout=300, cwd=REPO)
    report = json.loads(selftest.stdout.strip().splitlines()[-1]) if selftest.stdout else {}
    emit("selftest", rc=selftest.returncode,
         checks={k: {f: x for f, x in v.items() if f != "traceback"}
                 for k, v in report.get("checks", {}).items()},
         stderr=selftest.stderr[-1000:] if selftest.returncode else "")
    if selftest.returncode != 0:
        raise AssertionError(f"selftest --n 1 --checks all exited {selftest.returncode}")
    dryrun = dryrun_multichip(1)
    emit("dryrun_multichip", n_devices=1, report=dryrun)

    lines = {name: run_cli("--mode", "parallel", "--program", name,
                           "--scale", str(PAR_SCALE), "--seconds", "2")
             for name in PAR_TOL}
    refused = subprocess.run(
        [sys.executable, "-m", "tpu_pod_exporter_torch.loadgen", "--mode", "parallel",
         "--program", "multislice", "--scale", str(PAR_SCALE), "--seconds", "2"],
        capture_output=True, text=True, timeout=180, cwd=REPO)
    emit("parallel_cli", lines=lines, multislice_rc=refused.returncode,
         multislice_stderr=refused.stderr.strip()[-200:])
    for name, line in lines.items():
        pattern = rf"^{name} x{PAR_SCALE} on 1 devices: \d+ steps in [\d.]+s → [\d.]+ steps/s$"
        if not re.match(pattern, line.splitlines()[-1]):
            raise AssertionError(f"loadgen --mode parallel --program {name} printed {line!r}")
    if refused.returncode == 0 or "even device count" not in refused.stderr:
        raise AssertionError(f"multislice on one card: rc={refused.returncode}")
    return by_kernel


def held_card_nodes() -> set:
    """The /dev/nvidia<N> card nodes among this process's open files."""
    nodes = set()
    for fd in os.listdir("/proc/self/fd"):
        try:
            target = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            continue
        if re.fullmatch(r"/dev/nvidia[0-9]+", target):
            nodes.add(target)
    return nodes


def sample_ms(backend, calls: int = NVML_SAMPLES) -> dict:
    """Median and p99 ms of ``backend.sample()`` over ``calls`` calls."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        backend.sample()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return {"median": statistics.median(times), "p99": times[math.ceil(0.99 * calls) - 1],
            "calls": calls}


def kubelet_fixture(tmp: str, uuid: str) -> dict:
    """A synthetic kubelet checkpoint that gives the card ``uuid`` to the
    smoke pod, and the pod's UID map, written under ``tmp``; returns the
    exporter settings that read them."""
    ckpt, uids = Path(tmp, "kubelet_internal_checkpoint"), Path(tmp, "uids.json")
    ckpt.write_text(json.dumps({"Data": {"PodDeviceEntries": [
        {"PodUID": SMOKE_POD_UID, "ContainerName": "burn",
         "ResourceName": "nvidia.com/gpu", "DeviceIDs": {"-1": [uuid]}}]}}))
    uids.write_text(json.dumps({SMOKE_POD_UID: {"name": SMOKE_POD, "namespace": "smoke"}}))
    return {"attribution": "checkpoint", "checkpoint_path": str(ckpt),
            "uid_map_file": str(uids)}


def phase_nvml(dev, tm, hwcheck, uuid: str) -> dict:
    """The GPU node path on the card. Returns the launches by kernel of its
    closed loop."""
    import tempfile

    from tpu_pod_exporter_torch.app import build_backend
    from tpu_pod_exporter_torch.backend.nvml import NvmlBackend
    from tpu_pod_exporter_torch.backend.nvml_ctypes import CtypesNvmlDriver
    from tpu_pod_exporter_torch.backend.torchdev import _nvml_uuid
    from tpu_pod_exporter_torch.config import ExporterConfig

    driver = CtypesNvmlDriver()
    driver.nvmlInit()
    count = driver.nvmlDeviceGetCount()
    torch_uuid = _nvml_uuid(torch.cuda.get_device_properties(dev).uuid)
    handles = {driver.nvmlDeviceGetUUID(h): h
               for h in map(driver.nvmlDeviceGetHandleByIndex, range(count))}
    handle = handles.get(torch_uuid)
    minor = None if handle is None else driver.nvmlDeviceGetMinorNumber(handle)
    total_mib = None if handle is None else driver.nvmlDeviceGetMemoryInfo(handle)["total"] / 2**20
    driver.nvmlShutdown()
    smi_total = nvidia_smi("memory.total")
    held = held_card_nodes()
    emit("nvml_binding", count=count, uuid=torch_uuid, nvidia_smi_uuid=uuid,
         minor=minor, held_nodes=sorted(held), memory_total_mib=total_mib,
         nvidia_smi_memory_total=smi_total, process_symbol=driver.process_symbol)
    if not (count >= 1 and handle is not None and torch_uuid == uuid):
        raise AssertionError(f"NVML: {count} devices, none with torch's UUID {torch_uuid} "
                             f"(nvidia-smi {uuid})")
    if int(smi_total.split()[0]) != int(total_mib):
        raise AssertionError(f"NVML total {total_mib} MiB, nvidia-smi {smi_total}")
    node = f"/dev/nvidia{minor}"
    if held != {node}:
        raise AssertionError(f"minor {minor}, but this process holds {sorted(held)}")

    reset_counts(tm)
    with tempfile.TemporaryDirectory() as tmp:
        stim = hwcheck.TorchStimulus(hbm_bytes=FILL_BYTES, width=WIDTH, depth=DEPTH,
                                     batch=BATCH, iters=ITERS, device=dev)
        report = hwcheck.run_check(
            backend="nvml", idle_s=2.0, load_s=8.0, stimulus=stim,
            exporter_args={"process_metrics": True, "legacy_metrics": True,
                           **kubelet_fixture(tmp, torch_uuid)})
    by_kernel = dict(tm.tanh_matmul.launches_by_kernel)
    emit("nvml_closed_loop", report=report, pid=os.getpid(), launches_by_kernel=by_kernel,
         burn_steps=stim.steps)
    idle, load = report["phases"]["idle"], report["phases"]["load"]
    checks = report["checks"]
    if not (report["ok"] and report["family"] == "gpu" and checks["hbm_rises_under_load"]
            and checks["hbm_falls_after_release"] and checks["duty_cycle_responds"]):
        raise AssertionError(f"nvml closed loop failed: {checks}")
    rise = load["hbm_used_bytes"] - idle["hbm_used_bytes"]
    if rise < FILL_BYTES:
        raise AssertionError(f"gpu_hbm_used_bytes rose {rise} B, less than the fill")
    if sum(load["process_memory_bytes"].values()) < FILL_BYTES:
        raise AssertionError(f"process rows {load['process_memory_bytes']} sum under the fill")
    if str(os.getpid()) not in load["holder_pids"]:
        raise AssertionError(f"pid {os.getpid()} not among holders {load['holder_pids']}")
    pod_rise = (load["pod_memory_bytes"].get(SMOKE_POD, 0.0)
                - idle["pod_memory_bytes"].get(SMOKE_POD, 0.0))
    if pod_rise < FILL_BYTES:
        raise AssertionError(f"gpu_pod_memory_used_bytes{{pod={SMOKE_POD}}} rose {pod_rise} B")
    if not any(key.endswith("/" + SMOKE_POD) for key in load["legacy_pod_memory_bytes"]):
        raise AssertionError(f"no pod_gpu_memory_usage for {SMOKE_POD}: "
                             f"{load['legacy_pod_memory_bytes']}")
    if tm.tanh_matmul.launches <= 0:
        raise AssertionError("no tanh_matmul launch during the nvml load phase")
    check_all_wgmma(tm, "nvml closed loop", tm.tanh_matmul.launches)

    auto = build_backend(ExporterConfig(backend="auto"))
    auto_chips = auto.sample().chips if auto.name == "nvml" else ()
    auto.close()
    if len(auto_chips) < 1:
        raise AssertionError(f"--backend auto built {auto.name} with {len(auto_chips)} chips")

    backend = NvmlBackend()
    idle_sample = backend.sample().chips
    idle_ms = sample_ms(backend)
    stim = hwcheck.TorchStimulus(hbm_bytes=FILL_BYTES, width=WIDTH, depth=DEPTH,
                                 batch=BATCH, iters=ITERS, device=dev)
    stim.start()
    try:
        time.sleep(2.0)
        burn_ms = sample_ms(backend)
        (chip,) = [c for c in backend.sample().chips if c.info.device_ids[0] == torch_uuid]
        allocated, reserved = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
    finally:
        stim.stop()
        backend.close()
    (idle_chip,) = [c for c in idle_sample if c.info.device_ids[0] == torch_uuid]
    emit("nvml_numbers", sample_ms_idle=idle_ms, sample_ms_burn=burn_ms,
         poll_phase_last_ms={phase: report["phases"][phase]["poll_phase_last_ms"]
                             for phase in ("idle", "load")},
         poll_phase_mean_ms=report["phases"]["release"]["poll_phase_mean_ms"],
         nvml_used_bytes=chip.hbm_used_bytes, allocator_allocated_bytes=allocated,
         allocator_reserved_bytes=reserved,
         nvml_minus_reserved_bytes=chip.hbm_used_bytes - reserved,
         utilization_idle=idle_chip.tensorcore_duty_cycle_percent,
         utilization_burn=chip.tensorcore_duty_cycle_percent,
         process_rows_burn={str(p.pid): p.used_bytes for p in chip.processes},
         auto=auto.name, auto_chips=len(auto_chips), device_path=chip.info.device_path)
    return by_kernel


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(url: str, timeout: float = 5.0) -> tuple[int, bytes]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def wait_for(predicate, timeout_s: float, what: str, interval_s: float = 0.05,
             phase: str = "node state"):
    """Poll ``predicate`` until it returns a true value; raise naming
    ``phase`` and ``what`` when ``timeout_s`` passes first."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            got = predicate()
        except OSError:  # the exporter is not listening yet
            got = None
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"{phase}: {what} within {timeout_s:g} s")
        time.sleep(interval_s)


def samples_of(body: bytes, name: str) -> list:
    from tpu_pod_exporter_torch.metrics.parse import parse_exposition

    return [s for s in parse_exposition(body.decode()) if s.name == name]


def phase_buckets(body: bytes) -> dict:
    """{phase: {le: cumulative count}} of the exporter's poll-phase histogram."""
    out: dict = {}
    for s in samples_of(body, "tpu_exporter_poll_phase_duration_seconds_bucket"):
        out.setdefault(s.labels["phase"], {})[float(s.labels["le"])] = s.value
    return out


def bucket_quantile(q: float, buckets: dict) -> float | None:
    """Prometheus' histogram_quantile: linear inside the bucket that holds
    rank q of the count; the highest finite bound past the last one."""
    total = buckets.get(math.inf, 0.0)
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_count = 0.0, 0.0
    for le in sorted(buckets):
        count = buckets[le]
        if count >= rank:
            if le == math.inf:
                return prev_le
            return prev_le + (le - prev_le) * (rank - prev_count) / (count - prev_count)
        prev_le, prev_count = le, count
    return prev_le


def host_ms_in_turns(fns: dict, reps: int = 20) -> dict:
    """Median host ms a call of each function, called in turns."""
    times: dict = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def render_parity(body: bytes) -> tuple[int, dict]:
    """The served sample lines, rendered again natively through
    ``render_layout`` and in Python through ``format_value``: all three must
    be the same bytes. Returns the number of lines and each render's
    median host ms."""
    from array import array

    from tpu_pod_exporter_torch.metrics import native
    from tpu_pod_exporter_torch.metrics.registry import FamilyLayout, format_value

    lines = [ln + b"\n" for ln in body.splitlines() if ln and not ln.startswith(b"#")]
    prefixes, texts = zip(*(ln[:-1].rsplit(b" ", 1) for ln in lines))
    values = array("d", map(float, texts))
    layout = FamilyLayout(tuple((str(i),) for i in range(len(lines))), list(prefixes))

    def python_render() -> bytes:
        return b"".join(p + b" " + format_value(v).encode() + b"\n"
                        for p, v in zip(prefixes, values))

    native_bytes = native.render_layout(layout, values)
    served = b"".join(lines)
    if native_bytes is None or not native_bytes == python_render() == served:
        raise AssertionError("node state: the native render, the Python render and the "
                             "served exposition differ")
    return len(lines), host_ms_in_turns({"native": lambda: native.render_layout(layout, values),
                                         "python": python_render}, reps=200)


class _Counted:
    """Counts a bound method's calls and its non-None results."""

    def __init__(self, fn):
        self.fn, self.calls, self.results = fn, 0, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        out = self.fn(*args, **kwargs)
        self.results += out is not None
        return out


def poll_phase_segments(app, base: str, nativelib) -> dict:
    """The live exporter under the burn, in alternating segments of equal
    length with the native library on and off (``nativelib.load`` answering
    None makes every caller take its Python path, as on a node without the
    library). Returns per mode the poll-phase p50/p99 from the exporter's
    own histogram (bucket counts added over the mode's segments; the first
    poll is before every segment), polls, full walks by path."""
    scanner = app.process_scanner
    native_walk = scanner._native_full_scan = _Counted(scanner._native_full_scan)
    python_walk = scanner._python_full_scan = _Counted(scanner._python_full_scan)
    load = nativelib.load
    sums = {mode: {} for mode in ("native", "python")}
    walks = {mode: {"native": 0, "python": 0, "full_scans": 0} for mode in sums}
    try:
        for mode in NODE_STATE_MODES:
            nativelib.load = load if mode == "native" else (lambda: None)
            time.sleep(2 * NODE_STATE_INTERVAL_S)  # the poll in flight ends
            before = phase_buckets(http_get(base + "/metrics")[1])
            counts = (native_walk.results, python_walk.calls, scanner.full_scans)
            time.sleep(NODE_STATE_SEGMENT_S)
            after = phase_buckets(http_get(base + "/metrics")[1])
            walks[mode]["native"] += native_walk.results - counts[0]
            walks[mode]["python"] += python_walk.calls - counts[1]
            walks[mode]["full_scans"] += scanner.full_scans - counts[2]
            for phase in POLL_PHASES:
                acc = sums[mode].setdefault(phase, {})
                for le, n in after[phase].items():
                    acc[le] = acc.get(le, 0.0) + n - before.get(phase, {}).get(le, 0.0)
    finally:
        nativelib.load = load
    out = {}
    for mode, by_phase in sums.items():
        out[mode] = {"polls": by_phase["total"][math.inf], **walks[mode]}
        for phase, buckets in by_phase.items():
            out[mode][phase] = {f"p{round(q * 100)}_ms": 1e3 * bucket_quantile(q, buckets)
                                for q in (0.5, 0.99)}
    if walks["native"]["python"] or not walks["native"]["native"]:
        raise AssertionError(f"node state: the native segments walked /proc {walks['native']}")
    if walks["python"]["native"] or not walks["python"]["python"]:
        raise AssertionError(f"node state: the Python segments walked /proc {walks['python']}")
    return out


def ledger_receiver():
    """A ChaosReceiver with no fault rules whose ledger also keeps each
    acked sample's value by (labels, timestamp ms): the ledger the egress
    demo reads, plus the values to hold against the exporter's history."""
    from tpu_pod_exporter_torch.chaos import ChaosReceiver
    from tpu_pod_exporter_torch.egress import parse_write_request, snappy_decompress

    class LedgerReceiver(ChaosReceiver):
        def __init__(self) -> None:
            super().__init__([])
            self.values: dict = {}

        def _accept(self, h, body: bytes) -> None:
            before = self.stats()["requests"]
            super()._accept(h, body)
            if self.stats()["requests"] > before:  # acked and in the ledger
                for labels, samples in parse_write_request(snappy_decompress(body)):
                    for value, ts_ms in samples:
                        self.values[(tuple(sorted(labels.items())), ts_ms)] = value

    return LedgerReceiver()


def phase_node_state(dev, tm, hwcheck, uuid: str, libtpumon: Path) -> dict:
    """Phase 13 under the full-size load held by this process: the native
    path taken and equal to the Python one; history continuous across a
    SIGKILL; egress with no loss and no acked re-send; recovery after three
    injected NVML errors. Returns the launches by kernel of its load."""
    import signal
    import tempfile

    from tpu_pod_exporter_torch import nativelib
    from tpu_pod_exporter_torch.app import ExporterApp
    from tpu_pod_exporter_torch.backend.torchdev import nvml_minors
    from tpu_pod_exporter_torch.config import ExporterConfig
    from tpu_pod_exporter_torch.procscan import GPU_DEVICE_PREFIXES, ProcScanner

    t_phase = time.monotonic()
    nativelib.reset_for_tests()
    lib = nativelib.load()
    loaded = None if lib is None else Path(lib._name)
    if loaded != libtpumon:
        raise AssertionError(f"node state: nativelib.load() gave {loaded}, not {libtpumon}")
    node = f"/dev/nvidia{nvml_minors()[uuid]}"

    reset_counts(tm)
    stim = hwcheck.TorchStimulus(hbm_bytes=FILL_BYTES, width=WIDTH, depth=DEPTH,
                                 batch=BATCH, iters=ITERS, device=dev)
    procs: list = []
    recv = ledger_receiver()
    tmp = tempfile.TemporaryDirectory()
    stim.start()
    try:
        kubelet = kubelet_fixture(tmp.name, uuid)

        # (a) native: the walks over this machine's /proc, then the live
        # exporter's exposition and its poll phases by path.
        scanner = ProcScanner(device_prefixes=GPU_DEVICE_PREFIXES)
        walk_native, walk_python = scanner._native_full_scan(), scanner._python_full_scan()
        mine = walk_native.get(os.getpid(), ()) if walk_native is not None else ()
        if walk_native is None or walk_native != walk_python:
            raise AssertionError(f"node state: /proc walks differ: native {walk_native}, "
                                 f"Python {walk_python}")
        if [h.device_path for h in mine] != [node]:
            raise AssertionError(f"node state: this process holds {mine}, not {node} alone")
        walk_ms = host_ms_in_turns({"native": scanner._native_full_scan,
                                    "python": scanner._python_full_scan})
        app = ExporterApp(ExporterConfig(port=0, host="127.0.0.1", backend="nvml",
                                         process_metrics=True,
                                         interval_s=NODE_STATE_INTERVAL_S, **kubelet))
        app.start()
        try:
            base = f"http://127.0.0.1:{app.port}"
            body = http_get(base + "/metrics")[1]
            lines, render_ms = render_parity(body)
            segments = poll_phase_segments(app, base, nativelib)
        finally:
            app.stop()
        emit("node_state_native", library=str(loaded.relative_to(REPO)), node=node,
             holders={str(pid): [h.device_path for h in hs] for pid, hs in walk_native.items()},
             proc_entries=sum(e.isdigit() for e in os.listdir("/proc")),
             full_walk_ms=walk_ms, render_lines=lines, render_ms=render_ms,
             segment_s=NODE_STATE_SEGMENT_S, interval_s=NODE_STATE_INTERVAL_S,
             modes=list(NODE_STATE_MODES), poll_phase_ms=segments)

        # (b) and (c): a subprocess exporter on a state dir and egress,
        # SIGKILLed mid-poll by chaos, then restarted on the same dirs.
        recv.start()
        port = free_port()
        url = f"http://127.0.0.1:{port}"
        state_dir, egress_dir = Path(tmp.name, "state"), Path(tmp.name, "egress")
        log_path = Path(tmp.name, "exporter.log")
        args = [sys.executable, "-m", "tpu_pod_exporter_torch", "--host", "127.0.0.1",
                "--port", str(port), "--interval-s", str(NODE_STATE_RUN_INTERVAL_S),
                "--log-level", "warning", "--backend", "nvml", "--process-metrics",
                "--attribution", "checkpoint", "--checkpoint-path", kubelet["checkpoint_path"],
                "--uid-map-file", kubelet["uid_map_file"], "--state-dir", str(state_dir),
                "--state-fsync-interval-s", "0", "--egress-url", recv.url,
                "--egress-dir", str(egress_dir), "--egress-interval-s", "0"]

        def start(spec: str):
            log = open(log_path, "ab")
            procs.append(subprocess.Popen(args + ["--chaos-spec", spec], cwd=REPO,
                                          stdout=log, stderr=subprocess.STDOUT))
            log.close()
            return procs[-1]

        def ready():
            status, body = http_get(url + "/readyz")
            return status == 200 and json.loads(body).get("ready") is True

        def used() -> float | None:
            rows = samples_of(http_get(url + "/metrics")[1], "gpu_hbm_used_bytes")
            return rows[0].value if len(rows) == 1 else None

        t_start = time.time()
        first = start(f"kill:device:1:@{NODE_STATE_KILL_AT}:x1")
        wait_for(ready, 30, "the first run ready")
        used_before = wait_for(used, 10, "gpu_hbm_used_bytes in the first run")
        first.wait(timeout=60)
        t_killed = time.time()
        if first.returncode != -signal.SIGKILL:
            raise AssertionError(f"node state: the first run exited {first.returncode}, "
                                 "not by SIGKILL\n" + log_path.read_text()[-2000:])

        # (d) in the second run: three NVML errors on the device source.
        second = start(f"err:device:1:nvml=gpu_is_lost:@{NODE_STATE_ERRORS_AT}:x3")
        wait_for(ready, 30, "the restarted run ready")
        t_ready = time.time()
        restore = json.loads(http_get(url + "/debug/vars")[1]).get("persist", {}).get("restore")
        history = json.loads(http_get(
            url + f"/api/v1/query_range?metric=gpu_hbm_used_bytes"
                  f"&start={t_start - 5:.3f}&end={time.time() + 1:.3f}")[1])["data"]["result"]
        points = [(t, v) for row in history for t, v in row["values"]]
        before_kill = [v for t, v in points if t <= t_killed]
        if not (len(history) == 1 and before_kill and max(before_kill) >= FILL_BYTES):
            raise AssertionError(f"node state: the history across the kill: {len(history)} "
                                 f"series, pre-kill values {before_kill[-5:]}")

        def injected():
            doc = json.loads(http_get(url + "/debug/vars")[1])
            return len(doc.get("chaos", {}).get("device", {}).get("injected", [])) == 3

        wait_for(injected, 30, "three injected NVML errors")
        t_errors = time.time()

        def device_errors() -> list:
            return [s.value for s in samples_of(http_get(url + "/metrics")[1],
                                                "tpu_exporter_poll_errors_total")
                    if s.labels.get("source") == "device_read"]

        wait_for(lambda: sum(device_errors()) >= 3, 10, "three device errors counted")
        errors = device_errors()
        wait_for(lambda: (used() or 0.0) >= FILL_BYTES and samples_of(
            http_get(url + "/metrics")[1], "tpu_exporter_up")[0].value == 1.0,
            30, "the card's used memory after the errors")
        t_recovered = time.time()
        used_after = used()
        breaker = json.loads(http_get(url + "/debug/vars")[1])["supervisors"]["device"]
        wait_for(lambda: samples_of(http_get(url + "/metrics")[1],
                                    "tpu_exporter_egress_backlog_batches")[0].value == 0.0,
                 30, "the egress backlog drained")
        history = json.loads(http_get(
            url + f"/api/v1/query_range?metric=gpu_hbm_used_bytes"
                  f"&start={t_start - 5:.3f}&end={time.time() + 1:.3f}")[1])["data"]["result"]
        second.send_signal(signal.SIGTERM)
        second.wait(timeout=30)
        seen = {int(t * 1000): v for row in history for t, v in row["values"]}
        shipped = {ts: v for (labels, ts), v in recv.values.items()
                   if dict(labels).get("__name__") == "gpu_hbm_used_bytes"}
        matched = [ts for ts in shipped if ts in seen]
        stats = recv.stats()
        seqs = stats["accepted_seqs"]
        missing = sorted(set(range(min(seqs), max(seqs) + 1)) - set(seqs)) if seqs else None
        ledger = {"batches": len(seqs), "seq_first": min(seqs, default=None),
                  "seq_last": max(seqs, default=None), "missing_seqs": missing,
                  "duplicate_seqs": stats["duplicate_seqs"],
                  "duplicate_samples": stats["duplicate_samples"],
                  "accepted_samples": stats["accepted_samples"],
                  "gpu_hbm_used_bytes_samples": len(shipped),
                  "matched_in_history": len(matched),
                  "shipped_before_kill": sum(ts <= t_killed * 1000 for ts in shipped)}
        emit("node_state_restart", used_before_kill=used_before, kill_at_call=NODE_STATE_KILL_AT,
             killed_after_s=t_killed - t_start, restart_ready_after_s=t_ready - t_killed,
             restore=restore, history_points=len(points), before_kill_points=len(before_kill),
             before_kill_max=max(before_kill), second_rc=second.returncode)
        emit("node_state_egress", ledger=ledger)
        emit("node_state_chaos", spec=f"err:device:1:nvml=gpu_is_lost:@{NODE_STATE_ERRORS_AT}:x3",
             device_errors=errors, recovered_after_s=t_recovered - t_errors,
             used_after=used_after, breaker_transitions=breaker["transitions"],
             reconnects=breaker["reconnects"])
        if missing or stats["duplicate_seqs"] or stats["duplicate_samples"]:
            raise AssertionError(f"node state: egress lost or re-sent batches: {ledger}")
        if not ledger["shipped_before_kill"] or not matched or any(
                shipped[ts] != seen[ts] for ts in matched):
            raise AssertionError(f"node state: the ledger's gpu_hbm_used_bytes against the "
                                 f"exporter's history: {ledger}")
        if max(shipped.values()) < FILL_BYTES:
            raise AssertionError("node state: no shipped sample at the filled level")
        if errors != [3.0]:
            raise AssertionError(f"node state: device errors counted {errors}, not [3]")
        if second.returncode != 0:
            raise AssertionError(f"node state: the restarted run exited {second.returncode}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        recv.stop()
        stim.stop()
        tmp.cleanup()
    launches = tm.tanh_matmul.launches
    by_kernel = dict(tm.tanh_matmul.launches_by_kernel)
    emit("node_state", seconds=time.monotonic() - t_phase, burn_steps=stim.steps,
         launches_by_kernel=by_kernel)
    if launches <= 0:
        raise AssertionError("no tanh_matmul launch during the node state phase")
    check_all_wgmma(tm, "node state", launches)
    return by_kernel


class WebhookReceiver:
    """An in-process alert webhook: keeps each POST's receipt time,
    ``X-Tpe-Alert-Seq`` header and JSON body, and answers 200."""

    def __init__(self) -> None:
        import http.server
        import threading

        received = self.received = []
        lock = self.lock = threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self) -> None:  # noqa: N802 — http.server's casing
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                with lock:
                    received.append({"wall": time.time(),
                                     "seq": self.headers.get("X-Tpe-Alert-Seq"),
                                     "body": json.loads(body or b"{}")})
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args) -> None:
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/alerts"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def start(self) -> None:
        self.thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()

    def posts(self) -> list:
        with self.lock:
            return list(self.received)


class SseReader:
    """The port's stream client read on a thread: each frame with its
    receipt time. ``stop`` ends the read and closes the stream."""

    def __init__(self, port: int, metric: str, window_s: float) -> None:
        import threading

        from tpu_pod_exporter_torch.stream import QueryShape, StreamClient

        self.frames: list = []
        self.client = StreamClient("127.0.0.1", port, QueryShape(
            route="window_stats", metric=metric, window_s=window_s))
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        while not self.done.is_set() and not self.client.eof:
            for frame in self.client.frames(timeout_s=0.2):
                self.frames.append((time.time(), frame))

    def stop(self) -> list:
        self.done.set()
        self.thread.join(timeout=10)
        self.client.close()
        return self.frames


def proc_usage(pid: int) -> tuple[float, float]:
    """(user + system CPU seconds, resident bytes) of a live process, from
    /proc/<pid>/stat and /proc/<pid>/status."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    cpu_s = (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    rss = 0.0
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss = float(line.split()[1]) * 1024
    return cpu_s, rss


def parsed(body: bytes) -> list:
    from tpu_pod_exporter_torch.metrics.parse import parse_exposition

    return list(parse_exposition(body.decode()))


def rollups(rows: list, prefixes=("tpu_slice_", "tpu_fleet_family_")) -> dict:
    """{(name, sorted labels): value} of the parsed samples whose name starts
    with one of ``prefixes``."""
    return {(s.name, tuple(sorted(s.labels.items()))): s.value
            for s in rows if s.name.startswith(prefixes)}


def pick(table: dict, name: str, **labels) -> float | None:
    """The one value of ``name`` in a ``rollups`` table whose labels include
    ``labels``; None when there is none."""
    hits = [v for (n, lab), v in table.items()
            if n == name and all(dict(lab).get(k) == x for k, x in labels.items())]
    if len(hits) > 1:
        raise AssertionError(f"fleet: {len(hits)} series of {name}{labels}")
    return hits[0] if hits else None


def nearest_rank_ms(values: list) -> dict:
    """p50 and p99 (nearest rank) in ms of durations in seconds."""
    ordered = sorted(values)
    return {"rounds": len(ordered), **{
        f"p{round(q * 100)}_ms": ordered[math.ceil(q * len(ordered)) - 1] * 1e3
        for q in (0.5, 0.99)}}


def fleet_node_argv(port: int, kubelet: dict) -> list:
    """The real node of phase 14: the port's exporter on the card through
    NVML, with the process scan and checkpoint attribution."""
    node, pool = FLEET_REAL_NODE
    return [sys.executable, "-m", "tpu_pod_exporter_torch", "--host", "127.0.0.1",
            "--port", str(port), "--interval-s", str(FLEET_INTERVAL_S),
            "--log-level", "warning", "--backend", "nvml", "--process-metrics",
            "--attribution", "checkpoint", "--checkpoint-path", kubelet["checkpoint_path"],
            "--uid-map-file", kubelet["uid_map_file"], "--slice-name", pool,
            "--node-name", node, "--accelerator", FLEET_ACCELERATOR]


def fleet_status_node_argv(kubelet: dict) -> list:
    """``status`` in node mode on the card, as an operator runs it there."""
    return [sys.executable, "-m", "tpu_pod_exporter_torch.status", "--backend", "nvml",
            "--process-metrics", "--attribution", "checkpoint",
            "--checkpoint-path", kubelet["checkpoint_path"],
            "--uid-map-file", kubelet["uid_map_file"], "--json"]


# Phase 14's simulated nodes in one process: the port's ExporterApp on the
# simulated NVML driver, FLEET_SIM_GPUS cards each. Prints the ports as one
# JSON line, serves until SIGTERM, then stops every app and exits 0.
SIM_NODES_CODE = """
import json, signal, sys, threading
from tpu_pod_exporter_torch.app import ExporterApp
from tpu_pod_exporter_torch.config import ExporterConfig
nodes, gpus, accelerator, interval = json.loads(sys.argv[1])
done = threading.Event()
signal.signal(signal.SIGTERM, lambda *_: done.set())
apps = []
for node, pool in nodes:
    app = ExporterApp(ExporterConfig(
        port=0, host="127.0.0.1", backend="nvml", nvml_sim_gpus=gpus,
        attribution="none", slice_name=pool, node_name=node,
        accelerator=accelerator, interval_s=interval, log_level="warning"))
    app.start()
    apps.append(app)
print(json.dumps([app.port for app in apps]), flush=True)
done.wait()
for app in apps:
    app.stop()
"""


def phase_fleet(dev, tm, hwcheck, uuid: str) -> dict:
    """Phase 14 under the full-size load held by this process: the real
    node and fifteen simulated ones, scraped by a flat aggregator and by a
    two-leaf shard tree whose root keeps a store, evaluates an alert and
    serves a stream, beside a replica; ``status`` over the tree and on the
    node. Returns the launches by kernel of its load."""
    import signal
    import tempfile

    t_phase = time.monotonic()
    node_name, pool_a = FLEET_REAL_NODE
    pool_b = next(p for p in FLEET_POOLS if p != pool_a)
    sim_nodes = [(f"node-{i:02d}", pool_a if i < FLEET_HOSTS_PER_POOL else pool_b)
                 for i in range(1, 2 * FLEET_HOSTS_PER_POOL)]
    cards = {pool_a: 1 + (FLEET_HOSTS_PER_POOL - 1) * FLEET_SIM_GPUS,
             pool_b: FLEET_HOSTS_PER_POOL * FLEET_SIM_GPUS}
    tmp = tempfile.TemporaryDirectory()
    procs: dict = {}
    logs: dict = {}

    def spawn(name: str, argv: list, stdout=None) -> subprocess.Popen:
        logs[name] = Path(tmp.name, f"{name}.log")
        with open(logs[name], "wb") as log:
            procs[name] = subprocess.Popen(argv, cwd=REPO, stdout=stdout or log, stderr=log)
        return procs[name]

    def fail(msg: str):
        tails = {name: path.read_text(errors="replace")[-1500:]
                 for name, path in logs.items() if path.exists()}
        raise AssertionError(f"fleet: {msg}\nlogs: {json.dumps(tails, indent=1)}")

    def tier(module: str, port: int, *args: str) -> list:
        return [sys.executable, "-m", f"tpu_pod_exporter_torch.{module}", "--host",
                "127.0.0.1", "--port", str(port), "--interval-s", str(FLEET_INTERVAL_S),
                "--log-level", "warning", *args]

    def metrics(port: int) -> bytes:
        status, body = http_get(f"http://127.0.0.1:{port}/metrics")
        if status != 200:
            raise OSError(f"/metrics on {port} answered {status}")
        return body

    def usage_now() -> dict:
        return {"t": time.time(),
                "procs": {name: proc_usage(proc.pid) for name, proc in procs.items()}}

    reset_counts(tm)
    stim = hwcheck.TorchStimulus(hbm_bytes=FILL_BYTES, width=WIDTH, depth=DEPTH,
                                 batch=BATCH, iters=ITERS, device=dev)
    receiver = WebhookReceiver()
    receiver.start()  # before the try: its stop() waits for a started server
    stream = None
    try:
        kubelet = kubelet_fixture(tmp.name, uuid)
        # The nodes: the real one on the card, the simulated ones in a helper.
        node_port = free_port()
        spawn("node", fleet_node_argv(node_port, kubelet))
        helper = spawn("sim_nodes", [sys.executable, "-c", SIM_NODES_CODE, json.dumps(
            [sim_nodes, FLEET_SIM_GPUS, FLEET_ACCELERATOR, FLEET_INTERVAL_S])],
            stdout=subprocess.PIPE)
        sim_ports = json.loads(helper.stdout.readline() or "null")
        if not sim_ports:
            fail("the simulated nodes did not start")
        sim_targets = {f"127.0.0.1:{port}": node for port, node in zip(sim_ports, sim_nodes)}
        node_target = f"127.0.0.1:{node_port}"
        targets = ",".join([node_target, *sim_targets])
        node_body = wait_for(lambda: metrics(node_port), 30, "the real node's /metrics",
                             phase="fleet")
        node_rows = samples_of(node_body, "gpu_hbm_used_bytes")
        held = held_card_nodes()
        if len(node_rows) != 1 or {node_rows[0].labels["device_path"]} != held:
            fail(f"the real node serves {[r.labels for r in node_rows]}; "
                 f"this process holds {sorted(held)}")
        emit("fleet_setup", real_node={"target": node_target, "node": node_name,
                                       "pool": pool_a, "backend": "nvml",
                                       "device_path": node_rows[0].labels["device_path"]},
             simulated_nodes={target: {"node": n, "pool": p, "cards": FLEET_SIM_GPUS,
                                       "backend": "nvml simulated"}
                              for target, (n, p) in sim_targets.items()},
             hosts=1 + len(sim_nodes), cards=sum(cards.values()))

        # The flat aggregator first: its idle pool level sets the alert's threshold.
        flat_port, record = free_port(), Path(tmp.name, "rounds.jsonl")
        spawn("aggregate", tier("aggregate", flat_port, "--targets", targets,
                                "--stream", "on", "--record-to", str(record)))

        def flat_full():
            table = rollups(parsed(metrics(flat_port)))
            hosts = [pick(table, "tpu_slice_hosts_reporting", family="gpu", slice_name=p)
                     for p in FLEET_POOLS]
            return table if hosts == [FLEET_HOSTS_PER_POOL] * len(FLEET_POOLS) else None

        idle_a = pick(wait_for(flat_full, 30, "the flat aggregator over every host",
                               phase="fleet"),
                      "tpu_slice_hbm_used_bytes", family="gpu", slice_name=pool_a)
        threshold = idle_a + FILL_BYTES / 2
        rules, alerts = Path(tmp.name, "store.rules"), Path(tmp.name, "alert.rules")
        rules.write_text(FLEET_STORE_RULE + "\n")
        alerts.write_text(FLEET_ALERT_RULE.format(pool=pool_a, threshold=f"{threshold:.0f}"))

        # The shard tree: two leaves, the root with store and alerting, a replica.
        leaf_ports = [free_port(), free_port()]
        for i, port in enumerate(leaf_ports):
            spawn(f"leaf{i}", tier("shard", port, "--role", "leaf", "--shard-index", str(i),
                                   "--num-shards", "2", "--targets", targets))
        leaves = ",".join(f"shard-{i}=127.0.0.1:{p}" for i, p in enumerate(leaf_ports))
        root_port, replica_port = free_port(), free_port()
        store_dir, alert_dir = Path(tmp.name, "store"), Path(tmp.name, "alerts")
        spawn("root", tier("shard", root_port, "--role", "root", "--leaves", leaves,
                           "--store-dir", str(store_dir), "--store-tiers", FLEET_STORE_TIERS,
                           "--store-rules", str(rules), "--alert-rules", str(alerts),
                           "--alert-dir", str(alert_dir),
                           "--alert-webhook-url", receiver.url))
        spawn("replica", tier("shard", replica_port, "--role", "replica", "--leaves", leaves,
                              "--root-url", f"127.0.0.1:{root_port}"))

        def root_full():
            table = rollups(parsed(metrics(root_port)))
            chips = {p: pick(table, "tpu_slice_chip_count", family="gpu", slice_name=p)
                     for p in FLEET_POOLS}
            return table if chips == cards else None

        wait_for(root_full, 30, "the root over both leaves", phase="fleet")
        wait_for(lambda: rollups(parsed(metrics(replica_port))), 30, "the replica's rollups",
                 phase="fleet")
        stream = SseReader(root_port, *FLEET_STREAM)

        # Each observation scrapes the flat aggregator, the root and the
        # replica, and keeps each tier's round duration by round timestamp.
        seen: dict = {"idle": [], "load": [], "release": []}
        rounds: dict = {"flat": {}, "root": {}}
        alert_states: list = []

        def observe(stage: str) -> dict:
            now = time.time()
            flat_rows, root_rows = parsed(metrics(flat_port)), parsed(metrics(root_port))
            obs = {"t": now, "flat": rollups(flat_rows), "root": rollups(root_rows),
                   "replica": rollups(parsed(metrics(replica_port)),
                                      ("tpu_slice_", "tpu_fleet_family_", "tpu_replica_info")),
                   "workload": {(s.labels.get("pod"), s.labels.get("slice_name")): s.value
                                for s in flat_rows if s.name == "tpu_workload_hbm_used_bytes"},
                   "leaf_up": {s.labels["leaf"]: s.value
                               for s in root_rows if s.name == "tpu_root_leaf_up"},
                   "tpu_family": sorted({s.name for s in flat_rows + root_rows
                                         if s.labels.get("family") == "tpu"})}
            for who, rows, prefix in (("flat", flat_rows, "tpu_aggregator"),
                                      ("root", root_rows, "tpu_root")):
                one = {s.name: s.value for s in rows if s.name in (
                    f"{prefix}_last_round_timestamp_seconds", f"{prefix}_round_duration_seconds")}
                if len(one) == 2:
                    rounds[who][one[f"{prefix}_last_round_timestamp_seconds"]] = \
                        one[f"{prefix}_round_duration_seconds"]
            gauges = {s.name: s.value for s in root_rows
                      if s.name in ("tpu_root_alerts_firing", "tpu_root_alerts_pending")}
            obs["alert"] = ("firing" if gauges.get("tpu_root_alerts_firing") else
                            "pending" if gauges.get("tpu_root_alerts_pending") else "inactive")
            if not alert_states or alert_states[-1][1] != obs["alert"]:
                alert_states.append((now, obs["alert"]))
            seen[stage].append(obs)
            return obs

        # 1. At least FLEET_IDLE_ROUNDS idle rounds of the root over the whole fleet.
        t0 = time.time()
        usage = {"idle": usage_now()}
        first_round = max(rounds["root"], default=0.0)
        while True:
            observe("idle")
            if sum(t > first_round for t in rounds["root"]) >= FLEET_IDLE_ROUNDS + 1:
                break
            if time.time() - t0 > 30:
                fail(f"{len(rounds['root'])} root rounds in 30 s")
            time.sleep(FLEET_OBSERVE_S)

        # 2. The fill and the burn: at least FLEET_LOAD_S, until the alert fired.
        usage["fill"] = usage_now()
        t_fill = time.time()
        stim.start()
        status_tree = status_node = None
        while True:
            obs = observe("load")
            if obs["alert"] == "firing" and status_tree is None:
                status_tree = subprocess.run(
                    [sys.executable, "-m", "tpu_pod_exporter_torch.status", "--tree",
                     f"127.0.0.1:{root_port}", "--store-dir", str(store_dir),
                     "--alert-dir", str(alert_dir), "--json"],
                    cwd=REPO, capture_output=True, text=True, timeout=60)
                status_node = subprocess.run(fleet_status_node_argv(kubelet), cwd=REPO,
                                             capture_output=True, text=True, timeout=60)
            if status_tree is not None and time.time() - t_fill >= FLEET_LOAD_S:
                break
            if time.time() - t_fill > FLEET_LOAD_S + 30:
                fail(f"the alert did not fire under the fill: {alert_states}")
            time.sleep(FLEET_OBSERVE_S)

        # 3. Release; idle for at least FLEET_RELEASE_S, until the alert resolved.
        usage["release"] = usage_now()
        t_release = time.time()
        stim.stop()
        while True:
            obs = observe("release")
            released = pick(obs["flat"], "tpu_slice_hbm_used_bytes", family="gpu",
                            slice_name=pool_a)
            if (time.time() - t_release >= FLEET_RELEASE_S and obs["alert"] == "inactive"
                    and released is not None and released < threshold):
                break
            if time.time() - t_release > FLEET_RELEASE_S + 30:
                fail(f"no release in 30 s: pool a at {released}, alert {alert_states}")
            time.sleep(FLEET_OBSERVE_S)
        t_end = time.time()
        # The node exporter's own poll phases, with the burn in another
        # process (phase 13 ran the exporter beside the burn thread).
        buckets = phase_buckets(metrics(node_port))
        node_poll = {phase: {f"p{round(q * 100)}_ms": 1e3 * bucket_quantile(q, buckets[phase])
                             for q in (0.5, 0.99)}
                     for phase in POLL_PHASES if phase in buckets}
        node_poll["polls"] = buckets.get("total", {}).get(math.inf)
        root = f"http://127.0.0.1:{root_port}"
        store_answer = json.loads(http_get(
            f"{root}/api/v1/query_range?metric={FLEET_STORE_METRIC}&source=store"
            f"&start={t0 - 5:.3f}&end={t_end + 1:.3f}")[1])
        node_history = json.loads(http_get(
            f"http://127.0.0.1:{node_port}/api/v1/query_range?metric=gpu_hbm_used_bytes"
            f"&start={t0 - 5:.3f}&end={t_end + 1:.3f}")[1])["data"]["result"]
        readyz = json.loads(http_get(f"{root}/readyz")[1])
        transitions = {s.labels.get("to"): s.value
                       for s in samples_of(metrics(root_port), "tpu_root_alert_transitions_total")}
        wait_for(lambda: len(receiver.posts()) >= 2, 10, "the resolved notification", phase="fleet")
        frames = stream.stop()
        stream = None

        # Every tier drains on SIGTERM and exits 0; then the nodes.
        exits = {}
        for name in ("replica", "root", "leaf0", "leaf1", "aggregate", "node", "sim_nodes"):
            procs[name].send_signal(signal.SIGTERM)
            try:
                exits[name] = procs[name].wait(timeout=30)
            except subprocess.TimeoutExpired:
                exits[name] = None
        posts = receiver.posts()

        # ------------------------------------------------------------ checks
        # 1. The flat aggregator.
        def levels(stage: str, who: str = "flat") -> list:
            return [v for v in (pick(o[who], "tpu_slice_hbm_used_bytes", family="gpu",
                                     slice_name=pool_a) for o in seen[stage]) if v is not None]

        idle_level, load_level = levels("idle")[-1], max(levels("load"))
        released_level = levels("release")[-1]
        # The node's reading in the round whose pool-a sum the aggregator
        # published, from the aggregator's own round record.
        pool_a_targets = [node_target] + [t for t, (_, p) in sim_targets.items() if p == pool_a]
        node_by_sum: dict = {}
        for line in record.read_text().splitlines():
            bodies = json.loads(line)["bodies"]
            if any(bodies.get(t) is None for t in pool_a_targets):
                continue
            used = {t: sum(s.value for s in samples_of(bodies[t].encode(), "gpu_hbm_used_bytes"))
                    for t in pool_a_targets}
            node_by_sum.setdefault(sum(used.values()), set()).add(used[node_target])
        node_at = {level: sorted(node_by_sum.get(level, ())) for level in (idle_level, load_level)}
        if any(len(v) != 1 for v in node_at.values()):
            fail(f"pool a's published levels and the node's in the round record: {node_at}")
        last = seen["load"][-1]
        flat = {"idle": idle_level, "load_max": load_level, "released": released_level,
                "rise": load_level - idle_level, "fall": load_level - released_level,
                "node_rise_same_round": node_at[load_level][0] - node_at[idle_level][0],
                "recorded_rounds": len(record.read_text().splitlines()),
                "chips": {p: pick(last["flat"], "tpu_slice_chip_count", family="gpu",
                                  slice_name=p) for p in FLEET_POOLS},
                "hosts": {p: pick(last["flat"], "tpu_slice_hosts_reporting", family="gpu",
                                  slice_name=p) for p in FLEET_POOLS}}
        if flat["rise"] < FILL_BYTES or flat["fall"] < FILL_BYTES:
            fail(f"pool a's slice HBM did not rise and fall by the fill: {flat}")
        if flat["rise"] != flat["node_rise_same_round"]:
            fail(f"pool a rose {flat['rise']} B, the node {flat['node_rise_same_round']} B")
        if flat["chips"] != cards or set(flat["hosts"].values()) != {FLEET_HOSTS_PER_POOL}:
            fail(f"slice chips {flat['chips']}, hosts {flat['hosts']}")
        for obs in seen["idle"] + seen["load"] + seen["release"]:
            for field in ("chip_count", "hbm_used_bytes", "hbm_total_bytes", "hosts_reporting"):
                total = pick(obs["flat"], f"tpu_fleet_family_{field}", family="gpu")
                pools = [pick(obs["flat"], f"tpu_slice_{field}", family="gpu", slice_name=p)
                         for p in FLEET_POOLS]
                if None in pools or total != sum(pools):
                    fail(f"tpu_fleet_family_{field} {total}, the pools {pools}")
            if obs["tpu_family"]:
                fail(f"family=\"tpu\" series at a tier: {obs['tpu_family']}")
        pod = [o["workload"].get((SMOKE_POD, pool_a)) for o in seen["idle"] + seen["load"]]
        flat["pod_rise"] = max(v or 0.0 for v in pod) - (pod[len(seen["idle"]) - 1] or 0.0)
        if flat["pod_rise"] < FILL_BYTES:
            fail(f"tpu_workload_hbm_used_bytes{{pod={SMOKE_POD}}} rose {flat['pod_rise']} B")

        # 2. The shard tree: observations where both tiers folded one reading.
        every = seen["idle"] + seen["load"] + seen["release"]
        equal = {stage: sum(o["flat"] == o["root"] for o in seen[stage]) for stage in seen}
        filled_equal = sum(o["flat"] == o["root"] and (pick(
            o["root"], "tpu_slice_hbm_used_bytes", family="gpu", slice_name=pool_a)
            or 0.0) >= idle_level + FILL_BYTES for o in seen["load"])
        tree = {"observations": {stage: len(v) for stage, v in seen.items()},
                "equal": equal, "filled_equal": filled_equal, "leaf_up": last["leaf_up"],
                "replica_equal": sum({k: v for k, v in o["replica"].items()
                                      if k[0] != "tpu_replica_info"} == o["root"] for o in every),
                "replica_info": [dict(k[1]) for k in last["replica"]
                                 if k[0] == "tpu_replica_info"]}
        if not equal["idle"] or not filled_equal:
            fail(f"the root's rollups never equal the flat aggregator's: {tree}")
        if sorted(last["leaf_up"].values()) != [1.0, 1.0]:
            fail(f"tpu_root_leaf_up {last['leaf_up']}")
        if not tree["replica_equal"] or not tree["replica_info"]:
            fail(f"the replica does not serve the root's rollups: {tree}")

        # 3. The stream: a snapshot, then deltas with consecutive seqs.
        data = [(t, f) for t, f in frames if f["type"] != "heartbeat"]
        seqs = [f.get("seq") for _, f in data]

        def filled_row(row) -> bool:
            return (row["labels"].get("slice_name") == pool_a
                    and row["labels"].get("family") == "gpu"
                    and (row.get("stats") or {}).get("last", 0.0) >= idle_level + FILL_BYTES)

        filled = [t for t, f in data if f["type"] == "delta" and any(map(filled_row, f["changed"]))]
        node_idle = node_at[idle_level][0]
        node_points = [(t, v) for row in node_history for t, v in row["values"]]
        first_filled_poll = min((t for t, v in node_points if v >= node_idle + FILL_BYTES),
                                default=None)
        stream_check = {"frames": len(frames), "types": sorted({f["type"] for _, f in frames}),
                        "first": data[0][1]["type"] if data else None, "seq_first": seqs[:1],
                        "seq_last": seqs[-1:], "filled_deltas": len(filled),
                        "delta_lag_s": (filled[0] - first_filled_poll
                                        if filled and first_filled_poll else None)}
        if (not data or data[0][1]["type"] != "snapshot"
                or any(f["type"] != "delta" for _, f in data[1:])
                or seqs != list(range(seqs[0], seqs[0] + len(seqs)))):
            fail(f"the stream's frames {stream_check}, seqs {seqs}")
        if not filled or first_filled_poll is None:
            fail(f"no delta carried pool a's filled level: {stream_check}")

        # 4. The store: the idle, filled and released levels of pool a, in order.
        rows = [r for r in store_answer.get("data", {}).get("result", ())
                if r["labels"].get("slice_name") == pool_a]
        values = [v for r in rows for _, v in r["values"]]
        marks = [i for i, v in enumerate(values) if v >= idle_level + FILL_BYTES]
        store = {"status": store_answer.get("status"), "source": store_answer.get("source"),
                 "points": len(values), "filled_points": len(marks),
                 "levels": sorted(set(values))}
        if not (marks and any(v < threshold for v in values[:marks[0]])
                and any(v < threshold for v in values[marks[-1]:])):
            fail(f"the store's {FLEET_STORE_METRIC} for {pool_a}: {store}")

        # 5. Alerting: pending, firing, resolved; contiguous webhook seqs.
        states = [s for _, s in alert_states]
        firing_post = next((p for p in posts if p["body"].get("state") == "firing"), None)
        alerting = {"states": states, "transitions": transitions,
                    "posts": [(p["seq"], p["body"].get("state")) for p in posts],
                    "readyz": readyz.get("alerting"),
                    "firing_after_fill_s": (firing_post["body"]["wall"] - t_fill
                                            if firing_post else None),
                    "webhook_after_fill_s": firing_post["wall"] - t_fill if firing_post else None}
        if "pending" not in states or states[states.index("pending"):] != [
                "pending", "firing", "inactive"]:
            fail(f"the alert's states {alerting}")
        if [(p["seq"], p["body"].get("state"), p["body"].get("alert")) for p in posts] != [
                ("1", "firing", FLEET_ALERT), ("2", "resolved", FLEET_ALERT)]:
            fail(f"the webhook's notifications {alerting}")
        if (transitions.get("firing"), transitions.get("resolved")) != (1.0, 1.0) \
                or not transitions.get("pending"):
            fail(f"the root's transition counts {alerting}")
        if (readyz.get("alerting") or {}).get("status") != "ok":
            fail(f"the root's /readyz alerting {alerting}")

        # 6. status over the tree while the alert fired, and on the node.
        tree_doc = json.loads(status_tree.stdout) if status_tree.returncode == 0 else {}
        node_doc = json.loads(status_node.stdout) if status_node.returncode == 0 else {}
        card = [c for c in node_doc.get("chips", ()) if c["device_path"] in held]
        status = {"tree_rc": status_tree.returncode, "node_rc": status_node.returncode,
                  "tree_family_chips": tree_doc.get("fleet", {}).get("family_chips"),
                  "tree_alerts": {k: tree_doc.get("alerts", {}).get(k)
                                  for k in ("rules", "firing", "pending")},
                  "node_chips": [{k: c.get(k) for k in ("device_path", "device_kind",
                                                         "hbm_used_bytes", "pod", "holders")}
                                 for c in node_doc.get("chips", ())]}
        if status_tree.returncode != 0 or status_node.returncode != 0:
            fail(f"status: {status}\n{status_tree.stderr[-1500:]}\n{status_node.stderr[-1500:]}")
        if status["tree_family_chips"] != {"gpu": float(sum(cards.values()))} \
                or status["tree_alerts"]["firing"] != 1:
            fail(f"status --tree {status}")
        if (len(card) != 1 or card[0]["hbm_used_bytes"] < FILL_BYTES
                or os.getpid() not in [h["pid"] for h in card[0]["holders"]]):
            fail(f"status on the node {status}")

        # Every tier and both node processes drained: exit 0.
        if any(rc != 0 for rc in exits.values()):
            fail(f"exit codes on SIGTERM {exits}")
    finally:
        for proc in procs.values():  # first: nothing below may leave them running
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        if stream is not None:
            stream.stop()
        receiver.stop()
        stim.stop()
        tmp.cleanup()

    def cpu_and_rss(since: str, until: str) -> dict:
        a, b = usage[since], usage[until]
        return {name: {"cpu_s_per_s": (cpu - a["procs"][name][0]) / (b["t"] - a["t"]),
                       "rss_bytes": rss} for name, (cpu, rss) in b["procs"].items()}

    emit("fleet_rounds", flat=nearest_rank_ms(list(rounds["flat"].values())),
         root=nearest_rank_ms(list(rounds["root"].values())))
    emit("fleet_stream", **stream_check)
    emit("fleet_alert", **alerting)
    emit("fleet_processes", idle=cpu_and_rss("idle", "fill"), load=cpu_and_rss("fill", "release"),
         clock_ticks_per_s=os.sysconf("SC_CLK_TCK"), node_poll_phase_ms=node_poll)
    launches = tm.tanh_matmul.launches
    by_kernel = dict(tm.tanh_matmul.launches_by_kernel)
    emit("fleet", seconds=time.monotonic() - t_phase, burn_steps=stim.steps,
         launches_by_kernel=by_kernel, flat=flat, tree=tree, store=store, status=status,
         exits=exits, threshold=threshold, simulated_hosts=len(sim_nodes))
    if launches <= 0:
        raise AssertionError("no tanh_matmul launch during the fleet phase")
    check_all_wgmma(tm, "fleet", launches)
    return by_kernel


def main() -> int:
    from tpu_pod_exporter_torch import hwcheck, nativelib
    from tpu_pod_exporter_torch.kernels import online_softmax as osm
    from tpu_pod_exporter_torch.kernels import sgd
    from tpu_pod_exporter_torch.kernels import tanh_matmul as tm
    from tpu_pod_exporter_torch.loadgen import parallel as par
    from tpu_pod_exporter_torch.loadgen import sharded
    from tpu_pod_exporter_torch.loadgen import workload as wl

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    uuid = nvidia_smi("uuid")
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         uuid=uuid, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.monotonic()
    path, log = tm.build()
    emit("build", seconds=time.monotonic() - t0, library=path.name,
         ptxas=[ln.strip() for ln in log.splitlines()
                if "ptxas" in ln or "spill" in ln])  # spills print unprefixed
    t0 = time.monotonic()
    prebuilt = nativelib.library_path().exists()
    libtpumon = nativelib.build()
    emit("build_libtpumon", seconds=time.monotonic() - t0, prebuilt=prebuilt,
         library=str(libtpumon.relative_to(REPO)), flags=list(nativelib.CXX_FLAGS))

    records = phase_kernel(dev, tm)
    phase_workload(dev, tm, wl)
    torch.cuda.empty_cache()
    closed_loop = phase_closed_loop(dev, tm, hwcheck, uuid)
    torch.cuda.empty_cache()
    records["sgd"] = phase_sgd(dev, sgd)
    phase_grad(dev, tm, wl)
    torch.cuda.empty_cache()
    train = phase_train(dev, tm, sgd, sharded)
    torch.cuda.empty_cache()
    phase_cli(dev)
    records["online_softmax"] = phase_online_softmax(dev, osm)
    torch.cuda.empty_cache()
    parallel = phase_parallel(dev, tm, sgd, osm, par)
    torch.cuda.empty_cache()
    nvml = phase_nvml(dev, tm, hwcheck, uuid)
    torch.cuda.empty_cache()
    node_state = phase_node_state(dev, tm, hwcheck, uuid, libtpumon)
    torch.cuda.empty_cache()
    fleet = phase_fleet(dev, tm, hwcheck, uuid)

    # Launches on the main paths: the closed loop, the training run, the
    # collective programs, the NVML closed loop, the node state phase and
    # the fleet phase.
    names = (*SOURCES, "sgd", "online_softmax")
    by_path = {kernel: {"closed_loop": closed_loop.get(kernel, 0),
                        "train": train.get(kernel, 0), "parallel": parallel[kernel],
                        "nvml": nvml.get(kernel, 0), "node_state": node_state.get(kernel, 0),
                        "fleet": fleet.get(kernel, 0)}
               for kernel in names}
    kernels = [{
        "name": tm.ENTRIES[kernel],
        "route": "cuda",
        "source": f"tpu_pod_exporter_torch/kernels/csrc/{source}",
        "replaces": "tpu_pod_exporter/loadgen/workload.py:40",
    } for kernel, source in SOURCES.items()] + [{
        "name": "sgd_update_bf16",
        "route": "cuda",
        "source": "tpu_pod_exporter_torch/kernels/csrc/sgd_update.cu",
        "replaces": "tpu_pod_exporter/loadgen/sharded.py:103",
    }, {
        "name": "online_softmax_f32",
        "route": "cuda",
        "source": "tpu_pod_exporter_torch/kernels/csrc/online_softmax.cu",
        "replaces": "tpu_pod_exporter/loadgen/parallel.py:88",
    }]
    for record, kernel in zip(kernels, names):
        record.update(launches=sum(by_path[kernel].values()),
                      launches_by_path=by_path[kernel], **records[kernel])
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
