#!/usr/bin/env python3
"""Drive tpu_pod_exporter_torch on one CUDA card and check every phase.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device    — the card's name, and nvidia-smi's name and power limit;
2. build     — one nvcc call builds both tanh_matmul kernels (wgmma and
               wmma) from this checkout;
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
               and every launch is on the wgmma kernel.

Then one JSON line with every kernel's numbers, nvidia-smi's line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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


def reset_counts(tm) -> None:
    tm.tanh_matmul.launches = 0
    for kernel in tm.tanh_matmul.launches_by_kernel:
        tm.tanh_matmul.launches_by_kernel[kernel] = 0


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


def main() -> int:
    from tpu_pod_exporter_torch import hwcheck
    from tpu_pod_exporter_torch.kernels import tanh_matmul as tm
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

    records = phase_kernel(dev, tm)
    phase_workload(dev, tm, wl)
    torch.cuda.empty_cache()
    launches = phase_closed_loop(dev, tm, hwcheck, uuid)

    print(json.dumps({"kernels": [{
        "name": tm.ENTRIES[kernel],
        "route": "cuda",
        "source": f"tpu_pod_exporter_torch/kernels/csrc/{source}",
        "replaces": "tpu_pod_exporter/loadgen/workload.py:40",
        "launches": launches[kernel],
        **records[kernel],
    } for kernel, source in SOURCES.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
