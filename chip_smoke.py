#!/usr/bin/env python3
"""Drive tpu_pod_exporter_torch on one CUDA card and check every phase.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device    — the card's name, and nvidia-smi's name and power limit;
2. build     — nvcc builds the tanh_matmul kernel from this checkout;
3. kernel    — tanh_matmul against tanh_matmul_plain on the card at three
               shapes, and its time beside its bound, the plain version's
               time and one cuBLAS call's (``torch.tanh(h @ w)``, a
               yardstick the package never calls);
4. workload  — a burn at width 8192, depth 8, batch 4096 (10 forwards per
               step), its TFLOP/s, and the chain checked against the plain
               chain;
5. closed    — the main path: hwcheck's live exporter on the torch backend,
   loop       scraped over HTTP while a 16 GiB fill and the full-size burn
               load the card; memory must rise under load and fall after.

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
KERNEL_SHAPES = ((32, 128, 128), (257, 1000, 4095), (BATCH, WIDTH, WIDTH))
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


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of one call each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def layer_bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time for one layer: operations at the bf16 tensor-core peak or
    bytes (h and w read once, y written once) at the memory rate."""
    ops_ms = 2.0 * m * n * k / PEAK_BF16_FLOPS * 1e3
    bytes_ms = 2.0 * (m * k + k * n + m * n) / PEAK_HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_kernel(dev, tm) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    record: dict = {}
    for m, k, n in KERNEL_SHAPES:
        h = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device=dev) * k**-0.5).to(torch.bfloat16)
        y = tm.tanh_matmul(h, w)
        ref = tm.tanh_matmul_plain(h, w)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        emit("kernel", shape=[m, k, n], max_abs_err=err, atol=LAYER_ATOL)
        if not (torch.isfinite(y.float()).all() and err <= LAYER_ATOL):
            raise AssertionError(f"tanh_matmul {m}x{k}x{n}: max_abs_err {err} > {LAYER_ATOL}")
        if (m, k, n) == (BATCH, WIDTH, WIDTH):
            bound, bound_by = layer_bound_ms(m, k, n)
            record = {
                "max_abs_err": err,
                "ms": time_ms(lambda: tm.tanh_matmul(h, w)),
                "plain_ms": time_ms(lambda: tm.tanh_matmul_plain(h, w)),
                "library_ms": time_ms(lambda: torch.tanh(h @ w)),
                "bound_ms": bound,
                "bound_by": bound_by,
            }
            emit("kernel_time", shape=[m, k, n], **record,
                 tflops=2.0 * m * n * k / record["ms"] / 1e9)
        del h, w, y, ref
    return record


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
    tm.tanh_matmul.launches = 0
    steps = 0
    t0 = time.monotonic()
    while time.monotonic() - t0 < BURN_SECONDS:
        x = wl.burn_step(params, x, iters=ITERS)
        torch.cuda.synchronize()
        steps += 1
    dt = time.monotonic() - t0
    launches = tm.tanh_matmul.launches
    if launches != steps * ITERS * DEPTH or not torch.isfinite(x.float()).all():
        raise AssertionError(f"burn: {launches} launches for {steps} steps")
    flops = 2 * BATCH * WIDTH * WIDTH * DEPTH * ITERS * steps
    emit("workload", width=WIDTH, depth=DEPTH, batch=BATCH, iters=ITERS,
         steps=steps, seconds=dt, tflops=flops / dt / 1e12,
         launches=launches, chain_max_abs_err=chain_err, chain_atol=CHAIN_ATOL)


def phase_closed_loop(dev, tm, hwcheck, uuid: str) -> int:
    stim = hwcheck.TorchStimulus(hbm_bytes=FILL_BYTES, width=WIDTH, depth=DEPTH,
                                 batch=BATCH, iters=ITERS, device=dev)
    tm.tanh_matmul.launches = 0
    report = hwcheck.run_check(backend="torch", idle_s=2.0, load_s=8.0,
                               stimulus=stim)
    launches = tm.tanh_matmul.launches
    emit("closed_loop", report=report, launches=launches, burn_steps=stim.steps)
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
    from tpu_pod_exporter_torch.backend.torchdev import TorchCudaBackend

    (chip,) = TorchCudaBackend().sample().chips
    if chip.info.device_ids[0] != uuid:
        raise AssertionError(f"device id {chip.info.device_ids} != nvidia-smi {uuid}")
    return launches


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
         ptxas=[ln.strip() for ln in log.splitlines() if "ptxas" in ln])

    record = phase_kernel(dev, tm)
    phase_workload(dev, tm, wl)
    torch.cuda.empty_cache()
    launches = phase_closed_loop(dev, tm, hwcheck, uuid)

    print(json.dumps({"kernels": [{
        "name": "tanh_matmul",
        "route": "cuda",
        "source": "tpu_pod_exporter_torch/kernels/csrc/tanh_matmul.cu",
        "replaces": "tpu_pod_exporter/loadgen/workload.py:40",
        "launches": launches,
        **record,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
