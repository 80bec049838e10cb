"""Numeric checks of every loadgen program, ported from
``tpu_pod_exporter/loadgen/selftest.py``.

Runs the collective programs of :mod:`.parallel` and the dp x tp training
step of :mod:`.sharded` on a world of n ranks and holds each against its
single-device ground truth (float64 on the CPU; f32 with TF32 off on the
card), printing ONE JSON line with every check's result:

    python -m tpu_pod_exporter_torch.loadgen.selftest --n 4 --checks all --device cpu
    python -m tpu_pod_exporter_torch.loadgen.selftest --n 1 --checks all

``--checks dryrun`` runs only the multichip gate (``entry.dryrun_multichip``).
The default device is the CUDA card; a world of more than one rank is a set
of rank processes that :func:`~.sharded.run_world` starts (gloo on the CPU,
NCCL on the cards), every rank runs every check in the same order, and rank
0's line is printed. Exit code 0 iff every requested check passed.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tpu_pod_exporter_torch.loadgen import parallel as par
from tpu_pod_exporter_torch.loadgen import sharded

MODULE = "tpu_pod_exporter_torch.loadgen.selftest"


def run_subprocess(n_devices: int, checks: str = "dryrun", timeout: float = 300,
                   device: str = "cuda") -> subprocess.CompletedProcess:
    """Run this module in a child process (``--n``, ``--checks``,
    ``--device``) and return the completed process: the one spawn recipe of
    ``entry.dryrun_multichip`` and the tests. The child's world of ranks
    gets a hard timeout inside ``timeout``; past ``timeout`` the child and
    every process it started are killed and ``subprocess.TimeoutExpired``
    (with the output so far) is raised."""
    repo = Path(__file__).resolve().parents[2]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", MODULE, "--n", str(n_devices), "--checks", checks,
           "--device", device, "--timeout", str(max(timeout - 30, timeout / 2))]
    # A process group of its own, so that a timeout kills the ranks too.
    with subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, start_new_session=True) as proc:
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
            raise subprocess.TimeoutExpired(cmd, timeout, output=out, stderr=err) from None
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def _close(out, ref, rtol: float, atol: float) -> dict:
    """allclose verdict and max abs error, as ``np.allclose`` (a bound of
    atol + rtol * |ref| an element)."""
    out = np.asarray(torch.as_tensor(out).detach().double().cpu())
    ref = np.asarray(torch.as_tensor(ref).detach().double().cpu())
    return {
        "ok": bool(out.shape == ref.shape and np.allclose(out, ref, rtol=rtol, atol=atol)),
        "max_abs_err": float(np.max(np.abs(out - ref))),
    }


def _inputs(seed: int, *shapes, scale: float = 1.0) -> list[torch.Tensor]:
    """Normal f32 tensors from a CPU generator: the same on every rank."""
    gen = torch.Generator().manual_seed(seed)
    return [scale * torch.randn(shape, generator=gen) for shape in shapes]


def _on(device, *tensors):
    """(the tensors on this rank's device, the same as reference inputs:
    float64 on the CPU, f32 on the card)."""
    dev = par.rank_device(device)
    ref = torch.float64 if dev.type == "cpu" else torch.float32
    return [t.to(dev) for t in tensors], [t.to(dev, ref) for t in tensors]


# --------------------------------------------------------------- checks

def check_dryrun_dp_tp(n: int, device=None) -> dict:
    loss = sharded.run_dryrun(n, steps=1, device=device)
    return {"ok": loss == loss, "loss": loss}


def check_dryrun_parallelism(n: int, device=None) -> dict:
    results = par.run_parallelism_dryrun(n, device=device)
    return {"ok": all(v == v for v in results.values()), **results}


def _ring(n, device, q, k, v, rtol, atol) -> dict:
    fn, shard = par.ring_attention_fn(par.make_1d_mesh(n, "seq", device=device))
    (q, k, v), ref = _on(device, q, k, v)
    out = par.gather_output("ring", fn(shard(q), shard(k), shard(v)))
    finite = bool(torch.isfinite(out).all())
    res = _close(out, par.reference_attention(*ref), rtol=rtol, atol=atol)
    return {**res, "ok": finite and res["ok"], "finite": finite}


def check_ring_attention(n: int, device=None) -> dict:
    t, d = 4 * n, 16
    return _ring(n, device, *_inputs(7, (t, d), (t, d), (t, d)), rtol=2e-5, atol=2e-5)


def check_ring_attention_stability(n: int, device=None) -> dict:
    """Large score magnitudes exercise the running-max renormalization."""
    t, d = 2 * n, 4
    q, k = _inputs(0, (t, d), (t, d), scale=30.0)
    (v,) = _inputs(2, (t, d))
    return _ring(n, device, q, k, v, rtol=1e-4, atol=1e-4)


def check_ulysses_attention(n: int, device=None) -> dict:
    """Ulysses head swap vs exact multi-head attention: the two
    all_to_alls must be inverses and the per-head math exact."""
    fn, shard = par.ulysses_attention_fn(par.make_1d_mesh(n, "seq", device=device))
    t, h, d = 4 * n, 2 * n, 16  # heads a strict multiple of devices
    (q, k, v), ref = _on(device, *_inputs(11, (t, h, d), (t, h, d), (t, h, d)))
    out = par.gather_output("ulysses", fn(shard(q), shard(k), shard(v)))
    return _close(out, par.reference_mha(*ref), rtol=2e-5, atol=2e-5)


def check_pipeline(n: int, device=None) -> dict:
    fn, shard_w = par.pipeline_forward_fn(par.make_1d_mesh(n, "stage", device=device))
    n_micro, mb, width = 2 * n, 4, 8
    (stage_w,) = _inputs(3, (n, width, width), scale=0.5)
    (xs,) = _inputs(4, (n_micro, mb, width))
    (stage_w, xs), ref = _on(device, stage_w, xs)
    out = fn(shard_w(stage_w), xs)
    return _close(out, par.reference_pipeline(*ref), rtol=2e-4, atol=2e-4)


def check_moe(n: int, device=None) -> dict:
    fn, shard_w, shard_x = par.moe_forward_fn(par.make_1d_mesh(n, "expert", device=device))
    d, tokens = 8, n * n * 2
    (expert_w,) = _inputs(5, (n, d, d), scale=0.5)
    (x,) = _inputs(6, (tokens, d))
    (expert_w, x), ref = _on(device, expert_w, x)
    out = par.gather_output("moe", fn(shard_w(expert_w), shard_x(x)))
    return _close(out, par.reference_moe(*ref), rtol=2e-4, atol=2e-4)


def check_fsdp(n: int, device=None) -> dict:
    """The sharded FSDP step (all_gather forward, reduce_scatter backward)
    must match the dense single-device SGD step."""
    fn, shard = par.fsdp_step_fn(par.make_1d_mesh(n, "shard", device=device))
    d, b = 2 * n, 4 * n
    (w,) = _inputs(11, (d, d), scale=0.3)
    x, y = _inputs(12, (b, d), (b, d))
    (w, x, y), ref = _on(device, w, x, y)
    new_w, loss = par.gather_output("fsdp", fn(shard(w), shard(x), shard(y)))
    ref_w, ref_loss = par.reference_fsdp(*ref)
    res = _close(new_w, ref_w, rtol=2e-5, atol=2e-5)
    loss_err = abs(float(loss) - float(ref_loss))
    return {**res, "ok": res["ok"] and loss_err < 1e-5, "loss_abs_err": loss_err}


def check_multislice(n: int, device=None) -> dict:
    """Cross-slice dp x intra-slice tp over a 2D mesh (2 slices x n/2) must
    match the dense single-device SGD step: the gradient all-reduced over
    the slices once, the loss over both axes."""
    if n < 4 or n % 2:
        # The 2 x (n/2) mesh needs an even n, and d = 2n must split over n/2.
        return {"ok": True, "skipped": f"needs even n>=4, got {n}"}
    fn, shard_w, shard_x = par.multislice_step_fn(par.make_2d_mesh(2, n // 2, device=device))
    d, b = 2 * n, 8
    (w,) = _inputs(13, (d, d), scale=0.3)
    (x,) = _inputs(14, (b, d))
    (w, x), ref = _on(device, w, x)
    new_w, loss = par.gather_output("multislice", fn(shard_w(w), shard_x(x)))
    ref_w, ref_loss = par.reference_multislice(*ref)
    res = _close(new_w, ref_w, rtol=2e-4, atol=2e-4)
    loss_err = abs(float(loss) - float(ref_loss)) / max(abs(float(ref_loss)), 1e-9)
    return {**res, "ok": res["ok"] and loss_err < 1e-4, "loss_rel_err": loss_err}


def check_sharded_descends(n: int, device=None) -> dict:
    """SGD on a fixed batch must descend over 5 steps."""
    step, params, (x, y) = sharded.sharded_train_step(
        sharded.make_mesh(n, device=device), width=64, depth=2, batch=16)
    losses = []
    for _ in range(5):
        params, loss = step(params, x, y)
        losses.append(float(loss))
    ok = bool(np.isfinite(losses).all()) and losses[-1] < losses[0]
    return {"ok": ok, "losses": losses}


def check_flagship(n: int, device=None) -> dict:
    from tpu_pod_exporter_torch.loadgen.workload import flagship

    fn, (params, x) = flagship(width=64, depth=2, batch=8, device=par.rank_device(device))
    out = fn(params, x).float()
    ok = tuple(out.shape) == (8, 64) and bool(torch.isfinite(out).all())
    return {"ok": ok, "shape": list(out.shape)}


CHECKS = {
    "dryrun_dp_tp": check_dryrun_dp_tp,
    "dryrun_parallelism": check_dryrun_parallelism,
    "ring_attention": check_ring_attention,
    "ring_attention_stability": check_ring_attention_stability,
    "ulysses_attention": check_ulysses_attention,
    "pipeline": check_pipeline,
    "moe": check_moe,
    "fsdp": check_fsdp,
    "multislice": check_multislice,
    "sharded_descends": check_sharded_descends,
    "flagship": check_flagship,
}

# The multichip gate: one step of every program, no reference
# numerics.
DRYRUN_CHECKS = ("dryrun_dp_tp", "dryrun_parallelism")


def run_checks(n: int, names, device=None) -> dict:
    """Each named check on the world of n ranks this process is part of
    (or a world of one), in order; a check that raises is reported as
    ``ok: false`` with its error."""
    results: dict[str, dict] = {}
    for name in names:
        try:
            results[name] = CHECKS[name](n, device)
        except Exception as exc:  # noqa: BLE001 — reported, not swallowed
            results[name] = {
                "ok": False,
                "error": f"{type(exc).__name__}: {exc}",
                "traceback": traceback.format_exc(limit=5),
            }
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog=f"python -m {MODULE}",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=8, help="world size (mesh size)")
    parser.add_argument("--checks", default="all",
                        help="'all', 'dryrun', or comma-separated check names")
    parser.add_argument("--device", choices=tuple(sharded.BACKENDS), default="cuda",
                        help="the cards (default), or the CPU when asked")
    parser.add_argument("--timeout", type=float, default=240.0,
                        help="seconds the world of ranks may take")
    parser.add_argument("--rank", type=int, help="(a rank of a world run_world starts)")
    parser.add_argument("--world-size", type=int)
    parser.add_argument("--init-method")
    args = parser.parse_args(argv)

    if args.checks == "all":
        names = list(CHECKS)
    elif args.checks == "dryrun":
        names = list(DRYRUN_CHECKS)
    else:
        names = [c.strip() for c in args.checks.split(",") if c.strip()]
        unknown = [c for c in names if c not in CHECKS]
        if unknown:
            print(json.dumps({"fatal": f"unknown checks: {unknown}"}))
            return 2

    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.rank is None and args.n > 1:
        report = sharded.run_world(
            args.n, args.device, ["--n", str(args.n), "--checks", ",".join(names)],
            timeout=args.timeout, module=MODULE)[0]
        report.pop("rank")
    else:
        if args.rank is not None:
            dist.init_process_group(sharded.BACKENDS[args.device],
                                    init_method=args.init_method,
                                    rank=args.rank, world_size=args.world_size)
        try:
            results = run_checks(args.n, names, device=args.device)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        report = {"n_devices": args.n, "ok": all(r.get("ok") for r in results.values()),
                  "checks": results}
        if args.rank is not None:
            # A rank's line goes to run_world; the rank exits 0 either way.
            print(json.dumps({"rank": args.rank, **report}), flush=True)
            return 0
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
