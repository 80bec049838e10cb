"""Sequence-, pipeline- and expert-parallel programs over a device mesh,
ported from ``tpu_pod_exporter/loadgen/parallel.py``.

Each program of the JAX package is a ``shard_map`` whose collectives XLA
places; here each is a function that runs on one rank of a
``torch.distributed`` world, over a ``DeviceMesh`` with the JAX axis names,
and the collectives are written out:

- **Ring attention** (``seq``): K/V blocks go one hop round the ring a step
  (``batch_isend_irecv``: send to rank r+1, receive from rank r-1) while a
  running softmax accumulates; the running-softmax update is one launch of
  the hand kernel ``online_softmax_f32`` (:mod:`..kernels.online_softmax`)
  between two plain products.
- **Ulysses attention** (``seq``): one ``all_to_all_single`` swaps the
  sequence shard of q, k and v for a head shard, exact attention runs per
  head, a second swaps back.
- **Pipeline** (``stage``): GPipe ticks; activations go stage to stage with
  send/recv; the last stage's outputs are all-reduced.
- **MoE** (``expert``): token j goes to expert ``j % n``;
  ``all_to_all_single`` dispatches and combines.
- **FSDP** (``shard``): the forward all-gathers the row shards; the
  gather's backward reduce-scatters, and the step divides by n.
- **Multislice** (``slice`` x ``intra``): the gradient is all-reduced over
  ``slice`` once, the loss over the whole world.

Every program runs in f32 with plain products (``torch.mm``), as the JAX
package leaves them to XLA; the ``reference_*`` functions are the
single-device ground truth (run them in float64 on the CPU, or in f32 with
TF32 off on the card). A world of one skips every collective. A program's
function takes this rank's blocks of its inputs (the ``shard`` functions
cut them from full tensors, as ``device_put`` with the JAX shardings does)
and returns this rank's blocks of its outputs; :func:`gather_output` puts
them back together. The meshes span the whole world: :func:`run_world`
starts a world of rank processes, each running this module's :func:`main`.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_pod_exporter_torch.kernels.online_softmax import online_softmax_update_
from tpu_pod_exporter_torch.loadgen.sharded import (
    BACKENDS,
    _all_gather,
    _platform,
    _reduce_scatter,
    join_world,
)

MODULE = "tpu_pod_exporter_torch.loadgen.parallel"


def make_1d_mesh(n_devices: int, axis: str, device=None) -> DeviceMesh:
    """A mesh of the n ranks of the current world along ``axis``, on CUDA
    unless ``device`` is the CPU; for n = 1 with no world yet, starts a
    world of one in this process."""
    platform = _platform(device)
    join_world(n_devices, platform)
    return DeviceMesh(platform, torch.arange(n_devices), mesh_dim_names=(axis,))


def make_2d_mesh(n_slices: int, per_slice: int,
                 axes: tuple[str, str] = ("slice", "intra"), device=None) -> DeviceMesh:
    """An (n_slices, per_slice) mesh of the current world's ranks."""
    platform = _platform(device)
    join_world(n_slices * per_slice, platform)
    return DeviceMesh(platform, torch.arange(n_slices * per_slice).reshape(n_slices, per_slice),
                      mesh_dim_names=axes)


def _axis(mesh: DeviceMesh, axis: str):
    """(size, this rank's index, process group) of a mesh axis."""
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.size(dim), mesh.get_local_rank(dim), mesh.get_group(dim)


def _block(t: torch.Tensor, n: int, idx: int, dim: int = 0) -> torch.Tensor:
    """Block ``idx`` of ``n`` along ``dim``, contiguous."""
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {n}")
    size = t.shape[dim] // n
    return t.narrow(dim, idx * size, size).contiguous()


def _sharder(mesh: DeviceMesh, axis: str, dim: int = 0):
    """``shard(t)``: this rank's block of a full tensor split over ``axis``."""
    n, idx, _ = _axis(mesh, axis)
    return functools.partial(_block, n=n, idx=idx, dim=dim)


def _all_to_all(t: torch.Tensor, n: int, group) -> torch.Tensor:
    """Slot j of ``t`` (its dim 0 has n slots) to rank j of ``group``; slot
    j of the result came from rank j."""
    if n == 1:
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def _p2p(group, sends, recvs) -> None:
    """Post every (tensor, group rank) send and receive at once and wait."""
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, peer), group)
           for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, peer), group)
            for t, peer in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


# --------------------------------------------------------------------- ring

def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain softmax attention, the single-device ground truth; batched
    over leading dims."""
    d = q.shape[-1]
    scores = (q @ k.transpose(-2, -1)) / math.sqrt(d)
    w = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    return w @ v


def ring_attention_fn(mesh: DeviceMesh, axis: str = "seq"):
    """``(fn, shard)``: ``fn(q, k, v)`` takes this rank's (T/n, d) blocks
    of the sequence and returns its block of the attention output. K/V
    blocks go round the ring for n steps, one hop after every step (the last
    included, as the JAX scan does), while the running softmax accumulates:
    each step is ``r = q @ kb.T``, one ``online_softmax_update_`` launch,
    and ``o += p @ vb``."""
    n, idx, group = _axis(mesh, axis)

    def rotate(kb: torch.Tensor, vb: torch.Tensor):
        if n == 1:
            return kb, vb
        k_next, v_next = torch.empty_like(kb), torch.empty_like(vb)
        _p2p(group, [(kb, (idx + 1) % n), (vb, (idx + 1) % n)],
             [(k_next, (idx - 1) % n), (v_next, (idx - 1) % n)])
        return k_next, v_next

    def local_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        d = q.shape[-1]
        o = torch.zeros_like(q, memory_format=torch.contiguous_format)
        m = torch.full((q.shape[0],), -math.inf, dtype=q.dtype, device=q.device)
        l = torch.zeros_like(m)
        kb, vb = k, v
        for _ in range(n):
            p = torch.mm(q, kb.t())  # r, overwritten with p
            online_softmax_update_(p, m, l, o, d)
            o.addmm_(p, vb)
            kb, vb = rotate(kb, vb)
        return o / l[:, None]

    return local_block, _sharder(mesh, axis)


def reference_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-head softmax attention on full (T, H, d) tensors, the ground truth
    for :func:`ulysses_attention_fn`: :func:`reference_attention` over the
    head axis."""
    out = reference_attention(q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1))
    return out.transpose(0, 1)


def ulysses_attention_fn(mesh: DeviceMesh, axis: str = "seq"):
    """``(fn, shard)``: ``fn(q, k, v)`` takes this rank's (T/n, H, d)
    sequence blocks (H a multiple of n) and returns its block of the
    output. One ``all_to_all_single`` of q, k and v together gives this rank
    the whole sequence for its H/n heads; exact attention runs on them; a
    second ``all_to_all_single`` gives each rank back its sequence block for
    every head."""
    n, _, group = _axis(mesh, axis)

    def local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        tl, h, d = q.shape
        if h % n:
            raise ValueError(f"{h} heads do not split over {n} devices")
        hl = h // n
        # Slot j: this rank's sequence block of head group j, for rank j.
        send = torch.stack((q, k, v)).view(3, tl, n, hl, d).permute(2, 0, 1, 3, 4)
        recv = _all_to_all(send, n, group)  # slot j: sequence block j
        qh, kh, vh = recv.transpose(0, 1).reshape(3, n * tl, hl, d).unbind(0)
        out = reference_mha(qh, kh, vh)  # (T, H/n, d): exact attention, own heads
        back = _all_to_all(out.reshape(n, tl, hl, d), n, group)  # slot j: head group j
        return back.transpose(0, 1).reshape(tl, h, d)

    return local, _sharder(mesh, axis)


# ----------------------------------------------------------------- pipeline

def pipeline_forward_fn(mesh: DeviceMesh, axis: str = "stage"):
    """``(fn, shard_w)``: GPipe over the stages. ``fn(stage_w, xs)`` takes
    this stage's (1, w, w) weights and the replicated (n_micro, mb, w)
    microbatches and returns the pipeline output (replicated). Each of the
    ``n_micro + n - 1`` ticks, bubbles included, every stage computes
    ``tanh(h_in @ w)`` and sends it to the next stage; stage 0 reads the
    next microbatch (zeros once they run out), the others what they
    received. Only the last stage adds into the output, which an
    ``all_reduce`` (sum) then replicates."""
    n, idx, group = _axis(mesh, axis)

    def local(stage_w: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        w = stage_w[0]
        n_micro, mb, width = xs.shape
        out = torch.zeros_like(xs)
        zeros = xs.new_zeros((mb, width))
        h_recv = zeros
        for t in range(n_micro + n - 1):
            if idx == 0:
                h_in = xs[t] if t < n_micro else zeros
            else:
                h_in = h_recv
            h_out = torch.tanh(h_in @ w)
            slot = t - (n - 1)
            if idx == n - 1 and slot >= 0:
                out[slot] += h_out
            # Stage i sends to stage i+1 (no wraparound); stage 0 reads zeros.
            h_recv = zeros if idx == 0 else torch.empty_like(h_out)
            _p2p(group, [(h_out, idx + 1)] if idx < n - 1 else [],
                 [(h_recv, idx - 1)] if idx > 0 else [])
        if n > 1:
            dist.all_reduce(out, group=group)
        return out

    return local, _sharder(mesh, axis)


def reference_pipeline(stage_w: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Every stage in turn on every microbatch: the ground truth."""
    h = xs
    for w in stage_w:
        h = torch.tanh(h @ w)
    return h


# ---------------------------------------------------------------------- moe

def moe_forward_fn(mesh: DeviceMesh, axis: str = "expert"):
    """``(fn, shard_w, shard_x)``: expert i on rank i. ``fn(expert_w, x)``
    takes this rank's (1, d, d) expert and (t_local, d) tokens (t_local a
    multiple of n); local token j goes to expert ``j % n``. One
    ``all_to_all_single`` dispatches each expert's (cap, d) group, the
    expert computes ``tanh(x @ w)``, a second sends the results home."""
    n, _, group = _axis(mesh, axis)

    def local(expert_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        t_local, d = x.shape
        cap = t_local // n
        groups = x.reshape(cap, n, d).transpose(0, 1).contiguous()  # (n, cap, d)
        recv = _all_to_all(groups, n, group)  # slot j: rank j's tokens for this expert
        hidden = torch.tanh(recv.reshape(n * cap, d) @ expert_w[0])
        back = _all_to_all(hidden.reshape(n, cap, d), n, group)
        return back.transpose(0, 1).reshape(t_local, d)

    return local, _sharder(mesh, axis), _sharder(mesh, axis)


def reference_moe(expert_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Every token through its position-routed expert: the ground truth."""
    n_exp = expert_w.shape[0]
    out = torch.empty_like(x)
    for e in range(n_exp):
        out[e::n_exp] = torch.tanh(x[e::n_exp] @ expert_w[e])
    return out


# --------------------------------------------------------------------- fsdp

class _GatherRows(torch.autograd.Function):
    """All-gather of row shards over a group; its backward reduce-scatters
    (sums) the cotangent, as the transpose of JAX's tiled all_gather."""

    @staticmethod
    def forward(ctx, shard: torch.Tensor, n: int, group) -> torch.Tensor:
        ctx.n, ctx.group = n, group
        out = shard.new_empty((n * shard.shape[0], *shard.shape[1:]))
        _all_gather(out, shard.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        out = grad.new_empty((grad.shape[0] // ctx.n, *grad.shape[1:]))
        _reduce_scatter(out, grad.contiguous(), group=ctx.group)
        return out, None, None


def fsdp_step_fn(mesh: DeviceMesh, axis: str = "shard", lr: float = 0.1):
    """``(fn, shard)``: ``fn(w_shard, x, y) -> (new_w_shard, loss)`` on
    this rank's (d/n, d) rows of the weight and (b/n, d) rows of the batch.
    The forward all-gathers the weight; the gradient reaches the shard
    through the gather's reduce-scatter, which already sums every rank's
    share, so the data-parallel mean is a division by n (a mean over the
    ranks would average the grads of different shards). The loss is the
    ranks' mean."""
    n, _, group = _axis(mesh, axis)

    def local(w_shard: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
        ws = w_shard.detach().requires_grad_()
        w = _GatherRows.apply(ws, n, group) if n > 1 else ws
        loss = torch.mean((torch.tanh(x @ w) - y) ** 2)
        (g,) = torch.autograd.grad(loss, ws)
        loss = loss.detach()
        if n > 1:
            dist.all_reduce(loss, group=group)
        return w_shard - lr * (g / n), loss / n

    return local, _sharder(mesh, axis)


def _sgd_reference(loss_of, w: torch.Tensor, lr: float):
    wf = w.detach().requires_grad_()
    loss = loss_of(wf)
    (g,) = torch.autograd.grad(loss, wf)
    return w - lr * g, loss.detach()


def reference_fsdp(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor, lr: float = 0.1):
    """The dense single-device step: the ground truth for :func:`fsdp_step_fn`."""
    return _sgd_reference(lambda wf: torch.mean((torch.tanh(x @ wf) - y) ** 2), w, lr)


# ------------------------------------------------------------- multi-slice

def multislice_step_fn(mesh: DeviceMesh, slice_axis: str = "slice",
                       tp_axis: str = "intra", lr: float = 0.1):
    """``(fn, shard_w, shard_x)`` over a 2D mesh: ``fn(w_shard, x_shard) ->
    (new_w_shard, loss)`` with the weight's (d, d/tp) columns over
    ``tp_axis`` (the same on every slice) and the batch's (b/slices, d)
    rows over ``slice_axis``, for the loss ``sum((x @ w)**2)``. JAX puts the
    cross-slice gradient all-reduce into the transpose of the replicated
    weight's use; autograd puts in nothing, so it is written here, once.
    The loss is all-reduced over both axes: the whole world."""
    n_slices, _, slice_group = _axis(mesh, slice_axis)
    world = dist.get_world_size()

    def local(w_shard: torch.Tensor, x_shard: torch.Tensor):
        ws = w_shard.detach().requires_grad_()
        y = x_shard @ ws
        part = torch.sum(y * y)
        (g,) = torch.autograd.grad(part, ws)
        if n_slices > 1:
            dist.all_reduce(g, group=slice_group)
        loss = part.detach()
        if world > 1:
            dist.all_reduce(loss)
        return w_shard - lr * g, loss

    return local, _sharder(mesh, tp_axis, dim=1), _sharder(mesh, slice_axis)


def reference_multislice(w: torch.Tensor, x: torch.Tensor, lr: float = 0.1):
    """The dense single-device step: the ground truth for :func:`multislice_step_fn`."""
    return _sgd_reference(lambda wf: torch.sum((x @ wf) ** 2), w, lr)


# ------------------------------------------------------------------- dryrun

PARALLEL_PROGRAMS = (
    "ring", "ulysses", "pipeline", "moe", "fsdp", "multislice",
)


def _gather(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's block of ``t``, in rank order along ``dim``."""
    n = dist.get_world_size()
    if n == 1:
        return t
    part = t.movedim(dim, 0).contiguous()
    out = part.new_empty((n * part.shape[0], *part.shape[1:]))
    _all_gather(out, part)
    return out.movedim(0, dim)


def gather_output(name: str, out):
    """A program's full output from every rank's blocks (every rank takes
    part and gets it): the attention outputs, MoE tokens and FSDP weights
    are row blocks over the world, the pipeline's output is replicated, and
    the multislice weight is column blocks over ``intra``, the same on
    every slice. Losses are replicated."""
    if name == "pipeline":
        return out
    if name in ("ring", "ulysses", "moe"):
        return _gather(out)
    w, loss = out
    if name == "fsdp":
        return _gather(w), loss
    per_slice = dist.get_world_size() // 2
    return _gather(w, dim=1)[:, :per_slice * w.shape[1]], loss


# The mesh axis of each one-dimensional program (multislice has two).
AXES = {"ring": "seq", "ulysses": "seq", "pipeline": "stage", "moe": "expert", "fsdp": "shard"}
# The arguments of each program, in order.
ARGS = {"ring": ("q", "k", "v"), "ulysses": ("q", "k", "v"),
        "pipeline": ("stage_w", "xs"), "moe": ("expert_w", "x"),
        "fsdp": ("w", "x", "y"), "multislice": ("w", "x")}


def _program(name: str, n_devices: int, device=None, multislice_lr: float = 0.1):
    """(fn, one shard function for each of its :data:`ARGS`) of a program
    on a mesh of the world's n ranks."""
    if name not in PARALLEL_PROGRAMS:
        raise ValueError(f"unknown program {name!r}; pick from {PARALLEL_PROGRAMS}")
    if name == "multislice":
        if n_devices % 2:
            raise ValueError("multislice needs an even device count")
        fn, shard_w, shard_x = multislice_step_fn(
            make_2d_mesh(2, n_devices // 2, device=device), lr=multislice_lr)
        return fn, (shard_w, shard_x)
    mesh = make_1d_mesh(n_devices, AXES[name], device=device)
    if name == "moe":
        fn, shard_w, shard_x = moe_forward_fn(mesh)
        return fn, (shard_w, shard_x)
    make = {"ring": ring_attention_fn, "ulysses": ulysses_attention_fn,
            "pipeline": pipeline_forward_fn, "fsdp": fsdp_step_fn}[name]
    fn, shard = make(mesh)
    if name == "pipeline":
        return fn, (shard, lambda xs: xs)  # the microbatches are replicated
    return fn, (shard,) * len(ARGS[name])


def rank_device(device) -> torch.device:
    """This rank's device once its world is joined: its card, or the CPU."""
    if _platform(device) == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def build_parallel_program(name: str, n_devices: int, scale: int = 1, device=None):
    """One named program packaged for a loop, as in the JAX package:
    ``(step, args, feed)``, where ``step(*args)`` runs one iteration on this
    rank's blocks and ``feed(args, out) -> args`` threads the output back in
    as the next input (a real data dependency a step). ``scale`` multiplies
    the tensor dimensions without changing the collective pattern.

    Shapes, scales, learning rates and feeds are the JAX package's. So is
    the inputs' structure: JAX draws every tensor of a program from one key,
    so q = k = v, and a program's tensors share a draw; here each tensor is
    drawn from a generator on the rank's device seeded 0 afresh. Every rank
    draws the full tensors and keeps its blocks."""
    n = n_devices
    # Multislice's lr scales with 1/d, as in the JAX package: the looped
    # w <- step(w) is gradient descent on sum(y**2), which diverges once
    # lr * lambda_max (about 2d here) passes 2; 0.04/d keeps a 10x margin
    # at any d.
    d_multislice = max(2 * scale, 2) * max(n // 2, 1)
    fn, shards = _program(name, n, device, multislice_lr=0.04 / d_multislice)
    dev = rank_device(device)

    def normal(*shape: int) -> torch.Tensor:
        gen = torch.Generator(device=dev).manual_seed(0)
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    if name in ("ring", "ulysses"):
        t, d = 4 * n * scale, 8 * scale
        q = normal(t, d) if name == "ring" else normal(t, n, d)
        args = (q, q, q)
        feed = lambda a, out: (out, a[1], a[2])  # noqa: E731
    elif name == "pipeline":
        width, mb, n_micro = 8 * scale, 4 * scale, 2 * n
        args = (normal(n, width, width) * 0.5, normal(n_micro, mb, width))
        feed = lambda a, out: (a[0], torch.tanh(out))  # noqa: E731
    elif name == "moe":
        d, tokens = 8 * scale, n * n * 2 * scale
        args = (normal(n, d, d) * 0.5, normal(tokens, d))
        feed = lambda a, out: (a[0], out)  # noqa: E731
    elif name == "fsdp":
        d = 2 * n * scale
        args = (normal(d, d) * 0.3, normal(4 * n, d), normal(4 * n, d))
        feed = lambda a, out: (out[0], a[1], a[2])  # noqa: E731
    else:
        d = d_multislice
        args = (normal(d, d) * 0.2, normal(4, d))
        feed = lambda a, out: (out[0], a[1])  # noqa: E731
    return fn, tuple(shard(a) for shard, a in zip(shards, args)), feed


def run_parallelism_dryrun(n_devices: int, device=None) -> dict[str, float]:
    """One step of each program at scale 1 on the world of n ranks this
    process is part of (or a world of one); returns a finite checksum per
    program, the sum of its full output, under the JAX package's keys.
    Multislice needs an even n of at least 4 and is left out otherwise."""
    keys = {"ring": "ring_attention", "ulysses": "ulysses_attention",
            "multislice": "multislice_dp_tp"}
    results: dict[str, float] = {}
    for name in PARALLEL_PROGRAMS:
        if name == "multislice" and (n_devices < 4 or n_devices % 2):
            continue
        step, inputs, _feed = build_parallel_program(name, n_devices, device=device)
        out = gather_output(name, step(*inputs))
        leaf = out[0] if isinstance(out, tuple) else out
        results[keys.get(name, name)] = float(leaf.double().sum())
    return results


def run_loop(name: str, n_devices: int, scale: int, seconds: float, device=None) -> dict:
    """The CLI's loop on this rank: one warm-up step, then steps fed back
    into the next for ``seconds``, each read back on the host (the first
    element of this rank's output). Every rank stops after the same step;
    the loop ends early when a rank reads a value that is not finite.

    Returns {"program", "scale", "n", "steps", "seconds", "finite", "probe"}."""
    step, inputs, feed = build_parallel_program(name, n_devices, scale=scale, device=device)
    out = step(*inputs)
    leaf = out[0] if isinstance(out, tuple) else out
    flags = torch.ones(2, device=leaf.device)
    probe, steps = float(leaf.reshape(-1)[0]), 0
    t0 = time.monotonic()
    while True:
        flags[0] = float(time.monotonic() - t0 < seconds)
        flags[1] = float(math.isfinite(probe))
        if n_devices > 1:
            dist.all_reduce(flags, op=dist.ReduceOp.MIN)
        if not flags.all():
            break
        out = step(*inputs)
        inputs = feed(inputs, out)
        leaf = out[0] if isinstance(out, tuple) else out
        probe = float(leaf.reshape(-1)[0])
        steps += 1
    return {"program": name, "scale": scale, "n": n_devices, "steps": steps,
            "seconds": time.monotonic() - t0, "finite": bool(flags[1]), "probe": probe}


# --------------------------------------------------------------- the ranks

def run_cases(inputs: dict[str, np.ndarray], n_devices: int, device=None) -> dict[str, np.ndarray]:
    """Run each case of ``inputs`` once on the world of n ranks and return
    the full outputs (on every rank).

    ``inputs`` holds full f32 arrays named ``<case>.<arg>``, where a case
    is a program's name, or the name, a hyphen and a label
    (``ring-30x.q``), and the args are :data:`ARGS`'. The outputs are named
    ``<case>`` (the attention, pipeline and MoE outputs) or ``<case>.w``
    and ``<case>.loss`` (FSDP and multislice). Cases run in sorted order,
    the same on every rank."""
    join_world(n_devices, _platform(device))
    dev = rank_device(device)
    outputs: dict[str, np.ndarray] = {}
    for case in sorted({key.rsplit(".", 1)[0] for key in inputs}):
        name = case.split("-")[0]
        fn, shards = _program(name, n_devices, device)
        args = [shard(torch.from_numpy(inputs[f"{case}.{arg}"]).to(dev))
                for shard, arg in zip(shards, ARGS[name])]
        out = gather_output(name, fn(*args))
        if isinstance(out, tuple):
            outputs[f"{case}.w"] = out[0].cpu().numpy()
            outputs[f"{case}.loss"] = out[1].cpu().numpy()
        else:
            outputs[case] = out.cpu().numpy()
    return outputs


def main(argv=None) -> int:
    """One rank of a world that :func:`run_world` starts: join the world,
    then run the cases of ``--inputs`` once (rank 0 saves the outputs to
    ``--outputs``) or loop ``--program`` as the load CLI does; print a
    report as one JSON line."""
    p = argparse.ArgumentParser(prog=f"python -m {MODULE}", description=main.__doc__)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--init-method", required=True, help="tcp://host:port")
    p.add_argument("--device", choices=tuple(BACKENDS), default="cuda")
    p.add_argument("--inputs", help=".npz of full inputs, <case>.<arg> (see run_cases)")
    p.add_argument("--outputs", help="rank 0 saves the full outputs here (.npz)")
    p.add_argument("--program", choices=PARALLEL_PROGRAMS, default="ring")
    p.add_argument("--scale", type=int, default=1)
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)

    dist.init_process_group(BACKENDS[args.device], init_method=args.init_method,
                            rank=args.rank, world_size=args.world_size)
    try:
        if args.inputs:
            with np.load(args.inputs) as data:
                outputs = run_cases(dict(data), args.world_size, device=args.device)
            if args.rank == 0 and args.outputs:
                np.savez(args.outputs, **outputs)
            report = {"cases": sorted(outputs)}
        else:
            report = run_loop(args.program, args.world_size, args.scale, args.seconds,
                              device=args.device)
    finally:
        dist.destroy_process_group()
    print(json.dumps({"rank": args.rank, **report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
