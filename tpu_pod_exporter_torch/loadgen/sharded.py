"""Multi-device sharded training step, ported from ``tpu_pod_exporter/loadgen/sharded.py``.

A data-parallel x tensor-parallel SGD step over a ``DeviceMesh`` with dims
``("data", "model")``: the batch is split by rows over ``data``, every
layer's weight by output columns over ``model``. XLA places the
collectives of the JAX step itself; here they are written out, one rank a
process:

- forward: layer i > 0 all-gathers the previous layer's column shards
  over ``model`` and runs ``tanh_matmul`` on its own columns; the
  gather's backward is a reduce-scatter over ``model``;
- loss: each rank takes the squared error of its shard of the last
  layer's output, divided by the global element count, so that the
  ranks' losses sum to the mean and no gradient is counted twice;
- backward: the weight gradient is all-reduced over ``data``;
- update: one :func:`~tpu_pod_exporter_torch.kernels.sgd.sgd_update_`
  launch on the rank's stacked shard of the layers.

XLA sums the partial products of a sharded contraction in f32 and rounds
to bf16 once, after the collective; a collective of bf16 partials would
round once more on every rank. So where a group has more than one rank,
the partials are taken, summed and only then rounded. A world of one skips
every collective and runs the same slicing, padding, loss and update code.

Ranks are processes: :func:`run_world` starts a world of them on one host
(gloo on the CPU, NCCL on CUDA, rank r on card r), each running this
module's :func:`main`.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_pod_exporter_torch.cudaenv import require_cuda
from tpu_pod_exporter_torch.kernels.sgd import sgd_update_
from tpu_pod_exporter_torch.kernels.tanh_matmul import tanh_matmul
from tpu_pod_exporter_torch.loadgen.workload import init_params, params_from_jax

BACKENDS = {"cpu": "gloo", "cuda": "nccl"}
# torch >= 2.12 names the tensor collectives *_single and deprecates the
# older names, which are all that earlier versions have.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)


def _platform(device) -> str:
    """"cuda" (the default, checked) or "cpu"."""
    if device is None or torch.device(device).type == "cuda":
        require_cuda(device)
        return "cuda"
    if torch.device(device).type != "cpu":
        raise ValueError(f"expected a cuda or cpu device, got {device}")
    return "cpu"


def pick_devices(n: int, platform: str = "cuda") -> list[torch.device]:
    """One device for each of n ranks: cards 0..n-1 on ``"cuda"``; on
    ``"cpu"``, where the ranks are processes, the one CPU n times."""
    if platform == "cpu":
        return [torch.device("cpu")] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have >= n:
        return [torch.device("cuda", i) for i in range(n)]
    raise ValueError(f"need {n} devices, have {have} on cuda platform; "
                     "a world on the CPU takes --device cpu")


def mesh_shape(n_devices: int, dp: int | None = None,
               tp: int | None = None) -> tuple[int, int]:
    """(dp, tp) with dp * tp = n; defaults to the most-square
    factorization with dp >= tp."""
    if dp is None or tp is None:
        tp = 1
        for cand in range(int(n_devices**0.5), 0, -1):
            if n_devices % cand == 0:
                tp = cand
                break
        dp = n_devices // tp
    if dp * tp != n_devices:
        raise ValueError(f"dp({dp}) * tp({tp}) != n_devices({n_devices})")
    return dp, tp


def make_mesh(n_devices: int, dp: int | None = None, tp: int | None = None,
              device=None) -> DeviceMesh:
    """A (data, model) mesh over the current ``torch.distributed`` world of
    n ranks, on CUDA unless ``device`` is the CPU. For n = 1 with no world
    yet, starts a world of one in this process (an in-memory store, no
    socket)."""
    dp, tp = mesh_shape(n_devices, dp, tp)
    platform = _platform(device)
    join_world(n_devices, platform)
    return DeviceMesh(platform, torch.arange(n_devices).reshape(dp, tp),
                      mesh_dim_names=("data", "model"))


def join_world(n_devices: int, platform: str) -> None:
    """Check that this process is a rank of a world of n ranks on
    ``platform`` ("cuda" or "cpu"), starting a world of one in this process
    (an in-memory store, no socket) when there is none and n = 1; on CUDA,
    make card r the current device of rank r."""
    devices = pick_devices(n_devices, platform)
    if not dist.is_initialized():
        if n_devices != 1:
            raise RuntimeError(f"a mesh of {n_devices} needs a torch.distributed "
                               f"world of {n_devices} ranks (run_world starts one)")
        dist.init_process_group(BACKENDS[platform], store=dist.HashStore(),
                                rank=0, world_size=1)
    if dist.get_world_size() != n_devices:
        raise ValueError(f"world has {dist.get_world_size()} ranks, mesh needs {n_devices}")
    if platform == "cuda":
        torch.cuda.set_device(devices[dist.get_rank()])


def padded(batch: int, width: int, dp: int, tp: int) -> tuple[int, int]:
    """Batch rounded up to a multiple of dp and width to one of tp, so that
    any mesh shape divides them (dp=3: batch 32 -> 33)."""
    return -(-batch // dp) * dp, -(-width // tp) * tp


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands, summed and returned in f32."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _ShardedLayer(torch.autograd.Function):
    """One layer on one rank: ``tanh(h @ w)`` for the rank's rows of the
    batch and its columns of the layer. ``gather`` all-gathers ``h`` from
    the column shards over ``model`` first (every layer but the first)."""

    @staticmethod
    def forward(ctx, h, w, step: "ShardedStep", gather: bool):
        if gather and step.tp > 1:
            out = h.new_empty((step.tp * h.shape[0], h.shape[1]))
            _all_gather(out, h, group=step.model)
            h = out.view(step.tp, -1, h.shape[1]).transpose(0, 1).reshape(h.shape[0], -1)
        y = tanh_matmul(h, w)
        ctx.save_for_backward(h, w, y)
        ctx.step, ctx.gather = step, gather
        return y

    @staticmethod
    def backward(ctx, dy):
        h, w, y = ctx.saved_tensors
        step = ctx.step
        g = torch.ops.aten.tanh_backward(dy, y)
        dh = dw = None
        if ctx.needs_input_grad[1]:
            if step.dp > 1:
                dw = _f32_product(h.t(), g)
                dist.all_reduce(dw, group=step.data)
                dw = dw.to(torch.bfloat16)
            else:
                dw = h.t() @ g
        if ctx.needs_input_grad[0]:
            if ctx.gather and step.tp > 1:
                rows = g.shape[0]
                part = _f32_product(g, w.t()).view(rows, step.tp, -1)
                dh = part.new_empty((rows, part.shape[2]))
                _reduce_scatter(dh, part.transpose(0, 1).reshape(-1, part.shape[2]),
                                group=step.model)
                dh = dh.to(torch.bfloat16)
            else:
                dh = g @ w.t()
        return dh, dw, None, None


class ShardedStep:
    """``step(params, x, y) -> (params, loss)`` on one rank of the mesh.

    ``params`` is the rank's ``{"layers": (depth, width, width / tp)}`` and
    is updated in place; ``x`` and ``y`` are its rows of the batch at full
    width; ``loss`` is the global mean (f32, 0-d). The three phases,
    :meth:`forward`, ``loss.backward()`` and :meth:`update`, may also be
    called one by one, as a timing of each does.
    """

    def __init__(self, mesh: DeviceMesh, lr: float, n_elements: int):
        self.dp, self.tp = mesh.size(0), mesh.size(1)
        self.data, self.model = mesh.get_group("data"), mesh.get_group("model")
        self.column = mesh.get_local_rank("model")
        self.world = dist.get_world_size()
        self.lr = lr
        self.n_elements = n_elements

    def forward(self, layers: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
        """This rank's share of the loss, with its graph."""
        h = x
        for i, w in enumerate(layers.unbind(0)):
            h = _ShardedLayer.apply(h, w, self, i > 0)
        cols = h.shape[1]
        target = y[:, self.column * cols:(self.column + 1) * cols]
        return ((h.float() - target.float()) ** 2).sum() / self.n_elements

    def update(self, params: dict, grad: torch.Tensor) -> None:
        sgd_update_(params["layers"], grad, self.lr)

    def __call__(self, params: dict, x: torch.Tensor, y: torch.Tensor):
        layers = params["layers"].detach().requires_grad_()
        share = self.forward(layers, x, y)
        share.backward()
        self.update(params, layers.grad)
        loss = share.detach()
        if self.world > 1:
            dist.all_reduce(loss)  # the ranks' shares sum to the mean
        return params, loss


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def sharded_train_step(mesh: DeviceMesh, width: int = 128, depth: int = 4,
                       batch: int = 32, lr: float = 1e-2, params: dict | None = None):
    """Build (step, this rank's params, this rank's (x, y)) on the mesh.

    ``x`` is ones and ``y`` zeros, as in the JAX package. ``params``, when
    given, are the full layers ``{"layers": (depth, width, width)}`` at the
    padded width (the JAX package's weights through ``params_from_jax``);
    by default they come from :func:`init_params` with seed 0. The rank
    keeps a copy of its columns.
    """
    dp, tp = mesh.size(0), mesh.size(1)
    batch, width = padded(batch, width, dp, tp)
    dev = _mesh_device(mesh)
    if params is None:
        params = init_params(width=width, depth=depth, device=dev)
    layers = params["layers"]
    if tuple(layers.shape) != (depth, width, width):
        raise ValueError(f"params are {tuple(layers.shape)}, "
                         f"the step needs {(depth, width, width)}")
    cols, rows = width // tp, batch // dp
    j = mesh.get_local_rank("model")
    local = layers[:, :, j * cols:(j + 1) * cols].to(dev).clone(
        memory_format=torch.contiguous_format)
    x = torch.ones((rows, width), dtype=torch.bfloat16, device=dev)
    y = torch.zeros((rows, width), dtype=torch.bfloat16, device=dev)
    return ShardedStep(mesh, lr, batch * width), {"layers": local}, (x, y)


def gather_params(mesh: DeviceMesh, params: dict) -> torch.Tensor:
    """The full (depth, width, width) layers from every rank's columns."""
    local = params["layers"]
    tp = mesh.size(1)
    if tp == 1:
        return local.clone()
    depth, width, cols = local.shape
    out = local.new_empty((tp * depth, width, cols))
    _all_gather(out, local, group=mesh.get_group("model"))
    return out.view(tp, depth, width, cols).permute(1, 2, 0, 3).reshape(depth, width, -1)


def train(mesh: DeviceMesh, width: int, depth: int, batch: int, steps: int = 1,
          seconds: float = 0.0, params: dict | None = None,
          params_out: str | None = None) -> dict:
    """Run ``steps`` steps, then more until ``seconds`` have passed since
    they ended (every rank stops after the same step). Rank 0 saves the
    gathered layers after each of the first ``steps`` to ``params_out``
    (f32 ``.npy``, shape (steps, depth, width, width)).

    Returns {"mesh", "batch" and "width" (padded), "losses" (every step),
    "steps" and "seconds" (of the timed steps after the first ``steps``)}.
    """
    step, params, (x, y) = sharded_train_step(mesh, width, depth, batch, params=params)
    losses, saved = [], []
    for _ in range(steps):
        params, loss = step(params, x, y)
        losses.append(float(loss))
        if params_out:
            saved.append(gather_params(mesh, params).float().cpu().numpy())
    if params_out and dist.get_rank() == 0:
        np.save(params_out, np.stack(saved))
    timed, t0 = 0, time.monotonic()
    more = torch.ones((), device=_mesh_device(mesh))
    while True:
        more.fill_(float(time.monotonic() - t0 < seconds))
        if step.world > 1:
            dist.all_reduce(more, op=dist.ReduceOp.MIN)
        if not more.item():
            break
        params, loss = step(params, x, y)
        losses.append(float(loss))
        timed += 1
    return {"mesh": {"data": step.dp, "model": step.tp},
            "batch": step.n_elements // x.shape[1], "width": x.shape[1],
            "losses": losses, "steps": timed, "seconds": time.monotonic() - t0}


def run_dryrun(n_devices: int, steps: int = 1, device=None) -> float:
    """Run the sharded step on an n-device mesh; returns the final loss.
    A world of one, or the world of n this process is a rank of, runs in
    this process; otherwise a world of n starts through :func:`run_world`."""
    if n_devices == 1 or (dist.is_initialized() and dist.get_world_size() == n_devices):
        mesh = make_mesh(n_devices, device=device)
        return train(mesh, width=128, depth=4, batch=32, steps=steps)["losses"][-1]
    reports = run_world(n_devices, _platform(device), ["--steps", str(steps)])
    return reports[0]["losses"][-1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read(f) -> str:
    f.seek(0)
    return f.read().decode(errors="replace")


def run_world(n: int, device: str, argv: list[str], timeout: float = 60.0,
              module: str = "tpu_pod_exporter_torch.loadgen.sharded") -> list[dict]:
    """Start n ranks of ``module``'s ``main`` (by default this module's
    :func:`main`) as child processes on this host, each given ``argv``
    after ``--rank``, ``--world-size``, ``--init-method`` and ``--device``,
    and return their reports (the last line of each rank's output, JSON) in
    rank order.

    ``device`` is "cpu" (gloo) or "cuda" (NCCL, rank r on card r). Raises
    RuntimeError with the children's stderr tails when one fails or when
    the world has not finished within ``timeout`` seconds; no child
    outlives the call.
    """
    if device not in BACKENDS:
        raise ValueError(f"device is one of {tuple(BACKENDS)}, not {device!r}")
    pick_devices(n, device)
    repo = Path(__file__).resolve().parents[2]
    env = dict(os.environ)
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"  # n ranks share the host's cores
    init = f"tcp://127.0.0.1:{_free_port()}"
    outs = [tempfile.TemporaryFile() for _ in range(n)]
    errs = [tempfile.TemporaryFile() for _ in range(n)]
    procs = []
    try:
        for rank in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module,
                 "--rank", str(rank), "--world-size", str(n), "--init-method", init,
                 "--device", device, *argv],
                cwd=repo, env=env, stdout=outs[rank], stderr=errs[rank]))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, code in enumerate(codes) if code not in (None, 0)]
            if not failed and None not in codes:
                break
            if failed or time.monotonic() > deadline:
                what = (f"rank {failed[0]} exited rc={codes[failed[0]]}"
                        if failed else f"timed out after {timeout}s")
                raise RuntimeError(f"world of {n} on {device}: {what}\n" + "\n".join(
                    f"rank {r} stderr tail: {_read(e)[-1500:]!r}"
                    for r, e in enumerate(errs)))
            time.sleep(0.05)
        return [json.loads(_read(o).strip().splitlines()[-1]) for o in outs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in outs + errs:
            f.close()


def main(argv=None) -> int:
    """One rank of a world that :func:`run_world` starts: join the world,
    run :func:`train` and print its report as one JSON line."""
    p = argparse.ArgumentParser(prog="python -m tpu_pod_exporter_torch.loadgen.sharded",
                                description=main.__doc__)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--init-method", required=True, help="tcp://host:port")
    p.add_argument("--device", choices=tuple(BACKENDS), default="cuda")
    p.add_argument("--dp", type=int)
    p.add_argument("--tp", type=int)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--params-in", help="full layers as a .npy, (depth, width, width)")
    p.add_argument("--params-out", help="rank 0 saves the layers after each step here")
    args = p.parse_args(argv)

    dist.init_process_group(BACKENDS[args.device], init_method=args.init_method,
                            rank=args.rank, world_size=args.world_size)
    try:
        mesh = make_mesh(args.world_size, args.dp, args.tp, device=args.device)
        params = None
        if args.params_in:
            params = params_from_jax({"layers": np.load(args.params_in)},
                                     device=_mesh_device(mesh))
        report = train(mesh, args.width, args.depth, args.batch, steps=args.steps,
                       seconds=args.seconds, params=params, params_out=args.params_out)
    finally:
        dist.destroy_process_group()
    print(json.dumps({"rank": args.rank, **report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
