"""Single-device synthetic workloads, ported from ``tpu_pod_exporter/loadgen/workload.py``.

``flagship()`` is the forward step: a depth-stacked bf16 matmul chain. Each
layer is one :func:`~tpu_pod_exporter_torch.kernels.tanh_matmul.tanh_matmul`
launch (bf16 operands, f32 accumulation, tanh, one bf16 round), where the
JAX package runs one XLA-fused body under ``lax.scan``.

Parameters are a dict ``{"layers": (depth, width, width) bf16}``, with each
layer indexed ``[in, out]`` as in the JAX package. Every function takes an
explicit ``device``; ``None`` means the current CUDA device, and the CPU is
used only when a caller names it.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_pod_exporter_torch.cudaenv import require_cuda
from tpu_pod_exporter_torch.kernels.tanh_matmul import tanh_matmul


def _device(device) -> torch.device:
    if device is None:
        return require_cuda()
    dev = torch.device(device)
    return require_cuda(dev) if dev.type == "cuda" else dev


def init_params(width: int = 512, depth: int = 8, seed: int = 0, device=None) -> dict:
    """Stacked layer weights (depth, width, width) in bf16, std sqrt(2/width),
    drawn from a ``torch.Generator`` on ``device`` seeded with ``seed``."""
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = (2.0 / width) ** 0.5
    w = torch.randn((depth, width, width), generator=gen, dtype=torch.float32,
                    device=dev)
    return {"layers": w.mul_(scale).to(torch.bfloat16)}


def params_from_jax(params, device=None) -> dict:
    """The JAX package's ``{"layers": array}`` (as numpy) as this package's dict.

    JAX bf16 arrays come out of ``np.asarray`` as ``ml_dtypes.bfloat16``,
    which ``torch.from_numpy`` rejects; bf16 → f32 → bf16 is exact.
    """
    layers = np.asarray(params["layers"]).astype(np.float32)
    return {"layers": torch.from_numpy(layers).to(torch.bfloat16).to(_device(device))}


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (batch, width) bf16 → (batch, width) bf16, one kernel per layer."""
    h = x
    for w in params["layers"]:
        h = tanh_matmul(h, w)
    return h


def loss_fn(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """f32 mean squared error of ``forward`` against ``y``."""
    pred = forward(params, x).float()
    return torch.mean((pred - y.float()) ** 2)


def flagship(width: int = 512, depth: int = 8, batch: int = 256, device=None):
    """(forward fn, example_args) with ``x = ones``, as in the JAX package."""
    dev = _device(device)
    params = init_params(width=width, depth=depth, device=dev)
    x = torch.ones((batch, width), dtype=torch.bfloat16, device=dev)
    return forward, (params, x)


def burn_step(params: dict, x: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Run ``iters`` forward passes, each fed the previous one's output — a
    duty-cycle dial with a real data dependency from step to step."""
    for _ in range(iters):
        x = forward(params, x)
    return x


def hbm_fill(n_bytes: int, device=None) -> torch.Tensor:
    """Allocate ~n_bytes on ``device`` (bf16 zeros) and return the live buffer.

    Holding the returned tensor keeps the memory in use — the instrument
    for exercising ``gpu_hbm_used_bytes`` end to end on a real card.
    """
    dev = _device(device)
    arr = torch.zeros((max(n_bytes // 2, 1),), dtype=torch.bfloat16, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return arr
