"""``sgd_update_``: the training step's parameter update as one CUDA kernel.

Replaces the update that XLA fuses into the JAX step,
``tpu_pod_exporter/loadgen/sharded.py:103-107``:
``(p.astype(f32) - lr * g).astype(bf16)`` for bf16 ``p`` and ``g``. JAX
rounds ``lr`` to bf16 and ``lr * g`` to bf16 before the f32 subtraction
(weak typing), so the update here is

    p = bf16(f32(p) - f32(bf16(bf16(lr) * g)))

step for step, and agrees with JAX bit for bit. No single PyTorch call
computes it: ``p.add_(g, alpha=-lr)`` rounds neither ``lr`` nor ``lr * g``,
and the eager sequence below (:func:`sgd_update_plain`) makes four passes
and f32 temporaries twice the size of ``p``.

The kernel (``csrc/sgd_update.cu``, C entry ``sgd_update_bf16``, built into
the same library as the ``tanh_matmul`` kernels) updates ``p`` in place in
one pass, as the JAX step's ``donate_argnums=(0,)`` allows: 16-byte loads
where ``p`` and ``g`` are both aligned, one element at a time otherwise.
Memory bounds it: at the full size (8 layers of 8192 x 8192) it moves
3 GiB, 0.962 ms at 3.35 TB/s on an H100 SXM.

:func:`sgd_update_` takes :func:`sgd_update_plain` only for CPU tensors;
for CUDA tensors it launches the kernel or raises. ``sgd_update_.launches``
counts launches.
"""

from __future__ import annotations

import torch

from tpu_pod_exporter_torch.kernels.tanh_matmul import library


def bf16_lr(lr: float) -> float:
    """``lr`` rounded to bf16, as JAX rounds it in ``lr * g`` for bf16 ``g``."""
    return float(torch.tensor(lr, dtype=torch.bfloat16))


def sgd_update_plain(p: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """The same update in plain PyTorch, in place on ``p``; returns ``p``."""
    # bf16 times bf16 is exact in f32, so one round gives the bf16 product.
    step = (g.float() * bf16_lr(lr)).to(torch.bfloat16)
    return p.copy_((p.float() - step.float()).to(torch.bfloat16))


def _check(p: torch.Tensor, g: torch.Tensor) -> None:
    if p.device != g.device:
        raise ValueError(f"p on {p.device}, g on {g.device}")
    if p.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise ValueError(f"expected bf16 p and g, got {p.dtype} and {g.dtype}")
    if p.shape != g.shape:
        raise ValueError(f"shapes differ: {tuple(p.shape)} and {tuple(g.shape)}")
    if not (p.is_contiguous() and g.is_contiguous()):
        raise ValueError("p and g must be contiguous")


def sgd_update_(p: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """``p -= lr * g`` with JAX's bf16 rounding, in place; returns ``p``."""
    _check(p, g)
    if p.device.type == "cpu":
        return sgd_update_plain(p, g, lr)
    if p.device.type != "cuda":
        raise ValueError(f"sgd_update_ runs on cuda or cpu, not {p.device}")
    if p.numel() == 0:
        return p
    lib = library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.sgd_update_bf16(p.data_ptr(), g.data_ptr(), p.numel(),
                                  bf16_lr(lr), stream)
    if err != 0:
        raise RuntimeError(f"sgd_update_bf16 launch failed: CUDA error {err}")
    sgd_update_.launches += 1
    return p


sgd_update_.launches = 0
