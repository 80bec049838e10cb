"""``online_softmax_update_``: one step of ring attention's running softmax as one CUDA kernel.

Replaces the body that XLA fuses inside ring attention's scan,
``tpu_pod_exporter/loadgen/parallel.py:88-95``. With ``r = q @ kb.T``
taken by a plain product, the step is

    s = r / sqrt(f32(d));  m_new = max(m, rowmax(s));  corr = exp(m - m_new)
    p = exp(s - m_new);    l = l * corr + rowsum(p);   o = o * corr

after which the caller adds ``p @ vb`` into ``o`` (``o.addmm_(p, vb)``,
another plain product). The kernel (``csrc/online_softmax.cu``, C entry
``online_softmax_f32``, built into the same library as the other kernels)
does the whole step in one launch, in place: ``p`` over ``r``, ``m`` and
``l`` updated, ``o`` scaled. One block takes one row and keeps its scores in
shared memory, so ``r`` is read once and written once. Memory bounds it: at
the card's ring shape (Tq = Tkv = 4096, ``o`` 4096 x 8192) it moves 384 MiB,
0.120 ms at 3.35 TB/s on an H100 SXM. No single PyTorch call computes the
step.

:func:`online_softmax_update_` takes :func:`online_softmax_update_plain`
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
``online_softmax_update_.launches`` counts launches.
"""

from __future__ import annotations

import torch

from tpu_pod_exporter_torch.kernels.tanh_matmul import library

# The longest row a block's shared memory holds: 227 KiB less the kernel's
# 32 bytes of reduction scratch, in f32.
MAX_TKV = (232_448 - 32) // 4


def online_softmax_update_plain(r: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                                o: torch.Tensor, d: int) -> torch.Tensor:
    """The same step in plain PyTorch, in place on r, m, l and o; returns r (now p)."""
    s = r / torch.tensor(float(d), dtype=r.dtype, device=r.device).sqrt()
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[:, None])
    l.mul_(corr).add_(p.sum(dim=-1))
    o.mul_(corr[:, None])
    m.copy_(m_new)
    return r.copy_(p)


def _check(r: torch.Tensor, m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
           d: int) -> None:
    tensors = {"r": r, "m": m, "l": l, "o": o}
    if any(t.device != r.device for t in tensors.values()):
        raise ValueError("r, m, l and o must be on one device: "
                         + ", ".join(f"{k} on {t.device}" for k, t in tensors.items()))
    if any(t.dtype != torch.float32 for t in tensors.values()):
        raise ValueError("expected f32 r, m, l and o, got "
                         + ", ".join(f"{k} {t.dtype}" for k, t in tensors.items()))
    if r.dim() != 2 or o.dim() != 2 or m.shape != (r.shape[0],) or l.shape != m.shape \
            or o.shape[0] != r.shape[0]:
        raise ValueError(f"expected r (Tq, Tkv), m and l (Tq,), o (Tq, D); got r "
                         f"{tuple(r.shape)}, m {tuple(m.shape)}, l {tuple(l.shape)}, "
                         f"o {tuple(o.shape)}")
    if not 1 <= r.shape[1] <= MAX_TKV:
        raise ValueError(f"Tkv = {r.shape[1]} is outside 1..{MAX_TKV}")
    if max(r.shape[0], o.shape[1]) >= 2**31 or not 1 <= d < 2**24:
        raise ValueError(f"sizes past int32 or d = {d} not in 1..2**24")
    if not all(t.is_contiguous() for t in tensors.values()):
        raise ValueError("r, m, l and o must be contiguous")


def online_softmax_update_(r: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                           o: torch.Tensor, d: int) -> torch.Tensor:
    """One running-softmax step over the scores ``r = q @ kb.T`` of queries
    of width ``d``, in place: r (Tq, Tkv) becomes p, m and l (Tq,) are
    updated and o (Tq, D) is scaled by the correction. Returns r."""
    _check(r, m, l, o, d)
    if r.device.type == "cpu":
        return online_softmax_update_plain(r, m, l, o, d)
    if r.device.type != "cuda":
        raise ValueError(f"online_softmax_update_ runs on cuda or cpu, not {r.device}")
    tq, tkv = r.shape
    if tq == 0:
        return r
    lib = library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.online_softmax_f32(r.data_ptr(), m.data_ptr(), l.data_ptr(), o.data_ptr(),
                                     tq, tkv, o.shape[1], d, stream)
    if err != 0:
        raise RuntimeError(f"online_softmax_f32 launch failed: CUDA error {err}")
    online_softmax_update_.launches += 1
    return r


online_softmax_update_.launches = 0
