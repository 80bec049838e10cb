"""``tanh_matmul``: the flagship layer ``y = tanh(h @ W)`` as a CUDA kernel.

Replaces the layer body that XLA fuses on the TPU,
``tpu_pod_exporter/loadgen/workload.py:40-43`` (``forward.layer``): bf16
operands, f32 accumulation, ``tanh`` taken on the f32 sum, one round to
bf16. Layout is the JAX package's, ``h @ W`` with ``W`` indexed
``[in, out]`` (not ``nn.Linear``'s ``[out, in]``).

Bound on an H100 SXM at the main-path shape (M=4096, K=N=8192): 5.5e11
operations take 0.556 ms at the 989 TFLOP/s dense bf16 peak, its 256 MiB of
traffic 0.08 ms at 3.35 TB/s, so the tensor cores bound it.

Two hand kernels, chosen by shape before the launch (:func:`sm90_eligible`):

- ``wgmma`` (``csrc/tanh_matmul_sm90.cu``, C entry ``tanh_matmul_bf16_sm90``)
  for every shape TMA can address (K > 0, K and N multiples of 8, ``h`` and
  ``w`` 16-byte aligned), the main path among them: a warp-specialised
  kernel in which one producer thread keeps TMA loads of 128x64 slices of
  ``h`` and 64x256 slices of ``w`` in flight through a 4-stage ring, and two
  consumer warpgroups run ``wgmma.m64n256k16`` on them (``w`` read
  MN-major, never transposed), with ``tanhf`` on the registers;
- ``wmma`` (``csrc/tanh_matmul.cu``, C entry ``tanh_matmul_bf16``) for the
  rest (K or N not a multiple of 8, a misaligned ``h`` or ``w``, K = 0):
  128x128 tiles of wmma fragments, two cp.async stages, masked edges.

Every source under ``csrc/`` (these two, ``sgd_update.cu``, see
:mod:`.sgd`, and ``online_softmax.cu``, see :mod:`.online_softmax`) is compiled by one ``nvcc`` call at first CUDA use into one
library in ``tpu_pod_exporter_torch/_build/`` (file name keyed by a hash of
every file under ``csrc/`` and the flags) and bound through ``ctypes``.

:func:`tanh_matmul` takes :func:`tanh_matmul_plain` only for CPU tensors.
For CUDA tensors it launches one of the two kernels or raises; there is no
fallback from one to the other. ``tanh_matmul.launches`` counts kernel
launches, ``tanh_matmul.launches_by_kernel`` counts them by kernel; both
count forward launches only.

The gradient (:class:`TanhMatmul`) is the same code on both devices:
``g = tanh_backward(dy, y)``, ``dh = g @ w.T``, ``dw = h.T @ g``, bf16
operands with f32 accumulation (plain products, left to ``torch.matmul`` as
the JAX package leaves them to XLA). It takes ``1 - y**2`` from the bf16
output ``y``; JAX saves the f32 ``t = tanh(h @ w)`` and takes ``g`` in f32.
That puts the two gradients 0.7-0.8% of max|grad| apart at (width, depth,
batch) = (64,2,16) to (256,4,64) on the CPU (``tests/test_torch_train.py``),
so the parity tests allow 2**-6 (1.6%) of max|grad|.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the log
)

# Kernel name -> its C entry in the library.
ENTRIES = {"wgmma": "tanh_matmul_bf16_sm90", "wmma": "tanh_matmul_bf16"}
# Every C entry in the library -> its argument types. Pointers and the
# stream go as c_void_p: left to ctypes' default they would pass as 32-bit
# ints and lose their high bits.
_TANH_MATMUL_ARGS = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # h, w, y
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # M, N, K
    ctypes.c_void_p,                                    # stream
)
SIGNATURES = {
    "tanh_matmul_bf16_sm90": _TANH_MATMUL_ARGS,
    "tanh_matmul_bf16": _TANH_MATMUL_ARGS,
    # p, g, n, lr, stream (kernels/sgd.py)
    "sgd_update_bf16": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_float, ctypes.c_void_p),
    # r, m, l, o, Tq, Tkv, D, d, stream (kernels/online_softmax.py)
    "online_softmax_f32": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install at ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); looked at "
        + ", ".join(candidates)
    )


def sources() -> list[Path]:
    """The ``.cu`` files that make the library, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the shared library for the current sources and flags lives:
    keyed by every file under ``csrc/``, so that a change to any of them
    builds anew."""
    digest = hashlib.sha256()
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        digest.update(path.relative_to(CSRC).as_posix().encode() + b"\0")
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtanh_matmul-{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile both kernels in one nvcc call, unless the library for these
    sources exists; return its path and nvcc's output ("" when it was
    already built).

    Writes to a temporary name and renames, so concurrent builders never
    load a half-written file. Raises RuntimeError with nvcc's output when
    the build fails.
    """
    target = library_path()
    if target.exists():
        return target, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (rc={proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target, proc.stderr + proc.stdout


def library() -> ctypes.CDLL:
    """The port's kernel library, built at first use, with the argument
    types of every C entry in :data:`SIGNATURES` set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()[0]))
            for entry, argtypes in SIGNATURES.items():
                fn = getattr(lib, entry)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def tanh_matmul_plain(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: f32 product, tanh, one bf16 round."""
    return torch.tanh(h.float() @ w.float()).to(torch.bfloat16)


def _check(h: torch.Tensor, w: torch.Tensor) -> None:
    if h.device != w.device:
        raise ValueError(f"h on {h.device}, w on {w.device}")
    if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"expected bf16 operands, got {h.dtype} and {w.dtype}")
    if h.dim() != 2 or w.dim() != 2:
        raise ValueError(f"expected 2-D operands, got {tuple(h.shape)} and {tuple(w.shape)}")
    if h.shape[1] != w.shape[0]:
        raise ValueError(f"inner dims differ: {tuple(h.shape)} @ {tuple(w.shape)}")
    if not (h.is_contiguous() and w.is_contiguous()):
        raise ValueError("operands must be contiguous (row-major)")
    if max(*h.shape, w.shape[1]) >= 2**31:
        raise ValueError(f"dimension past int32: {tuple(h.shape)} @ {tuple(w.shape)}")


def sm90_eligible(m: int, n: int, k: int, h_ptr: int, w_ptr: int) -> bool:
    """Whether the wgmma kernel takes h (m,k) at ``h_ptr`` times w (k,n) at
    ``w_ptr``: TMA needs row strides of 16 bytes (k and n multiples of 8
    bf16 values) and 16-byte aligned bases, and the kernel a nonempty sum.
    Any m >= 1 is fine: TMA fills rows past the matrix with zeros."""
    return k > 0 and k % 8 == 0 and n % 8 == 0 and h_ptr % 16 == 0 and w_ptr % 16 == 0


def launch(kernel: str, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the hand kernel ``kernel`` ("wgmma" or "wmma") on CUDA
    operands and return y; raises if the launch fails. Counts the launch."""
    _check(h, w)
    if h.device.type != "cuda":
        raise ValueError(f"{kernel} kernel runs on cuda, not {h.device}")
    entry = ENTRIES[kernel]
    m, k = h.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=torch.bfloat16, device=h.device)
    if y.numel() == 0:
        return y
    lib = library()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = getattr(lib, entry)(
            h.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k, stream
        )
    if err < 0:
        raise RuntimeError(
            f"{entry}: cuTensorMapEncodeTiled failed with CUresult {-err}"
        )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    tanh_matmul.launches += 1
    tanh_matmul.launches_by_kernel[kernel] += 1
    return y


def _forward(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check(h, w)
    if h.device.type == "cpu":
        return tanh_matmul_plain(h, w)
    if h.device.type != "cuda":
        raise ValueError(f"tanh_matmul runs on cuda or cpu, not {h.device}")
    m, k = h.shape
    n = w.shape[1]
    eligible = sm90_eligible(m, n, k, h.data_ptr(), w.data_ptr())
    return launch("wgmma" if eligible else "wmma", h, w)


class TanhMatmul(torch.autograd.Function):
    """``tanh(h @ w)`` with its gradient; forward as :func:`tanh_matmul`."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        y = _forward(h, w)
        ctx.save_for_backward(h, w, y)
        return y

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        h, w, y = ctx.saved_tensors
        g = torch.ops.aten.tanh_backward(dy, y)
        dh = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = h.t() @ g if ctx.needs_input_grad[1] else None
        return dh, dw


def tanh_matmul(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``tanh(h @ w)``: h (M,K) and w (K,N) bf16, contiguous; returns (M,N)
    bf16, differentiable in both operands."""
    return TanhMatmul.apply(h, w)


tanh_matmul.launches = 0
tanh_matmul.launches_by_kernel = {kernel: 0 for kernel in ENTRIES}
