"""``tanh_matmul``: the flagship layer ``y = tanh(h @ W)`` as one CUDA kernel.

Replaces the layer body that XLA fuses on the TPU,
``tpu_pod_exporter/loadgen/workload.py:40-43`` (``forward.layer``): bf16
operands, f32 accumulation, ``tanh`` taken on the f32 sum, one round to
bf16. Layout is the JAX package's, ``h @ W`` with ``W`` indexed
``[in, out]`` (not ``nn.Linear``'s ``[out, in]``).

Bound on an H100 SXM at the main-path shape (M=4096, K=N=8192): 5.5e11
operations take 0.56 ms at the 989 TFLOP/s dense bf16 peak, its 256 MiB of
traffic 0.08 ms at 3.35 TB/s, so the tensor cores bound it. The kernel
(``csrc/tanh_matmul.cu``) tiles 128x128 blocks over wmma bf16 fragments with
f32 accumulators, stages K through shared memory in two cp.async buffers,
and applies ``tanhf`` in the epilogue so the f32 pre-activation never
reaches device memory. Ragged M, N and K are masked.

The source is compiled with ``nvcc`` at first CUDA use into
``tpu_pod_exporter_torch/_build/`` (file name keyed by a hash of the source
and flags) and bound through ``ctypes`` to a plain C entry point.

:func:`tanh_matmul` takes :func:`tanh_matmul_plain` only for CPU tensors.
For CUDA tensors it launches the kernel or raises. ``tanh_matmul.launches``
counts kernel launches.
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

SOURCE = Path(__file__).resolve().parent / "csrc" / "tanh_matmul.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the log
)

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


def library_path() -> Path:
    """Where the shared library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtanh_matmul-{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernel unless the library for this source exists;
    return its path and nvcc's output ("" when it was already built).

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
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
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


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()[0]))
            fn = lib.tanh_matmul_bf16
            # Pointers and the stream as c_void_p: left to ctypes' default
            # they would pass as 32-bit ints and lose their high bits.
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
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


def tanh_matmul(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``tanh(h @ w)``: h (M,K) and w (K,N) bf16, contiguous; returns (M,N) bf16."""
    _check(h, w)
    if h.device.type == "cpu":
        return tanh_matmul_plain(h, w)
    if h.device.type != "cuda":
        raise ValueError(f"tanh_matmul runs on cuda or cpu, not {h.device}")
    m, k = h.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=torch.bfloat16, device=h.device)
    if y.numel() == 0:
        return y
    lib = _library()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.tanh_matmul_bf16(
            h.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k, stream
        )
    if err != 0:
        raise RuntimeError(f"tanh_matmul launch failed: CUDA error {err}")
    tanh_matmul.launches += 1
    return y


tanh_matmul.launches = 0
