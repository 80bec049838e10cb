"""The port on a CUDA card: the tanh_matmul kernel against its plain version
at ragged and misaligned shapes, the launch count, the backend reading the
allocator, and a small closed loop. Each test needs a CUDA device and skips
without one; on a machine with a card run

    python -m pytest tests/test_torch_cuda.py -q

This file imports no JAX, so it runs where only torch is installed.
"""

import pytest
import torch

from tpu_pod_exporter_torch.kernels import tanh_matmul as tm
from tpu_pod_exporter_torch.loadgen import workload as wl

# Two bf16 steps in [0.5, 1): the kernel and the plain version sum in f32 in
# other orders and take tanh in f32 (tanhf against torch.tanh), so a result
# may round to the neighbouring bf16 value.
LAYER_ATOL = 2.0**-7


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _operands(m, k, n, dev, offset=0, seed=0):
    """h (m,k) and w (k,n) bf16; ``offset`` elements shift h off 16-byte
    alignment while keeping it contiguous."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    if offset:
        buf = torch.empty((m * k + offset,), dtype=torch.bfloat16, device=dev)
        h = buf[offset:].view(m, k).copy_(h)
    w = (torch.randn((k, n), generator=g, device=dev) * max(k, 1) ** -0.5).to(torch.bfloat16)
    return h, w


@pytest.mark.parametrize("m,k,n,offset", [
    (1, 1, 1, 0),
    (17, 24, 40, 0),
    (128, 128, 128, 0),
    (130, 72, 200, 0),
    (257, 1000, 4095, 0),
    (64, 200, 136, 1),  # h not 16-byte aligned: element-wise staging
    (33, 7, 9, 0),      # K and N not multiples of 8
    (16, 0, 16, 0),     # empty sum: tanh(0) = 0
])
def test_kernel_matches_plain(dev, m, k, n, offset):
    h, w = _operands(m, k, n, dev, offset)
    before = tm.tanh_matmul.launches
    y = tm.tanh_matmul(h, w)
    torch.cuda.synchronize()
    assert tm.tanh_matmul.launches == before + 1
    assert y.shape == (m, n) and y.dtype == torch.bfloat16 and y.device == h.device
    err = (y.float() - tm.tanh_matmul_plain(h, w).float()).abs().max().item()
    assert err <= LAYER_ATOL, f"max_abs_err {err} > {LAYER_ATOL}"


def test_kernel_rejects_cuda_operands_it_does_not_take(dev):
    h, w = _operands(32, 64, 32, dev)
    before = tm.tanh_matmul.launches
    with pytest.raises(ValueError):
        tm.tanh_matmul(h.float(), w)
    with pytest.raises(ValueError):
        tm.tanh_matmul(h, w.t())
    with pytest.raises(ValueError):
        tm.tanh_matmul(h, w.cpu())
    assert tm.tanh_matmul.launches == before


def test_forward_launches_once_per_layer(dev):
    fn, (params, x) = wl.flagship(width=256, depth=3, batch=64, device=dev)
    plain = x
    for w in params["layers"]:
        plain = tm.tanh_matmul_plain(plain, w)
    before = tm.tanh_matmul.launches
    out = wl.burn_step(params, x, iters=1)
    torch.cuda.synchronize()
    assert tm.tanh_matmul.launches == before + 3
    err = (out.float() - plain.float()).abs().max().item()
    assert err <= 2.0**-4


def test_backend_reads_the_allocator(dev):
    from tpu_pod_exporter_torch.backend.torchdev import TorchCudaBackend

    backend = TorchCudaBackend()
    before = backend.sample().chips[0]
    held = wl.hbm_fill(256 << 20, device=dev)
    during = backend.sample().chips[0]
    assert during.hbm_used_bytes - before.hbm_used_bytes >= 256 << 20
    assert during.hbm_total_bytes > during.hbm_used_bytes
    assert during.info.device_ids[0].startswith("GPU-")
    assert during.info.device_kind == torch.cuda.get_device_name(0)
    del held


def test_small_closed_loop(dev):
    from tpu_pod_exporter_torch.hwcheck import TorchStimulus, run_check

    stim = TorchStimulus(hbm_bytes=512 << 20, width=512, depth=2, batch=128,
                         iters=4, device=dev)
    before = tm.tanh_matmul.launches
    report = run_check(backend="torch", idle_s=0.5, load_s=1.5, stimulus=stim)
    assert report["ok"] is True, report
    assert report["family"] == "gpu"
    assert tm.tanh_matmul.launches > before
