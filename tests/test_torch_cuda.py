"""The port on a CUDA card: both tanh_matmul kernels (wgmma for shapes TMA
can address, wmma for the rest) against the plain version at ragged and
misaligned shapes, which kernel each shape launched, the SGD update kernel
against its plain version bit for bit, the gradient through the kernels,
a training step on one card, ring attention's running-softmax kernel
against its plain version at its edge cases, the ring program on one card
against plain attention, the backend reading the allocator, a small
closed loop, the NVML binding against torch, the card's memory and
this process's device node, the torch and NVML backends naming one node for
one card, and the port's native library built and loaded there. Every test
carries the ``gpu``
marker, needs a CUDA device and skips without one; on a machine with a card
run

    python -m pytest -m gpu tests/test_torch_cuda.py -q

This file imports no JAX, so it runs where only torch is installed.
"""

import pytest
import torch

from tpu_pod_exporter_torch.kernels import online_softmax as osm
from tpu_pod_exporter_torch.kernels import sgd
from tpu_pod_exporter_torch.kernels import tanh_matmul as tm
from tpu_pod_exporter_torch.loadgen import parallel
from tpu_pod_exporter_torch.loadgen import sharded
from tpu_pod_exporter_torch.loadgen import workload as wl

pytestmark = pytest.mark.gpu

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


@pytest.mark.parametrize("m,k,n,offset,kernel", [
    (1, 1, 1, 0, "wmma"),
    (17, 24, 40, 0, "wgmma"),
    (128, 128, 128, 0, "wgmma"),
    (130, 72, 200, 0, "wgmma"),
    (32, 128, 128, 0, "wgmma"),
    (257, 1000, 4096, 0, "wgmma"),  # ragged M and K tiles
    (1, 64, 8, 0, "wgmma"),         # one row; N and K inside one tile
    (300, 136, 264, 0, "wgmma"),    # ragged M, N and K; a W box wholly past N
    (257, 1000, 4095, 0, "wmma"),   # N not a multiple of 8
    (64, 200, 136, 1, "wmma"),      # h not 16-byte aligned: element-wise staging
    (300, 136, 264, 1, "wmma"),
    (33, 7, 9, 0, "wmma"),          # K and N not multiples of 8
    (16, 0, 16, 0, "wmma"),         # empty sum: tanh(0) = 0
])
def test_kernel_matches_plain(dev, m, k, n, offset, kernel):
    h, w = _operands(m, k, n, dev, offset)
    before = tm.tanh_matmul.launches
    by_kernel = dict(tm.tanh_matmul.launches_by_kernel)
    y = tm.tanh_matmul(h, w)
    torch.cuda.synchronize()
    assert tm.tanh_matmul.launches == before + 1
    assert tm.tanh_matmul.launches_by_kernel == {
        name: count + (name == kernel) for name, count in by_kernel.items()}
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


def test_chain_goes_through_wgmma_only(dev):
    fn, (params, x) = wl.flagship(width=256, depth=3, batch=64, device=dev)
    by_kernel = dict(tm.tanh_matmul.launches_by_kernel)
    out = fn(params, x)
    torch.cuda.synchronize()
    assert tm.tanh_matmul.launches_by_kernel == {
        "wgmma": by_kernel["wgmma"] + 3, "wmma": by_kernel["wmma"]}
    assert torch.isfinite(out.float()).all()


def test_wgmma_launches_from_a_new_thread(dev):
    # The burn runs in its own thread, where cached allocations leave no
    # CUDA context current until the kernel's entry makes one so.
    import threading

    h, w = _operands(64, 128, 256, dev)
    want = tm.tanh_matmul(h, w)
    out: dict = {}

    def run():
        try:
            out["y"] = tm.tanh_matmul(h, w)
        except Exception as e:  # noqa: BLE001 - reported below
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert "error" not in out, out.get("error")
    torch.cuda.synchronize()
    assert torch.equal(out["y"], want)


def _misaligned(t, offset):
    """A contiguous copy of 1-D ``t`` starting ``offset`` elements into a buffer."""
    buf = torch.empty((t.numel() + offset,), dtype=t.dtype, device=t.device)
    return buf[offset:].copy_(t)


@pytest.mark.parametrize("n,p_offset,g_offset", [
    (1, 0, 0), (7, 0, 0), (8, 0, 0), (4097, 0, 0),  # vector body and scalar tail
    (4096, 1, 0),      # p off 16-byte alignment: element by element
    (4097, 3, 3),      # both off by the same amount
    (1 << 20, 0, 1),   # g off alignment
    (3_000_017, 0, 0),  # more chunks than the grid has threads
])
@pytest.mark.parametrize("lr", [1e-2, 0.1])
def test_sgd_update_matches_plain_bit_for_bit(dev, n, p_offset, g_offset, lr):
    gen = torch.Generator(device=dev).manual_seed(n)
    p = torch.randn((n,), generator=gen, device=dev).to(torch.bfloat16)
    g = (0.05 * torch.randn((n,), generator=gen, device=dev)).to(torch.bfloat16)
    want = sgd.sgd_update_plain(p.clone(), g, lr)
    p, g = _misaligned(p, p_offset), _misaligned(g, g_offset)
    before = sgd.sgd_update_.launches
    assert sgd.sgd_update_(p, g, lr) is p
    torch.cuda.synchronize()
    assert sgd.sgd_update_.launches == before + 1
    assert torch.equal(p, want)


def test_sgd_update_rejects_and_skips_empty(dev):
    p = torch.zeros((8,), dtype=torch.bfloat16, device=dev)
    before = sgd.sgd_update_.launches
    with pytest.raises(ValueError):
        sgd.sgd_update_(p, p.cpu(), 1e-2)
    with pytest.raises(ValueError):
        sgd.sgd_update_(p, p.float(), 1e-2)
    empty = p[:0]
    assert sgd.sgd_update_(empty, empty.clone(), 1e-2) is empty
    assert sgd.sgd_update_.launches == before


# The gradient through the kernels against the gradient through the plain
# chain (f32 products, f32 tanh, as JAX's): the kernels' backward takes
# 1 - y**2 from the bf16 y, which puts the two under 1% of max|grad| apart.
GRAD_RTOL = 2.0**-6


def _grads(layers, x, y, layer_fn):
    layers = layers.detach().clone().requires_grad_()
    h = x
    for w in layers.unbind(0):
        h = layer_fn(h, w)
    loss = torch.mean((h.float() - y.float()) ** 2)
    loss.backward()
    return loss.detach(), layers.grad


def test_gradient_through_wgmma_matches_plain_chain(dev):
    params = wl.init_params(width=512, depth=3, seed=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((128, 512), generator=gen, device=dev).to(torch.bfloat16)
    y = torch.zeros_like(x)
    by_kernel = dict(tm.tanh_matmul.launches_by_kernel)
    loss, grad = _grads(params["layers"], x, y, tm.tanh_matmul)
    assert tm.tanh_matmul.launches_by_kernel["wgmma"] == by_kernel["wgmma"] + 3
    ref_loss, ref = _grads(params["layers"], x, y, tm.tanh_matmul_plain)
    torch.cuda.synchronize()
    assert grad.dtype == torch.bfloat16 and grad.device == x.device
    assert abs(loss.item() - ref_loss.item()) <= 1e-2 * ref_loss.item()
    rel = ((grad.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    assert rel <= GRAD_RTOL, f"max|dgrad| / max|grad| = {rel}"


def test_backward_from_a_new_thread(dev):
    import threading

    params = wl.init_params(width=256, depth=2, seed=3, device=dev)
    x = torch.ones((64, 256), dtype=torch.bfloat16, device=dev)
    want = _grads(params["layers"], x, torch.zeros_like(x), tm.tanh_matmul)[1]
    out: dict = {}

    def run():
        try:
            out["grad"] = _grads(params["layers"], x, torch.zeros_like(x), tm.tanh_matmul)[1]
        except Exception as e:  # noqa: BLE001 - reported below
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and "error" not in out, out.get("error")
    torch.cuda.synchronize()
    assert torch.equal(out["grad"], want)


def test_f32_product_of_bf16_operands(dev):
    # A group of more than one rank sums its partial products in f32; on
    # the card they come from torch.mm's out_dtype.
    gen = torch.Generator(device=dev).manual_seed(4)
    a = torch.randn((64, 96), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((96, 48), generator=gen, device=dev).to(torch.bfloat16)
    got = sharded._f32_product(a.t().contiguous().t(), b)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, a.float() @ b.float(), rtol=1e-5, atol=1e-4)


def test_sharded_step_descends_on_one_card(dev):
    import torch.distributed as dist

    try:
        step, params, (x, y) = sharded.sharded_train_step(
            sharded.make_mesh(1), width=64, depth=2, batch=16)
        assert params["layers"].device == x.device == dev
        launches = sgd.sgd_update_.launches
        losses = []
        for _ in range(5):
            params, loss = step(params, x, y)
            losses.append(loss.item())
    finally:
        dist.destroy_process_group()
    assert sgd.sgd_update_.launches == launches + 5
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


# The running-softmax kernel against its plain version: m is a max of the
# same f32 quotients (true division by the same correctly rounded sqrt), so
# it is equal; p and l differ by expf against torch.exp and the order of the
# row sum, a few f32 ulps; o is scaled by the same corr.
SOFTMAX_RTOL = 1e-5
SOFTMAX_ATOL = 1e-30  # below any p that matters; p underflows near 1e-38


def _softmax_case(dev, tq, tkv, dv, d, first, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = scale * torch.randn((tq, tkv), generator=g, device=dev)
    o = torch.randn((tq, dv), generator=g, device=dev)
    if first:
        m = torch.full((tq,), float("-inf"), device=dev)
        l = torch.zeros((tq,), device=dev)
    else:
        m = torch.randn((tq,), generator=g, device=dev)
        l = torch.rand((tq,), generator=g, device=dev) + 0.5
    return r, m, l, o, d


@pytest.mark.parametrize("tq,tkv,dv,d,first,scale", [
    (64, 256, 64, 64, True, 1.0),       # the first step: m = -inf, l = 0
    (64, 256, 64, 64, False, 1.0),      # a later step
    (1, 4096, 8192, 8192, False, 1.0),  # Tq = 1
    (33, 1, 16, 16, True, 1.0),         # Tkv = 1
    (17, 1000, 48, 16, False, 1.0),     # Tkv not a multiple of the block
    (40, 4097, 24, 4, True, 900.0),     # scores scaled 30x30, as the stability check
    (8, 20000, 32, 64, False, 1.0),     # a row past 48 KiB of shared memory
])
def test_online_softmax_matches_plain(dev, tq, tkv, dv, d, first, scale):
    args = _softmax_case(dev, tq, tkv, dv, d, first, scale)
    want = [t.clone() for t in args[:4]]
    osm.online_softmax_update_plain(*want, d)
    before = osm.online_softmax_update_.launches
    got = args[:4]
    assert osm.online_softmax_update_(*got, d) is got[0]
    torch.cuda.synchronize()
    assert osm.online_softmax_update_.launches == before + 1
    assert torch.equal(got[1], want[1])  # m
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=SOFTMAX_RTOL, atol=SOFTMAX_ATOL)


def test_online_softmax_rejects_and_skips_empty(dev):
    r, m, l, o, d = _softmax_case(dev, 4, 8, 8, 8, True)
    before = osm.online_softmax_update_.launches
    with pytest.raises(ValueError):
        osm.online_softmax_update_(r.double(), m, l, o, d)
    with pytest.raises(ValueError):
        osm.online_softmax_update_(r, m.cpu(), l, o, d)
    with pytest.raises(ValueError):
        osm.online_softmax_update_(r.t(), m, l, o, d)
    with pytest.raises(ValueError):
        osm.online_softmax_update_(r.new_empty((4, osm.MAX_TKV + 1)), m, l, o, d)
    empty = r[:0]
    assert osm.online_softmax_update_(empty, m[:0], l[:0], o[:0], d) is empty
    assert osm.online_softmax_update_.launches == before


def test_ring_program_on_one_card_matches_plain_attention(dev):
    import torch.distributed as dist

    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((256, 64), generator=gen, device=dev) for _ in range(3))
    try:
        fn, shard = parallel.ring_attention_fn(parallel.make_1d_mesh(1, "seq"))
        before = osm.online_softmax_update_.launches
        out = fn(shard(q), shard(k), shard(v))
    finally:
        dist.destroy_process_group()
    torch.cuda.synchronize()
    assert osm.online_softmax_update_.launches == before + 1
    torch.testing.assert_close(out, parallel.reference_attention(q, k, v),
                               rtol=2e-5, atol=2e-5)


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


def _nvml_card(dev):
    """(ctypes driver, handle) of the card torch calls ``dev``, by UUID."""
    from tpu_pod_exporter_torch.backend.nvml_ctypes import CtypesNvmlDriver
    from tpu_pod_exporter_torch.backend.torchdev import _nvml_uuid

    driver = CtypesNvmlDriver()
    driver.nvmlInit()
    uuid = _nvml_uuid(torch.cuda.get_device_properties(dev).uuid)
    handles = [driver.nvmlDeviceGetHandleByIndex(i)
               for i in range(driver.nvmlDeviceGetCount())]
    (handle,) = [h for h in handles if driver.nvmlDeviceGetUUID(h) == uuid]
    return driver, handle


def test_nvml_binding_agrees_with_torch(dev):
    driver, handle = _nvml_card(dev)
    try:
        assert driver.nvmlDeviceGetName(handle) == torch.cuda.get_device_name(dev)
        total = driver.nvmlDeviceGetMemoryInfo(handle)["total"]
        assert abs(total - torch.cuda.mem_get_info(dev)[1]) <= 1 << 30
        assert 0 <= driver.nvmlDeviceGetUtilizationRates(handle)["gpu"] <= 100
    finally:
        driver.nvmlShutdown()


def test_nvml_sees_a_gib_allocation_and_its_release(dev):
    driver, handle = _nvml_card(dev)
    try:
        torch.cuda.empty_cache()
        torch.cuda.synchronize(dev)
        before = driver.nvmlDeviceGetMemoryInfo(handle)["used"]
        held = torch.ones(1 << 30, dtype=torch.uint8, device=dev)
        torch.cuda.synchronize(dev)
        during = driver.nvmlDeviceGetMemoryInfo(handle)["used"]
        rows = driver.nvmlDeviceGetComputeRunningProcesses(handle)
        del held
        torch.cuda.empty_cache()
        after = driver.nvmlDeviceGetMemoryInfo(handle)["used"]
    finally:
        driver.nvmlShutdown()
    assert during - before >= 1 << 30
    assert after < during
    assert sum(r["usedGpuMemory"] or 0 for r in rows) >= 1 << 30


def test_this_process_holds_the_minor_node(dev):
    import os

    from tpu_pod_exporter_torch.app import build_backend
    from tpu_pod_exporter_torch.config import ExporterConfig
    from tpu_pod_exporter_torch.procscan import GPU_DEVICE_PREFIXES, ProcScanner

    driver, handle = _nvml_card(dev)
    try:
        node = f"/dev/nvidia{driver.nvmlDeviceGetMinorNumber(handle)}"
        uuid = driver.nvmlDeviceGetUUID(handle)
    finally:
        driver.nvmlShutdown()
    torch.ones(1, device=dev)  # the context holds the node from here on
    links = {os.readlink(f"/proc/self/fd/{fd}") for fd in os.listdir("/proc/self/fd")
             if os.path.islink(f"/proc/self/fd/{fd}")}
    assert node in links
    holders = ProcScanner(device_prefixes=GPU_DEVICE_PREFIXES).scan()
    assert (os.getpid(), node) in {(h.pid, h.device_path) for h in holders}
    backend = build_backend(ExporterConfig(backend="auto"))
    try:
        assert backend.name == "nvml"
        chips = {c.info.device_ids[0]: c for c in backend.sample().chips}
        assert chips[uuid].info.device_path == node
    finally:
        backend.close()


def test_torch_and_nvml_backends_name_one_node(dev):
    from tpu_pod_exporter_torch.backend.nvml import NvmlBackend
    from tpu_pod_exporter_torch.backend.torchdev import TorchCudaBackend

    driver, handle = _nvml_card(dev)
    try:
        node = f"/dev/nvidia{driver.nvmlDeviceGetMinorNumber(handle)}"
    finally:
        driver.nvmlShutdown()
    torch_chips = {c.info.device_ids[0]: c.info.device_path
                   for c in TorchCudaBackend().sample().chips}
    nvml = NvmlBackend()
    try:
        nvml_chips = {c.info.device_ids[0]: c.info.device_path
                      for c in nvml.sample().chips}
    finally:
        nvml.close()
    assert set(torch_chips) <= set(nvml_chips)
    for uuid, path in torch_chips.items():
        assert path == nvml_chips[uuid]
    (uuid,) = [u for u, p in nvml_chips.items() if p == node]
    assert torch_chips[uuid] == node


def test_native_library_builds_and_loads(dev, tmp_path):
    import os

    from tpu_pod_exporter_torch import nativelib
    from tpu_pod_exporter_torch.metrics import native
    from tpu_pod_exporter_torch.procscan import GPU_DEVICE_PREFIXES, ProcScanner

    nativelib.reset_for_tests()
    lib = native.load()
    assert lib is not None
    assert lib._name == str(nativelib.library_path())
    assert native.render_lines([b'm{a="1"}', b"m"], [1.0, 2.5]) == b'm{a="1"} 1\nm 2.5\n'
    torch.ones(1, device=dev)  # the context holds the card's node from here on
    scanner = ProcScanner(device_prefixes=GPU_DEVICE_PREFIXES)
    native_walk = scanner._native_full_scan()
    assert native_walk is not None
    mine = native_walk.get(os.getpid(), ())
    assert mine == scanner._python_full_scan().get(os.getpid(), ())
    assert mine and all(h.device_path.startswith("/dev/nvidia") for h in mine)


def test_flat_aggregator_folds_the_card_as_gpu_chips(dev):
    from tpu_pod_exporter_torch.aggregate import SliceAggregator
    from tpu_pod_exporter_torch.app import ExporterApp
    from tpu_pod_exporter_torch.config import ExporterConfig
    from tpu_pod_exporter_torch.metrics import SnapshotStore
    from tpu_pod_exporter_torch.metrics.parse import parse_exposition

    driver, _ = _nvml_card(dev)
    try:
        count = driver.nvmlDeviceGetCount()
        total = sum(driver.nvmlDeviceGetMemoryInfo(driver.nvmlDeviceGetHandleByIndex(i))["total"]
                    for i in range(count))
    finally:
        driver.nvmlShutdown()
    app = ExporterApp(ExporterConfig(port=0, host="127.0.0.1", backend="nvml",
                                     attribution="none", slice_name="h100-pool",
                                     node_name="node-0", interval_s=0.5))
    app.start()
    try:
        store = SnapshotStore()
        agg = SliceAggregator((f"127.0.0.1:{app.port}",), store)
        try:
            agg.poll_once()
        finally:
            agg.close()
    finally:
        app.stop()
    rows = {(s.name, s.labels.get("slice_name"), s.labels.get("family")): s.value
            for s in parse_exposition(store.current().encode().decode())
            if s.name.startswith("tpu_slice_")}
    assert rows[("tpu_slice_chip_count", "h100-pool", "gpu")] == count
    assert rows[("tpu_slice_hbm_total_bytes", "h100-pool", "gpu")] == total
    assert rows[("tpu_slice_hosts_reporting", "h100-pool", "gpu")] == 1
    assert {family for _, _, family in rows} == {"gpu"}
