"""The port's workload and its kernel wrapper, held against the JAX package
on the CPU (mirrors tests/test_loadgen.py::TestWorkload).

The same numpy weights and inputs go through
``tpu_pod_exporter.loadgen.workload`` (XLA on the CPU) and
``tpu_pod_exporter_torch.loadgen.workload`` (the kernel's plain version on
the CPU). Both take bf16 products in f32 and round to bf16 once a layer;
the sums may be taken in other orders, so a result may land one bf16 step
away. The tolerance is two bf16 steps in [0.5, 1): 2**-7.
"""

import numpy as np
import pytest
import torch

from tests.conftest import require_jax
from tpu_pod_exporter_torch.kernels import tanh_matmul as tm
from tpu_pod_exporter_torch.loadgen import workload as twl

BF16_ATOL = 2.0**-7


@pytest.fixture(autouse=True)
def _needs_jax():
    require_jax()


def _numpy_case(width: int, depth: int, batch: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((depth, width, width), dtype=np.float32)
    x = rng.standard_normal((batch, width), dtype=np.float32)
    return w * np.float32((2.0 / width) ** 0.5), x


def _both(width: int, depth: int, batch: int):
    """(jax params, jax x, torch params, torch x) from the same numpy arrays."""
    import jax.numpy as jnp

    w, x = _numpy_case(width, depth, batch)
    jp = {"layers": jnp.asarray(w).astype(jnp.bfloat16)}
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tp = twl.params_from_jax({"layers": np.asarray(jp["layers"])}, device="cpu")
    tx = torch.from_numpy(np.asarray(jx).astype(np.float32)).to(torch.bfloat16)
    return jp, jx, tp, tx


class TestParityWithJax:
    @pytest.mark.parametrize("width,depth,batch", [
        (128, 4, 32),  # the entry() shape
        (96, 4, 32),
        (96, 4, 17),
        (90, 4, 17),   # a width that is not a multiple of 8: the staged route on a card
    ])
    def test_forward_matches_jax(self, width, depth, batch, record_property):
        from tpu_pod_exporter.loadgen import workload as jwl

        jp, jx, tp, tx = _both(width, depth, batch)
        want = np.asarray(jwl.forward(jp, jx)).astype(np.float32)
        got = twl.forward(tp, tx)
        assert got.dtype == torch.bfloat16
        assert tuple(got.shape) == (batch, width)
        err = float(np.abs(got.float().numpy() - want).max())
        record_property("max_abs_err", err)
        assert err <= BF16_ATOL, f"max_abs_err {err} > {BF16_ATOL}"

    def test_loss_fn_matches_jax_in_f32(self):
        import jax.numpy as jnp

        from tpu_pod_exporter.loadgen import workload as jwl

        jp, jx, tp, tx = _both(128, 4, 32)
        target = np.random.default_rng(1).standard_normal((32, 128), dtype=np.float32)
        want = float(jwl.loss_fn(jp, jx, jnp.asarray(target)))
        got = twl.loss_fn(tp, tx, torch.from_numpy(target))
        assert got.dtype == torch.float32
        # f32 means over 4096 terms summed in other orders.
        assert float(got) == pytest.approx(want, rel=1e-5)

    def test_params_from_jax_is_exact(self):
        from tpu_pod_exporter.loadgen import workload as jwl

        jp = jwl.init_params(width=64, depth=2, seed=3)
        tp = twl.params_from_jax({"layers": np.asarray(jp["layers"])}, device="cpu")
        assert tp["layers"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp["layers"].float().numpy(),
            np.asarray(jp["layers"]).astype(np.float32),
        )


class TestWorkload:
    def test_forward_is_deterministic(self):
        fn, (params, x) = twl.flagship(width=64, depth=2, batch=8, device="cpu")
        torch.testing.assert_close(fn(params, x), fn(params, x), rtol=0, atol=0)

    def test_init_params_is_seeded_and_scaled(self):
        a = twl.init_params(width=256, depth=3, seed=7, device="cpu")["layers"]
        b = twl.init_params(width=256, depth=3, seed=7, device="cpu")["layers"]
        c = twl.init_params(width=256, depth=3, seed=8, device="cpu")["layers"]
        assert a.shape == (3, 256, 256) and a.dtype == torch.bfloat16
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert float(a.float().std()) == pytest.approx((2.0 / 256) ** 0.5, rel=0.02)

    def test_flagship_input_is_ones(self):
        _, (params, x) = twl.flagship(width=32, depth=2, batch=4, device="cpu")
        assert params["layers"].shape == (2, 32, 32)
        assert torch.equal(x, torch.ones((4, 32), dtype=torch.bfloat16))

    def test_burn_step_is_three_chained_forwards(self):
        _, (params, x) = twl.flagship(width=64, depth=2, batch=8, device="cpu")
        want = twl.forward(params, twl.forward(params, twl.forward(params, x)))
        got = twl.burn_step(params, x, iters=3)
        assert got.shape == (8, 64)
        assert torch.equal(got, want)

    def test_hbm_fill_allocates(self):
        arr = twl.hbm_fill(1 << 20, device="cpu")
        assert arr.dtype == torch.bfloat16
        assert arr.numel() * arr.element_size() == 1 << 20
        assert not arr.any()

    def test_entry_points_default_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            twl.init_params(width=8, depth=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            twl.hbm_fill(1024)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            twl.flagship(width=8, depth=1, batch=2, device="cuda")


class TestTanhMatmulWrapper:
    def test_cpu_uses_plain_version_and_counts_no_launch(self):
        g = torch.Generator().manual_seed(0)
        h = torch.randn((33, 70), generator=g).to(torch.bfloat16)
        w = torch.randn((70, 19), generator=g).to(torch.bfloat16)
        before = tm.tanh_matmul.launches
        y = tm.tanh_matmul(h, w)
        assert tm.tanh_matmul.launches == before
        assert y.shape == (33, 19) and y.dtype == torch.bfloat16
        assert torch.equal(y, tm.tanh_matmul_plain(h, w))

    def test_plain_version_rounds_once(self):
        h = torch.tensor([[1.0, 2.0]], dtype=torch.bfloat16)
        w = torch.tensor([[0.25], [0.125]], dtype=torch.bfloat16)
        want = torch.tanh(torch.tensor([[0.5]])).to(torch.bfloat16)
        assert torch.equal(tm.tanh_matmul_plain(h, w), want)

    @pytest.mark.parametrize("h,w", [
        (torch.ones(4, 8), torch.ones(8, 4)),  # f32, not bf16
        (torch.ones(4, 8, dtype=torch.bfloat16), torch.ones(8, 4)),
        (torch.ones(2, 4, 8, dtype=torch.bfloat16),
         torch.ones(8, 4, dtype=torch.bfloat16)),  # rank 3
        (torch.ones(4, 8, dtype=torch.bfloat16),
         torch.ones(9, 4, dtype=torch.bfloat16)),  # inner dims differ
        (torch.ones(8, 4, dtype=torch.bfloat16).t(),
         torch.ones(8, 4, dtype=torch.bfloat16)),  # not contiguous
        (torch.ones(4, 8, dtype=torch.bfloat16),
         torch.ones(8, 4, dtype=torch.bfloat16, device="meta")),  # devices differ
        (torch.ones(4, 8, dtype=torch.bfloat16, device="meta"),
         torch.ones(8, 4, dtype=torch.bfloat16, device="meta")),  # neither cpu nor cuda
    ])
    def test_rejects_what_the_kernel_does_not_take(self, h, w):
        before = tm.tanh_matmul.launches
        with pytest.raises(ValueError):
            tm.tanh_matmul(h, w)
        assert tm.tanh_matmul.launches == before

    def test_library_path_is_keyed_by_source(self):
        path = tm.library_path()
        assert path.parent == tm.BUILD_DIR
        assert path.name.startswith("libtanh_matmul-") and path.suffix == ".so"
        assert tm.library_path() == path


class TestBuild:
    """The nvcc build, driven through a stand-in compiler, so that the build
    path is tested without a CUDA toolkit."""

    def _fake_nvcc(self, tmp_path, body: str) -> str:
        path = tmp_path / "nvcc"
        path.write_text("#!/bin/sh\n" + body)
        path.chmod(0o755)
        return str(path)

    def test_failed_build_raises_with_nvcc_output(self, tmp_path, monkeypatch):
        nvcc = self._fake_nvcc(tmp_path, 'echo "error: no such intrinsic" >&2\nexit 2\n')
        monkeypatch.setattr(tm, "find_nvcc", lambda: nvcc)
        monkeypatch.setattr(tm, "BUILD_DIR", tmp_path / "_build")
        with pytest.raises(RuntimeError, match="no such intrinsic"):
            tm.build()
        assert list((tmp_path / "_build").iterdir()) == []

    def test_build_runs_once_per_source(self, tmp_path, monkeypatch):
        calls = tmp_path / "calls"
        # Write the -o target, as nvcc does, and count the invocations.
        nvcc = self._fake_nvcc(tmp_path, (
            f'echo x >> "{calls}"\n'
            'while [ "$1" != "-o" ]; do shift; done\n'
            'echo lib > "$2"\n'
        ))
        monkeypatch.setattr(tm, "find_nvcc", lambda: nvcc)
        monkeypatch.setattr(tm, "BUILD_DIR", tmp_path / "_build")
        first, log = tm.build()
        assert first == tm.library_path() and first.read_text() == "lib\n"
        assert tm.build() == (first, "")
        assert calls.read_text().count("x") == 1
        assert [p.name for p in (tmp_path / "_build").iterdir()] == [first.name]

    def test_missing_nvcc_raises(self, monkeypatch):
        monkeypatch.delenv("CUDA_HOME", raising=False)
        monkeypatch.setattr(tm.shutil, "which", lambda name: None)
        monkeypatch.setattr(tm.os.path, "isfile", lambda path: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tm.find_nvcc()
