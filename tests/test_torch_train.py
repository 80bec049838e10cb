"""The port's training path held against the JAX package on the CPU: the
gradient of ``loss_fn`` through ``tanh_matmul``'s autograd Function, the
SGD update, the single-device step, the load CLI and ``entry.py``.

The same numpy inputs go into both programs. Tolerances:

- gradients: 2**-6 of max|grad_jax|. The port's backward takes
  ``1 - y**2`` from the bf16 layer output ``y``; JAX keeps the f32
  ``tanh`` and takes the gradient of the activation in f32. That puts the
  two 0.7-0.8% of max|grad| apart at these shapes (recorded as
  ``rel_err``).
- the update: bit for bit against JAX's update run op by op (its jaxpr:
  ``lr`` rounded to bf16, ``lr * g`` rounded to bf16, then the f32
  difference rounded to bf16).
- the step: losses within 1e-3 relative over 5 steps; parameters after one
  step equal or one bf16 step apart.
"""

import re

import numpy as np
import pytest
import torch

from tests.conftest import require_jax
from tpu_pod_exporter_torch.kernels import sgd
from tpu_pod_exporter_torch.kernels import tanh_matmul as tm
from tpu_pod_exporter_torch.loadgen import sharded as ts
from tpu_pod_exporter_torch.loadgen import workload as twl
from tpu_pod_exporter_torch.loadgen.__main__ import main as cli

GRAD_RTOL = 2.0**-6
LOSS_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _needs_jax():
    require_jax()


def bf16_steps_apart(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """How many bf16 values lie between a and b (0: equal), element-wise."""
    def key(v):
        bits = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
        bits = bits.to(torch.bfloat16).view(torch.int16).int()
        # Order the sign-magnitude patterns as the values they stand for.
        return torch.where(bits < 0, -32768 - bits, bits)
    return (key(a) - key(b)).abs().numpy()


def bf16_spacing(v: np.ndarray) -> np.ndarray:
    """The distance from |v| to the next bf16 value above it (normal range)."""
    exponent = np.floor(np.log2(np.maximum(np.abs(v), np.float32(2.0**-126))))
    return np.exp2(exponent - 7).astype(np.float32)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(torch.bfloat16)


def _case(width, depth, batch, seed=0):
    """JAX and torch copies of the same bf16 weights, input and target."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    w = rng.standard_normal((depth, width, width), dtype=np.float32)
    w *= np.float32((2.0 / width) ** 0.5)
    x = rng.standard_normal((batch, width), dtype=np.float32)
    y = 0.5 * rng.standard_normal((batch, width), dtype=np.float32)
    jax_args = ({"layers": jnp.asarray(w).astype(jnp.bfloat16)},
                jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(y).astype(jnp.bfloat16))
    torch_args = (twl.params_from_jax({"layers": np.asarray(jax_args[0]["layers"])},
                                      device="cpu"),
                  _bf16(jax_args[1]), _bf16(jax_args[2]))
    return jax_args, torch_args


class TestGradient:
    @pytest.mark.parametrize("width,depth,batch", [(64, 2, 16), (128, 4, 32), (256, 4, 64)])
    def test_loss_fn_gradient_matches_jax(self, width, depth, batch, record_property):
        import jax

        from tpu_pod_exporter.loadgen import workload as jwl

        jax_args, (params, x, y) = _case(width, depth, batch)
        want_loss, want = jax.value_and_grad(jwl.loss_fn)(*jax_args)
        want = np.asarray(want["layers"]).astype(np.float32)
        layers = params["layers"].requires_grad_()
        loss = twl.loss_fn({"layers": layers}, x, y)
        loss.backward()
        assert layers.grad.dtype == torch.bfloat16
        assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
        rel = float(np.abs(layers.grad.float().numpy() - want).max() / np.abs(want).max())
        record_property("rel_err", rel)
        assert rel <= GRAD_RTOL, f"max|dgrad| / max|grad| = {rel} > {GRAD_RTOL}"

    def test_backward_is_the_bf16_formula(self):
        g = torch.Generator().manual_seed(0)
        h = torch.randn((9, 24), generator=g).to(torch.bfloat16).requires_grad_()
        w = torch.randn((24, 16), generator=g).mul(0.2).to(torch.bfloat16).requires_grad_()
        dy = torch.randn((9, 16), generator=g).to(torch.bfloat16)
        y = tm.tanh_matmul(h, w)
        y.backward(dy)
        gy = (dy.float() * (1 - y.float() ** 2)).to(torch.bfloat16)
        assert torch.equal(h.grad, gy @ w.detach().t())
        assert torch.equal(w.grad, h.detach().t() @ gy)

    def test_forward_without_grad_and_cpu_launches_nothing(self):
        before = (tm.tanh_matmul.launches, dict(tm.tanh_matmul.launches_by_kernel))
        h = torch.ones((4, 8), dtype=torch.bfloat16)
        w = torch.ones((8, 8), dtype=torch.bfloat16, requires_grad=True)
        out = tm.tanh_matmul(h, w)
        assert out.requires_grad and out.grad_fn is not None
        out.sum().backward()
        assert h.grad is None and w.grad.shape == (8, 8)
        assert tm.tanh_matmul(h, w.detach()).grad_fn is None
        assert (tm.tanh_matmul.launches, tm.tanh_matmul.launches_by_kernel) == before


def _jax_update(p, g, lr, jit: bool):
    """The JAX step's update, ``sharded.py``'s tree_map, op by op or jitted."""
    import jax
    import jax.numpy as jnp

    def update(params, grads):
        return jax.tree_util.tree_map(
            lambda p, g: (p.astype(jnp.float32) - lr * g).astype(p.dtype), params, grads)

    fn = jax.jit(update) if jit else update
    out = fn({"layers": jnp.asarray(p).astype(jnp.bfloat16)},
             {"layers": jnp.asarray(g).astype(jnp.bfloat16)})
    return np.asarray(out["layers"]).astype(np.float32)


def _update_case(n=50_000, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n, dtype=np.float32)
    g = 0.05 * rng.standard_normal(n, dtype=np.float32)
    return p, g


class TestUpdate:
    @pytest.mark.parametrize("lr", [1e-2, 0.1])
    def test_plain_update_is_jaxs_bit_for_bit(self, lr):
        p, g = _update_case()
        got = sgd.sgd_update_plain(_bf16(p), _bf16(g), lr)
        np.testing.assert_array_equal(got.float().numpy(), _jax_update(p, g, lr, jit=False))

    @pytest.mark.parametrize("lr", [1e-2, 0.1])
    def test_compiled_jax_update_differs_by_the_rounding_of_lr_g(self, lr, record_property):
        # XLA's compiled update (the JAX step is jitted) keeps lr * g in f32
        # (excess precision) where the jaxpr rounds it to bf16. So on a few
        # elements the two differ: by one bf16 step of the result, or, where
        # p and lr * g nearly cancel, by at most half a bf16 step of lr * g.
        p, g = _update_case()
        got = sgd.sgd_update_plain(_bf16(p), _bf16(g), lr).float().numpy()
        want = _jax_update(p, g, lr, jit=True)
        apart = bf16_steps_apart(got, want)
        lr_g = _bf16(g).float().numpy() * sgd.bf16_lr(lr)
        record_property("share_differing", float((apart > 0).mean()))
        assert (apart > 0).mean() < 0.02
        assert ((apart <= 1) | (np.abs(got - want) <= bf16_spacing(lr_g) / 2)).all()

    def test_lr_is_rounded_to_bf16(self):
        assert sgd.bf16_lr(1e-2) == 0.010009765625
        assert sgd.bf16_lr(0.1) == 0.10009765625

    def test_wrapper_updates_in_place_and_counts_no_launch_on_cpu(self):
        p, g = _update_case(n=4097)
        tp, tg = _bf16(p), _bf16(g)
        want = sgd.sgd_update_plain(tp.clone(), tg, 1e-2)
        before = sgd.sgd_update_.launches
        assert sgd.sgd_update_(tp, tg, 1e-2) is tp
        assert torch.equal(tp, want)
        assert sgd.sgd_update_.launches == before

    @pytest.mark.parametrize("p,g", [
        (torch.ones(8), torch.ones(8)),  # f32, not bf16
        (torch.ones(8, dtype=torch.bfloat16), torch.ones(9, dtype=torch.bfloat16)),
        (torch.ones(4, 2, dtype=torch.bfloat16).t(), torch.ones(2, 4, dtype=torch.bfloat16)),
        (torch.ones(8, dtype=torch.bfloat16),
         torch.ones(8, dtype=torch.bfloat16, device="meta")),
        (torch.ones(8, dtype=torch.bfloat16, device="meta"),
         torch.ones(8, dtype=torch.bfloat16, device="meta")),
    ])
    def test_rejects_what_the_kernel_does_not_take(self, p, g):
        before = sgd.sgd_update_.launches
        with pytest.raises(ValueError):
            sgd.sgd_update_(p, g, 1e-2)
        assert sgd.sgd_update_.launches == before


def _jax_steps(n, dp=None, tp=None, width=64, depth=2, batch=16, steps=5):
    """(initial layers, losses, layers after each step) of the JAX step on
    an n-device mesh of the virtual CPU devices."""
    from tpu_pod_exporter.loadgen import sharded as js

    step, params, (x, y) = js.sharded_train_step(
        js.make_mesh(n, dp=dp, tp=tp), width=width, depth=depth, batch=batch)
    first = np.asarray(params["layers"]).astype(np.float32)
    losses, after = [], []
    for _ in range(steps):
        params, loss = step(params, x, y)
        losses.append(float(loss))
        after.append(np.asarray(params["layers"]).astype(np.float32))
    return first, losses, after


def check_step_matches(want_losses, want_after, losses, after_one):
    rel = max(abs(a - b) / abs(a) for a, b in zip(want_losses, losses))
    assert len(losses) == len(want_losses) and rel <= LOSS_RTOL, (want_losses, losses)
    assert after_one.shape == want_after[0].shape
    assert bf16_steps_apart(after_one, want_after[0]).max() <= 1


class TestDenseStep:
    def test_world_of_one_matches_jax_on_a_1x1_mesh(self):
        first, want_losses, want_after = _jax_steps(1)
        mesh = ts.make_mesh(1, device="cpu")
        assert (mesh.size(0), mesh.size(1)) == (1, 1)
        step, params, (x, y) = ts.sharded_train_step(
            mesh, 64, 2, 16, params=twl.params_from_jax({"layers": first}, device="cpu"))
        losses, after = [], []
        for _ in range(5):
            params, loss = step(params, x, y)
            assert loss.dtype == torch.float32 and loss.dim() == 0
            losses.append(float(loss))
            after.append(params["layers"].float().numpy().copy())
        check_step_matches(want_losses, want_after, losses, after[0])

    def test_step_updates_params_in_place_with_one_sgd_call(self, monkeypatch):
        calls = []
        real = ts.sgd_update_
        monkeypatch.setattr(ts, "sgd_update_",
                            lambda p, g, lr: calls.append((p, g.shape, lr)) or real(p, g, lr))
        step, params, (x, y) = ts.sharded_train_step(ts.make_mesh(1, device="cpu"), 32, 3, 8)
        layers = params["layers"]
        before = layers.clone()
        params2, _ = step(params, x, y)
        assert params2["layers"] is layers and not torch.equal(layers, before)
        assert len(calls) == 1 and calls[0][0] is layers
        assert calls[0][1] == (3, 32, 32) and calls[0][2] == 1e-2


class TestCli:
    def test_burn_on_cpu(self, capsys):
        assert cli(["--mode", "burn", "--device", "cpu", "--width", "32", "--depth", "2",
                    "--batch", "4", "--iters", "2", "--seconds", "0.2"]) == 0
        assert "TFLOP/s" in capsys.readouterr().out

    def test_hbm_on_cpu(self, capsys):
        assert cli(["--mode", "hbm", "--device", "cpu", "--gib", "0.001",
                    "--seconds", "0.1"]) == 0
        assert capsys.readouterr().out.startswith("holding 0.00 GiB on cpu")

    @pytest.mark.parametrize("devices,mesh", [
        ("1", "{'data': 1, 'model': 1}"),
        ("4", "{'data': 2, 'model': 2}"),  # a gloo world of four ranks
    ])
    def test_sharded_on_cpu(self, capsys, devices, mesh):
        assert cli(["--mode", "sharded", "--device", "cpu", "--devices", devices,
                    "--width", "32", "--depth", "2", "--batch", "8", "--seconds", "0.3"]) == 0
        out = capsys.readouterr().out
        assert out.startswith(f"mesh {mesh} | ") and "| loss " in out

    @pytest.mark.parametrize("program,devices", [
        ("ring", "1"),
        ("fsdp", "2"),  # a gloo world of two ranks
    ])
    def test_parallel_on_cpu(self, capsys, program, devices):
        assert cli(["--mode", "parallel", "--device", "cpu", "--program", program,
                    "--devices", devices, "--seconds", "0.3"]) == 0
        out = capsys.readouterr().out
        assert re.fullmatch(rf"{program} x1 on {devices} devices: \d+ steps in [\d.]+s "
                            r"→ [\d.]+ steps/s\n", out), out

    def test_program_names_are_the_jax_packages(self):
        from tpu_pod_exporter.loadgen.parallel import PARALLEL_PROGRAMS
        from tpu_pod_exporter_torch.loadgen.__main__ import PARALLEL_PROGRAMS as ours

        assert ours == PARALLEL_PROGRAMS

    @pytest.mark.parametrize("mode", ["burn", "hbm", "sharded", "parallel"])
    def test_raises_without_cuda_unless_asked_for_cpu(self, monkeypatch, mode):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli(["--mode", mode, "--seconds", "0"])


class TestEntry:
    def test_entry_matches_graft_entry_on_jax_weights(self):
        import __graft_entry__ as ge
        from tpu_pod_exporter_torch.entry import entry

        jfn, (jparams, jx) = ge.entry()
        fn, (params, x) = entry(device="cpu")
        assert params["layers"].shape == (4, 128, 128)
        assert torch.equal(x, _bf16(np.asarray(jx)))
        out = fn(twl.params_from_jax({"layers": np.asarray(jparams["layers"])},
                                     device="cpu"), x)
        assert out.shape == (32, 128)
        np.testing.assert_array_equal(out.float().numpy(),
                                      np.asarray(jfn(jparams, jx)).astype(np.float32))

    def test_entry_defaults_to_cuda(self, monkeypatch):
        from tpu_pod_exporter_torch.entry import entry

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
