"""The port's dp x tp training step over worlds of rank processes, held
against the JAX package's step on a mesh of the same shape over the
conftest's virtual CPU devices (mirrors tests/test_loadgen.py::TestSharded).

Each world is a gloo world of child processes started by ``run_world``,
with a timeout of its own. The JAX step's initial weights go to every rank
as a ``.npy``; rank 0 saves the gathered layers after each step. Both
programs take the same losses (1e-3 relative over 5 steps) and the same
parameters after one step (equal, or one bf16 step apart; see
``tests/test_torch_train.py`` for the tolerances' reasons).
"""

import numpy as np
import pytest
import torch

from tests.conftest import require_jax
from tests.test_torch_train import _jax_steps, check_step_matches
from tpu_pod_exporter_torch.loadgen import sharded as ts

WORLD_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _needs_jax():
    require_jax()


def _world(tmp_path, n, argv, first=None):
    """Run a CPU world of n ranks; returns (reports, layers after each step)."""
    if first is not None:
        np.save(tmp_path / "first.npy", first)
        argv = [*argv, "--params-in", str(tmp_path / "first.npy"),
                "--params-out", str(tmp_path / "after.npy")]
    reports = ts.run_world(n, "cpu", argv, timeout=WORLD_TIMEOUT_S)
    assert [r["rank"] for r in reports] == list(range(n))
    after = np.load(tmp_path / "after.npy") if first is not None else None
    return reports, after


class TestMesh:
    @pytest.mark.parametrize("n,dp,tp,want", [
        (8, None, None, (4, 2)),  # most-square, dp >= tp
        (4, None, None, (2, 2)),
        (1, None, None, (1, 1)),
        (3, None, None, (3, 1)),
        (8, 8, 1, (8, 1)),
        (8, 2, 4, (2, 4)),
        (4, 1, 4, (1, 4)),
    ])
    def test_factorization(self, n, dp, tp, want):
        assert ts.mesh_shape(n, dp, tp) == want

    def test_factorization_matches_jax(self):
        from tpu_pod_exporter.loadgen import sharded as js

        for n in (1, 2, 3, 4, 6, 8):
            assert ts.mesh_shape(n) == js.make_mesh(n).devices.shape

    def test_dp_times_tp_must_be_n(self):
        with pytest.raises(ValueError, match=r"dp\(3\) \* tp\(2\) != n_devices\(8\)"):
            ts.mesh_shape(8, dp=3, tp=2)
        with pytest.raises(ValueError):
            ts.make_mesh(8, dp=3, tp=2, device="cpu")

    def test_world_of_one_mesh(self):
        mesh = ts.make_mesh(1, device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert (mesh.size(0), mesh.size(1)) == (1, 1) and mesh.device_type == "cpu"

    def test_larger_mesh_needs_a_world(self):
        with pytest.raises((RuntimeError, ValueError), match="ranks"):
            ts.make_mesh(4, device="cpu")

    def test_too_few_cards(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="need 4 devices, have 1"):
            ts.pick_devices(4)
        with pytest.raises(ValueError, match="need 2 devices, have 1"):
            ts.run_world(2, "cuda", [])
        assert ts.pick_devices(3, "cpu") == [torch.device("cpu")] * 3

    def test_no_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ts.make_mesh(1)

    @pytest.mark.parametrize("batch,width,dp,tp,want", [
        (32, 128, 3, 1, (33, 128)),
        (16, 64, 3, 1, (18, 64)),
        (16, 66, 2, 4, (16, 68)),
        (16, 64, 2, 2, (16, 64)),
    ])
    def test_padding(self, batch, width, dp, tp, want):
        assert ts.padded(batch, width, dp, tp) == want


class TestShardedStep:
    @pytest.mark.parametrize("dp,tp", [(2, 2), (4, 1), (1, 4)])
    def test_four_ranks_match_jax(self, tmp_path, dp, tp):
        first, want_losses, want_after = _jax_steps(4, dp=dp, tp=tp)
        reports, after = _world(tmp_path, 4, [
            "--dp", str(dp), "--tp", str(tp), "--width", "64", "--depth", "2",
            "--batch", "16", "--steps", "5"], first)
        assert reports[0]["mesh"] == {"data": dp, "model": tp}
        # Every rank reports the same global loss.
        assert all(r["losses"] == reports[0]["losses"] for r in reports)
        check_step_matches(want_losses, want_after, reports[0]["losses"], after[0])

    def test_default_mesh_of_four_is_2x2(self, tmp_path):
        reports, _ = _world(tmp_path, 4, ["--width", "32", "--depth", "2", "--batch", "8"])
        assert reports[0]["mesh"] == {"data": 2, "model": 2}

    def test_dp3_pads_the_batch_and_matches_jax_losses(self, tmp_path):
        first, want_losses, _ = _jax_steps(3)
        reports, after = _world(tmp_path, 3, [
            "--width", "64", "--depth", "2", "--batch", "16", "--steps", "5"], first)
        assert reports[0]["mesh"] == {"data": 3, "model": 1}
        assert (reports[0]["batch"], reports[0]["width"]) == (18, 64)
        assert after.shape == (5, 2, 64, 64)
        rel = max(abs(a - b) / a for a, b in zip(want_losses, reports[0]["losses"]))
        assert rel <= 1e-3

    def test_descends(self):
        # selftest.check_sharded_descends: SGD on a fixed batch descends
        # over 5 steps; here strictly at every step.
        step, params, (x, y) = ts.sharded_train_step(
            ts.make_mesh(1, device="cpu"), width=64, depth=2, batch=16)
        losses = []
        for _ in range(5):
            params, loss = step(params, x, y)
            losses.append(float(loss))
        assert np.isfinite(losses).all()
        assert all(b < a for a, b in zip(losses, losses[1:])), losses

    def test_run_dryrun(self):
        assert np.isfinite(ts.run_dryrun(1, steps=2, device="cpu"))


class TestWorld:
    def test_timeout_raises_with_stderr_tails(self):
        with pytest.raises(RuntimeError, match=r"world of 2 on cpu: timed out after 0\.5s"):
            ts.run_world(2, "cpu", ["--seconds", "30"], timeout=0.5)

    def test_failed_rank_raises_with_its_stderr(self, tmp_path):
        with pytest.raises(RuntimeError, match=r"rank \d exited rc=1(.|\n)*No such file"):
            ts.run_world(2, "cpu", ["--params-in", str(tmp_path / "missing.npy")],
                         timeout=WORLD_TIMEOUT_S)
