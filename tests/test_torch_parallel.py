"""The port's collective programs held against the JAX package's on the CPU
(mirrors tests/test_parallel.py).

The same numpy inputs, from a fixed seed, go into both: the JAX programs
run on the conftest's virtual CPU devices, the port's in gloo worlds of
rank processes that ``run_world`` starts (one world of 4 runs every
program, multislice on 2x2; one world of 3 an odd ring and pipeline), with
the inputs passed in and the outputs brought back as ``.npz`` files.
Tolerances (rtol = atol) are the numeric selftest's: 2e-5 for ring,
Ulysses and the FSDP weights, 1e-4 for the ring with scores scaled 30x30,
2e-4 for pipeline, MoE and the multislice weights; losses 1e-5 absolute
(FSDP) and 1e-4 relative (multislice).

Ring attention's running-softmax step (the kernel's plain version, which
the wrapper takes on the CPU) is held against the JAX ring on shared
inputs, the first step from m = -inf included.
"""

import math

import numpy as np
import pytest
import torch

from tests.conftest import require_jax
from tpu_pod_exporter_torch.kernels import online_softmax as osm
from tpu_pod_exporter_torch.loadgen import parallel as tp
from tpu_pod_exporter_torch.loadgen import sharded as ts

WORLD_TIMEOUT_S = 60
TOL = {"ring": 2e-5, "ring-30x": 1e-4, "ulysses": 2e-5, "pipeline": 2e-4, "moe": 2e-4,
       "fsdp": 2e-5, "multislice": 2e-4}
FSDP_LOSS_ATOL = 1e-5
MULTISLICE_LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _needs_jax():
    require_jax()


def _inputs(n: int, cases, seed: int = 0) -> dict[str, np.ndarray]:
    """Full f32 inputs, ``<case>.<arg>``, at the selftest's sizes for n."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    shapes = {
        "ring": lambda: (normal(4 * n, 16), normal(4 * n, 16), normal(4 * n, 16)),
        "ring-30x": lambda: (normal(2 * n, 4, scale=30.0), normal(2 * n, 4, scale=30.0),
                             normal(2 * n, 4)),
        "ulysses": lambda: tuple(normal(4 * n, 2 * n, 16) for _ in range(3)),
        "pipeline": lambda: (normal(n, 8, 8, scale=0.5), normal(2 * n, 4, 8)),
        "moe": lambda: (normal(n, 8, 8, scale=0.5), normal(2 * n * n, 8)),
        "fsdp": lambda: (normal(2 * n, 2 * n, scale=0.3), normal(4 * n, 2 * n),
                         normal(4 * n, 2 * n)),
        "multislice": lambda: (normal(2 * n, 2 * n, scale=0.3), normal(8, 2 * n)),
    }
    out = {}
    for case in cases:
        arrays = shapes[case]()
        out.update({f"{case}.{arg}": a
                    for arg, a in zip(tp.ARGS[case.split("-")[0]], arrays)})
    return out


def _jax_outputs(inputs: dict[str, np.ndarray], n: int) -> dict[str, np.ndarray]:
    """The JAX programs on n of the virtual CPU devices, named as ``run_cases`` names them."""
    import jax

    from tpu_pod_exporter.loadgen import parallel as jp

    out = {}
    for case in sorted({key.rsplit(".", 1)[0] for key in inputs}):
        name = case.split("-")[0]
        a = [inputs[f"{case}.{arg}"] for arg in tp.ARGS[name]]
        if name in ("ring", "ulysses"):
            make = jp.ring_attention_fn if name == "ring" else jp.ulysses_attention_fn
            fn, sh = make(jp.make_1d_mesh(n, "seq"))
            out[case] = fn(*(jax.device_put(x, sh) for x in a))
        elif name == "pipeline":
            fn, w_sh = jp.pipeline_forward_fn(jp.make_1d_mesh(n, "stage"))
            out[case] = fn(jax.device_put(a[0], w_sh), a[1])
        elif name == "moe":
            fn, w_sh, x_sh = jp.moe_forward_fn(jp.make_1d_mesh(n, "expert"))
            out[case] = fn(jax.device_put(a[0], w_sh), jax.device_put(a[1], x_sh))
        elif name == "fsdp":
            fn, sh = jp.fsdp_step_fn(jp.make_1d_mesh(n, "shard"))
            out[f"{case}.w"], out[f"{case}.loss"] = fn(*(jax.device_put(x, sh) for x in a))
        else:
            fn, w_sh, x_sh = jp.multislice_step_fn(jp.make_2d_mesh(2, n // 2))
            out[f"{case}.w"], out[f"{case}.loss"] = fn(jax.device_put(a[0], w_sh),
                                                       jax.device_put(a[1], x_sh))
    return {key: np.asarray(value) for key, value in out.items()}


def _world(tmp_path, n: int, cases):
    """(port outputs, JAX outputs) of every case on a world of n."""
    inputs = _inputs(n, cases)
    np.savez(tmp_path / "in.npz", **inputs)
    reports = ts.run_world(n, "cpu", ["--inputs", str(tmp_path / "in.npz"),
                                      "--outputs", str(tmp_path / "out.npz")],
                           timeout=WORLD_TIMEOUT_S, module=tp.MODULE)
    assert [r["rank"] for r in reports] == list(range(n))
    with np.load(tmp_path / "out.npz") as data:
        ours = dict(data)
    return ours, _jax_outputs(inputs, n)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    require_jax()
    return _world(tmp_path_factory.mktemp("world4"), 4, TOL)


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    require_jax()
    return _world(tmp_path_factory.mktemp("world3"), 3, ("ring", "pipeline"))


def _check_case(outputs, case: str, record_property) -> None:
    ours, want = outputs
    tol = TOL[case]
    if case in ("fsdp", "multislice"):
        w, want_w = ours[f"{case}.w"], want[f"{case}.w"]
        loss, want_loss = float(ours[f"{case}.loss"]), float(want[f"{case}.loss"])
        if case == "fsdp":
            assert abs(loss - want_loss) < FSDP_LOSS_ATOL, (loss, want_loss)
        else:
            assert abs(loss - want_loss) / abs(want_loss) < MULTISLICE_LOSS_RTOL
    else:
        w, want_w = ours[case], want[case]
    assert w.shape == want_w.shape and np.isfinite(w).all()
    record_property("max_abs_err", float(np.abs(w - want_w).max()))
    np.testing.assert_allclose(w, want_w, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", sorted(TOL))
def test_world_of_four_matches_jax(world4, case, record_property):
    _check_case(world4, case, record_property)


@pytest.mark.parametrize("case", ["ring", "pipeline"])
def test_odd_world_of_three_matches_jax(world3, case, record_property):
    _check_case(world3, case, record_property)


# ------------------------------------------------------------ K5 on the CPU

def _ring_by_blocks(q, k, v, n: int, update) -> torch.Tensor:
    """Ring attention in one process, rank by rank: rank r's queries meet
    the K/V blocks of ranks r, r-1, ..., one ``update`` and one product a
    block, as the program's steps do."""
    t, d = q.shape[0] // n, q.shape[1]
    outs = []
    for r in range(n):
        qb = q[r * t:(r + 1) * t]
        o = torch.zeros((t, d))
        m = torch.full((t,), -math.inf)
        l = torch.zeros((t,))
        for s in range(n):
            j = (r - s) % n
            p = torch.mm(qb, k[j * t:(j + 1) * t].t())
            update(p, m, l, o, d)
            o.addmm_(p, v[j * t:(j + 1) * t])
        outs.append(o / l[:, None])
    return torch.cat(outs)


@pytest.mark.parametrize("update", [osm.online_softmax_update_plain, osm.online_softmax_update_],
                         ids=["plain", "wrapper"])
@pytest.mark.parametrize("n,scale", [(1, 1.0), (2, 1.0), (4, 1.0), (1, 30.0), (2, 30.0)])
def test_running_softmax_step_matches_jax_ring(update, n, scale):
    import jax

    from tpu_pod_exporter.loadgen import parallel as jp

    rng = np.random.default_rng(n)
    q, k = ((scale * rng.standard_normal((8 * n, 16))).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((8 * n, 16)).astype(np.float32)
    fn, sh = jp.ring_attention_fn(jp.make_1d_mesh(n, "seq"))
    want = np.asarray(fn(*(jax.device_put(a, sh) for a in (q, k, v))))
    launches = osm.online_softmax_update_.launches
    got = _ring_by_blocks(*map(torch.from_numpy, (q, k, v)), n, update).numpy()
    assert osm.online_softmax_update_.launches == launches  # the CPU launches nothing
    tol = 2e-5 if scale == 1.0 else 1e-4
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_first_step_from_minus_infinity():
    gen = torch.Generator().manual_seed(3)
    r = torch.randn((5, 7), generator=gen)
    o = torch.randn((5, 3), generator=gen)
    m, l = torch.full((5,), -math.inf), torch.zeros(5)
    s = r.double() / math.sqrt(16)
    p = osm.online_softmax_update_(r, m, l, o, 16)
    assert p is r
    torch.testing.assert_close(m, s.amax(dim=1).float(), rtol=0, atol=0)
    torch.testing.assert_close(r.double(), torch.exp(s - s.amax(dim=1, keepdim=True)),
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(l.double(), r.double().sum(dim=1), rtol=1e-6, atol=0)
    assert torch.equal(o, torch.zeros_like(o))  # o * exp(-inf) = 0


@pytest.mark.parametrize("args", [
    lambda: (torch.ones(2, 3, dtype=torch.float64), torch.zeros(2), torch.zeros(2),
             torch.zeros(2, 4)),                                      # f64 scores
    lambda: (torch.ones(2, 3), torch.zeros(3), torch.zeros(2), torch.zeros(2, 4)),  # m's shape
    lambda: (torch.ones(3, 2).t(), torch.zeros(2), torch.zeros(2), torch.zeros(2, 4)),  # strided
    lambda: (torch.ones(2, 0), torch.zeros(2), torch.zeros(2), torch.zeros(2, 4)),  # Tkv = 0
    lambda: (torch.ones(1, osm.MAX_TKV + 1), torch.zeros(1), torch.zeros(1),
             torch.zeros(1, 4)),                                      # row past shared memory
    lambda: (torch.ones(2, 3, device="meta"), torch.zeros(2, device="meta"),
             torch.zeros(2, device="meta"), torch.zeros(2, 4, device="meta")),  # not cuda/cpu
])
def test_wrapper_rejects_what_the_kernel_does_not_take(args):
    launches = osm.online_softmax_update_.launches
    with pytest.raises(ValueError):
        osm.online_softmax_update_(*args(), 16)
    assert osm.online_softmax_update_.launches == launches


# ------------------------------------- references and build_parallel_program

@pytest.mark.parametrize("name", tp.PARALLEL_PROGRAMS)
def test_references_match_jax(name):
    from tpu_pod_exporter.loadgen import parallel as jp

    case = _inputs(4, [name], seed=5)
    args = [case[f"{name}.{arg}"] for arg in tp.ARGS[name]]
    ref = {"ring": "reference_attention", "ulysses": "reference_mha",
           "pipeline": "reference_pipeline", "moe": "reference_moe",
           "fsdp": "reference_fsdp", "multislice": "reference_multislice"}[name]
    got = getattr(tp, ref)(*(torch.from_numpy(a).double() for a in args))
    want = getattr(jp, ref)(*args)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", tp.PARALLEL_PROGRAMS)
def test_built_inputs_have_the_jax_shapes_and_structure(name):
    from tpu_pod_exporter.loadgen import parallel as jp

    if name == "multislice":
        with pytest.raises(ValueError, match="multislice needs an even device count"):
            jp.build_parallel_program(name, 1)
        with pytest.raises(ValueError, match="multislice needs an even device count"):
            tp.build_parallel_program(name, 1, device="cpu")
        return
    _, args, feed = tp.build_parallel_program(name, 1, scale=2, device="cpu")
    _, jargs, _ = jp.build_parallel_program(name, 1, scale=2)
    assert [tuple(a.shape) for a in args] == [tuple(a.shape) for a in jargs]
    assert all(a.dtype == torch.float32 for a in args)
    # Where JAX draws two tensors of one shape from its one key, they are equal.
    for i in range(len(args)):
        for j in range(i):
            same = args[i].shape == args[j].shape and torch.equal(args[i], args[j])
            jsame = jargs[i].shape == jargs[j].shape and np.array_equal(jargs[i], jargs[j])
            assert same == jsame, (i, j)
    assert len(feed(args, args[0] if name != "fsdp" else (args[0], None))) == len(args)


def test_dryrun_of_one_has_the_jax_keys():
    from tpu_pod_exporter.loadgen import parallel as jp

    got = tp.run_parallelism_dryrun(1, device="cpu")
    assert set(got) == set(jp.run_parallelism_dryrun(1))
    assert all(math.isfinite(v) for v in got.values())


def test_program_names_are_the_jax_packages():
    from tpu_pod_exporter.loadgen import parallel as jp

    assert tp.PARALLEL_PROGRAMS == jp.PARALLEL_PROGRAMS
    assert set(tp.ARGS) == set(tp.PARALLEL_PROGRAMS)


def test_a_mesh_of_more_than_one_needs_a_world():
    with pytest.raises((RuntimeError, ValueError), match="ranks"):
        tp.make_1d_mesh(4, "seq", device="cpu")
    with pytest.raises((RuntimeError, ValueError), match="ranks"):
        tp.make_2d_mesh(2, 2, device="cpu")


def test_mesh_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.make_1d_mesh(1, "seq")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.build_parallel_program("ring", 1)
