"""How ``tanh_matmul`` picks between its two hand kernels, and how their
library is keyed and built, checked without a card or nvcc.

The wgmma kernel (``csrc/tanh_matmul_sm90.cu``) takes every shape TMA can
address; the wmma kernel (``csrc/tanh_matmul.cu``) the rest. Both come from
one nvcc call into one library.
"""

import pathlib

import pytest
import torch

from tpu_pod_exporter_torch.kernels import tanh_matmul as tm

MAIN = (4096, 8192, 8192)


@pytest.mark.parametrize("m,n,k,h_ptr,w_ptr,eligible", [
    (*MAIN, 0x7F0000000000, 0x7F0004000000, True),  # the main path
    (1, 8, 64, 256, 512, True),                     # one row
    (257, 4096, 1000, 256, 512, True),              # ragged M, N and K tiles
    (300, 264, 136, 256, 512, True),
    (257, 4095, 1000, 256, 512, False),             # N not a multiple of 8
    (33, 9, 8, 256, 512, False),
    (64, 136, 200 + 4, 256, 512, False),            # K not a multiple of 8
    (33, 9, 7, 256, 512, False),                    # neither
    (16, 16, 0, 256, 512, False),                   # K = 0: an empty sum
    (64, 136, 200, 258, 512, False),                # h one element off alignment
    (64, 136, 200, 264, 512, False),                # h 8 bytes off
    (64, 136, 200, 256, 514, False),                # w off alignment
    (64, 136, 200, 272, 528, True),                 # 16-byte aligned, not 256
])
def test_sm90_eligible(m, n, k, h_ptr, w_ptr, eligible):
    assert tm.sm90_eligible(m, n, k, h_ptr, w_ptr) is eligible


def test_every_kernel_has_an_entry_and_a_count():
    assert tm.ENTRIES == {"wgmma": "tanh_matmul_bf16_sm90", "wmma": "tanh_matmul_bf16"}
    assert set(tm.tanh_matmul.launches_by_kernel) == set(tm.ENTRIES)


def test_sources_are_both_kernels():
    # Both tanh_matmul kernels, and the SGD update and ring attention's
    # running softmax built into the same library.
    assert [p.name for p in tm.sources()] == [
        "online_softmax.cu", "sgd_update.cu", "tanh_matmul.cu", "tanh_matmul_sm90.cu"]


def test_every_c_entry_has_its_own_argtypes():
    assert set(tm.ENTRIES.values()) | {"sgd_update_bf16", "online_softmax_f32"} \
        == set(tm.SIGNATURES)
    assert len(tm.SIGNATURES["sgd_update_bf16"]) == 5  # p, g, n, lr, stream
    assert len(tm.SIGNATURES["online_softmax_f32"]) == 9  # r, m, l, o, Tq, Tkv, D, d, stream
    assert all(len(tm.SIGNATURES[e]) == 7 for e in tm.ENTRIES.values())


@pytest.mark.parametrize("name", ["tanh_matmul.cu", "tanh_matmul_sm90.cu", "sgd_update.cu",
                                  "online_softmax.cu"])
def test_library_path_changes_with_either_source(monkeypatch, name):
    before = tm.library_path()
    read = pathlib.Path.read_bytes

    def edited(path):
        data = read(path)
        return data + b"\n// edited\n" if path.name == name else data

    monkeypatch.setattr(pathlib.Path, "read_bytes", edited)
    after = tm.library_path()
    assert after != before and after.parent == before.parent
    monkeypatch.undo()
    assert tm.library_path() == before


def test_one_nvcc_call_builds_both_sources(tmp_path, monkeypatch):
    argv = tmp_path / "argv"
    nvcc = tmp_path / "nvcc"
    # Record the arguments and write the -o target, as nvcc does.
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{argv}"\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo lib > "$2"\n'
    )
    nvcc.chmod(0o755)
    monkeypatch.setattr(tm, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(tm, "BUILD_DIR", tmp_path / "_build")
    tm.build()
    (call,) = argv.read_text().splitlines()
    assert call.endswith(" ".join(str(p) for p in tm.sources()))
    assert "arch=compute_90a,code=sm_90a" in call


@pytest.mark.parametrize("m,k,n", [(33, 70, 19), (1, 64, 8), (16, 0, 16), (300, 136, 264)])
def test_cpu_takes_the_plain_version_and_counts_nothing(m, k, n):
    g = torch.Generator().manual_seed(m + k + n)
    h = torch.randn((m, k), generator=g).to(torch.bfloat16)
    w = torch.randn((k, n), generator=g).to(torch.bfloat16)
    launches = tm.tanh_matmul.launches
    by_kernel = dict(tm.tanh_matmul.launches_by_kernel)
    y = tm.tanh_matmul(h, w)
    assert torch.equal(y, tm.tanh_matmul_plain(h, w))
    assert tm.tanh_matmul.launches == launches
    assert tm.tanh_matmul.launches_by_kernel == by_kernel


@pytest.mark.parametrize("kernel", ["wgmma", "wmma"])
def test_launch_refuses_cpu_operands_and_counts_nothing(kernel):
    h = torch.ones((4, 8), dtype=torch.bfloat16)
    w = torch.ones((8, 8), dtype=torch.bfloat16)
    by_kernel = dict(tm.tanh_matmul.launches_by_kernel)
    with pytest.raises(ValueError, match="runs on cuda"):
        tm.launch(kernel, h, w)
    assert tm.tanh_matmul.launches_by_kernel == by_kernel
