"""How ``tanh_matmul`` picks its route, what the staged route copies, and
how the kernels' library is keyed and built, checked without a card or nvcc.

The wgmma route (``csrc/tanh_matmul_sm90.cu``) takes every shape TMA can
address as it lies; the staged route the rest, through the same kernel
after ``csrc/stage_rows.cu`` copies an operand to 16-byte rows at an aligned
base. The wmma kernel (``csrc/tanh_matmul.cu``) stays reachable through
``launch`` only. All come from one nvcc call into one library.
"""

import ctypes
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


ALIGNED = (256, 512)  # 16-byte-aligned bases of h and w


@pytest.mark.parametrize("k", [8, 64, 1000, 1, 7, 9, 1001, 0])
@pytest.mark.parametrize("n", [8, 4096, 1, 9, 4095])
@pytest.mark.parametrize("h_off,w_off", [(0, 0), (2, 0), (0, 2), (8, 14)])
def test_route_and_staging_over_the_grid(k, n, h_off, w_off):
    h_ptr, w_ptr = ALIGNED[0] + h_off, ALIGNED[1] + w_off
    aligned = k % 8 == 0 and n % 8 == 0 and h_off == 0 and w_off == 0
    want = "wgmma" if k > 0 and aligned else "staged"
    assert ("wgmma" if tm.sm90_eligible(33, n, k, h_ptr, w_ptr) else "staged") == want
    plan = tm.staging(n, k, h_ptr, w_ptr)
    stage_h = k > 0 and (k % 8 != 0 or h_off != 0)
    stage_w = k > 0 and (n % 8 != 0 or w_off != 0)
    assert plan == ({"h": -(-k // 8) * 8} if stage_h else {}) | (
        {"w": -(-n // 8) * 8} if stage_w else {})
    for ld in plan.values():
        assert ld % 8 == 0  # 16-byte rows: what TMA demands
    if want == "wgmma":
        assert plan == {}


@pytest.mark.parametrize("n,k,h_ptr,w_ptr,plan", [
    (4096, 1000, 256, 512, {}),                      # aligned: nothing to copy
    (8190, 8190, 256, 512, {"h": 8192, "w": 8192}),  # both extents ragged
    (8192, 8192, 258, 512, {"h": 8192}),             # the main shape, h one element off
    (8192, 8192, 256, 514, {"w": 8192}),             # w one element off
    (9, 7, 256, 512, {"h": 8, "w": 16}),
    (17, 4, 256, 512, {"h": 8, "w": 24}),            # a width of 17, a depth of 4
    (16, 0, 258, 514, {}),                           # K = 0: nothing to read
])
def test_staging_names_the_copies_and_their_row_strides(n, k, h_ptr, w_ptr, plan):
    assert tm.staging(n, k, h_ptr, w_ptr) == plan


@pytest.mark.parametrize("cols", [0, 1, 7, 8, 9, 17, 8190, 8192])
def test_row_stride_rounds_up_to_16_bytes(cols):
    ld = tm.row_stride(cols)
    assert ld % 8 == 0 and cols <= ld < cols + 8


@pytest.mark.parametrize("rows,cols,offset", [(1, 1, 0), (5, 7, 1), (33, 17, 3), (4, 16, 0),
                                              (3, 0, 0), (0, 9, 0), (64, 200, 5)])
def test_stage_rows_plain_pads_rows_to_an_aligned_stride(rows, cols, offset):
    g = torch.Generator().manual_seed(rows * 100 + cols)
    x = torch.randn((rows, cols), generator=g).to(torch.bfloat16)
    if offset:  # the input off 16-byte alignment, contiguous
        buf = torch.empty((rows * cols + offset,), dtype=torch.bfloat16)
        x = buf[offset:].view(rows, cols).copy_(x)
    ld = tm.row_stride(cols)
    out = tm.stage_rows_plain(x, ld)
    assert out.shape == (rows, ld) and (out.numel() == 0 or out.stride() == (ld, 1))
    assert out.data_ptr() % 16 == 0
    assert torch.equal(out[:, :cols], x)
    assert not out[:, cols:].any()  # the pad columns are zeros


def test_stage_rows_on_the_cpu_is_the_plain_copy_and_counts_nothing():
    x = torch.arange(35, dtype=torch.float32).view(5, 7).to(torch.bfloat16)
    launches = tm.stage_rows.launches
    assert torch.equal(tm.stage_rows(x, 8), tm.stage_rows_plain(x, 8))
    assert tm.stage_rows.launches == launches


@pytest.mark.parametrize("x,ld", [
    (torch.ones((4, 9), dtype=torch.bfloat16), 12),  # not a multiple of 8
    (torch.ones((4, 9), dtype=torch.bfloat16), 8),   # under cols
    (torch.ones((4, 9)), 16),                          # f32
    (torch.ones((9, 4), dtype=torch.bfloat16).t(), 16),  # not contiguous
    (torch.ones((2, 4, 9), dtype=torch.bfloat16), 16),   # 3-D
])
def test_stage_rows_refuses_what_the_kernel_does_not_take(x, ld):
    with pytest.raises(ValueError):
        tm.stage_rows(x, ld)


def test_every_kernel_has_an_entry_and_a_count():
    assert tm.ENTRIES == {"wgmma": "tanh_matmul_bf16_sm90",
                          "staged": "tanh_matmul_bf16_sm90_strided",
                          "wmma": "tanh_matmul_bf16"}
    assert set(tm.tanh_matmul.launches_by_kernel) == set(tm.ENTRIES)
    assert isinstance(tm.stage_rows.launches, int)


def test_sources_are_both_kernels():
    # The tanh_matmul kernels, the staging copy, and the SGD update and
    # ring attention's running softmax built into the same library.
    assert [p.name for p in tm.sources()] == [
        "online_softmax.cu", "sgd_update.cu", "stage_rows.cu", "tanh_matmul.cu",
        "tanh_matmul_sm90.cu"]


def test_every_c_entry_has_its_own_argtypes():
    assert set(tm.ENTRIES.values()) | {"sgd_update_bf16", "online_softmax_f32",
                                       "stage_rows_bf16"} == set(tm.SIGNATURES)
    assert len(tm.SIGNATURES["sgd_update_bf16"]) == 5  # p, g, n, lr, stream
    assert len(tm.SIGNATURES["online_softmax_f32"]) == 9  # r, m, l, o, Tq, Tkv, D, d, stream
    assert all(len(tm.SIGNATURES[tm.ENTRIES[k]]) == 7 for k in ("wgmma", "wmma"))
    # h, w, y, M, N, K, ldh, ldw, ldy, stream: pointers and the stream as
    # c_void_p, the rest as int.
    c_void_p, c_int = ctypes.c_void_p, ctypes.c_int
    assert tm.SIGNATURES["tanh_matmul_bf16_sm90_strided"] == (
        c_void_p, c_void_p, c_void_p, c_int, c_int, c_int, c_int, c_int, c_int, c_void_p)
    # src, dst, rows (64-bit), cols, ld, stream
    assert tm.SIGNATURES["stage_rows_bf16"] == (
        c_void_p, c_void_p, ctypes.c_int64, c_int, c_int, c_void_p)


@pytest.mark.parametrize("name", ["tanh_matmul.cu", "tanh_matmul_sm90.cu", "sgd_update.cu",
                                  "online_softmax.cu", "stage_rows.cu"])
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


@pytest.mark.parametrize("kernel", ["wgmma", "wmma", "staged"])
def test_launch_refuses_cpu_operands_and_counts_nothing(kernel):
    h = torch.ones((4, 7), dtype=torch.bfloat16)
    w = torch.ones((7, 9), dtype=torch.bfloat16)
    by_kernel = dict(tm.tanh_matmul.launches_by_kernel)
    staged = tm.stage_rows.launches
    with pytest.raises(ValueError, match="runs on cuda"):
        tm.launch(kernel, h, w)
    assert tm.tanh_matmul.launches_by_kernel == by_kernel
    assert tm.stage_rows.launches == staged
