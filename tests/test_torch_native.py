"""The port's libtpumon held against the JAX package's.

First the cases of tests/test_native.py against the port's own build of
``tpu_pod_exporter_torch/native/tpumon.cc`` (compiled with g++ at first use
into ``tpu_pod_exporter_torch/_build/``). Then the two packages side by
side: the port's library, the reference's ``native/libtpumon.so`` (built as
tests/test_native.py builds it) and the Python formatter render the same
bytes for the same prefixes and values, and the native and Python ``/proc``
walks give the same holders on a GPU node's tree. Without g++ and without a
built library these skip, as the reference's own cases do.
"""

import ctypes
import math
import shutil
import subprocess
from array import array
from pathlib import Path

import pytest

from test_torch_procscan import CGROUP_V1, NVIDIA_LINKS, add_proc
from tpu_pod_exporter_torch import nativelib
from tpu_pod_exporter_torch.metrics import native
from tpu_pod_exporter_torch.metrics.registry import (
    FamilyLayout,
    MetricSpec,
    format_value,
    render_prefix,
)
from tpu_pod_exporter_torch.procscan import GPU_DEVICE_PREFIXES, ProcScanner

REPO = Path(__file__).resolve().parent.parent
REFERENCE_SO = REPO / "native" / "libtpumon.so"

# Values an exporter publishes (byte counts, percentages, seconds, counters)
# and the formatting edges among them: huge and tiny exponents, non-finite
# values, signed zero. All three renders give the same bytes for these.
VALUES = [0.0, -0.0, 1.0, -1.0, 2.5, 1e18, 1.5e-9, 123456789.0,
          math.nan, math.inf, -math.inf, 0.1, 1 / 3, 80 * 1024.0**3,
          1.7976931348623157e308, 19_003_924_480.0, 2.0**53 - 1, 2.0**63,
          1234567.125, 3e-05]
# Where tpumon.cc and the Python formatter choose different digits for the
# same double: integral values from 2**53 on (C prints the integer, Python
# a float) and subnormals (C prints 15 significant digits). Both packages'
# libraries give the same bytes, and every text parses back to the value.
EDGE_VALUES = [2.0**53 + 2, 12345678901234567.0, 5e-324, 5e-321]


@pytest.fixture(scope="module")
def built_lib():
    if not nativelib.library_path().exists() and shutil.which("g++") is None:
        pytest.skip("no libtpumon build and no g++ to build it")
    # earlier tests may have cached a failed load from before the build
    nativelib.reset_for_tests()
    lib = native.load()
    if lib is None:
        pytest.skip("native lib not loadable")
    return lib


@pytest.fixture(scope="module")
def reference_lib():
    """The JAX package's library, built by its own Makefile."""
    if not REFERENCE_SO.exists():
        if shutil.which("g++") is None:
            pytest.skip("no libtpumon.so and no g++ to build it")
        subprocess.run(["make"], cwd=REPO / "native", check=True, capture_output=True)
    lib = ctypes.CDLL(str(REFERENCE_SO))
    lib.tpumon_render.restype = ctypes.c_long
    lib.tpumon_render.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_double),
        ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
    ]
    return lib


class TestNativeRender:
    def test_parity_with_python_formatting(self, built_lib):
        values = [0.0, 1.0, -1.0, 2.5, 1e18, 1.5e-9, 123456789.0,
                  math.nan, math.inf, -math.inf, 0.1, 1 / 3]
        prefixes = [f'm{{i="{i}"}}'.encode() for i in range(len(values))]
        out = native.render_lines(prefixes, values)
        assert out is not None
        lines = out.decode().strip().split("\n")
        assert len(lines) == len(values)
        for line, prefix, v in zip(lines, prefixes, values):
            got_prefix, got_val = line.rsplit(" ", 1)
            assert got_prefix == prefix.decode()
            # native may choose different digits than repr(); must round-trip
            if math.isnan(v):
                assert got_val == "NaN"
            elif math.isinf(v):
                assert got_val == ("+Inf" if v > 0 else "-Inf")
            else:
                assert float(got_val) == v
                # integral values render without decimal point, like Python's
                if v == int(v) and abs(v) < 2**53:
                    assert got_val == format_value(v)

    def test_empty_input(self, built_lib):
        assert native.render_lines([], []) is None  # caller falls back

    def test_device_scan_against_fake_tree(self, built_lib, tmp_path):
        (tmp_path / "dev").mkdir()
        for i in range(4):
            (tmp_path / "dev" / f"accel{i}").touch()
        (tmp_path / "dev" / "accelfoo").touch()  # non-numeric suffix ignored
        built_lib.tpumon_count_devices.restype = ctypes.c_int
        built_lib.tpumon_count_devices.argtypes = [ctypes.c_char_p]
        assert built_lib.tpumon_count_devices(str(tmp_path).encode()) == 4

    def test_snapshot_encode_uses_native_and_parses(self, built_lib):
        from prometheus_client.parser import text_string_to_metric_families

        from tpu_pod_exporter_torch.metrics.registry import SnapshotBuilder

        b = SnapshotBuilder()
        spec = MetricSpec(name="m", help="h", label_names=("a",))
        for i in range(100):
            b.add(spec, i * 1.5, (str(i),))
        text = b.build().encode().decode()
        fams = {f.name: f for f in text_string_to_metric_families(text)}
        assert len(fams["m"].samples) == 100
        assert fams["m"].samples[3].value == 4.5


class TestNativeParseLayout:
    """The whole-body native parse must be a strict subset of the Python
    layout parser: identical values on perfect matches, None on anything
    else (incl. shapes where native acceptance would widen the grammar)."""

    NAMES = frozenset({"m", "tpu_x"})

    def _warm(self, text):
        from tpu_pod_exporter_torch.metrics.parse import (
            LayoutCache,
            parse_exposition_layout,
        )

        layout = LayoutCache()
        parse_exposition_layout(text, self.NAMES, layout)
        return layout

    def test_values_match_python(self, built_lib):
        t1 = (
            "# HELP m h\n# TYPE m gauge\n"
            'm{a="1"} 5\nskip{a="1"} 2\nm{a="2"} NaN\n'
            "tpu_x +Inf\nm 2.5 1700000000\n"
        )
        layout = self._warm(t1)
        t2 = t1.replace(" 5\n", " 50\n").replace(" 2.5 ", " -7.25 ")
        got = native.parse_layout(layout, t2)
        assert got is not None
        assert got[0] == 50.0
        assert math.isnan(got[1])
        assert got[2] == math.inf
        assert got[3] == -7.25

    def test_rejects_what_python_float_rejects(self, built_lib):
        # strtod would take a hex float; Python float() raises — native
        # must decline so the Python parser can raise ParseError.
        layout = self._warm("m 5\n")
        assert native.parse_layout(layout, "m 0x1p3\n") is None

    def test_rejects_brace_tails(self, built_lib):
        layout = self._warm('m{a="1"} 5\nm{a="2"} 6\n')
        assert native.parse_layout(layout, 'm{a="1"} 5 m{a="2"} 6\n') is None

    def test_rejects_shape_changes(self, built_lib):
        layout = self._warm("m 1\nm 2\n")
        assert native.parse_layout(layout, "m 1\n") is None          # shrank
        assert native.parse_layout(layout, "m 1\nm 2\nm 3\n") is None  # grew
        assert native.parse_layout(layout, "m2 1\nm 2\n") is None    # renamed

    def test_arrays_rebuilt_on_churn(self, built_lib):
        from tpu_pod_exporter_torch.metrics.parse import parse_exposition_layout

        layout = self._warm("m 1\n")
        built = layout.native_built_for
        parse_exposition_layout("m 1\nm 2\n", self.NAMES, layout)  # churn
        got = native.parse_layout(layout, "m 3\nm 4\n")
        assert got == [3.0, 4.0]
        assert layout.native_built_for is not built

    def test_end_to_end_fast_path_returns_shared_labels(self, built_lib):
        from tpu_pod_exporter_torch.metrics.parse import parse_exposition_layout

        t = 'm{a="1"} 5\n'
        layout = self._warm(t)
        r1 = parse_exposition_layout(t, self.NAMES, layout)
        r2 = parse_exposition_layout('m{a="1"} 6\n', self.NAMES, layout)
        assert r1[0][1] is r2[0][1]  # labels dict shared via the template
        assert r2[0][2] == 6.0


# --------------------------------------------------- the two packages apart


def _reference_render(lib, prefixes, values) -> bytes:
    n = len(prefixes)
    cap = sum(map(len, prefixes)) + 32 * n
    buf = ctypes.create_string_buffer(cap)
    written = lib.tpumon_render((ctypes.c_char_p * n)(*prefixes),
                                (ctypes.c_double * n)(*values), n, buf, cap)
    assert written >= 0
    return buf.raw[:written]


def _gpu_prefixes(n: int) -> list[bytes]:
    spec = MetricSpec(name="gpu_hbm_used_bytes", help="h",
                      label_names=("chip_id", "device_path", "uuid"))
    return [render_prefix(spec, (str(i), f"/dev/nvidia{i + 3}",
                                 f'GPU-"{i}"\\\n')) for i in range(n)]


class TestAgainstTheReference:
    def test_port_never_loads_the_reference_library(self, built_lib):
        assert Path(built_lib._name) == nativelib.library_path()
        assert nativelib.library_path().parent == REPO / "tpu_pod_exporter_torch" / "_build"
        assert Path(built_lib._name) != REFERENCE_SO

    def test_three_renders_give_the_same_bytes(self, built_lib, reference_lib):
        prefixes = _gpu_prefixes(len(VALUES))
        python = b"".join(p + b" " + format_value(v).encode() + b"\n"
                          for p, v in zip(prefixes, VALUES))
        assert native.render_lines(prefixes, VALUES) == python
        assert _reference_render(reference_lib, prefixes, VALUES) == python

    def test_edges_match_the_reference_and_round_trip(self, built_lib, reference_lib):
        prefixes = _gpu_prefixes(len(EDGE_VALUES))
        ours = native.render_lines(prefixes, EDGE_VALUES)
        assert ours == _reference_render(reference_lib, prefixes, EDGE_VALUES)
        texts = [line.rsplit(b" ", 1)[1].decode() for line in ours.splitlines()]
        assert [float(t) for t in texts] == EDGE_VALUES
        assert texts != [format_value(v) for v in EDGE_VALUES]

    def test_render_layout_matches_python_and_reference(self, built_lib, reference_lib):
        prefixes = _gpu_prefixes(len(VALUES))
        layout = FamilyLayout(tuple((str(i),) for i in range(len(VALUES))), prefixes)
        for values in (VALUES, VALUES[::-1]):  # the second pass reuses the buffers
            packed = array("d", values)
            python = b"".join(p + b" " + format_value(v).encode() + b"\n"
                              for p, v in zip(prefixes, values))
            assert native.render_layout(layout, packed) == python
            assert _reference_render(reference_lib, prefixes, values) == python


class TestProcWalks:
    def _walks(self, root):
        scanner = ProcScanner(proc_root=str(root), device_prefixes=GPU_DEVICE_PREFIXES)
        return scanner._native_full_scan(), scanner._python_full_scan()

    def test_native_and_python_walks_agree_on_a_gpu_node(self, built_lib, tmp_path):
        add_proc(tmp_path, 118, NVIDIA_LINKS)
        add_proc(tmp_path, 119, ["/dev/nvidiactl", "/dev/nvidia-uvm"], cgroup=CGROUP_V1)
        add_proc(tmp_path, 7, ["/dev/nvidia3 (deleted)", "/dev/nvidiactl (deleted)"],
                 comm="wedged\tjob")
        add_proc(tmp_path, 9, ["/dev/nvidia", "/dev/nvidia0x", "/dev/accel0"])
        native_walk, python_walk = self._walks(tmp_path)
        assert native_walk is not None
        assert native_walk == python_walk
        assert {pid: [h.device_path for h in hs] for pid, hs in native_walk.items()} == {
            7: ["/dev/nvidia3"], 118: ["/dev/nvidia0", "/dev/nvidia10"]}
        assert native_walk[7][0].comm == "wedged?job"

    def test_scan_goes_native_and_keeps_the_verify_cache(self, built_lib, tmp_path,
                                                         monkeypatch):
        add_proc(tmp_path, 118, NVIDIA_LINKS)
        scanner = ProcScanner(proc_root=str(tmp_path), device_prefixes=GPU_DEVICE_PREFIXES,
                              full_scan_every=3)
        monkeypatch.setattr(scanner, "_python_full_scan",
                            lambda: pytest.fail("the Python walk ran"))
        first = scanner.scan()
        assert [h.device_path for h in first] == ["/dev/nvidia0", "/dev/nvidia10"]
        assert scanner.scan() == first  # the Python verify agrees with the native cache
        assert (scanner.full_scans, scanner.verify_scans) == (1, 1)

    def test_python_walk_when_the_library_is_absent(self, tmp_path, monkeypatch):
        add_proc(tmp_path, 118, NVIDIA_LINKS)
        monkeypatch.setattr(nativelib, "load", lambda: None)
        native_walk, python_walk = self._walks(tmp_path)
        assert native_walk is None
        assert [h.device_path for h in python_walk[118]] == ["/dev/nvidia0", "/dev/nvidia10"]
