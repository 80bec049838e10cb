"""Native exposition rendering via libtpumon (see ``nativelib`` for loading).

The render hot path (thousands of `prefix value\n` lines per poll at 256
chips × 1 s) runs in C when the shared library is present; callers fall
back to the pure-Python formatter when ``render_lines`` returns None.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

from tpu_pod_exporter_torch import nativelib

if TYPE_CHECKING:  # typing only
    from array import array

    from tpu_pod_exporter_torch.metrics.parse import LayoutCache
    from tpu_pod_exporter_torch.metrics.registry import FamilyLayout


def render_lines(prefixes: list[bytes], values: list[float]) -> bytes | None:
    """Render `prefix value\\n` lines natively. None → caller falls back."""
    lib = nativelib.load()
    if lib is None or not prefixes:
        return None
    n = len(prefixes)
    arr_p = (ctypes.c_char_p * n)(*prefixes)
    arr_v = (ctypes.c_double * n)(*values)
    # Worst case ~ prefix + " " + 24-char value + "\n".
    cap = sum(len(p) for p in prefixes) + 32 * n
    buf = ctypes.create_string_buffer(cap)
    written = lib.tpumon_render(arr_p, arr_v, n, buf, cap)
    if written < 0:
        return None
    return buf.raw[:written]


def render_layout(layout: "FamilyLayout", values: "array") -> bytes | None:
    """Render one family via its :class:`FamilyLayout`, reusing the ctypes
    pointer array across polls (building it is the per-call cost of
    ``render_lines``; the prefixes themselves are stable between churn
    events). ``values`` is an ``array('d')`` — passed to C by buffer, no
    per-element marshalling. None → caller falls back to the Python
    formatter."""
    lib = nativelib.load()
    if lib is None or not layout.prefixes:
        return None
    n = len(layout.prefixes)
    if layout.native_arr is None:
        layout.native_arr = (ctypes.c_char_p * n)(*layout.prefixes)
        layout.plens_arr = (ctypes.c_int * n)(*map(len, layout.prefixes))
    arr_v = (ctypes.c_double * n).from_buffer(values)
    cap = layout.prefix_total + 32 * n
    buf = layout.out_buf
    if buf is None or len(buf) < cap:
        # Reused across polls: create_string_buffer would malloc + zero-fill
        # hundreds of KB per family per poll on the big (per-link) families.
        buf = layout.out_buf = ctypes.create_string_buffer(cap)
    written = lib.tpumon_render2(
        layout.native_arr, layout.plens_arr, arr_v, n, buf, len(buf)
    )
    if written < 0:
        return None
    return ctypes.string_at(buf, written)


def parse_layout(layout: "LayoutCache", text: str) -> "list[float] | None":
    """Whole-body value-only parse of one exposition body against a warm
    :class:`~tpu_pod_exporter_torch.metrics.parse.LayoutCache` — the parse-side
    inverse of :func:`render_layout`. Returns the kind-2 entry values in
    entry order on a PERFECT byte-level match of every line, else None
    (the Python parser owns all divergence/rebuild semantics). The ctypes
    key arrays are cached on the layout and rebuilt only when its entries
    list is swapped (churn)."""
    lib = nativelib.load()
    entries = layout.entries
    if lib is None or not entries:
        return None
    if layout.native_built_for is not entries or layout.native_out is None:
        keys = [ent[1].encode() for ent in entries]
        n = len(entries)
        # The c_char_p array holds pointers INTO the bytes objects; keep
        # the list alive alongside it.
        layout.native_keybytes = keys
        layout.native_keys = (ctypes.c_char_p * n)(*keys)
        layout.native_klens = (ctypes.c_int * n)(*map(len, keys))
        layout.native_kinds = (ctypes.c_ubyte * n)(*(e[0] for e in entries))
        layout.samples_template = [
            (e[2], e[3]) for e in entries if e[0] == 2
        ]
        layout.native_out = (ctypes.c_double * len(layout.samples_template))()
        layout.native_built_for = entries
    data = text.encode()
    got = lib.tpumon_parse_layout(
        data, len(data), layout.native_keys, layout.native_klens,
        layout.native_kinds, len(entries), layout.native_out,
    )
    if got != len(layout.native_out):
        return None
    return list(layout.native_out)


def load() -> "ctypes.CDLL | None":
    """Kept for tests: the shared library handle (or None)."""
    return nativelib.load()
