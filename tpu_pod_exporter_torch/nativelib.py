"""Single loader for libtpumon.so — shared by device discovery and the
exposition renderer.

One CDLL handle, one candidate search (``TPE_NATIVE_LIB`` env override →
in-repo build → system path), one ABI check. Any load/symbol/ABI surprise
disables the native path; callers always have a pure-Python fallback, so a
bad .so can never take the exporter down.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path

log = logging.getLogger("tpu_pod_exporter_torch.nativelib")

ABI_VERSION = 4

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _candidates(notes: list):
    env = os.environ.get("TPE_NATIVE_LIB")
    if env:
        yield Path(env)
    # This package's own build of native/tpumon.cc, compiled at first use.
    try:
        yield build()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        notes.append((logging.WARNING, "cannot build %s: %s", (SOURCE, e)))
    yield Path("/usr/local/lib/libtpumon.so")


SOURCE = Path(__file__).resolve().parent / "native" / "tpumon.cc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# The flags of the JAX package's native/Makefile.
CXX_FLAGS = ("-O2", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared")


def library_path() -> Path:
    """Where the build of ``native/tpumon.cc`` lives: keyed by a hash of
    the source and the flags, so an edit to either builds anew."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtpumon-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/tpumon.cc`` with g++ unless its build exists;
    return the library's path. Writes to a temporary name and renames, so a
    concurrent loader never opens a half-written file. Raises OSError (no
    compiler, no writable build directory) or RuntimeError (with the
    compiler's output)."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                               f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load() -> ctypes.CDLL | None:
    global _lib, _tried
    # Load outcomes are collected here and logged AFTER the lock releases
    # (lock-io discipline): log handlers do stream I/O, and the first
    # caller to race in during startup must not serialize behind it.
    notes: list[tuple[int, str, tuple]] = []
    with _lock:
        lib = _load_locked(notes)
    for level, fmt, args in notes:
        log.log(level, fmt, *args)
    return lib


def _load_locked(notes: list) -> ctypes.CDLL | None:
    """Candidate search + ABI check; caller holds ``_lock``. Messages are
    appended to ``notes`` as (level, fmt, args) instead of logged."""
    global _lib, _tried
    if not _tried:
        _tried = True
        for cand in _candidates(notes):
            if not cand.exists():
                continue
            try:
                lib = ctypes.CDLL(str(cand))
                lib.tpumon_abi_version.restype = ctypes.c_int
                if lib.tpumon_abi_version() != ABI_VERSION:
                    notes.append((
                        logging.WARNING, "%s: ABI version mismatch, ignoring",
                        (cand,),
                    ))
                    continue
                lib.tpumon_count_devices.restype = ctypes.c_int
                lib.tpumon_count_devices.argtypes = [ctypes.c_char_p]
                lib.tpumon_list_devices.restype = ctypes.c_int
                lib.tpumon_list_devices.argtypes = [
                    ctypes.c_char_p,
                    ctypes.c_char_p,
                    ctypes.c_long,
                ]
                lib.tpumon_render.restype = ctypes.c_long
                lib.tpumon_render.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.c_long,
                    ctypes.c_char_p,
                    ctypes.c_long,
                ]
                lib.tpumon_render2.restype = ctypes.c_long
                lib.tpumon_render2.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.c_long,
                    ctypes.c_char_p,
                    ctypes.c_long,
                ]
                lib.tpumon_scan_proc.restype = ctypes.c_long
                lib.tpumon_scan_proc.argtypes = [
                    ctypes.c_char_p,
                    ctypes.c_char_p,
                    ctypes.c_char_p,
                    ctypes.c_long,
                ]
                lib.tpumon_parse_layout.restype = ctypes.c_long
                lib.tpumon_parse_layout.argtypes = [
                    ctypes.c_char_p,
                    ctypes.c_long,
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_ubyte),
                    ctypes.c_long,
                    ctypes.POINTER(ctypes.c_double),
                ]
                _lib = lib
                notes.append((
                    logging.INFO, "libtpumon loaded from %s", (cand,),
                ))
                break
            except (OSError, AttributeError) as e:
                notes.append((
                    logging.WARNING, "cannot load native lib %s: %s",
                    (cand, e),
                ))
    return _lib


def reset_for_tests() -> None:
    global _lib, _tried
    with _lock:
        _lib = None
        _tried = False
