"""Native (C++) runtime components, built on demand with the system
toolchain and loaded via ctypes — no pybind11/pip dependency. Every
native path has a pure-Python fallback; set RAY_TPU_TORCH_NATIVE=0 to
force the fallbacks.

The port's copy of ``ray_tpu/_native``. The library, its cache
directory and its switches carry the port's own names
(``libray_tpu_torch_ringbuf.so`` under ``RAY_TPU_TORCH_NATIVE_CACHE``,
default ``<tmp>/ray_tpu_torch_native-py<ver>``), so the two packages
never load each other's build.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_dir() -> str:
    d = os.environ.get("RAY_TPU_TORCH_NATIVE_CACHE") or os.path.join(
        tempfile.gettempdir(),
        f"ray_tpu_torch_native-py{sys.version_info[0]}"
        f"{sys.version_info[1]}")
    os.makedirs(d, exist_ok=True)
    return d


def _ensure_built() -> Optional[str]:
    src = os.path.join(_HERE, "ringbuf.cc")
    out = os.path.join(_build_dir(), "libray_tpu_torch_ringbuf.so")
    try:
        if os.path.exists(out) and \
                os.path.getmtime(out) >= os.path.getmtime(src):
            return out
        tmp = out + f".tmp{os.getpid()}"
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
             "-o", tmp, src],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        return None


def load_ringbuf() -> Optional[ctypes.CDLL]:
    """The compiled ring library, or None (caller falls back to
    Python). Compilation happens once per machine/python; concurrent
    builders race benignly via the atomic rename."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("RAY_TPU_TORCH_NATIVE", "1") in ("0", "false", "off"):
        return None
    path = _ensure_built()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    u64, u8p = ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8)
    lib.rb_write.argtypes = [u8p, u64, u64, ctypes.c_char_p, u64,
                             ctypes.c_uint8, ctypes.c_double]
    lib.rb_write.restype = ctypes.c_int
    lib.rb_read.argtypes = [u8p, u64, u64, u8p, u64,
                            ctypes.POINTER(ctypes.c_uint8),
                            ctypes.POINTER(u64), ctypes.c_double]
    lib.rb_read.restype = ctypes.c_int64
    lib.rb_wait_readable.argtypes = [u8p, u64, u64, ctypes.c_double]
    lib.rb_wait_readable.restype = ctypes.c_int64
    lib.rb_release.argtypes = [u8p]
    lib.rb_release.restype = None
    lib.rb_has_space.argtypes = [u8p, u64]
    lib.rb_has_space.restype = ctypes.c_int
    lib.rb_wait_space.argtypes = [u8p, u64, ctypes.c_double]
    lib.rb_wait_space.restype = ctypes.c_int
    lib.rb_publish_write.argtypes = [u8p]
    lib.rb_publish_write.restype = None
    lib.rb_wake_readers.argtypes = [u8p]
    lib.rb_wake_readers.restype = None
    lib.rb_wake_writers.argtypes = [u8p]
    lib.rb_wake_writers.restype = None
    _LIB = lib
    return lib
