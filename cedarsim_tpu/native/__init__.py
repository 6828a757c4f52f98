"""Native (C++) components, built on demand with the system toolchain.

The compute path is JAX/XLA; these are the host-side runtime pieces
that the reference delegates to native dependencies (SURVEY.md §2.10):
currently the sparse symbolic-factorization planner (KLU's symbolic half).
A pure-Python fallback keeps everything working without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))


def _cache_dir():
    """Where the built library goes: CEDARSIM_TPU_NATIVE_CACHE, else
    ``.cedarsim_cache/native`` in the checkout."""
    from cedarsim_tpu.config import LOCAL_CACHE
    return os.environ.get("CEDARSIM_TPU_NATIVE_CACHE",
                          os.path.join(LOCAL_CACHE, "native"))


_lib = None
_tried = False


def _build():
    src = os.path.join(_HERE, "symbolic.cpp")
    cache = _cache_dir()
    os.makedirs(cache, exist_ok=True)
    out = os.path.join(cache, "libcsim_symbolic.so")
    if (not os.path.exists(out)
            or os.path.getmtime(out) < os.path.getmtime(src)):
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp],
            check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def get_lib():
    """ctypes handle to the native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        path = _build()
        lib = ctypes.CDLL(path)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.csim_md_order.argtypes = [ctypes.c_int, ip, ip, ip]
        lib.csim_md_order.restype = ctypes.c_int
        lib.csim_symbolic_fill.argtypes = [ctypes.c_int, ip, ip, ip, ip]
        lib.csim_symbolic_fill.restype = ctypes.c_longlong
        _lib = lib
    except Exception:
        _lib = None
    return _lib
