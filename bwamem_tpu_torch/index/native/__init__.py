"""Native helpers for index construction.

`suffix_array_sais(t)` — linear-time SA-IS suffix array over nt4 codes with
an implicit smallest sentinel, drop-in for the NumPy prefix-doubling
builder (same output contract).  The C source (sais.c) is compiled to a
shared library in the repository's `build/` directory on first use with
the system compiler; callers fall back to the NumPy path when compilation is
unavailable (`available()` is False).
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from bwamem_tpu_torch._build import shared_lib

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sais.c")
_lock = threading.Lock()
_lib = None
_failed = False


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            lib = ctypes.CDLL(shared_lib(
                _SRC, "libsais.so", ["cc", "-O3", "-shared", "-fPIC"]))
            lib.sais_u8_entry.restype = ctypes.c_int
            lib.sais_u8_entry.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64]
            _lib = lib
        except (OSError, RuntimeError):
            _failed = True
        return _lib


def available() -> bool:
    return _load() is not None


def suffix_array_sais(t: np.ndarray, full: bool = False) -> np.ndarray:
    """Suffix array of `t` (small non-negative integer codes) under an
    implicit terminal sentinel smaller than every symbol; returns the n
    real suffix positions in rank order (sentinel suffix excluded) —
    exactly the contract of index.build.suffix_array.  With full=True,
    returns the whole (n+1)-rank array including the sentinel at rank 0
    (sa[0] == n) without slicing — giga-scale callers use the buffer
    directly as SA_full."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native sais unavailable")
    n = len(t)
    if n == 0:
        return (np.asarray([0], np.int64) if full
                else np.zeros(0, dtype=np.int64))
    hi = int(t.max())
    s = np.empty(n + 1, dtype=np.uint8)
    s[:n] = t + 1                      # shift so 0 is free for the sentinel
    s[n] = 0
    sa = np.empty(n + 1, dtype=np.int64)
    rc = lib.sais_u8_entry(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n + 1), ctypes.c_int64(hi + 2))
    if rc != 0:
        raise RuntimeError("sais failed")
    assert sa[0] == n                  # sentinel suffix ranks first
    return sa if full else sa[1:]
