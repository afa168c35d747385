"""Native host helpers (port of ``apex_tpu._native``, the host half of the
reference's ``apex_C``): pack many host buffers into one, unpack them
again, and the f64 sum of f32 squares behind a checkpoint's checksum.

The library is ``csrc/apex_c.cpp``, built with ``g++`` at first use into
``apex_tpu_torch/_build/`` under a name keyed on a hash of the source
(:func:`apex_tpu_torch._build.host_library`).  Every entry point keeps
the reference's NumPy fallback for a host without a compiler;
:func:`available` says which one runs.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# why the library did not load (None while it has not been tried, or
# when it loaded)
load_error: Optional[str] = None


def lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None (the NumPy fallbacks run)."""
    global _lib, _tried, load_error
    with _lock:
        if not _tried:
            _tried = True
            from apex_tpu_torch import _build
            try:
                l = _build.host_library("apex_c")
                i64p = ctypes.POINTER(ctypes.c_int64)
                l.apex_c_flatten.restype = None
                l.apex_c_flatten.argtypes = [
                    ctypes.POINTER(ctypes.c_void_p), i64p, ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_int64]
                l.apex_c_unflatten.restype = None
                l.apex_c_unflatten.argtypes = [
                    ctypes.c_void_p, i64p, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_void_p), ctypes.c_int64]
                l.apex_c_l2norm_sq_f32.restype = ctypes.c_double
                l.apex_c_l2norm_sq_f32.argtypes = [
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                    ctypes.c_int64]
                _lib = l
            except (RuntimeError, OSError) as e:
                load_error = f"{type(e).__name__}: {e}"
        return _lib


def available() -> bool:
    return lib() is not None


def _n_threads() -> int:
    return min(8, os.cpu_count() or 1)


def _bytes(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def host_flatten(arrays: List[np.ndarray]) -> np.ndarray:
    """Pack host arrays into one contiguous u8 buffer (``apex_C.flatten``
    on the host; any dtype)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    sizes = np.asarray([a.nbytes for a in arrays], np.int64)
    out = np.empty(int(sizes.sum()), np.uint8)
    l = lib()
    if l is None or not arrays:
        off = 0
        for a, nb in zip(arrays, sizes):
            out[off:off + nb] = _bytes(a)
            off += int(nb)
        return out
    ptrs = (ctypes.c_void_p * len(arrays))(
        *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays])
    l.apex_c_flatten(ptrs, sizes.ctypes.data_as(
        ctypes.POINTER(ctypes.c_int64)), len(arrays),
        out.ctypes.data_as(ctypes.c_void_p), _n_threads())
    return out


def host_unflatten(flat: np.ndarray, like: List[np.ndarray]
                   ) -> List[np.ndarray]:
    """Inverse of :func:`host_flatten`: split ``flat`` into new arrays
    shaped and typed as ``like``."""
    flat = _bytes(flat)
    outs = [np.empty(a.shape, a.dtype) for a in like]
    sizes = np.asarray([a.nbytes for a in outs], np.int64)
    if int(sizes.sum()) != flat.nbytes:
        raise ValueError(f"host_unflatten: {flat.nbytes} bytes for arrays "
                         f"of {int(sizes.sum())}")
    l = lib()
    if l is None or not outs:
        off = 0
        for o, nb in zip(outs, sizes):
            _bytes(o)[:] = flat[off:off + int(nb)]
            off += int(nb)
        return outs
    ptrs = (ctypes.c_void_p * len(outs))(
        *[o.ctypes.data_as(ctypes.c_void_p) for o in outs])
    l.apex_c_unflatten(flat.ctypes.data_as(ctypes.c_void_p),
                       sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                       len(outs), ptrs, _n_threads())
    return outs


def host_l2norm(x: np.ndarray) -> float:
    """L2 norm of a host f32 buffer, squares summed in f64 (threaded):
    the checkpoint checksum."""
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    l = lib()
    if l is None:
        return float(np.linalg.norm(x.astype(np.float64)))
    return float(l.apex_c_l2norm_sq_f32(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.size,
        _n_threads())) ** 0.5
