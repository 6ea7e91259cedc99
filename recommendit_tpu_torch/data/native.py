"""ctypes binding of the native fastparse library (``native/fastparse.cpp``)
— torch port of ``recommendit_tpu/data/native.py``, with its API.

The library is built from the repo's unedited source at first use
(``utils/native_build.py``); where it cannot be built, :func:`available`
is false and :func:`parse_int4_file` returns ``None``, and callers take the
numpy parser (``data/movielens.py``), as JAX's take the Python one. The
binding copies the malloc'd columns into numpy arrays and frees the C
buffers.
"""
from __future__ import annotations

import ctypes
import logging
from typing import Optional, Tuple

import numpy as np

from recommendit_tpu_torch.utils.native_build import load_native

logger = logging.getLogger(__name__)

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    lib = load_native("fastparse.cpp", "libfastparse")
    if lib is None:
        logger.info("native fastparse unavailable: the numpy parser reads ratings")
        return None
    lib.parse_int4_file.restype = ctypes.c_int64
    lib.parse_int4_file.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
    ]
    lib.fastparse_free.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    logger.info("native fastparse loaded: it reads ratings")
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def parse_int4_file(path: str) -> Optional[Tuple[np.ndarray, ...]]:
    """An all-integer ``a::b::c::d`` file → 4 int64 arrays (lines with
    fewer than 4 fields skipped). ``None`` when the library is unavailable
    or the file cannot be read (callers then use the numpy parser)."""
    lib = _load()
    if lib is None:
        return None
    ptrs = [ctypes.POINTER(ctypes.c_int64)() for _ in range(4)]
    n = lib.parse_int4_file(str(path).encode(), *[ctypes.byref(p) for p in ptrs])
    if n < 0:
        return None
    try:
        cols = tuple(np.ctypeslib.as_array(p, shape=(n,)).copy() if n else
                     np.zeros(0, np.int64) for p in ptrs)
    finally:
        for p in ptrs:
            lib.fastparse_free(p)
    return cols
