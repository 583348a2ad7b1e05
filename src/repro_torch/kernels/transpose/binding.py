"""ctypes binding of ``transpose.cu`` (built at first use by ``_build``)."""

from __future__ import annotations

import ctypes
import functools

from .. import _build


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    so = _build.load("transpose")
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    so.batched_transpose.argtypes = [ptr, ptr, i64, i64, i64, ctypes.c_int,
                                     ptr]
    so.batched_transpose.restype = ctypes.c_int
    so.batched_transpose_error_string.argtypes = [ctypes.c_int]
    so.batched_transpose_error_string.restype = ctypes.c_char_p
    return so
