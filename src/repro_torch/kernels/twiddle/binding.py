"""ctypes binding of ``twiddle.cu`` (built at first use by ``_build``)."""

from __future__ import annotations

import ctypes
import functools

from .. import _build


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    so = _build.load("twiddle")
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    so.complex_multiply.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i64,
                                    i64, ptr]
    so.complex_multiply.restype = ctypes.c_int
    so.complex_multiply_error_string.argtypes = [ctypes.c_int]
    so.complex_multiply_error_string.restype = ctypes.c_char_p
    return so
