"""ctypes binding of ``fftconv.cu`` (built at first use by ``_build``)."""

from __future__ import annotations

import ctypes
import functools

from .. import _build


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    so = _build.load("fftconv")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    so.fftconv_fused.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i32, i32,
                                 i32, ptr]
    so.fftconv_fused.restype = ctypes.c_int
    so.fftconv_fused_error_string.argtypes = [ctypes.c_int]
    so.fftconv_fused_error_string.restype = ctypes.c_char_p
    return so
