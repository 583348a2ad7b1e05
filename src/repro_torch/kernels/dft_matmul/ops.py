"""Public wrapper of the four-step FFT kernel.

A CUDA tensor launches the hand-written kernel (``dft_matmul.cu``); a build
or launch failure raises. A CPU tensor runs the plain PyTorch version in
``ref.py``, which is what a caller asks for by putting data on the CPU.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ...core import algo
from .._grad import refuse_autograd
from . import binding
from .ref import fft_four_step_ref

MAX_FACTOR = 128

#: kernel launches since the last reset (the CPU path does not count)
LAUNCHES = 0

_TABLES: Dict[tuple, Tuple[torch.Tensor, ...]] = {}


def interleaved(c: algo.Complex) -> torch.Tensor:
    return torch.stack(c, dim=-1).contiguous()      # float2 per entry


def tables(n1: int, n2: int, device: torch.device):
    """The roots w^k of n1, T, and the roots of n2 (sign -1), as interleaved
    complex tensors on ``device``: the radix kernels' twiddle tables."""
    key = (n1, n2, device)
    if key not in _TABLES:
        _TABLES[key] = (
            interleaved(algo.roots(n1, -1, device)),
            interleaved(algo.twiddle_factors(n1, n2, -1, device)),
            interleaved(algo.roots(n2, -1, device)))
    return _TABLES[key]


def fft_four_step(x: algo.Complex, factors: Tuple[int, int], *,
                  karatsuba: bool = False,
                  permuted: bool = False) -> algo.Complex:
    """Batched c2c FFT (sign -1) along the last axis; x = (re, im), shape
    (..., n1*n2) float32. ``permuted`` skips the digit transpose."""
    global LAUNCHES
    xr, xi = x
    n1, n2 = (int(f) for f in factors)
    n = n1 * n2
    if xr.shape != xi.shape or xr.shape[-1] != n:
        raise ValueError(f"need a pair of shape (..., {n1}*{n2}), got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    if xr.device.type == "cpu" and xi.device.type == "cpu":
        return fft_four_step_ref(x, (n1, n2), karatsuba=karatsuba,
                                 permuted=permuted)
    if xr.device.type != "cuda" or xi.device != xr.device:
        raise ValueError(f"fft_four_step runs on one CUDA device or on the "
                         f"CPU, got {xr.device} and {xi.device}")
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"fft_four_step takes float32, got {xr.dtype}")
    if not (1 <= n1 <= MAX_FACTOR and 1 <= n2 <= MAX_FACTOR):
        raise ValueError(f"factors must lie in 1..{MAX_FACTOR}: {factors}")
    refuse_autograd("fft_four_step", xr, xi)
    batch = tuple(xr.shape[:-1])
    a = xr.reshape(-1, n).contiguous()
    b = xi.reshape(-1, n).contiguous()
    yr, yi = torch.empty_like(a), torch.empty_like(b)
    rows = a.shape[0]
    if rows:
        r1, tw, r2 = tables(n1, n2, xr.device)
        lib = binding.lib()
        with torch.cuda.device(xr.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.four_step_fft(a.data_ptr(), b.data_ptr(), r1.data_ptr(),
                                   tw.data_ptr(), r2.data_ptr(),
                                   yr.data_ptr(), yi.data_ptr(), rows, n1, n2,
                                   int(karatsuba), int(permuted), stream)
        if rc:
            raise RuntimeError("four_step_fft launch failed: "
                               + lib.four_step_fft_error_string(rc).decode())
        LAUNCHES += 1
    return yr.reshape(batch + (n,)), yi.reshape(batch + (n,))
