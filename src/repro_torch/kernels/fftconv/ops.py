"""Public wrapper of the fused FFT-convolution kernel.

A CUDA tensor launches the hand-written kernel (``fftconv.cu``), and its
filter spectrum comes from the four-step kernel in permuted mode; a build
or launch failure raises. A CPU tensor runs the plain PyTorch version of
the kernel's schedule in ``ref.py``, which is what a caller asks for by
putting data on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...core import algo
from ..dft_matmul import ops as dft_ops
from .._grad import refuse_autograd
from . import binding
from .ref import filter_spectrum_plain, fftconv_fused_plain

#: kernel launches since the last reset (the CPU path does not count)
LAUNCHES = 0


def _factors(factors) -> Tuple[int, int]:
    n1, n2 = (int(f) for f in factors)
    top = dft_ops.MAX_FACTOR
    if not (1 <= n1 <= top and 1 <= n2 <= top):
        raise ValueError(f"factors must lie in 1..{top}: {factors}")
    return n1, n2


def filter_spectrum_permuted(h: torch.Tensor, factors: Tuple[int, int]
                             ) -> algo.Complex:
    """Real filter (nf,) -> its spectrum pair in the permuted order C[k1, k2]
    the kernel computes in, as ``algo.fft(..., permuted=True)`` gives it. On
    the card it is one launch of the four-step kernel."""
    n1, n2 = _factors(factors)
    if h.dim() != 1 or h.shape[0] != n1 * n2:
        raise ValueError(f"need a filter of shape ({n1}*{n2},), got "
                         f"{tuple(h.shape)}")
    if h.device.type == "cpu":
        return filter_spectrum_plain(h, (n1, n2))
    if h.dtype != torch.float32:
        raise TypeError(f"filter_spectrum_permuted takes float32, got "
                        f"{h.dtype}")
    return dft_ops.fft_four_step((h, torch.zeros_like(h)), (n1, n2),
                                 permuted=True)


def fftconv_fused(x: torch.Tensor, h: torch.Tensor,
                  factors: Tuple[int, int], *,
                  block_rows: int = 8) -> torch.Tensor:
    """y[b] = circular_conv(x[b], h): x (B, nf) and h (nf,) real float32,
    nf = n1*n2 with both factors in 1..128. ``block_rows`` (at least 1) is
    the reference's rows per grid step; the kernel's persistent CTAs size
    their work by shared memory and do not read it, and the result does not
    depend on it."""
    global LAUNCHES
    n1, n2 = _factors(factors)
    nf = n1 * n2
    if x.dim() != 2 or x.shape[1] != nf:
        raise ValueError(f"need x of shape (B, {n1}*{n2}), got "
                         f"{tuple(x.shape)}")
    if block_rows < 1:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    on_cpu = x.device.type == "cpu" and h.device.type == "cpu"
    if not on_cpu:
        if x.device.type != "cuda" or h.device != x.device:
            raise ValueError(f"fftconv_fused runs on one CUDA device or on "
                             f"the CPU, got {x.device} and {h.device}")
        if x.dtype != torch.float32 or h.dtype != torch.float32:
            raise TypeError(f"fftconv_fused takes float32, got {x.dtype} "
                            f"and {h.dtype}")
        refuse_autograd("fftconv_fused", x, h)
    h_spec = filter_spectrum_permuted(h, (n1, n2))
    if on_cpu:
        return fftconv_fused_plain(x, h_spec, (n1, n2))
    src = x.contiguous()
    out = torch.empty_like(src)
    if src.shape[0]:
        r1, tw, r2 = dft_ops.tables(n1, n2, x.device)
        spec = dft_ops.interleaved(h_spec)
        lib = binding.lib()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.fftconv_fused(src.data_ptr(), spec.data_ptr(),
                                   r1.data_ptr(), tw.data_ptr(),
                                   r2.data_ptr(), out.data_ptr(),
                                   src.shape[0], n1, n2, int(block_rows),
                                   stream)
        if rc:
            raise RuntimeError("fftconv_fused launch failed: "
                               + lib.fftconv_fused_error_string(rc).decode())
        LAUNCHES += 1
    return out
