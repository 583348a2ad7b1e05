"""N-D FFT executors: the single-card layer.

Port of the local part of ``repro.core.dfft``: the pad-and-crop helpers,
the transform along one axis, and the any-length real-input rows. The slab,
pencil and factor1d executors need several ranks and come with the
distributed layer.

The move of an axis to the end and back (``moveaxis`` in the reference) is
a batched transpose: a contiguous array of shape ``pre + (n,) + post`` is a
``(B, n, M)`` block with ``B = prod(pre)`` and ``M = prod(post)``, and
moving axis ``n`` last is ``(B, n, M) -> (B, M, n)``. On the GPU that runs
the tiled transpose kernel (``repro_torch.kernels.transpose``), on the CPU
its plain version; both give the very values ``moveaxis`` gives.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.transpose import transpose
from . import algo
from .plan import Plan, Planner, execute, execute_inverse

Complex = algo.Complex

__all__ = ["rows_rfft", "rows_irfft", "hermitian_extend_last"]


# ---------------------------------------------------------------------------
# shared pad-and-crop layer
# ---------------------------------------------------------------------------


def _pad_axis(c: Complex, axis: int, target: int) -> Complex:
    """Zero-pad one axis of an (re, im) pair up to ``target`` entries."""
    pad = target - c[0].shape[axis]
    if pad <= 0:
        return c
    shape = list(c[0].shape)
    shape[axis] = pad
    zeros = c[0].new_zeros(shape)
    return torch.cat([c[0], zeros], axis), torch.cat([c[1], zeros], axis)


def _crop_axis(c: Complex, axis: int, n: int) -> Complex:
    """Crop one axis of a pair back to its true length ``n``."""
    if c[0].shape[axis] == n:
        return c
    return c[0].narrow(axis, 0, n), c[1].narrow(axis, 0, n)


def move_blocks(shape, axis: int):
    """The blocks the transpose is handed to move ``axis`` of a contiguous
    ``shape`` last, ``(B, n, M)``, and to move it back, ``(B, M, n)``."""
    b, n, m = math.prod(shape[:axis]), shape[axis], math.prod(shape[axis + 1:])
    return (b, n, m), (b, m, n)


def _axis_last(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``moveaxis(x, axis, -1)`` through the batched transpose."""
    shape = tuple(x.shape)
    block, _ = move_blocks(shape, axis)
    y = transpose(x.contiguous().view(block))
    return y.view(shape[:axis] + shape[axis + 1:] + (shape[axis],))


def _axis_back(y: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of :func:`_axis_last`: ``moveaxis(y, -1, axis)``."""
    shape = tuple(y.shape)
    pre, post, n = shape[:axis], shape[axis:-1], shape[-1]
    _, block = move_blocks(pre + (n,) + post, axis)
    x = transpose(y.contiguous().view(block))
    return x.view(pre + (n,) + post)


def _fft_axis(plan: Plan, c: Complex, axis: int, inverse: bool = False
              ) -> Complex:
    """c2c transform along one (fully local) axis of a pair."""
    run = execute_inverse if inverse else execute
    axis = axis % c[0].dim()
    if axis == c[0].dim() - 1:
        return run(plan, c)
    zt = run(plan, (_axis_last(c[0], axis), _axis_last(c[1], axis)))
    return _axis_back(zt[0], axis), _axis_back(zt[1], axis)


def hermitian_extend_last(c: Complex, n: int) -> Complex:
    """Rebuild the full length-``n`` spectrum from the half spectrum of a
    real signal along the last axis: ``F[k] = conj(F[n-k])`` for k > n//2.
    Valid whenever every other axis is already in its real/spatial form."""
    mh = n // 2 + 1
    idx = torch.from_numpy(np.arange(n - mh, 0, -1)).to(c[0].device)
    return (torch.cat([c[0], c[0][..., idx]], -1),
            torch.cat([c[1], -c[1][..., idx]], -1))


def rows_rfft(planner: Planner, x: torch.Tensor, n: int) -> Complex:
    """r2c FFT along the last axis for ANY length: even lengths use the
    packed real path, odd lengths a c2c transform of the real signal
    cropped to the half spectrum."""
    if n % 2 == 0:
        return execute(planner.plan(n, kind="r2c"), x)
    re, im = execute(planner.plan(n, kind="c2c"), (x, torch.zeros_like(x)))
    return re[..., : n // 2 + 1], im[..., : n // 2 + 1]


def rows_irfft(planner: Planner, c: Complex, n: int) -> torch.Tensor:
    """c2r inverse of :func:`rows_rfft` (input ``(..., n//2+1)``)."""
    if n % 2 == 0:
        return execute(planner.plan(n, kind="c2r"), c)
    full = hermitian_extend_last(c, n)
    return execute_inverse(planner.plan(n, kind="c2c"), full)[0]
