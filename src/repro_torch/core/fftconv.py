"""FFT-based long convolution on one device, ported from
``repro.core.fftconv``.

Hyena/S4-style token mixing is a length-L causal convolution, computed as

    y = ifft( fft(pad(u)) * fft(pad(k)) )[:L]

with a c2c plan in permuted frequency order (the pointwise product commutes
with the four-step digit permutation, so the forward digit transpose and
the inverse's un-permute are both skipped). On the GPU the product is the
complex-multiply kernel (``repro_torch.kernels.twiddle``), the forward
transforms run the four-step kernel under the ``hopper`` planner, and the
``(B, L, D) <-> (B, D, L)`` moves run the tiled transpose kernel; on the
CPU their plain versions run. The sequence-sharded variant
(``fft_conv_seq_sharded``) comes with the distributed layer.

Device policy: ``device=None`` means the GPU and raises without one; pass
``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.transpose import transpose
from ..kernels.twiddle import complex_multiply
from . import algo
from .plan import Planner, execute, execute_inverse, resolve_device

__all__ = ["next_fft_len", "factor_split", "filter_basis",
           "materialize_filter", "fft_conv"]


def next_fft_len(n: int) -> int:
    """Smallest power of two >= n (all assigned seq lens are powers of two)."""
    m = 1
    while m < n:
        m *= 2
    return m


def factor_split(n: int, p: int) -> Optional[Tuple[int, int]]:
    """Factor a 1D transform length for the distributed factor-split FFT:
    ``n = n1 * n2`` with both factors divisible by ``p`` and as close to
    ``sqrt(n)`` as the divisors allow. Returns ``None`` when no such split
    exists (``n`` not a multiple of ``p**2``, or a factor would be an
    unfactorizable prime)."""
    if p < 1 or n % (p * p):
        return None
    r = n // (p * p)
    best = None
    for a in range(1, math.isqrt(r) + 1):
        if r % a == 0:
            best = a                    # largest divisor <= sqrt(r)
    n1, n2 = p * best, p * (r // best)
    try:                                # both stages must be plannable
        algo.default_factorization(n1)
        algo.default_factorization(n2)
    except ValueError:
        return None
    return n1, n2


# ---------------------------------------------------------------------------
# implicit filter parameterization (Hyena-lite): tiny param count at any L
# ---------------------------------------------------------------------------


def filter_basis(length: int, rank: int, dtype=torch.float32,
                 device="cpu") -> torch.Tensor:
    """(rank, length) damped-oscillator basis, built in float32 in the
    reference's order of operations."""
    t = (torch.arange(length, dtype=torch.float32, device=device)[None, :]
         / max(length, 1))
    r = torch.arange(rank, dtype=torch.float32, device=device)[:, None]
    decay = torch.exp(-torch.exp(0.5 * r) * t)
    phase = torch.cos(2.0 * np.pi * (r + 1.0) * t)
    return (decay * phase).to(dtype)


def materialize_filter(weights: torch.Tensor, length: int) -> torch.Tensor:
    """weights (D, rank) -> causal filters (D, length)."""
    basis = filter_basis(length, weights.shape[-1], weights.dtype,
                         weights.device)
    return weights @ basis


# ---------------------------------------------------------------------------
# single-device FFT convolution
# ---------------------------------------------------------------------------


def fft_conv(u: torch.Tensor, k: torch.Tensor,
             planner: Optional[Planner] = None, permuted: bool = True,
             device=None) -> torch.Tensor:
    """Causal convolution via FFT.

    u: (B, L, D) real activations; k: (D, L) real causal filters. Returns
    (B, L, D) in ``u``'s dtype, on ``device`` (None: the GPU). Uses c2c on
    the real signal (imag = 0) so the permuted-order transpose elision
    applies end to end. On the GPU the kernels record nothing for autograd:
    an input that requires grad raises unless autograd is off.
    """
    dev = resolve_device(device)
    u = torch.as_tensor(u).to(dev)
    b, slen, d = u.shape
    nf = next_fft_len(2 * slen)
    planner = planner or Planner(backends=("torch",))
    plan = planner.plan(nf, kind="c2c", permuted=permuted)

    ut = transpose(u).float()                                   # (B, D, L)
    up = torch.nn.functional.pad(ut, (0, nf - slen))
    kp = torch.nn.functional.pad(torch.as_tensor(k).to(dev).float(),
                                 (0, nf - slen))

    uf = execute(plan, (up, torch.zeros_like(up)))
    kf = execute(plan, (kp, torch.zeros_like(kp)))
    prod = complex_multiply(uf, kf)
    y = execute_inverse(plan, prod)[0]                          # real part
    return transpose(y[..., :slen]).to(u.dtype)
