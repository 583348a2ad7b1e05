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
CPU their plain versions run.

``fft_conv_seq_sharded`` is the paper's distributed algorithm with the
sequence sharded over a mesh axis: the length-nf signal is viewed as an
(n1, n2) row-major matrix sharded over n1,

  stage A: all_to_all -> columns local; DFT along n1; twiddle T[k1, n2]
  stage B: all_to_all -> rows local;    DFT along n2

and the spectrum C[k1, k2] stays row-sharded in permuted order, so the
pointwise product needs no global transpose; the inverse retraces the
stages. Each rank passes its (B, L/p, D) block of the activations and the
whole (D, L) filters, and gets back its (B, L/p, D) block of the output.
It works in (B, D, n1, n2) order, in which the (n1, n2/p) twiddle is a
trailing block of the activations and the complex-multiply kernel reads
it without expanding it.

Device policy: ``device=None`` means the GPU and raises without one; pass
``device="cpu"`` to run on the CPU. The sharded convolution runs on the
mesh's device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.transpose import transpose
from ..kernels.twiddle import complex_multiply
from . import algo, dfft
from .comm import (CommBackend, CommSpec, get_backend, measure_comm_conv,
                   mesh_device, mesh_sizes, plan_comm_conv, reshard_last)
from .plan import Planner, execute, execute_inverse, resolve_device

Complex = algo.Complex

__all__ = ["next_fft_len", "factor_split", "filter_basis",
           "materialize_filter", "fft_conv", "fft_conv_seq_sharded"]


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


# ---------------------------------------------------------------------------
# sequence-sharded distributed FFT convolution
# ---------------------------------------------------------------------------


def _inv_exec(plan, x: Complex) -> Complex:
    """Unnormalized inverse (sign=+1) transform with the plan's recipe, on
    ``torch.matmul`` as in the reference."""
    return algo.fft(x, sign=+1, factors=plan.factors or None,
                    karatsuba=plan.karatsuba)


def _dist_fft_permuted(x: Complex, group, p: int, me: int, n1: int, n2: int,
                       sign: int, planner: Planner,
                       backend: Optional[CommBackend] = None) -> Complex:
    """Distributed c2c FFT along the last axis of this rank's (..., Lloc)
    block of a length n1*n2 signal, row-major (n1, n2) and sharded over n1
    (``me`` is this rank's index in ``group``). Returns C[k1, k2] in
    permuted order, k1-sharded: a (..., Lloc) block."""
    backend = backend or get_backend("collective")
    lead, lloc = tuple(x[0].shape[:-1]), x[0].shape[-1]
    n1loc = n1 // p
    if lloc != n1loc * n2:
        raise ValueError(f"a block of {lloc} is not ({n1}/{p}) x {n2}")
    plan1 = planner.plan(n1, kind="c2c")
    plan2 = planner.plan(n2, kind="c2c")
    i1, i2 = len(lead), len(lead) + 1

    def dft(plan, z):
        return execute(plan, z) if sign < 0 else _inv_exec(plan, z)

    a = tuple(t.reshape(lead + (n1loc, n2)) for t in x)
    # stage A: columns local
    a = backend.exchange(a, group, split=i2, concat=i1, p=p)  # (n1, n2/p)
    a = dfft.along_axis(lambda z: dft(plan1, z), a, i1)
    # twiddle T[k1, n2-block]: this rank's n2 columns, built once and kept
    a = complex_multiply(a, dfft._factor1d_twiddle_block(
        n1, n2, me, p, sign, chunk_axis=1, device=a[0].device))
    # stage B: rows local
    c = backend.exchange(a, group, split=i1, concat=i2, p=p)  # (n1/p, n2)
    c = dft(plan2, c)
    return tuple(t.reshape(lead + (lloc,)) for t in c)


def _dist_ifft_permuted(x: Complex, group, p: int, me: int, n1: int, n2: int,
                        planner: Planner,
                        backend: Optional[CommBackend] = None) -> Complex:
    """Inverse of :func:`_dist_fft_permuted` (consumes permuted order)."""
    backend = backend or get_backend("collective")
    lead, lloc = tuple(x[0].shape[:-1]), x[0].shape[-1]
    n1loc = n1 // p
    plan1 = planner.plan(n1, kind="c2c")
    plan2 = planner.plan(n2, kind="c2c")
    i1, i2 = len(lead), len(lead) + 1

    c = tuple(t.reshape(lead + (n1loc, n2)) for t in x)
    # inverse DFT along k2 (rows are local)
    c = _inv_exec(plan2, c)
    # conjugate twiddle T[k1-block, n2]
    c = complex_multiply(c, dfft._factor1d_twiddle_block(
        n1, n2, me, p, +1, chunk_axis=0, device=c[0].device))
    # all_to_all -> columns local; inverse DFT along k1
    a = backend.exchange(c, group, split=i2, concat=i1, p=p)  # (n1, n2/p)
    a = dfft.along_axis(lambda z: _inv_exec(plan1, z), a, i1)
    # back to the row-sharded layout
    o = backend.exchange(a, group, split=i1, concat=i2, p=p)  # (n1/p, n2)
    scale = 1.0 / (n1 * n2)
    return tuple(t.reshape(lead + (lloc,)) * scale for t in o)


def fft_conv_seq_sharded(u: torch.Tensor, k: torch.Tensor, mesh, axis: str,
                         planner: Optional[Planner] = None,
                         comm: CommSpec = "collective",
                         chunks: int = 4) -> torch.Tensor:
    """Causal FFT convolution with the sequence sharded over mesh axis
    ``axis``, on the mesh's device (every rank of the axis calls it).

    u: this rank's (B, L/p, D) block of the activations (rank r holds
    positions r*L/p..); k: the whole (D, L) causal filters, the same on
    every rank. Returns this rank's (B, L/p, D) block of the output, in
    ``u``'s dtype. ``comm`` picks the exchange backend; ``"auto"`` plans it
    from the roofline, ``"measure"`` times the backends on the live mesh
    (verdict cached in the planner's wisdom). The zero padding to nf is one
    exchange in and one out (uneven all_to_alls; nothing at p = 1): rank r's
    block of the padded sequence is not its block of ``u``."""
    planner = planner or Planner(backends=("torch",))
    dev = mesh_device(mesh)
    u = torch.as_tensor(u).to(dev)
    b, lloc, d = u.shape
    p, me = mesh_sizes(mesh)[axis], mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    slen = lloc * p
    k = torch.as_tensor(k).to(dev)
    if tuple(k.shape) != (d, slen):
        raise ValueError(f"filters {tuple(k.shape)}, a block {tuple(u.shape)}"
                         f" over {p} ranks needs ({d}, {slen})")
    nf = next_fft_len(2 * slen)
    # both factors near sqrt(nf), each divisible by p (stage-A AND stage-B
    # exchanges are tiled all_to_alls): the factor1d decomposition's split
    split = factor_split(nf, p)
    if split is None:
        raise ValueError(f"sequence too short for the mesh: nf={nf}, p={p}")
    n1, n2 = split
    if comm == "auto":
        comm = plan_comm_conv(b, d, n1, n2, p, hw=planner.hw,
                              planner=planner)
    elif comm == "measure":
        comm = measure_comm_conv(b, d, n1, n2, mesh, axis,
                                 wisdom=planner.wisdom, hw=planner.hw)
    backend = get_backend(comm, chunks=chunks)
    w = nf // p

    # this rank's blocks of the zero-padded sequences, (B, D, nf/p) and
    # (D, nf/p): the filters are whole on every rank, so only u moves
    up = reshard_last(transpose(u).float(), group, p, me, w, slen)
    lo, hi = min(me * w, slen), min(me * w + w, slen)
    kp = torch.nn.functional.pad(k[:, lo:hi].float(), (0, w - (hi - lo)))

    uf = _dist_fft_permuted((up, torch.zeros_like(up)), group, p, me, n1,
                            n2, -1, planner, backend)
    kf = _dist_fft_permuted((kp, torch.zeros_like(kp)), group, p, me, n1,
                            n2, -1, planner, backend)
    prod = complex_multiply(uf, kf)
    y = _dist_ifft_permuted(prod, group, p, me, n1, n2, planner,
                            backend)[0]                  # real part
    y = reshard_last(y, group, p, me, lloc, slen)        # (B, D, L/p)
    return transpose(y).to(u.dtype)
