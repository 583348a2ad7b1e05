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

``fft_conv`` is a ``torch.autograd.Function`` whose backward runs the same
ops. The gradient of a causal convolution is a correlation, an FFT
convolution against the conjugate spectrum: with ``G`` the spectrum of the
zero-padded output gradient ``g``, ``grad_u = crop(ifft(G * conj(K)))`` and
``grad_k = crop(ifft(sum_b conj(U_b) * G_b))``. Both crops are exact:
``nf >= 2L``, so a circular correlation cropped to its first L entries
wraps only onto the zero padding. The forward saves the spectra ``U`` and
``K`` (in the plan's order, permuted or not); under non-reentrant
checkpointing they come from the recompute.

``fft_conv_seq_sharded`` is the paper's distributed algorithm with the
sequence sharded over a mesh axis: the length-nf signal is viewed as an
(n1, n2) row-major matrix sharded over n1,

  stage A: all_to_all -> columns local; DFT along n1; twiddle T[k1, n2]
  stage B: all_to_all -> rows local;    DFT along n2

and the spectrum C[k1, k2] stays row-sharded in permuted order, so the
pointwise product needs no global transpose; the inverse retraces the
stages. Each rank passes its (B, L/p, D) block of the activations and the
whole (D, L) filters, and gets back its (B, L/p, D) block of the output.
Its backward is the same correlation on the same distributed transforms:
the output gradient's block through the forward stages, the products with
the saved spectra's conjugates, the inverse stages; the filters' gradient
comes back whole on every rank.
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
import torch.distributed as dist
from torch.autograd.function import once_differentiable

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


def _spectrum(plan, x: torch.Tensor) -> Complex:
    """The plan's transform of the real rows ``x`` (..., L), zero-padded to
    ``plan.n``, in float32."""
    xp = torch.nn.functional.pad(x.float(), (0, plan.n - x.shape[-1]))
    return execute(plan, (xp, torch.zeros_like(xp)))


def _real_crop(plan, spec: Complex, length: int) -> torch.Tensor:
    """The first ``length`` entries of the real part of the plan's inverse
    of ``spec``."""
    return execute_inverse(plan, spec)[0][..., :length]


def _conj(z: Complex) -> Complex:
    return z[0], -z[1]


class _FFTConv(torch.autograd.Function):
    """``fft_conv`` of (B, L, D) activations and (D, L) filters with its
    correlation backward, every product on ``complex_multiply``."""

    @staticmethod
    def forward(ctx, u, k, plan):
        slen = u.shape[1]
        uf = _spectrum(plan, transpose(u))                       # (B, D, nf)
        kf = _spectrum(plan, k)                                  # (D, nf)
        y = _real_crop(plan, complex_multiply(uf, kf), slen)
        ctx.plan, ctx.dtypes = plan, (u.dtype, k.dtype)
        ctx.save_for_backward(*uf, *kf)
        return transpose(y).to(u.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        plan, (u_dtype, k_dtype) = ctx.plan, ctx.dtypes
        ur, ui, kr, ki = ctx.saved_tensors
        slen = g.shape[1]
        gf = _spectrum(plan, transpose(g))                       # (B, D, nf)
        grad_u = grad_k = None
        if ctx.needs_input_grad[0]:
            y = _real_crop(plan, complex_multiply(gf, _conj((kr, ki))), slen)
            grad_u = transpose(y).to(u_dtype)
        if ctx.needs_input_grad[1]:
            pr, pi = complex_multiply(gf, _conj((ur, ui)))
            grad_k = _real_crop(plan, (pr.sum(0), pi.sum(0)),
                                slen).to(k_dtype)
        return grad_u, grad_k, None


def fft_conv(u: torch.Tensor, k: torch.Tensor,
             planner: Optional[Planner] = None, permuted: bool = True,
             device=None) -> torch.Tensor:
    """Causal convolution via FFT.

    u: (B, L, D) real activations; k: (D, L) real causal filters. Returns
    (B, L, D) in ``u``'s dtype, on ``device`` (None: the GPU). Uses c2c on
    the real signal (imag = 0) so the permuted-order transpose elision
    applies end to end. Differentiable in ``u`` and ``k`` on every device:
    the backward runs the same kernels (the module docstring), and its
    gradients come back in ``u``'s and ``k``'s dtypes.
    """
    dev = resolve_device(device)
    u = torch.as_tensor(u).to(dev)
    k = torch.as_tensor(k).to(dev)
    nf = next_fft_len(2 * u.shape[1])
    planner = planner or Planner(backends=("torch",))
    plan = planner.plan(nf, kind="c2c", permuted=permuted)
    return _FFTConv.apply(u, k, plan)


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


class _ShardedConv(torch.autograd.Function):
    """``fft_conv_seq_sharded`` of this rank's (B, L/p, D) block and the
    whole (D, L) filters, with its correlation backward on the same
    distributed transforms (``ctx.spec``: the mesh, the axis and the
    split, from ``fft_conv_seq_sharded``)."""

    @staticmethod
    def forward(ctx, u, k, spec):
        group, p, me, w, slen = (spec["group"], spec["p"], spec["me"],
                                 spec["w"], spec["slen"])
        # this rank's blocks of the zero-padded sequences, (B, D, nf/p) and
        # (D, nf/p): the filters are whole on every rank, so only u moves
        up = reshard_last(transpose(u).float(), group, p, me, w, slen)
        lo, hi = min(me * w, slen), min(me * w + w, slen)
        kp = torch.nn.functional.pad(k[:, lo:hi].float(),
                                     (0, w - (hi - lo)))
        uf = _sharded_fft(spec, up)
        kf = _sharded_fft(spec, kp)
        y = _sharded_ifft(spec, complex_multiply(uf, kf))
        ctx.spec, ctx.dtypes = spec, (u.dtype, k.dtype)
        ctx.save_for_backward(*uf, *kf)
        return transpose(y).to(u.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        spec, (u_dtype, k_dtype) = ctx.spec, ctx.dtypes
        ur, ui, kr, ki = ctx.saved_tensors
        group, p, me, w, slen = (spec["group"], spec["p"], spec["me"],
                                 spec["w"], spec["slen"])
        gf = _sharded_fft(spec, reshard_last(transpose(g).float(), group, p,
                                             me, w, slen))
        grad_u = grad_k = None
        if ctx.needs_input_grad[0]:
            y = _sharded_ifft(spec, complex_multiply(gf, _conj((kr, ki))))
            grad_u = transpose(y).to(u_dtype)
        if ctx.needs_input_grad[1]:
            pr, pi = complex_multiply(gf, _conj((ur, ui)))
            # this rank's block of the padded positions, then all of them
            gk = _dist_ifft_permuted((pr.sum(0), pi.sum(0)), group, p, me,
                                     spec["n1"], spec["n2"], spec["planner"],
                                     spec["backend"])[0].contiguous()
            parts = [torch.empty_like(gk) for _ in range(p)]
            dist.all_gather(parts, gk, group=group)
            grad_k = torch.cat(parts, -1)[:, :slen].contiguous()
            for other in spec["others"]:
                dist.all_reduce(grad_k, group=other)
            grad_k = grad_k.to(k_dtype)
        return grad_u, grad_k, None


def _sharded_fft(spec, x: torch.Tensor) -> Complex:
    """The distributed forward transform of real rows (..., nf/p)."""
    return _dist_fft_permuted((x, torch.zeros_like(x)), spec["group"],
                              spec["p"], spec["me"], spec["n1"], spec["n2"],
                              -1, spec["planner"], spec["backend"])


def _sharded_ifft(spec, z: Complex) -> torch.Tensor:
    """The real part of the distributed inverse of a (B, D, nf/p) spectrum
    block, cropped and moved back to this rank's (B, D, L/p) block."""
    y = _dist_ifft_permuted(z, spec["group"], spec["p"], spec["me"],
                            spec["n1"], spec["n2"], spec["planner"],
                            spec["backend"])[0]
    return reshard_last(y, spec["group"], spec["p"], spec["me"],
                        spec["slen"] // spec["p"], spec["slen"])


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
    block of the padded sequence is not its block of ``u``.

    Differentiable in ``u`` and ``k`` (the correlation of the module
    docstring on the same distributed transforms): ``u``'s gradient is this
    rank's (B, L/p, D) block; ``k``'s is the whole (D, L) gradient, the same
    on every rank (each rank's block of positions all-gathered along
    ``axis``; on a mesh of more axes summed over the others, which hold
    other rows of the batch)."""
    planner = planner or Planner(backends=("torch",))
    dev = mesh_device(mesh)
    u = torch.as_tensor(u).to(dev)
    b, lloc, d = u.shape
    p, me = mesh_sizes(mesh)[axis], mesh.get_local_rank(axis)
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
    spec = dict(group=mesh.get_group(axis), p=p, me=me, n1=n1, n2=n2,
                w=nf // p, slen=slen, planner=planner,
                backend=get_backend(comm, chunks=chunks),
                others=[mesh.get_group(a) for a in mesh.mesh_dim_names
                        if a != axis])
    return _ShardedConv.apply(u, k, spec)
