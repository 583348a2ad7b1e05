"""N-D FFT executors: the single-card layer and the distributed
executors, ported from ``repro.core.dfft``.

The move of an axis to the end and back (``moveaxis`` in the reference) is
a batched transpose: a contiguous array of shape ``pre + (n,) + post`` is a
``(B, n, M)`` block with ``B = prod(pre)`` and ``M = prod(post)``, and
moving axis ``n`` last is ``(B, n, M) -> (B, M, n)``. On the GPU that runs
the tiled transpose kernel (``repro_torch.kernels.transpose``), on the CPU
its plain version; both give the very values ``moveaxis`` gives.

The distributed executors (slab over one mesh axis, pencil over a chain of
2..ndim-1 mesh axes, factor1d for one long axis) run each reference
``shard_map`` body on this rank's block, with every exchange an explicit
collective of :mod:`repro_torch.core.comm` over the mesh axis's process
group (one rank per process, NCCL on the card, gloo on the CPU).

**Layout convention.** The reference's ``shard_map`` takes and returns
global arrays; here every rank passes and gets back its own block:

* forward input: this rank's block of ``NdPlan.padded_input_shape``;
* forward output: this rank's block of ``NdPlan.padded_spectrum_shape``;
* the inverses take the forward's output block and return the input block.

The sharded transform axes are those of the reference's specs
(:func:`input_layout`, :func:`spectrum_layout`): slab shards the first
axis in and out (``output_layout="transposed"``: the last axis out),
pencil shards the first k axes in and axes 1..k-1 and the last axis out,
factor1d shards its one axis. Leading batch axes are never sharded.
:func:`distribute` cuts a full array, the same on every rank, into this
rank's zero-padded block; :func:`collect` gathers the blocks and crops
them with ``plan.crop``. The padded bands stay exactly zero through every
exchange (mixed radix: an axis is cropped to its true length just before
it is transformed and re-padded after), so the crop recovers the exact
transform.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.transpose import transpose
from ..kernels.twiddle import complex_multiply
from . import algo
from .comm import (CommBackend, get_backend, mesh_device, mesh_sizes,
                   pad_to, resolve_axis_backends, _gather_start, _unlead)
from .plan import Plan, Planner, execute, execute_inverse

Complex = algo.Complex

__all__ = ["rows_rfft", "rows_irfft", "hermitian_extend_last",
           "execute_slab", "execute_slab_inverse",
           "execute_pencil", "execute_pencil_inverse",
           "execute_factor1d", "execute_factor1d_inverse",
           "input_layout", "spectrum_layout", "block_shape",
           "distribute", "collect",
           "fft2_slab", "ifft2_slab", "fft3_pencil", "ifft3_pencil",
           "rfft3_pencil", "irfft3_pencil"]


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
    return along_axis(lambda z: run(plan, z), c, axis)


def along_axis(fn, c: Complex, axis: int) -> Complex:
    """Apply ``fn``, a transform of the last axis of a pair, along ``axis``:
    the axis is moved last and back on the transpose kernel."""
    axis = axis % c[0].dim()
    if axis == c[0].dim() - 1:
        return fn(c)
    zt = fn((_axis_last(c[0], axis), _axis_last(c[1], axis)))
    return _axis_back(zt[0], axis), _axis_back(zt[1], axis)


@functools.lru_cache(maxsize=None)
def _mirror_index(n: int, device: torch.device) -> torch.Tensor:
    """n-k for k = n//2+1..n-1, on ``device``: kept there like
    ``algo._wrap_index``, since a copy from host memory in every call
    would make the host wait for the stream."""
    return torch.from_numpy(np.arange(n - (n // 2 + 1), 0, -1)).to(device)


def hermitian_extend_last(c: Complex, n: int) -> Complex:
    """Rebuild the full length-``n`` spectrum from the half spectrum of a
    real signal along the last axis: ``F[k] = conj(F[n-k])`` for k > n//2.
    Valid whenever every other axis is already in its real/spatial form."""
    idx = _mirror_index(n, c[0].device)
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


def _local_rows_rfft(planner: Planner, x: torch.Tensor, n: int,
                     width: int) -> Complex:
    """r2c FFT along the last axis (any length) + zero-pad to the
    collective-divisible ``width`` (any number of leading batch axes)."""
    return _pad_axis(rows_rfft(planner, x, n), -1, width)


# ---------------------------------------------------------------------------
# layouts: which transform axis is sharded over which mesh axis
# ---------------------------------------------------------------------------


def input_layout(nd) -> Tuple[Optional[str], ...]:
    """Mesh axis of each transform axis of the forward input (None: whole
    on every rank): the reference executors' ``in_specs``."""
    d = len(nd.shape)
    if nd.decomp == "local":
        return (None,) * d
    if nd.decomp == "pencil":
        return tuple(nd.mesh_axes) + (None,) * (d - len(nd.mesh_axes))
    return (nd.mesh_axes[0],) + (None,) * (d - 1)      # slab, factor1d


def spectrum_layout(nd) -> Tuple[Optional[str], ...]:
    """Mesh axis of each transform axis of the forward output (the
    reference's ``out_specs``; ``_pencil_spectrum_spec`` for pencil: axis
    j+1 over mesh axis j for j < k-1, the last axis over mesh axis k-1)."""
    d = len(nd.shape)
    if nd.decomp == "slab" and nd.output_layout == "transposed":
        return (None,) * (d - 1) + (nd.mesh_axes[0],)
    if nd.decomp == "pencil":
        axs, k = nd.mesh_axes, len(nd.mesh_axes)
        spec = [None] * d
        for j in range(k - 1):
            spec[j + 1] = axs[j]
        spec[d - 1] = axs[k - 1]
        return tuple(spec)
    return input_layout(nd)


def block_shape(nd, spectrum: bool) -> Tuple[int, ...]:
    """Transform-axes shape of one rank's block of the padded input (or,
    with ``spectrum``, of the padded spectrum)."""
    sizes = dict(zip(nd.mesh_axes, nd.mesh_shape))
    if spectrum:
        full, layout = nd.padded_spectrum_shape, spectrum_layout(nd)
    else:
        full, layout = nd.padded_input_shape, input_layout(nd)
    return tuple(n // sizes[a] if a else n for n, a in zip(full, layout))


def _check_block(nd, t: torch.Tensor, spectrum: bool) -> int:
    """Raise unless ``t`` ends in this rank's block shape; returns the
    number of leading batch axes."""
    want = block_shape(nd, spectrum)
    d = len(want)
    if t.dim() < d or tuple(t.shape[t.dim() - d:]) != want:
        what = "padded spectrum" if spectrum else "padded input"
        raise ValueError(
            f"{nd.decomp} plan of {nd.shape} over {nd.mesh_axes or 'no'} "
            f"mesh axes: a rank's block of the {what} ends in {want}, got "
            f"{tuple(t.shape)} (cut it with distribute(x, plan, mesh))")
    return t.dim() - d


def _group(mesh, nd, name: str):
    """The process group of mesh axis ``name``, checked against the plan."""
    p = dict(zip(nd.mesh_axes, nd.mesh_shape))[name]
    have = mesh_sizes(mesh).get(name)
    if have != p:
        raise ValueError(f"plan wants mesh axis {name!r} of size {p}, the "
                         f"mesh has {mesh_sizes(mesh)}")
    return mesh.get_group(name)


def _slab_backend(nd, chunks: int) -> CommBackend:
    return get_backend(nd.comm[0] if nd.comm else "collective", chunks=chunks)


def _pencil_backends(nd, chunks: int) -> Tuple[CommBackend, ...]:
    return resolve_axis_backends(nd.comm, nd.mesh_axes, chunks=chunks)


# ---------------------------------------------------------------------------
# slab executor (1 mesh axis, ndim >= 2, leading batch dims, mixed radix)
# ---------------------------------------------------------------------------
#
# Layout (forward, transform shape (n0, ..., nlast), P ranks over `ax`):
#
#   input   (b..., n0p/P, ..., nlast)   last-axis FFT (r2c or c2c) local,
#                                       then every middle axis, then pad the
#                                       spectrum's last axis to lp
#   xchg    split last, concat first -> (b..., n0p, ..., lp/P)
#   ax0 FFT crop n0p -> n0, transform, re-pad to n0p
#   xchg    split first, concat last -> (b..., n0p/P, ..., lp)
#
# n0p = pad_to(n0, P); lp = padded_half(nlast, P) for r2c, pad_to(nlast, P)
# for c2c.


def _check_legacy_flags(nd, flags: bool) -> None:
    """The reference's checks on the legacy 2D layout flags."""
    if flags and len(nd.shape) != 2:
        raise ValueError("transposed/permuted layouts are 2D-only")
    if flags and nd.output_layout == "transposed":
        raise ValueError("legacy layout flag on an already-transposed plan")


def execute_slab(nd, x, mesh, planner: Planner, *, chunks: int = 4,
                 keep_transposed: bool = False, permuted_cols: bool = False):
    """Forward slab transform of an :class:`~repro_torch.core.api.NdPlan`.

    ``x``: this rank's block of the padded input — a real tensor for
    ``kind="r2c"``, an (re, im) pair for ``"c2c"`` — with any number of
    leading batch dims. Returns this rank's block of the padded spectrum,
    sharded over the first transform axis, or with
    ``output_layout="transposed"`` over the last one, which skips the
    second exchange.

    ``keep_transposed`` / ``permuted_cols`` are the historical 2D-only
    layout flags of ``fft2_slab``: the first returns this rank's block
    transposed, (lp/p, n0) (the reference's folded (lp/p, n0*p) layout,
    cut by rank; no second exchange), the second plans the column pass
    ``permuted=True``, so it skips its digit transpose (on the four-step
    kernel under ``hopper``). New code plans the layout instead."""
    d = len(nd.shape)
    if nd.decomp != "slab" or len(nd.mesh_axes) != 1:
        raise ValueError(f"execute_slab takes a slab plan, got {nd.decomp}")
    _check_legacy_flags(nd, keep_transposed or permuted_cols)
    ax, p = nd.mesh_axes[0], nd.mesh_shape[0]
    group = _group(mesh, nd, ax)
    pair_in = nd.kind == "c2c"
    bnd = _check_block(nd, x[0] if pair_in else x, spectrum=False)
    i0, il = bnd, bnd + d - 1
    n0, nlast = nd.shape[0], nd.shape[-1]
    n0p = pad_to(n0, p)
    if keep_transposed and n0p != n0:
        raise ValueError("keep_transposed requires shape[0] divisible by "
                         "the mesh axis (mixed radix keeps both exchanges)")
    lp = nd.padded_spectrum_shape[-1]
    backend = _slab_backend(nd, chunks)
    mid_plans = [planner.plan(nd.shape[k], kind="c2c")
                 for k in range(1, d - 1)]
    col_plan = planner.plan(n0, kind="c2c", permuted=permuted_cols)

    if pair_in:
        y = _pad_axis(execute(planner.plan(nlast, kind="c2c"), x), il, lp)
    else:
        y = _local_rows_rfft(planner, x, nlast, lp)         # r2c last axis
    for k, mp in enumerate(mid_plans):                      # middle axes
        y = _fft_axis(mp, y, i0 + 1 + k)
    y = backend.exchange(y, group, split=il, concat=i0, p=p)
    y = _crop_axis(y, i0, n0)                               # mixed radix
    y = _fft_axis(col_plan, y, i0)                          # first axis
    if keep_transposed:     # 2D: hand back the transposed local block
        return _swap_last(y)
    y = _pad_axis(y, i0, n0p)
    if nd.output_layout == "transposed":    # skip the second exchange
        return y
    return backend.exchange(y, group, split=i0, concat=il, p=p)


def execute_slab_inverse(nd, c: Complex, mesh, planner: Planner, *,
                         chunks: int = 4, from_transposed: bool = False,
                         permuted_cols: bool = False):
    """Inverse slab transform: this rank's block of the PADDED spectrum
    (zero padded bands) in, this rank's block of the padded input out —
    real for ``kind="r2c"``, a pair for ``"c2c"`` — the first transform
    axis still padded to ``pad_to(n0, p)``. A transposed plan consumes the
    last-axis-sharded layout with a single exchange; the legacy 2D
    ``from_transposed`` flag consumes ``keep_transposed``'s (lp/p, n0)
    block instead, and ``permuted_cols`` a column pass in permuted
    order."""
    d = len(nd.shape)
    if nd.decomp != "slab" or len(nd.mesh_axes) != 1:
        raise ValueError(f"execute_slab_inverse takes a slab plan, got "
                         f"{nd.decomp}")
    _check_legacy_flags(nd, from_transposed or permuted_cols)
    ax, p = nd.mesh_axes[0], nd.mesh_shape[0]
    group = _group(mesh, nd, ax)
    n0, nlast = nd.shape[0], nd.shape[-1]
    n0p = pad_to(n0, p)
    lp = nd.padded_spectrum_shape[-1]
    if from_transposed:
        if n0p != n0:
            raise ValueError("from_transposed requires shape[0] divisible "
                             "by the mesh axis")
        want = (lp // p, n0)
        if tuple(c[0].shape[-2:]) != want:
            raise ValueError(f"a rank's transposed block ends in {want}, "
                             f"got {tuple(c[0].shape)}")
        bnd = c[0].dim() - d
    else:
        bnd = _check_block(nd, c[0], spectrum=True)
    i0, il = bnd, bnd + d - 1
    ltrue = nd.spectrum_shape[-1]       # mh for r2c, nlast for c2c
    backend = _slab_backend(nd, chunks)
    col_plan = planner.plan(n0, kind="c2c", permuted=permuted_cols)
    mid_plans = [planner.plan(nd.shape[k], kind="c2c")
                 for k in range(1, d - 1)]

    z = c
    if from_transposed:
        # the first axis is last in the folded layout: transform it there
        z = _swap_last(execute_inverse(col_plan, z))        # (n0, lp/p)
    else:
        if nd.output_layout != "transposed":
            # the transposed input is already in the post-exchange layout
            z = backend.exchange(z, group, split=il, concat=i0, p=p)
        z = _crop_axis(z, i0, n0)
        z = _fft_axis(col_plan, z, i0, inverse=True)
        z = _pad_axis(z, i0, n0p)
    z = backend.exchange(z, group, split=i0, concat=il, p=p)
    z = _crop_axis(z, il, ltrue)                            # drop padding
    for k, mp in reversed(list(enumerate(mid_plans))):      # middle axes
        z = _fft_axis(mp, z, i0 + 1 + k, inverse=True)
    if nd.kind == "c2c":
        return execute_inverse(planner.plan(nlast, kind="c2c"), z)
    return rows_irfft(planner, z, nlast)                    # c2r last axis


# ---------------------------------------------------------------------------
# pencil executor (P3DFFT-style, k mesh axes, ndim >= k+1, batch dims,
# mixed radix)
# ---------------------------------------------------------------------------
#
# Forward, mesh axes (a0..a_{k-1}) of sizes (p0..p_{k-1}) sharding the FIRST
# k transform axes; 3D/2-axis shown:
#
#   input   (b..., Xp/p0, Yp/p1, Z)    Z-FFT local, pad Z -> Zp (or zh_pad)
#   xchg 1  over a1 (row communicator):   split Z, concat Y
#           (b..., Xp/p0, Yp, Zp/p1)   crop Y, Y-FFT local, re-pad
#   xchg 2  over a0 (column communicator): split Y, concat X
#           (b..., Xp,  Yp/p0, Zp/p1)  crop X, X-FFT local, re-pad
#
# For k > 2 the chain continues axis by axis, one exchange per adjacent pair
# of sharded axes, each inside its own communicator. Axis paddings: axis 0
# -> pad_to(., p0); axis j (0 < j < k) -> pad_to(., lcm(p_{j-1}, p_j));
# unsharded middle axes unpadded; last axis pad_to(., p_{k-1})
# (padded_half for r2c). The inverse retraces the chain backwards.


def execute_pencil(nd, x, mesh, planner: Planner, *, chunks: int = 4):
    """Forward pencil transform (``kind="c2c"``: (re, im) pair in,
    ``"r2c"``: real tensor in; any number of leading batch dims). ``x`` is
    this rank's block of the padded input (the first k transform axes
    sharded over the mesh axes in order); returns this rank's block of the
    padded spectrum (axis j+1 over mesh axis j, the last over the last)."""
    d = len(nd.shape)
    k = len(nd.mesh_axes)
    if nd.decomp != "pencil" or not 2 <= k <= d - 1:
        raise ValueError(f"execute_pencil takes a pencil plan of 2..ndim-1 "
                         f"mesh axes, got {nd.decomp} over {nd.mesh_axes}")
    axs, ps = nd.mesh_axes, nd.mesh_shape
    groups = [_group(mesh, nd, a) for a in axs]
    pair_in = nd.kind == "c2c"
    bnd = _check_block(nd, x[0] if pair_in else x, spectrum=False)
    il = bnd + d - 1
    padded = nd.padded_spectrum_shape
    backends = _pencil_backends(nd, chunks)
    plans = [planner.plan(nd.shape[j], kind="c2c") for j in range(d - 1)]

    if pair_in:                                             # FFT last axis
        z = _pad_axis(execute(planner.plan(nd.shape[-1], kind="c2c"), x),
                      il, padded[-1])
    else:                                                   # r2c last axis
        z = _local_rows_rfft(planner, x, nd.shape[-1], padded[-1])
    for j in range(k, d - 1):               # unsharded middle axes: local
        z = _fft_axis(plans[j], z, bnd + j)
    donor = il
    for j in range(k - 1, -1, -1):          # the exchange chain
        z = backends[j].exchange(z, groups[j], split=donor, concat=bnd + j,
                                 p=ps[j])
        z = _crop_axis(z, bnd + j, nd.shape[j])
        z = _fft_axis(plans[j], z, bnd + j)                 # FFT along j
        z = _pad_axis(z, bnd + j, padded[j])
        donor = bnd + j
    return z


def execute_pencil_inverse(nd, c: Complex, mesh, planner: Planner, *,
                           chunks: int = 4):
    """Inverse pencil transform: this rank's block of the PADDED spectrum
    in, its block of the padded input out — a pair for ``kind="c2c"``, a
    real tensor for ``"r2c"``."""
    d = len(nd.shape)
    k = len(nd.mesh_axes)
    if nd.decomp != "pencil" or not 2 <= k <= d - 1:
        raise ValueError(f"execute_pencil_inverse takes a pencil plan of "
                         f"2..ndim-1 mesh axes, got {nd.decomp} over "
                         f"{nd.mesh_axes}")
    axs, ps = nd.mesh_axes, nd.mesh_shape
    groups = [_group(mesh, nd, a) for a in axs]
    bnd = _check_block(nd, c[0], spectrum=True)
    il = bnd + d - 1
    padded = nd.padded_spectrum_shape
    ltrue = nd.spectrum_shape[-1]           # half width for r2c
    backends = _pencil_backends(nd, chunks)
    plans = [planner.plan(nd.shape[j], kind="c2c") for j in range(d - 1)]

    z = c
    for j in range(k):                      # retrace the chain backwards
        z = _crop_axis(z, bnd + j, nd.shape[j])
        z = _fft_axis(plans[j], z, bnd + j, inverse=True)
        z = _pad_axis(z, bnd + j, padded[j])
        donor = bnd + j + 1 if j < k - 1 else il
        z = backends[j].exchange(z, groups[j], split=bnd + j, concat=donor,
                                 p=ps[j])
    z = _crop_axis(z, il, ltrue)                            # drop padding
    for j in range(d - 2, k - 1, -1):       # unsharded middle axes
        z = _fft_axis(plans[j], z, bnd + j, inverse=True)
    if nd.kind == "c2c":                                    # inverse last
        return execute_inverse(planner.plan(nd.shape[-1], kind="c2c"), z)
    return rows_irfft(planner, z, nd.shape[-1])             # c2r last axis


# ---------------------------------------------------------------------------
# factor1d executor (distributed 1D c2c via the fft_conv factor split)
# ---------------------------------------------------------------------------
#
# The length-N signal is viewed as an (n1, n2) row-major matrix sharded over
# n1 (nd.factors = (n1, n2), both divisible by p):
#
#   stage A: all_to_all -> columns local; DFT along n1; twiddle T[k1, n2]
#   stage B: all_to_all -> rows local;    DFT along n2   => C[k1, k2]
#   unpermute: all_to_all + local transpose => X[n1*k2 + k1], row-sharded
#
# The twiddle product is the complex-multiply kernel on the GPU
# (repro_torch.kernels.twiddle), its plain version on the CPU.


# A block is 8*N/p bytes and costs several passes over int64 and float64
# arrays of N/p to build, more than the rest of a call at N = 2**26, so each
# is built once; a forward and an inverse of two sizes stay on the device.
@functools.lru_cache(maxsize=4)
def _factor1d_twiddle_block(n1: int, n2: int, me: int, p: int, sign: int,
                            chunk_axis: int, device: torch.device) -> Complex:
    """Rank ``me``'s block of ``T[k1, j2] = exp(sign*2*pi*i*k1*j2/N)``,
    N = n1*n2, built on the device from the rank (O(N/p) per rank).
    ``chunk_axis=1``: all k1, this rank's j2 columns (forward);
    ``chunk_axis=0``: this rank's k1 rows, all j2 (inverse). The reference
    forms k1*j2 in float32, exact only below 2**24; here ``(k1*j2) mod N``
    is exact in int64 and the angle and its cosine and sine are taken in
    float64, then rounded once to float32."""
    i64 = dict(dtype=torch.int64, device=device)
    if chunk_axis == 1:
        w = n2 // p
        k1 = torch.arange(n1, **i64)[:, None]
        j2 = (me * w + torch.arange(w, **i64))[None]
    else:
        w = n1 // p
        k1 = (me * w + torch.arange(w, **i64))[:, None]
        j2 = torch.arange(n2, **i64)[None]
    n = n1 * n2
    ang = (k1 * j2 % n).to(torch.float64) * (sign * 2.0 * math.pi / n)
    return torch.cos(ang).float(), torch.sin(ang).float()


def _swap_last(z: Complex) -> Complex:
    """Swap the last two axes of a pair through the batched transpose."""
    return transpose(z[0]), transpose(z[1])


def execute_factor1d(nd, x, mesh, planner: Planner, *,
                     chunks: int = 4) -> Complex:
    """Forward distributed 1D c2c transform of a ``decomp="factor1d"``
    plan: this rank's (re, im) block of the signal in (leading batch dims
    ride through), its block of the natural-order spectrum out."""
    if nd.decomp != "factor1d" or len(nd.mesh_axes) != 1:
        raise ValueError(f"execute_factor1d takes a factor1d plan, got "
                         f"{nd.decomp}")
    if nd.kind != "c2c":
        raise ValueError("factor1d is c2c-only (r2c 1D stays local)")
    ax, p = nd.mesh_axes[0], nd.mesh_shape[0]
    n1, n2 = nd.factors
    if n1 * n2 != nd.shape[0] or n1 % p or n2 % p:
        raise ValueError(f"factor1d split {nd.factors} of {nd.shape} does "
                         f"not suit {p} ranks")
    group = _group(mesh, nd, ax)
    _check_block(nd, x[0], spectrum=False)
    backend = _slab_backend(nd, chunks)
    plan1 = planner.plan(n1, kind="c2c")
    plan2 = planner.plan(n2, kind="c2c")
    me = mesh.get_local_rank(ax)

    shape = tuple(x[0].shape[:-1]) + (n1 // p, n2)
    z = (x[0].reshape(shape), x[1].reshape(shape))
    i1, i2 = len(shape) - 2, len(shape) - 1
    # stage A: columns local
    z = backend.exchange(z, group, split=i2, concat=i1, p=p)  # (n1, n2/p)
    z = _fft_axis(plan1, z, i1)                             # DFT along n1
    z = complex_multiply(z, _factor1d_twiddle_block(
        n1, n2, me, p, -1, chunk_axis=1, device=z[0].device))
    # stage B: rows local
    z = backend.exchange(z, group, split=i1, concat=i2, p=p)  # (n1/p, n2)
    z = _fft_axis(plan2, z, i2)                             # DFT along n2
    # unpermute C[k1, k2] -> X[n1*k2 + k1] (natural order, row-sharded)
    z = backend.exchange(z, group, split=i2, concat=i1, p=p)  # (n1, n2/p)
    z = _swap_last(z)
    flat = shape[:-2] + (n1 * n2 // p,)
    return z[0].reshape(flat), z[1].reshape(flat)


def execute_factor1d_inverse(nd, c: Complex, mesh, planner: Planner, *,
                             chunks: int = 4) -> Complex:
    """Inverse of :func:`execute_factor1d`: this rank's block of the
    natural-order spectrum in, its block of the signal out."""
    if nd.decomp != "factor1d" or len(nd.mesh_axes) != 1:
        raise ValueError(f"execute_factor1d_inverse takes a factor1d plan, "
                         f"got {nd.decomp}")
    ax, p = nd.mesh_axes[0], nd.mesh_shape[0]
    n1, n2 = nd.factors
    group = _group(mesh, nd, ax)
    _check_block(nd, c[0], spectrum=True)
    backend = _slab_backend(nd, chunks)
    plan1 = planner.plan(n1, kind="c2c")
    plan2 = planner.plan(n2, kind="c2c")
    me = mesh.get_local_rank(ax)

    shape = tuple(c[0].shape[:-1]) + (n2 // p, n1)
    z = (c[0].reshape(shape), c[1].reshape(shape))
    i1, i2 = len(shape) - 2, len(shape) - 1
    # re-permute X[n1*k2 + k1] -> C[k1, k2] (rows local)
    z = _swap_last(z)
    z = backend.exchange(z, group, split=i1, concat=i2, p=p)  # (n1/p, n2)
    # inverse DFT along k2 (normalized: 1/n2)
    z = _fft_axis(plan2, z, i2, inverse=True)
    # conjugate twiddle T[k1-block, n2]
    z = complex_multiply(z, _factor1d_twiddle_block(
        n1, n2, me, p, +1, chunk_axis=0, device=z[0].device))
    # columns local; inverse DFT along k1 (normalized: 1/n1)
    z = backend.exchange(z, group, split=i2, concat=i1, p=p)  # (n1, n2/p)
    z = _fft_axis(plan1, z, i1, inverse=True)
    # back to the row-sharded natural layout
    z = backend.exchange(z, group, split=i1, concat=i2, p=p)  # (n1/p, n2)
    flat = shape[:-2] + (n1 * n2 // p,)
    return z[0].reshape(flat), z[1].reshape(flat)


# ---------------------------------------------------------------------------
# deprecated shape-specific shims (build an NdPlan, run the shared executor)
# ---------------------------------------------------------------------------
#
# Each rank passes its block, as everywhere in the port. The reference's
# shims read the global shape off their global input; a block gives it
# only where the mesh divides every sharded length (the block of a padded
# axis names the padded length). Elsewhere pass the global transform
# ``shape=``; a block that does not fit it raises.

_DEPRECATED_EMITTED = set()


def _warn_deprecated(name: str) -> None:
    """One DeprecationWarning per entry point per process."""
    if name in _DEPRECATED_EMITTED:
        return
    _DEPRECATED_EMITTED.add(name)
    warnings.warn(
        f"repro_torch.core.dfft.{name} is deprecated; use "
        "repro_torch.core.api.plan_nd and the fftn/ifftn/rfftn/irfftn "
        "front-end instead", DeprecationWarning, stacklevel=3)


def _shim_plan(shape, kind, mesh, mesh_axes, comm, planner, decomp):
    from .api import plan_nd
    return plan_nd(tuple(int(n) for n in shape), kind, mesh=mesh,
                   axes=tuple(mesh_axes), comm=comm, planner=planner,
                   decomp=decomp)


def _shim_shape(shape, from_block, tail=None):
    """The global transform shape: ``shape``, or what the block gives;
    ``tail`` is a last length the reference's signature passes itself."""
    if shape is None:
        return tuple(from_block)
    shape = tuple(int(n) for n in shape)
    if tail is not None and shape[-1] != tail:
        raise ValueError(f"shape {shape} does not end in {tail}")
    return shape


def _on_mesh(x, mesh):
    from .api import _as_pair, _as_real
    dev = mesh_device(mesh)
    return _as_pair(x, dev) if isinstance(x, (tuple, list)) \
        else _as_real(x, dev)


def fft2_slab(x, mesh, axis: str, planner: Optional[Planner] = None,
              comm="collective", chunks: int = 4,
              keep_transposed: bool = False, permuted_cols: bool = False, *,
              shape=None) -> Complex:
    """DEPRECATED: distributed 2D r2c FFT (use ``plan_nd`` + ``rfftn``).

    x: this rank's real (N/p, M) block, rows sharded over ``axis``.
    Returns its (re, im) block of the (N, mh_pad) padded spectrum (crop to
    M//2+1 for the exact rfft2), or with ``keep_transposed`` its
    transposed (mh_pad/p, N) block (the whole second exchange saved).
    ``permuted_cols`` skips the column FFT's digit transpose (pair with
    ``ifft2_slab(..., permuted_cols=True)``)."""
    _warn_deprecated("fft2_slab")
    planner = planner or Planner(backends=("torch",))
    x = _on_mesh(x, mesh)
    p = mesh_sizes(mesh)[axis]
    nd = _shim_plan(_shim_shape(shape, (x.shape[0] * p, x.shape[1])),
                    "r2c", mesh, (axis,), comm, planner, "slab")
    return execute_slab(nd, x, mesh, planner, chunks=chunks,
                        keep_transposed=keep_transposed,
                        permuted_cols=permuted_cols)


def ifft2_slab(c: Complex, mesh, axis: str, m: int,
               planner: Optional[Planner] = None, comm="collective",
               chunks: int = 4, from_transposed: bool = False,
               permuted_cols: bool = False, *, shape=None) -> torch.Tensor:
    """DEPRECATED: inverse of :func:`fft2_slab` back to this rank's real
    (N/p, M) block (use ``plan_nd`` + ``irfftn``)."""
    _warn_deprecated("ifft2_slab")
    planner = planner or Planner(backends=("torch",))
    c = _on_mesh(c, mesh)
    p = mesh_sizes(mesh)[axis]
    n = c[0].shape[1] if from_transposed else c[0].shape[0] * p
    nd = _shim_plan(_shim_shape(shape, (n, m), tail=m), "r2c", mesh,
                    (axis,), comm, planner, "slab")
    return execute_slab_inverse(nd, c, mesh, planner, chunks=chunks,
                                from_transposed=from_transposed,
                                permuted_cols=permuted_cols)


def fft3_pencil(x: Complex, mesh, axes: Tuple[str, str],
                planner: Optional[Planner] = None, comm="collective",
                chunks: int = 4, *, shape=None) -> Complex:
    """DEPRECATED: 3D c2c pencil FFT (use ``plan_nd`` + ``fftn``): this
    rank's (X/p0, Y/p1, Z) block of a pair in, its (X, Y/p0, Z/p1) block
    of the spectrum out. ``comm`` may be one spec for both communicators,
    a per-axis pair/dict, ``"auto"`` or ``"measure"``."""
    _warn_deprecated("fft3_pencil")
    planner = planner or Planner(backends=("torch",))
    x = _on_mesh(x, mesh)
    p0, p1 = (mesh_sizes(mesh)[a] for a in axes)
    b = x[0].shape
    nd = _shim_plan(_shim_shape(shape, (b[0] * p0, b[1] * p1, b[2])),
                    "c2c", mesh, axes, comm, planner, "pencil")
    return execute_pencil(nd, x, mesh, planner, chunks=chunks)


def ifft3_pencil(c: Complex, mesh, axes: Tuple[str, str],
                 planner: Optional[Planner] = None, comm="collective",
                 chunks: int = 4, *, shape=None) -> Complex:
    """DEPRECATED: inverse of :func:`fft3_pencil` (use ``plan_nd`` +
    ``ifftn``)."""
    _warn_deprecated("ifft3_pencil")
    planner = planner or Planner(backends=("torch",))
    c = _on_mesh(c, mesh)
    p0, p1 = (mesh_sizes(mesh)[a] for a in axes)
    b = c[0].shape
    nd = _shim_plan(_shim_shape(shape, (b[0], b[1] * p0, b[2] * p1)),
                    "c2c", mesh, axes, comm, planner, "pencil")
    return execute_pencil_inverse(nd, c, mesh, planner, chunks=chunks)


def rfft3_pencil(x, mesh, axes: Tuple[str, str],
                 planner: Optional[Planner] = None, comm="collective",
                 chunks: int = 4, *, shape=None) -> Complex:
    """DEPRECATED: 3D r2c pencil FFT of this rank's real (X/p0, Y/p1, Z)
    block (use ``plan_nd`` + ``rfftn``). Returns its (re, im) block of the
    (X, Y, zh_pad) padded spectrum, (X, Y/p0, zh_pad/p1); crop the last
    axis to Z//2+1 for the exact ``numpy.fft.rfftn``."""
    _warn_deprecated("rfft3_pencil")
    planner = planner or Planner(backends=("torch",))
    x = _on_mesh(x, mesh)
    p0, p1 = (mesh_sizes(mesh)[a] for a in axes)
    b = x.shape
    nd = _shim_plan(_shim_shape(shape, (b[0] * p0, b[1] * p1, b[2])),
                    "r2c", mesh, axes, comm, planner, "pencil")
    return execute_pencil(nd, x, mesh, planner, chunks=chunks)


def irfft3_pencil(c: Complex, mesh, axes: Tuple[str, str], nz: int,
                  planner: Optional[Planner] = None, comm="collective",
                  chunks: int = 4, *, shape=None) -> torch.Tensor:
    """DEPRECATED: inverse of :func:`rfft3_pencil` back to this rank's real
    (X/p0, Y/p1, Z) block (use ``plan_nd`` + ``irfftn``). Takes the
    *uncropped* padded spectrum block plus the original Z length ``nz``."""
    _warn_deprecated("irfft3_pencil")
    planner = planner or Planner(backends=("torch",))
    c = _on_mesh(c, mesh)
    p0 = mesh_sizes(mesh)[axes[0]]
    b = c[0].shape
    nd = _shim_plan(_shim_shape(shape, (b[0], b[1] * p0, nz), tail=nz),
                    "r2c", mesh, axes, comm, planner, "pencil")
    return execute_pencil_inverse(nd, c, mesh, planner, chunks=chunks)


# ---------------------------------------------------------------------------
# distribute / collect (the paper's scatter and gather around the FFT)
# ---------------------------------------------------------------------------


def distribute(x, nd, mesh):
    """Cut a full array — the same on every rank, with any leading batch
    axes — into this rank's zero-padded block of ``nd.padded_input_shape``
    on the mesh's device. A pair or a complex array gives a pair, a real
    array a real block."""
    if isinstance(x, (tuple, list)):
        return tuple(distribute(a, nd, mesh) for a in x)
    t = torch.as_tensor(x)
    if t.is_complex():
        return distribute(algo.to_pair(t), nd, mesh)
    t = t.to(device=mesh_device(mesh), dtype=torch.float32)
    d = len(nd.shape)
    bnd = t.dim() - d
    if bnd < 0 or tuple(t.shape[bnd:]) != nd.shape:
        raise ValueError(f"distribute: array {tuple(t.shape)} does not end "
                         f"in the plan's shape {nd.shape}")
    for j, (name, n) in enumerate(zip(input_layout(nd),
                                      nd.padded_input_shape)):
        axis = bnd + j
        if t.shape[axis] != n:                  # mixed radix: zero-pad
            pad = list(t.shape)
            pad[axis] = n - t.shape[axis]
            t = torch.cat([t, t.new_zeros(pad)], axis)
        if name is not None:
            w = n // dict(zip(nd.mesh_axes, nd.mesh_shape))[name]
            t = t.narrow(axis, mesh.get_local_rank(name) * w, w)
    return t.contiguous()


def collect(local, nd, mesh, spatial: bool = False):
    """Gather every rank's block and crop it: the forward's output blocks
    give the exact spectrum (``nd.crop``), and with ``spatial`` the
    inverse's output blocks give the array of ``nd.shape``. Pairs are
    collected per member. Every rank of the mesh must call it."""
    if isinstance(local, (tuple, list)):
        return tuple(collect(a, nd, mesh, spatial) for a in local)
    layout = input_layout(nd) if spatial else spectrum_layout(nd)
    _check_block(nd, local, spectrum=not spatial)
    t = local
    bnd = t.dim() - len(nd.shape)
    for j, name in enumerate(layout):
        if name is None:
            continue
        work, buf = _gather_start(t, _group(mesh, nd, name),
                                  mesh_sizes(mesh)[name])
        work.wait()
        t = _unlead(buf, bnd + j)
    crop = nd.shape if spatial else nd.spectrum_shape
    return t[(Ellipsis,) + tuple(slice(0, n) for n in crop)]
