"""The plain references of the FFT cells, in PyTorch alone.

``spectrum`` is the float64 transform (``torch.fft``) of the fields the
benchmark made, computed axis by axis in blocks so that a 1024^3 field
fits beside what is left on the card. ``dft_tf32`` is the control: the
same transform as a plain DFT by matrix products whose operands are
rounded to TF32 (10 mantissa bits, as the card's tensor cores take
float32 operands with TF32 on), accumulated in float32. It stands for the
step a later change might take: float32 transforms on TF32 products.

Complex values enter and leave as (re, im) float32 pairs, as in the port.
Nothing here imports the port.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]


def _fft_axis_inplace(z: torch.Tensor, axis: int, inverse: bool,
                      block_bytes: int = 1 << 30) -> None:
    """Transform ``z`` (complex128) along ``axis`` in place, in blocks of
    the first other axis so that no temporary passes ``block_bytes``."""
    fn = torch.fft.ifft if inverse else torch.fft.fft
    other = 0 if axis != 0 else 1
    if z.dim() == 1:
        z.copy_(fn(z))
        return
    per = z.numel() // z.shape[other] * z.element_size()
    step = max(1, block_bytes // max(per, 1))
    for i in range(0, z.shape[other], step):
        part = z.narrow(other, i, min(step, z.shape[other] - i))
        part.copy_(fn(part, dim=axis))


def spectrum_inplace(z: torch.Tensor) -> torch.Tensor:
    """The float64 c2c transform of ``z`` (complex128) over all its axes,
    in place, axis by axis in blocks."""
    for ax in range(z.dim()):
        _fft_axis_inplace(z, ax, inverse=False)
    return z


def spectrum(x, kind: str, inverse: bool = False) -> torch.Tensor:
    """The float64 transform of a field over all its axes, complex128:
    ``kind`` r2c takes a real tensor and gives the half spectrum along the
    last axis (``numpy.fft.rfftn``); c2c takes a pair (``fftn``, or
    ``ifftn`` with ``inverse``)."""
    if kind == "r2c":
        z = torch.fft.rfft(x.double(), dim=-1)
        axes = range(x.dim() - 1)
    else:
        z = torch.complex(x[0].double(), x[1].double())
        axes = range(x[0].dim())
    for ax in axes:
        _fft_axis_inplace(z, ax, inverse)
    return z


def rel_l2_parts(got: Pair, want: torch.Tensor) -> Tuple[float, float]:
    """(sum of squared differences, sum of squared reference values) of a
    float32 pair against a complex128 reference, accumulated in float64."""
    dr = got[0].double() - want.real
    di = got[1].double() - want.imag
    diff = float((dr.square().sum() + di.square().sum()).item())
    ref = float(want.abs().square().sum().item())
    return diff, ref


def rel_l2_real(got: torch.Tensor, want: torch.Tensor) -> float:
    d = (got.double() - want.double()).square().sum()
    return float(torch.sqrt(d / want.double().square().sum()).item())


# ---------------------------------------------------------------------------
# the control: a DFT by matrix products on TF32-rounded operands
# ---------------------------------------------------------------------------


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away
    from zero), kept in float32."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _dft_matrix(n: int, sign: int, device) -> Pair:
    k = torch.arange(n, device=device, dtype=torch.float64)
    ang = (sign * 2.0 * math.pi / n) * torch.outer(k, k).remainder(n)
    return (round_tf32(torch.cos(ang).float()),
            round_tf32(torch.sin(ang).float()))


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32 with TF32 off (the operands are rounded already)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def dft_tf32_axis(z: Pair, axis: int, sign: int = -1) -> Pair:
    """The DFT of a pair along ``axis`` by one complex matrix product on
    TF32-rounded operands (four real products)."""
    n = z[0].shape[axis]
    wr, wi = _dft_matrix(n, sign, z[0].device)
    xr = round_tf32(z[0].movedim(axis, -1).contiguous())
    xi = round_tf32(z[1].movedim(axis, -1).contiguous())
    # W is symmetric, so x W transforms the rows of x; one product at a
    # time, to hold a 1024^3 field's on one card
    yr = _matmul(xr, wr)
    yr -= _matmul(xi, wi)
    yi = _matmul(xr, wi)
    yi += _matmul(xi, wr)
    del xr, xi
    return yr.movedim(-1, axis), yi.movedim(-1, axis)


def dft_tf32(x, kind: str, inverse: bool = False) -> Pair:
    """The control's transform over all axes (``spectrum``'s layout: r2c
    gives the half spectrum; ``inverse`` scales by 1/N)."""
    if kind == "r2c":
        z = (x.float(), torch.zeros_like(x, dtype=torch.float32))
    else:
        z = (x[0].float(), x[1].float())
    sign = 1 if inverse else -1
    for ax in range(z[0].dim()):
        z = dft_tf32_axis(z, ax, sign)
    if inverse:
        n = z[0].numel()
        z = (z[0] / n, z[1] / n)
    if kind == "r2c":
        m = z[0].shape[-1] // 2 + 1
        z = (z[0][..., :m], z[1][..., :m])
    return z


def inverse_r2c_tf32(c: Pair, shape: Sequence[int]) -> torch.Tensor:
    """The control's c2r round trip: the half spectrum extended by
    Hermitian symmetry and inverted by TF32 products; the real part."""
    n = shape[-1]
    idx = (-torch.arange(n // 2 + 1, n, device=c[0].device)) % n
    re = torch.cat([c[0], c[0][..., idx]], -1)
    im = torch.cat([c[1], -c[1][..., idx]], -1)
    # the mirrored half of a 2D+ spectrum also reverses the other axes
    for ax in range(re.dim() - 1):
        rev = (-torch.arange(re.shape[ax], device=re.device)) % re.shape[ax]
        tail_r = re[..., c[0].shape[-1]:].index_select(ax, rev)
        tail_i = im[..., c[0].shape[-1]:].index_select(ax, rev)
        re = torch.cat([re[..., :c[0].shape[-1]], tail_r], -1)
        im = torch.cat([im[..., :c[0].shape[-1]], tail_i], -1)
    return dft_tf32((re, im), "c2c", inverse=True)[0]
