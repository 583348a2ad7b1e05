"""Four-step (Bailey) matmul FFT in PyTorch: the 1D FFT substrate.

Port of ``repro.core.algo``. With N = N1*N2:

    A[n1, n2]   = x[n1*N2 + n2]                       (row-major reshape)
    B[k1, n2]   = sum_n1 A[n1, n2] * W_N1^{n1 k1}      (DFT along axis 0)
    B'[k1, n2]  = B[k1, n2] * W_N^{n2 k1}              (twiddle)
    C[k1, k2]   = sum_n2 B'[k1, n2] * W_N2^{n2 k2}     (DFT along axis 1)
    X[k2*N1+k1] = C[k1, k2]                            (digit transpose)

Sub-DFTs recurse until the factor is <= ``max_base`` and run as a dense
matmul (``torch.matmul``; on the GPU it must run in full float32, i.e. with
``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's default).
Complex numbers are (re, im) pairs of float32 tensors, as in the reference,
so the two packages compare one to one; a complex contraction costs 4 real
matmuls, or 3 with the Karatsuba trick.

``permuted=True`` skips the final digit transpose; ``ifft_from_permuted``
consumes that order directly.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

Complex = Tuple[torch.Tensor, torch.Tensor]  # (re, im)

# ---------------------------------------------------------------------------
# complex-pair helpers
# ---------------------------------------------------------------------------


def to_pair(z) -> Complex:
    """Complex tensor or numpy array -> (re, im) float32 pair."""
    z = torch.as_tensor(z)
    return z.real.float().contiguous(), z.imag.float().contiguous()


def to_complex(c: Complex) -> torch.Tensor:
    return torch.complex(c[0].float(), c[1].float())


def cmul(a: Complex, b: Complex) -> Complex:
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def cadd(a: Complex, b: Complex) -> Complex:
    return a[0] + b[0], a[1] + b[1]


def conj(a: Complex) -> Complex:
    return a[0], -a[1]


def cscale(a: Complex, s) -> Complex:
    return a[0] * s, a[1] * s


# ---------------------------------------------------------------------------
# DFT / twiddle tables: built in float64 on the host, cast to float32,
# exactly as the reference builds them, then copied once to each device
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dft_matrix_np(n: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """W[j, k] = exp(sign * 2*pi*i * j*k / n); float64 then cast to f32."""
    jk = np.outer(np.arange(n), np.arange(n)).astype(np.float64)
    ang = sign * 2.0 * np.pi * jk / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _twiddle_np(n1: int, n2: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """T[k1, n2] = exp(sign * 2*pi*i * k1*n2 / (n1*n2))."""
    jk = np.outer(np.arange(n1), np.arange(n2)).astype(np.float64)
    ang = sign * 2.0 * np.pi * jk / (n1 * n2)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _roots_np(n: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """w[k] = exp(sign * 2*pi*i * k / n), k < n: row 1 of W, for the radix
    kernels' stage twiddles."""
    ang = sign * 2.0 * np.pi * np.arange(n).astype(np.float64) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _half_twiddle_np(n: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    k = np.arange(n // 2 + 1).astype(np.float64)
    ang = sign * 2.0 * np.pi * k / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


# One device copy per (table, device): the tables are read-only and a few
# sizes cover a process, so the cache stays small.
@functools.lru_cache(maxsize=None)
def _on_device(table, args, device: torch.device) -> Complex:
    re, im = table(*args)
    return (torch.from_numpy(re).to(device), torch.from_numpy(im).to(device))


@functools.lru_cache(maxsize=None)
def _wrap_index(m: int, device: torch.device) -> torch.Tensor:
    """(-k) mod m for k = 0..m, on ``device``. Kept on the device like the
    tables: a copy from host memory in every call would make the host wait
    for the stream (a blocking copy), a barrier inside every row task."""
    return torch.from_numpy((-np.arange(m + 1)) % m).to(device)


def dft_matrix(n: int, sign: int = -1, device="cpu") -> Complex:
    return _on_device(_dft_matrix_np, (n, sign), torch.device(device))


def twiddle_factors(n1: int, n2: int, sign: int = -1, device="cpu") -> Complex:
    return _on_device(_twiddle_np, (n1, n2, sign), torch.device(device))


def roots(n: int, sign: int = -1, device="cpu") -> Complex:
    return _on_device(_roots_np, (n, sign), torch.device(device))


def _half_twiddle(n: int, sign: int, device) -> Complex:
    return _on_device(_half_twiddle_np, (n, sign), torch.device(device))


# ---------------------------------------------------------------------------
# complex matmul (..., n) x (n, k) -> (..., k), 4-matmul or Karatsuba 3-matmul
# ---------------------------------------------------------------------------


def complex_matmul(a: Complex, w: Complex, karatsuba: bool = False) -> Complex:
    """(ar + i*ai) @ (wr + i*wi), contracting a's last dim with w's first."""
    ar, ai = a
    wr, wi = w
    if karatsuba:
        # 3 real matmuls: p1 = ar@wr, p2 = ai@wi, p3 = (ar+ai)@(wr+wi)
        p1 = torch.matmul(ar, wr)
        p2 = torch.matmul(ai, wi)
        p3 = torch.matmul(ar + ai, wr + wi)
        return p1 - p2, p3 - p1 - p2
    return (torch.matmul(ar, wr) - torch.matmul(ai, wi),
            torch.matmul(ar, wi) + torch.matmul(ai, wr))


# ---------------------------------------------------------------------------
# factorization planning helper (the Planner in plan.py builds on this)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def default_factorization(n: int, max_base: int = 128) -> Tuple[int, ...]:
    """Split n into factors each <= max_base, minimizing (#factors, sum).

    The four-step cost is ~ N * sum(factors) MACs, so the sum is the flop
    count and fewer factors means fewer twiddle/transpose passes.  Balanced
    splits win: 256 -> (16, 16), 16384 -> (128, 128), 2**19 -> (128, 64, 64).
    """
    if n <= max_base:
        return (n,)
    best = None

    def key(fs):
        return (len(fs), sum(fs), -min(fs))

    for f in range(2, max_base + 1):
        if n % f == 0:
            try:
                rest = default_factorization(n // f, max_base)
            except ValueError:
                continue
            cand = tuple(sorted((f,) + rest, reverse=True))
            if best is None or key(cand) < key(best):
                best = cand
    if best is None:
        raise ValueError(f"cannot factor {n} with base <= {max_base}")
    return best


# ---------------------------------------------------------------------------
# core c2c FFT along the last axis
# ---------------------------------------------------------------------------


def _swap(c: Complex) -> Complex:
    return c[0].transpose(-1, -2), c[1].transpose(-1, -2)


def _fft_base(x: Complex, sign: int, karatsuba: bool) -> Complex:
    """Dense DFT matmul along the last axis."""
    n = x[0].shape[-1]
    return complex_matmul(x, dft_matrix(n, sign, x[0].device), karatsuba)


def _fft_factors(x: Complex, factors: Sequence[int], sign: int,
                 karatsuba: bool, permuted: bool) -> Complex:
    """Four-step FFT along the last axis with the given factorization."""
    n = x[0].shape[-1]
    if len(factors) == 1:
        assert factors[0] == n, (factors, n)
        return _fft_base(x, sign, karatsuba)
    n1 = factors[0]
    n2 = n // n1
    batch = tuple(x[0].shape[:-1])
    a = (x[0].reshape(batch + (n1, n2)), x[1].reshape(batch + (n1, n2)))

    # step 1: DFT_n1 along axis -2, as a last-axis matmul on the (..., n2, n1)
    # view — the "columns" FFT of the paper.
    bt = complex_matmul(_swap(a), dft_matrix(n1, sign, a[0].device),
                        karatsuba)                          # (..., n2, k1)
    b = _swap(bt)                                           # (..., k1, n2)

    # step 2: twiddle T[k1, n2]
    b = cmul(b, twiddle_factors(n1, n2, sign, b[0].device))

    # step 3: DFT_n2 along the last axis (recurse on remaining factors; only
    # the top level may skip its digit transpose)
    c = _fft_factors(b, tuple(factors[1:]), sign, karatsuba, permuted=False) \
        if len(factors) > 2 else _fft_base(b, sign, karatsuba)

    if permuted:
        return c[0].reshape(batch + (n,)), c[1].reshape(batch + (n,))
    # step 4: digit transpose  X[k2*n1 + k1] = C[k1, k2]
    ct = _swap(c)
    return ct[0].reshape(batch + (n,)), ct[1].reshape(batch + (n,))


def fft(x: Complex, *, sign: int = -1, factors: Sequence[int] | None = None,
        max_base: int = 128, karatsuba: bool = False,
        permuted: bool = False) -> Complex:
    """c2c FFT along the last axis of an (re, im) pair."""
    n = x[0].shape[-1]
    if factors is None:
        factors = default_factorization(n, max_base)
    return _fft_factors(x, tuple(factors), sign, karatsuba, permuted)


def ifft(x: Complex, *, factors: Sequence[int] | None = None,
         max_base: int = 128, karatsuba: bool = False) -> Complex:
    n = x[0].shape[-1]
    y = fft(x, sign=+1, factors=factors, max_base=max_base, karatsuba=karatsuba)
    return cscale(y, 1.0 / n)


def ifft_from_permuted(x: Complex, *, factors: Sequence[int] | None = None,
                       max_base: int = 128, karatsuba: bool = False) -> Complex:
    """Inverse FFT consuming the ``permuted=True`` forward output: inverse
    DFT along k2, conjugate twiddle, inverse DFT along k1, flatten — no
    transposes at all.  Only valid for two-factor plans."""
    n = x[0].shape[-1]
    if factors is None:
        factors = default_factorization(n, max_base)
    if len(factors) != 2:
        raise ValueError("permuted mode requires a two-factor plan")
    n1, n2 = factors
    dev = x[0].device
    batch = tuple(x[0].shape[:-1])
    c = (x[0].reshape(batch + (n1, n2)), x[1].reshape(batch + (n1, n2)))
    b = complex_matmul(c, dft_matrix(n2, +1, dev), karatsuba)   # along k2
    b = cmul(b, twiddle_factors(n1, n2, +1, dev))               # conj twiddle
    a = _swap(complex_matmul(_swap(b), dft_matrix(n1, +1, dev),
                             karatsuba))                         # along k1
    out = (a[0].reshape(batch + (n,)), a[1].reshape(batch + (n,)))
    return cscale(out, 1.0 / n)


# ---------------------------------------------------------------------------
# real-to-complex (the paper's transform kind) via pack-as-complex
# ---------------------------------------------------------------------------


def rfft(x: torch.Tensor, **kw) -> Complex:
    """r2c FFT along the last axis. len must be even; output length n//2 + 1.

    Packs even/odd samples into a complex signal of length n/2, runs one c2c
    FFT, and unpacks with conjugate symmetry.
    """
    n = x.shape[-1]
    assert n % 2 == 0, "rfft requires even length"
    m = n // 2
    zf = fft((x[..., 0::2], x[..., 1::2]), sign=-1, **kw)       # (..., m)
    # Z[(-k) mod m], k = 0..m  (index m wraps to 0)
    idx = _wrap_index(m, x.device)
    zr = (zf[0][..., idx], zf[1][..., idx])
    zk = (torch.cat([zf[0], zf[0][..., :1]], -1),
          torch.cat([zf[1], zf[1][..., :1]], -1))
    xe = cscale(cadd(zk, conj(zr)), 0.5)                        # even spectrum
    xo_t = cadd(zk, cscale(conj(zr), -1.0))                     # Z - conj(Zrev)
    xo = (0.5 * xo_t[1], -0.5 * xo_t[0])                        # /(2i)
    w = _half_twiddle(n, -1, x.device)
    return cadd(xe, cmul(w, xo))


def irfft(x: Complex, **kw) -> torch.Tensor:
    """c2r inverse FFT; input (..., n//2+1), output real (..., n)."""
    m = x[0].shape[-1] - 1
    n = 2 * m
    w = _half_twiddle(n, +1, x[0].device)
    xr = (torch.flip(x[0], (-1,)), torch.flip(x[1], (-1,)))     # X[m-k]
    xe = cscale(cadd(x, conj(xr)), 0.5)
    xo_f = cscale(cadd(x, cscale(conj(xr), -1.0)), 0.5)
    xo = cmul(w, xo_f)                                          # undo half twiddle
    # Z[k] = Xe[k] + i*Xo[k], k = 0..m-1
    z = (xe[0][..., :m] - xo[1][..., :m], xe[1][..., :m] + xo[0][..., :m])
    zi = ifft(z, **kw)
    out = torch.stack([zi[0], zi[1]], dim=-1)                   # interleave
    return out.reshape(out.shape[:-2] + (n,))


# ---------------------------------------------------------------------------
# multidimensional transforms (the paper's 2D algorithm, axis by axis)
# ---------------------------------------------------------------------------


def fft2(x: Complex, **kw) -> Complex:
    """2D c2c FFT over the last two axes: rows then columns via transpose."""
    return _swap(fft(_swap(fft(x, **kw)), **kw))


def ifft2(x: Complex, **kw) -> Complex:
    return _swap(ifft(_swap(ifft(x, **kw)), **kw))


def rfft2(x: torch.Tensor, **kw) -> Complex:
    """2D r2c: r2c along the contiguous rows, then c2c along columns."""
    return _swap(fft(_swap(rfft(x, **kw)), **kw))


def fftn(x: Complex, ndim: int, **kw) -> Complex:
    """n-D c2c FFT over the last ``ndim`` axes."""
    y = x
    for ax in range(ndim):
        axis = -1 - ax
        zt = fft((torch.movedim(y[0], axis, -1), torch.movedim(y[1], axis, -1)),
                 **kw)
        y = (torch.movedim(zt[0], -1, axis), torch.movedim(zt[1], -1, axis))
    return y
