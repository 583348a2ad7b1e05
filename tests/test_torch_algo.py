"""The port's four-step algorithm (repro_torch.core.algo) against the
reference (repro.core.algo) and numpy, on the CPU."""

import functools
import math

import jax
import numpy as np
import pytest
import torch

from repro.core import algo as jalgo
from repro_torch.core import algo

RNG = np.random.default_rng(11)


def _ref(f, *args, **kw):
    """A reference function, compiled whole (much faster than eager)."""
    return jax.jit(functools.partial(f, **kw))(*args)


def _rand_c(shape):
    return (RNG.standard_normal(shape).astype(np.float32)
            + 1j * RNG.standard_normal(shape).astype(np.float32))


def _tpair(z):
    return (torch.from_numpy(np.ascontiguousarray(z.real, np.float32)),
            torch.from_numpy(np.ascontiguousarray(z.imag, np.float32)))


def _np(c):
    return np.asarray(c[0], np.float64) + 1j * np.asarray(c[1], np.float64)


def _close(ours, ref):
    # the reference's own tolerance (tests/test_fft_core.py)
    np.testing.assert_allclose(ours, ref, rtol=2e-4,
                               atol=2e-4 * np.abs(ref).max())


@pytest.mark.parametrize("factors", [(64,), (16, 16), (128, 8), (8, 8, 4),
                                     (7, 5, 3)])
@pytest.mark.parametrize("karatsuba", [False, True])
def test_fft_ifft_match_reference_and_numpy(factors, karatsuba):
    n = math.prod(factors)
    x = _rand_c((3, n))
    ours = algo.fft(_tpair(x), factors=factors, karatsuba=karatsuba)
    theirs = _ref(jalgo.fft, jalgo.to_pair(x), factors=factors,
                  karatsuba=karatsuba)
    _close(_np(ours), np.fft.fft(x))
    _close(_np(ours), _np(theirs))
    inv = algo.ifft(_tpair(x), factors=factors, karatsuba=karatsuba)
    _close(_np(inv), np.fft.ifft(x))
    _close(_np(inv), _np(_ref(jalgo.ifft, jalgo.to_pair(x), factors=factors,
                              karatsuba=karatsuba)))


@pytest.mark.parametrize("karatsuba", [False, True])
def test_permuted_order_and_inverse_match_reference(karatsuba):
    x = _rand_c((4, 512))
    ours = algo.fft(_tpair(x), factors=(16, 32), karatsuba=karatsuba,
                    permuted=True)
    theirs = _ref(jalgo.fft, jalgo.to_pair(x), factors=(16, 32),
                  karatsuba=karatsuba, permuted=True)
    _close(_np(ours), _np(theirs))
    back = algo.ifft_from_permuted(ours, factors=(16, 32),
                                   karatsuba=karatsuba)
    np.testing.assert_allclose(_np(back), x, atol=2e-5 * 512)
    with pytest.raises(ValueError):
        algo.ifft_from_permuted(ours, factors=(8, 8, 8))


@pytest.mark.parametrize("n", [64, 1000, 4096])
def test_rfft_irfft_match_reference_and_numpy(n):
    x = RNG.standard_normal((3, n)).astype(np.float32)
    ours = algo.rfft(torch.from_numpy(x))
    _close(_np(ours), np.fft.rfft(x))
    _close(_np(ours), _np(_ref(jalgo.rfft, x)))
    back = algo.irfft(ours)
    np.testing.assert_allclose(back.numpy(), np.fft.irfft(np.fft.rfft(x)),
                               atol=2e-5 * n)
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(_ref(lambda a: jalgo.irfft(
                                   jalgo.rfft(a)), x)),
                               atol=2e-5 * n)


def test_fft2_rfft2_fftn_match_reference_and_numpy():
    x = _rand_c((2, 16, 24))
    _close(_np(algo.fft2(_tpair(x))), np.fft.fft2(x))
    _close(_np(algo.fft2(_tpair(x))), _np(_ref(jalgo.fft2, jalgo.to_pair(x))))
    _close(_np(algo.ifft2(_tpair(x))), np.fft.ifft2(x))
    r = x.real.astype(np.float32).copy()
    _close(_np(algo.rfft2(torch.from_numpy(r))), np.fft.rfft2(r))
    _close(_np(algo.rfft2(torch.from_numpy(r))), _np(_ref(jalgo.rfft2, r)))
    y = _rand_c((8, 12, 10))
    _close(_np(algo.fftn(_tpair(y), 3)), np.fft.fftn(y))
    _close(_np(algo.fftn(_tpair(y), 3)),
           _np(_ref(jalgo.fftn, jalgo.to_pair(y), ndim=3)))


@pytest.mark.parametrize("sign", [-1, 1])
def test_tables_bit_equal_to_reference(sign):
    for n in (1, 7, 16, 128):
        for ours, theirs in zip(algo.dft_matrix(n, sign),
                                jalgo._dft_matrix_np(n, sign)):
            assert ours.dtype == torch.float32
            np.testing.assert_array_equal(ours.numpy(), theirs)
    for n1, n2 in ((8, 16), (128, 128), (5, 3)):
        for ours, theirs in zip(algo.twiddle_factors(n1, n2, sign),
                                jalgo._twiddle_np(n1, n2, sign)):
            np.testing.assert_array_equal(ours.numpy(), theirs)


def test_default_factorization_equal_to_reference():
    for n in (2, 96, 128, 256, 384, 1000, 1536, 4096, 16384, 2 ** 19, 45):
        for base in (8, 64, 128):
            try:
                theirs = jalgo.default_factorization(n, base)
            except ValueError:
                with pytest.raises(ValueError):
                    algo.default_factorization(n, base)
                continue
            assert algo.default_factorization(n, base) == theirs


def test_rfft_wrap_index_is_built_once_per_device():
    # a fresh host-to-device copy in every rfft call would block the host on
    # the stream, a hidden barrier in each of the variants' row tasks
    idx = algo._wrap_index(8, torch.device("cpu"))
    assert idx is algo._wrap_index(8, torch.device("cpu"))
    assert idx.tolist() == [0, 7, 6, 5, 4, 3, 2, 1, 0]
