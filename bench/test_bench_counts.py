"""The operation and byte counts the benchmark reckons, against hand
counts."""

import math

import pytest

from bench.lib import counts

OLMO = {"num_layers": 16, "d_model": 2048, "d_ff": 8192,
        "vocab_size": 50304, "fftconv_rank": 16}


@pytest.mark.parametrize("shape,kind,flops", [
    ((16384, 16384), "c2c", 5 * 2 ** 28 * 28),
    ((16384, 16384), "r2c", 2.5 * 2 ** 28 * 28),
    ((16384, 16384), "c2r", 2.5 * 2 ** 28 * 28),
    ((1024, 1024, 1024), "c2c", 5 * 2 ** 30 * 30),
    ((8,), "c2c", 5 * 8 * 3)])
def test_fftw_flops(shape, kind, flops):
    assert counts.fftw_flops(shape, kind) == pytest.approx(flops)


def test_fft_bytes_read_and_write_once():
    n = 16384 * 16384
    half = 16384 * 8193
    assert counts.fft_bytes((16384, 16384), "c2c") == 16 * n
    assert counts.fft_bytes((16384, 16384), "r2c") == 4 * n + 8 * half
    assert counts.fft_bytes((16384, 16384), "c2r") == 8 * half + 4 * n


def test_least_seconds_is_the_longer_bound():
    # the 16384^2 r2c + c2r round trip is bound by its bytes: 1.28 ms
    shape = (16384, 16384)
    b = counts.fft_bytes(shape, "r2c") + counts.fft_bytes(shape, "c2r")
    f = counts.fftw_flops(shape, "r2c") * 2
    t = counts.least_seconds(f, b, counts.PEAKS["fp32_flops"])
    assert t == pytest.approx(b / 3.35e12)
    assert 1.27e-3 < t < 1.29e-3
    assert counts.least_seconds(1e12, 1.0, 1e12) == 1.0


def test_lm_matmul_params_by_hand():
    d, f, v = 2048, 8192, 50304
    per_layer = d * 2 * d + d * d + 3 * d * f
    assert counts.lm_matmul_params(OLMO) == 16 * per_layer + v * d
    assert counts.lm_matmul_params(OLMO) == 1_109_655_552


def test_lm_step_flops_by_hand():
    tokens = 2 * 8192
    mm = 6 * 1_109_655_552 * tokens
    nf = 16384
    conv = 16 * 2 * (2 * 2 + 1) * 2048 * 5 * nf * math.log2(nf)
    assert counts.lm_conv_flops(OLMO, 2, 8192) == pytest.approx(conv)
    assert counts.lm_step_flops(OLMO, 2, 8192) == pytest.approx(mm + conv)
    # about 1.095e14 a step: 11% of the bf16 peak at 975 ms
    assert 1.09e14 < mm + conv < 1.10e14


def test_next_pow2():
    assert [counts.next_pow2(n) for n in (1, 2, 3, 16384, 16385)] == [
        1, 2, 4, 16384, 32768]
