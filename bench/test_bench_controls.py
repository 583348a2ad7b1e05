"""Each cell's control, at a size the CPU holds, fails the cell's limits
(the reference in the precision below the configuration's: TF32 products
for the float32 FFT cells, the bf16 dataflow in fp8 for the training
cell); the limits themselves were set on the card at the cells' sizes
(PERF.md)."""

import time

import pytest

from bench import run
from bench.drivers import fft_dist, fft_local, train
from bench.lib import common, small

CONTROLS = {"fft2d_16384.r2c_roundtrip": fft_local.control,
            "fft2d_16384.c2c_forward": fft_local.control,
            "fft3d_1024.pencil_step_4chip": fft_dist.control,
            "fftconv_lm_olmo1b.train_2x8192": train.control}

common.use_src()


@pytest.mark.parametrize("name", sorted(CONTROLS))
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_control_fails_a_limit(name, seed):
    ctx = run.Context(name, small.small_cell(name), seed, 0.1, 0,
                      device="cpu", t_start=time.perf_counter())
    checks = CONTROLS[name](ctx)
    assert any(value > limit for _, value, limit in checks), checks
