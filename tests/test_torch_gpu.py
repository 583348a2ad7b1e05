"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: they skip without a CUDA device. This file imports no JAX,
so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch import Planner, fftn, ifftn, irfftn, kernels, rfftn
from repro_torch.kernels import (fft_four_step, fft_four_step_ref, transpose,
                                 transpose_ref)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("factors", [(8, 8), (16, 32), (128, 128), (8, 128),
                                     (128, 8), (25, 40), (7, 3), (128, 1)])
@pytest.mark.parametrize("karatsuba", [False, True])
@pytest.mark.parametrize("permuted", [False, True])
def test_four_step_kernel_matches_plain(cuda, factors, karatsuba, permuted):
    g = torch.Generator(device=cuda).manual_seed(1)
    shape = (5, factors[0] * factors[1])
    x = (torch.randn(shape, device=cuda, generator=g),
         torch.randn(shape, device=cuda, generator=g))
    before = kernels.launch_counts()["four_step_fft"]
    k = fft_four_step(x, factors, karatsuba=karatsuba, permuted=permuted)
    r = fft_four_step_ref(x, factors, karatsuba=karatsuba, permuted=permuted)
    assert kernels.launch_counts()["four_step_fft"] == before + 1
    # the reference's kernel tolerance (tests/test_kernels.py)
    scale = r[0].abs().max().item() + 1e-6
    for a, b in zip(k, r):
        assert (a - b).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32,
                                   torch.int32, torch.float64])
@pytest.mark.parametrize("shape", [(3, 40, 56), (96, 160), (1, 1),
                                   (70000, 3, 2)])
def test_transpose_kernel_matches_plain_exactly(cuda, dtype, shape):
    x = torch.arange(int(np.prod(shape)), device=cuda).reshape(shape).to(dtype)
    before = kernels.launch_counts()["batched_transpose"]
    assert torch.equal(transpose(x), transpose_ref(x))
    assert kernels.launch_counts()["batched_transpose"] == before + 1


@pytest.mark.parametrize("shape,ndim", [((2, 64, 96), 2), ((24, 40, 16), 3),
                                        ((30, 45), 2), ((4096,), 1)])
def test_transforms_on_the_default_device_match_torch_fft(cuda, shape, ndim):
    planner = Planner(backends=("hopper",))
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(shape, device=cuda, generator=g)
    axes = tuple(range(-ndim, 0))
    kernels.reset_launch_counts()
    spec = rfftn(x, ndim=ndim, planner=planner)
    ref = torch.fft.rfftn(x.double(), dim=axes)
    tol = 2e-4 * ref.abs().max().item()
    assert spec[0].device.type == "cuda"
    assert (spec[0].double() - ref.real).abs().max().item() <= tol
    assert (spec[1].double() - ref.imag).abs().max().item() <= tol
    back = irfftn(spec, shape=shape[len(shape) - ndim:], planner=planner)
    assert (back - x).abs().max().item() <= 2e-4 * x.abs().max().item()
    c = fftn((x, torch.zeros_like(x)), ndim=ndim, planner=planner)
    ref = torch.fft.fftn(x.double(), dim=axes)
    tol = 2e-4 * ref.abs().max().item()
    assert (c[0].double() - ref.real).abs().max().item() <= tol
    zb = ifftn(c, ndim=ndim, planner=planner)
    assert (zb[0] - x).abs().max().item() <= 2e-4 * x.abs().max().item()
    if ndim > 1:
        assert kernels.launch_counts()["batched_transpose"] > 0
