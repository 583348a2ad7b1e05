"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: they skip without a CUDA device. This file imports no JAX,
so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch import Planner, fft_conv, fftn, ifftn, irfftn, kernels, rfftn
from repro_torch.kernels import (complex_multiply, complex_multiply_ref,
                                 fft_four_step, fft_four_step_ref,
                                 fftconv_fused, fftconv_fused_ref, transpose,
                                 transpose_ref)
from repro_torch.kernels.fftconv.ref import (fftconv_fused_plain,
                                             filter_spectrum_plain)
from repro_torch.core import variants
from repro_torch.models import FFTConvMixer

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("factors", [(8, 8), (16, 32), (128, 128), (8, 128),
                                     (128, 8), (25, 40), (7, 3), (128, 1),
                                     (11, 13), (127, 1), (1, 127), (6, 10)])
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


@pytest.mark.parametrize("a_shape,b_shape", [
    ((3, 40, 56), (3, 40, 56)), ((4, 300), (300,)), ((2, 3, 64), (3, 64)),
    ((4, 300), (4, 1)), ((7,), ()), ((5, 1001), (1, 1001)),
    ((4096, 64), (64,))])
@pytest.mark.parametrize("block", [1, 3, 256, 1024, 4096])
def test_complex_multiply_kernel_matches_plain(cuda, a_shape, b_shape, block):
    g = torch.Generator(device=cuda).manual_seed(3)
    a = tuple(torch.randn(a_shape, device=cuda, generator=g) for _ in "ri")
    b = tuple(torch.randn(b_shape, device=cuda, generator=g) for _ in "ri")
    before = kernels.launch_counts()["complex_multiply"]
    k = complex_multiply(a, b, block=block)
    r = complex_multiply_ref(a, b)
    assert kernels.launch_counts()["complex_multiply"] == before + 1
    for x, y in zip(k, r):
        assert x.shape == a_shape
        # the reference's kernel tolerance (tests/test_kernels.py)
        assert (x - y).abs().max().item() <= 1e-5


def test_complex_multiply_kernel_on_unaligned_views(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    bufs = [torch.randn(4097, device=cuda, generator=g) for _ in range(4)]
    a = (bufs[0][1:].view(4, 1024), bufs[1][1:].view(4, 1024))
    b = (bufs[2][1:1025], bufs[3][1:1025])
    for x, y in zip(complex_multiply(a, b), complex_multiply_ref(a, b)):
        assert (x - y).abs().max().item() <= 1e-5


def test_complex_multiply_raises_on_bad_input(cuda):
    a = (torch.ones(4, 8, device=cuda), torch.ones(4, 8, device=cuda))
    with pytest.raises(TypeError):
        complex_multiply(tuple(t.double() for t in a), tuple(t.double()
                                                             for t in a))
    with pytest.raises(ValueError):
        complex_multiply(a, (torch.ones(8), torch.ones(8)))    # CPU b
    with pytest.raises(ValueError):
        complex_multiply(a, (torch.ones(3, device=cuda),) * 2)  # no broadcast


@pytest.mark.parametrize("factors", [(8, 8), (16, 32), (64, 64), (128, 8),
                                     (8, 128), (128, 128), (5, 7), (128, 1),
                                     (11, 13), (127, 1), (6, 10)])
@pytest.mark.parametrize("block_rows", [1, 4, 8])
@pytest.mark.parametrize("batch", [6, 5])
def test_fftconv_fused_kernel_matches_plain(cuda, factors, block_rows, batch):
    g = torch.Generator(device=cuda).manual_seed(5)
    n = factors[0] * factors[1]
    x = torch.randn(batch, n, device=cuda, generator=g)
    h = torch.randn(n, device=cuda, generator=g) * torch.exp(
        -torch.arange(n, device=cuda) / 64.0)
    before = kernels.launch_counts()["fftconv_fused"]
    k = fftconv_fused(x, h, factors, block_rows=block_rows)
    assert kernels.launch_counts()["fftconv_fused"] == before + 1
    r = fftconv_fused_plain(x, filter_spectrum_plain(h, factors), factors)
    o = fftconv_fused_ref(x, h)
    # the reference's kernel tolerance (tests/test_kernels_fftconv.py)
    assert (k - r).abs().max().item() <= 2e-4 * r.abs().max().item()
    assert (k - o).abs().max().item() <= 2e-4 * o.abs().max().item()


def test_fftconv_fused_raises_on_bad_input(cuda):
    x, h = torch.ones(2, 64, device=cuda), torch.ones(64, device=cuda)
    with pytest.raises(TypeError):
        fftconv_fused(x.double(), h.double(), (8, 8))
    with pytest.raises(ValueError):
        fftconv_fused(x, h.cpu(), (8, 8))
    with pytest.raises(ValueError):
        fftconv_fused(x, h, (16, 8))


def test_fft_conv_and_mixer_with_the_hopper_planner(cuda):
    planner = Planner(backends=("hopper",))
    g = torch.Generator(device=cuda).manual_seed(6)
    u = torch.randn(2, 128, 16, device=cuda, generator=g)
    k = torch.randn(16, 128, device=cuda, generator=g) * torch.exp(
        -torch.arange(128, device=cuda) / 16.0)
    kernels.reset_launch_counts()
    y = fft_conv(u, k, planner=planner)
    assert kernels.launch_counts() == {"four_step_fft": 2,
                                       "batched_transpose": 2,
                                       "complex_multiply": 1,
                                       "fftconv_fused": 0}
    uf = torch.fft.rfft(u.double(), n=256, dim=1)
    kf = torch.fft.rfft(k.double(), n=256, dim=1).T
    ref = torch.fft.irfft(uf * kf, n=256, dim=1)[:, :128]
    assert (y.double() - ref).abs().max().item() <= \
        2e-4 * ref.abs().max().item()
    mixer = FFTConvMixer(64, 16, planner=planner,
                         generator=torch.Generator(device=cuda).manual_seed(0))
    cpu = FFTConvMixer(64, 16, planner=planner, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    cpu.load_state_dict({n: t.cpu() for n, t in mixer.state_dict().items()})
    x = torch.randn(2, 128, 64, device=cuda, generator=g)
    with torch.no_grad():
        ours, plain = mixer(x), cpu(x.cpu())
    assert (ours.cpu() - plain).abs().max().item() <= \
        2e-4 * plain.abs().max().item()


def test_kernels_and_the_mixer_refuse_autograd(cuda):
    # the kernels record no grad_fn: with autograd on, an input that
    # requires grad raises instead of silently dropping the op's gradient
    x = torch.randn(2, 64, device=cuda, requires_grad=True)
    h = torch.randn(64, device=cuda)
    calls = [lambda: fft_four_step((x, x.detach()), (8, 8)),
             lambda: transpose(x),
             lambda: complex_multiply((x, x), (h, h)),
             lambda: fftconv_fused(x, h, (8, 8)),
             lambda: fft_conv(x.view(2, 64, 1), h.view(1, 64))]
    for call in calls:
        with pytest.raises(RuntimeError, match="no_grad"):
            call()
    with torch.no_grad():
        for call in calls:
            call()
    mixer = FFTConvMixer(16, 4, generator=torch.Generator(
        device=cuda).manual_seed(0))
    u = torch.randn(2, 32, 16, device=cuda)
    with pytest.raises(RuntimeError, match="no_grad"):
        mixer(u)
    with torch.no_grad():
        assert mixer(u).shape == u.shape


# kernel launches of one call of each variant: the column pass is the
# four-step kernel's; the whole-array moves are the transpose kernel's
# (future_naive and future_opt scatter their rows with torch's copy, agas
# gathers, strided copies its view inside the four-step op)
VARIANT_LAUNCHES = {"for_loop": 4, "future_sync": 4, "staged": 4,
                    "future_naive": 2, "future_opt": 2, "future_agas": 0,
                    "strided": 0}


@pytest.mark.parametrize("name", sorted(VARIANT_LAUNCHES))
def test_variants_on_the_card_match_torch_fft(cuda, name):
    planner = Planner(backends=("hopper",))
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(256, 512, device=cuda, generator=g)
    kernels.reset_launch_counts()
    if name == "staged":
        out = x
        for _, stage in variants.staged_for_loop(x, planner):
            out = stage(out)
    else:
        out = variants.run_variant(name, x, planner)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["four_step_fft"] == 1
    assert counts["batched_transpose"] == VARIANT_LAUNCHES[name]
    ref = torch.fft.rfft2(x.double())
    tol = 2e-4 * ref.abs().max().item()
    assert out[0].device.type == "cuda" and out[0].shape == (256, 257)
    assert out[0].is_contiguous() and out[1].is_contiguous()
    assert (out[0].double() - ref.real).abs().max().item() <= tol
    assert (out[1].double() - ref.imag).abs().max().item() <= tol
