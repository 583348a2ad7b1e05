"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: they skip without a CUDA device. This file imports no JAX,
so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import (Planner, collect, distribute, fft_conv, fftn, ifftn,
                         irfftn, kernels, make_mesh, plan_nd, rfftn)
from repro_torch.kernels import (complex_multiply, complex_multiply_ref,
                                 fft_four_step, fft_four_step_ref,
                                 fftconv_fused, fftconv_fused_ref, transpose,
                                 transpose_ref)
from repro_torch.kernels.fftconv.ref import (fftconv_fused_plain,
                                             filter_spectrum_plain)
from repro_torch.core import variants
from repro_torch.configs import get_smoke_config
from repro_torch.models import LM, FFTConvMixer

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


def test_bare_kernel_calls_refuse_autograd(cuda):
    # the kernels record no grad_fn: with autograd on, a bare kernel call
    # handed an input that requires grad raises instead of silently
    # dropping the op's gradient
    x = torch.randn(2, 64, device=cuda, requires_grad=True)
    h = torch.randn(64, device=cuda)
    calls = [lambda: fft_four_step((x, x.detach()), (8, 8)),
             lambda: transpose(x),
             lambda: complex_multiply((x, x), (h, h)),
             lambda: fftconv_fused(x, h, (8, 8))]
    for call in calls:
        with pytest.raises(RuntimeError, match="no_grad"):
            call()
    with torch.no_grad():
        for call in calls:
            call()


def _conv64(u, k):
    """The causal convolution of (B, L, D) and (D, L) by float64 torch.fft,
    differentiable: rfft, multiply, irfft."""
    length = u.shape[1]
    uf = torch.fft.rfft(u.double(), n=2 * length, dim=1)
    kf = torch.fft.rfft(k.double(), n=2 * length, dim=1).T
    return torch.fft.irfft(uf * kf, n=2 * length, dim=1)[:, :length]


def test_fft_conv_and_the_mixer_backpropagate_on_the_card(cuda,
                                                          monkeypatch):
    # fft_conv's backward (a correlation on the same kernels) under the
    # hopper planner: grad_u and grad_k against the autograd of a float64
    # torch.fft rendering, 2e-4 of max|ref|; the forward launches 2 / 2 / 1
    # four-step / transpose / complex multiply, the backward 1 / 2 / 2
    planner = Planner(backends=("hopper",))
    gen = torch.Generator(device=cuda).manual_seed(9)
    u = torch.randn(2, 512, 32, device=cuda, generator=gen,
                    requires_grad=True)
    k = torch.randn(32, 512, device=cuda, generator=gen, requires_grad=True)
    g = torch.randn(2, 512, 32, device=cuda, generator=gen)
    kernels.reset_launch_counts()
    y = fft_conv(u, k, planner=planner)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"four_step_fft": 2,
                                       "batched_transpose": 2,
                                       "complex_multiply": 1,
                                       "fftconv_fused": 0}
    kernels.reset_launch_counts()
    y.backward(g)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"four_step_fft": 1,
                                       "batched_transpose": 2,
                                       "complex_multiply": 2,
                                       "fftconv_fused": 0}
    u64 = u.detach().double().requires_grad_()
    k64 = k.detach().double().requires_grad_()
    _conv64(u64, k64).backward(g.double())
    for got, want in ((u.grad, u64.grad), (k.grad, k64.grad)):
        tol = 2e-4 * want.abs().max().item()
        assert (got.double() - want).abs().max().item() <= tol
    # the mixer's parameters, against the same mixer with its convolution
    # rendered in float64
    mixer = FFTConvMixer(32, 8, planner=planner, generator=gen)
    x = torch.randn(2, 512, 32, device=cuda, generator=gen)
    mixer(x).square().sum().backward()
    got = {n: p.grad.clone() for n, p in mixer.named_parameters()}
    mixer.zero_grad()
    from repro_torch.models import blocks
    monkeypatch.setattr(blocks, "fft_conv",
                        lambda v, f, **kw: _conv64(v, f).to(v.dtype))
    mixer(x).square().sum().backward()
    for n, p in mixer.named_parameters():
        tol = 2e-4 * p.grad.abs().max().item()
        assert (got[n] - p.grad).abs().max().item() <= tol, n


def test_lm_prefill_and_decode_on_the_card_match_the_cpu(cuda):
    # a hybrid LM at the olmo smoke width in float32 on the same weights:
    # prefill through the hopper planner launches two four-step, two
    # transpose and one complex-multiply kernel per FFT-conv layer, decode
    # none; logits within the kernels' 2e-4 of max|cpu|
    cfg = dataclasses.replace(get_smoke_config("olmo_1b"), segments=(
        ("attn_mlp", 1), ("fftconv_mlp", 2)))
    planner = Planner(backends=("hopper",))
    model = LM(cfg, planner=planner,
               generator=torch.Generator(device=cuda).manual_seed(0))
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict({n: t.cpu() for n, t in model.state_dict().items()})
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    kernels.reset_launch_counts()
    lg, cache = model.prefill({"tokens": toks[:, :60].to(cuda)}, 64)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"four_step_fft": 4,
                                       "batched_transpose": 4,
                                       "complex_multiply": 2,
                                       "fftconv_fused": 0}
    want, want_cache = cpu.prefill({"tokens": toks[:, :60]}, 64)
    steps = [(lg, want)]
    for i in range(60, 64):
        lg, cache = model.decode_step(cache, {"tokens": toks[:, i:i + 1]
                                              .to(cuda)})
        want, want_cache = cpu.decode_step(want_cache,
                                           {"tokens": toks[:, i:i + 1]})
        steps.append((lg, want))
    assert sum(kernels.launch_counts().values()) == 10
    for ours, plain in steps:
        assert ours.device.type == "cuda"
        assert (ours.cpu() - plain).abs().max().item() <= \
            2e-4 * plain.abs().max().item()


@pytest.mark.parametrize("arch", ["zamba2_7b", "xlstm_1_3b",
                                  "phi35_moe_42b", "qwen2_vl_7b"])
def test_lm_kinds_on_the_card_match_the_cpu(cuda, arch):
    # the other layer kinds at their smoke widths in float32 on the same
    # weights: no kernel of the port launches, and the card's prefill and
    # decode logits are the CPU's within 1e-4 of max|cpu| (float32 in
    # another order)
    cfg = get_smoke_config(arch)
    model = LM(cfg, generator=torch.Generator(device=cuda).manual_seed(0))
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict({n: t.cpu() for n, t in model.state_dict().items()})
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(2))
    kernels.reset_launch_counts()
    lg, cache = model.prefill({"tokens": toks[:, :36].to(cuda)}, 40)
    want, want_cache = cpu.prefill({"tokens": toks[:, :36]}, 40)
    steps = [(lg, want)]
    for i in range(36, 40):
        lg, cache = model.decode_step(cache, {"tokens": toks[:, i:i + 1]
                                              .to(cuda)})
        want, want_cache = cpu.decode_step(want_cache,
                                           {"tokens": toks[:, i:i + 1]})
        steps.append((lg, want))
    torch.cuda.synchronize()
    assert sum(kernels.launch_counts().values()) == 0
    v = cfg.vocab_size
    for ours, plain in steps:
        assert ours.device.type == "cuda"
        ours, plain = ours[..., :v].cpu(), plain[..., :v]
        assert (ours - plain).abs().max().item() <= \
            1e-4 * plain.abs().max().item()


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


@pytest.fixture(scope="module")
def nccl_meshes():
    """NCCL at world size 1 in this process: a (1,) and a (1, 1) mesh on
    the card (every exchange a local copy through NCCL)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield {"m1": make_mesh((1,), ("fft",)),
               "m11": make_mesh((1, 1), ("mx", "my"))}
    finally:
        dist.destroy_process_group()


def _within(pair, ref, what):
    tol = 2e-4 * ref.abs().max().item()
    err = max((pair[0].double() - ref.real).abs().max().item(),
              (pair[1].double() - ref.imag).abs().max().item())
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("comm,layout", [("collective", "natural"),
                                         ("pipelined:4", "natural"),
                                         ("agas", "natural"),
                                         ("collective", "transposed")])
def test_world_of_one_nccl_slab_matches_torch_fft(nccl_meshes, comm, layout):
    m, planner = nccl_meshes["m1"], Planner(backends=("hopper",))
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(2, 256, 384, device="cuda", generator=g)
    nd = plan_nd((256, 384), "r2c", mesh=m, decomp="slab", comm=comm,
                 output_layout=layout, planner=planner)
    local = distribute(x, nd, m)
    kernels.reset_launch_counts()
    spec = rfftn(local, mesh=m, plan=nd, planner=planner)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["four_step_fft"] >= 1 and counts["batched_transpose"] >= 2
    _within(collect(spec, nd, m), torch.fft.rfftn(x.double(), dim=(-2, -1)),
            "slab")
    back = collect(irfftn(spec, mesh=m, plan=nd, planner=planner), nd, m,
                   spatial=True)
    assert (back - x).abs().max().item() <= 2e-4 * x.abs().max().item()


def test_world_of_one_nccl_pencil_and_factor1d_match_torch_fft(nccl_meshes):
    planner = Planner(backends=("hopper",))
    g = torch.Generator(device="cuda").manual_seed(7)
    z = torch.randn(32, 48, 64, device="cuda", generator=g,
                    dtype=torch.complex64)
    m = nccl_meshes["m11"]
    nd = plan_nd(z.shape, "c2c", mesh=m, decomp="pencil", planner=planner)
    kernels.reset_launch_counts()
    spec = fftn(distribute(z, nd, m), mesh=m, plan=nd, planner=planner)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["four_step_fft"] == 3
    _within(collect(spec, nd, m), torch.fft.fftn(z.to(torch.complex128)),
            "pencil")
    back = collect(ifftn(spec, mesh=m, plan=nd, planner=planner), nd, m,
                   spatial=True)
    _within(back, z.to(torch.complex128), "pencil round trip")

    n = 1 << 16
    z1 = torch.randn(n, device="cuda", generator=g, dtype=torch.complex64)
    m = nccl_meshes["m1"]
    nd = plan_nd((n,), "c2c", mesh=m, decomp="factor1d", planner=planner)
    kernels.reset_launch_counts()
    spec = fftn(distribute(z1, nd, m), mesh=m, plan=nd, planner=planner)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["four_step_fft"] == 2 and counts["complex_multiply"] == 1
    _within(collect(spec, nd, m), torch.fft.fft(z1.to(torch.complex128)),
            "factor1d")


@pytest.mark.parametrize("comm", ["collective", "pipelined", "agas", "auto",
                                  "measure"])
def test_world_of_one_nccl_sharded_mixer_is_the_local_mixer(nccl_meshes,
                                                            comm):
    """The mixer's sequence-sharded branch at world size 1 on NCCL: the
    local mixer's values, with the four-step (4), transpose (14) and
    complex-multiply (4) kernels launched per call."""
    planner = Planner(backends=("hopper",))
    gen = torch.Generator(device="cuda").manual_seed(8)
    mixer = FFTConvMixer(64, 8, planner=planner, generator=gen,
                         mesh=nccl_meshes["m1"], axis="fft", comm=comm)
    x = torch.randn(2, 1024, 64, device="cuda", generator=gen)
    with torch.no_grad():
        want = mixer(x)
        kernels.reset_launch_counts()
        got = mixer(x, seq_axis_sharded=True)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["four_step_fft"], counts["batched_transpose"],
            counts["complex_multiply"]) == (4, 14, 4)
    tol = 2e-4 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


def test_world_of_one_nccl_shims_are_the_plan_nd_path(nccl_meshes):
    import warnings
    from repro_torch.core import dfft
    planner = Planner(backends=("hopper",))
    g = torch.Generator(device="cuda").manual_seed(9)
    m = nccl_meshes["m1"]
    x = torch.randn(256, 384, device="cuda", generator=g)
    nd = plan_nd(x.shape, "r2c", mesh=m, decomp="slab", planner=planner)
    want = rfftn(x, mesh=m, plan=nd, planner=planner)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for flags in ({}, {"keep_transposed": True},
                      {"permuted_cols": True}):
            spec = dfft.fft2_slab(x, m, "fft", planner, **flags)
            if not flags.get("permuted_cols"):
                got = spec if not flags else (spec[0].T, spec[1].T)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
            back = dfft.ifft2_slab(
                spec, m, "fft", 384, planner,
                from_transposed=flags.get("keep_transposed", False),
                permuted_cols=flags.get("permuted_cols", False))
            assert (back - x).abs().max().item() <= \
                2e-4 * x.abs().max().item()
        z = torch.randn(32, 48, 64, device="cuda", generator=g)
        spec = dfft.rfft3_pencil(z, nccl_meshes["m11"], ("mx", "my"),
                                 planner)
        _within(tuple(a[..., :33] for a in spec),
                torch.fft.rfftn(z.double()), "rfft3_pencil")


def test_world_of_one_nccl_compressed_psum(nccl_meshes):
    from repro_torch.optim import (choose_psum_comm, compressed_psum,
                                   dequantize_int8, quantize_int8)
    m = nccl_meshes["m1"]
    g = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn(1000, 37, device="cuda", generator=g)
    q, s, pad = quantize_int8(x)
    want = dequantize_int8(q, s, pad, x.shape)
    for comm in ("collective", "pipelined:2", "agas",
                 choose_psum_comm(m, "fft", x.shape, mode="measure"),
                 choose_psum_comm(m, "fft", x.shape)):
        total, err = compressed_psum(x, m.get_group("fft"), comm=comm)
        assert torch.equal(total, want) and torch.equal(err, x - want)
