"""The port's FFT convolution (repro_torch.core.fftconv, the complex-multiply
and fused FFT-conv kernels, the FFT-conv mixer) against the reference's
(repro.core.fftconv, its Pallas kernels in interpret mode,
repro.models.blocks) and numpy, on the CPU.

On the CPU each kernel op runs its plain PyTorch version; the CUDA kernels
are held against the same plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.olmo_1b import SMOKE
from repro.core import fftconv as jfc
from repro.kernels.fftconv import fftconv_fused as jax_fftconv_fused
from repro.kernels.fftconv.fftconv import \
    filter_spectrum_permuted as jax_filter_spectrum
from repro.kernels.twiddle import complex_multiply as jax_complex_multiply
from repro.models.blocks import fftconv_fwd, fftconv_meta
from repro.models.params import init_tree
from repro_torch import Planner, kernels
from repro_torch.convert import fftconv_mixer_from_reference
from repro_torch.core import fftconv as fc
from repro_torch.kernels import (complex_multiply, complex_multiply_ref,
                                 fftconv_fused, fftconv_fused_ref)
from repro_torch.kernels._grad import refuse_autograd
from repro_torch.kernels.fftconv import filter_spectrum_permuted
from repro_torch.models import FFTConvMixer

RNG = np.random.default_rng(15)


def _pair(shape):
    return (RNG.standard_normal(shape).astype(np.float32),
            RNG.standard_normal(shape).astype(np.float32))


def _t(pair):
    return tuple(torch.from_numpy(a) for a in pair)


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


def _filter(nf, decay):
    return (RNG.standard_normal(nf) * np.exp(-np.arange(nf) / decay)
            ).astype(np.float32)


# -- complex_multiply -------------------------------------------------------


@pytest.mark.parametrize("a_shape,b_shape", [
    ((128,), (128,)), ((4, 300), (4, 300)), ((2, 3, 64), (2, 3, 64)),
    ((4, 300), (300,)), ((2, 3, 64), (3, 64))])
def test_complex_multiply_matches_reference_kernel(a_shape, b_shape):
    a, b = _pair(a_shape), _pair(b_shape)
    ours = complex_multiply(_t(a), _t(b))
    bb = tuple(jnp.broadcast_to(jnp.asarray(t), a_shape) for t in b)
    theirs = jax_complex_multiply(_j(a), bb)
    # the reference's kernel tolerance (tests/test_kernels.py)
    for o, t in zip(ours, theirs):
        assert tuple(o.shape) == a_shape
        np.testing.assert_allclose(o.numpy(), np.asarray(t), atol=1e-5)


def test_complex_multiply_other_broadcasts_and_bad_input():
    a, b = _t(_pair((4, 300))), _t(_pair((4, 1)))
    ours = complex_multiply(a, b)
    want = complex_multiply_ref(a, tuple(t.expand(4, 300) for t in b))
    assert all(torch.equal(o, w) for o, w in zip(ours, want))
    with pytest.raises(ValueError):             # b larger than a
        complex_multiply(_t(_pair((300,))), _t(_pair((4, 300))))
    with pytest.raises(ValueError):             # mismatched pair
        complex_multiply((a[0], a[1][:2]), b)
    meta = (torch.empty(4, device="meta"), torch.empty(4, device="meta"))
    with pytest.raises(ValueError):
        complex_multiply(meta, meta)


# -- fftconv_fused ----------------------------------------------------------


def _close_scaled(got, ref, rel=2e-4):
    # the reference's kernel tolerance (tests/test_kernels_fftconv.py)
    scale = float(np.abs(ref).max()) + 1e-6
    np.testing.assert_allclose(got, ref, atol=rel * scale)


@pytest.mark.parametrize("factors", [(8, 8), (16, 32)])
@pytest.mark.parametrize("batch", [1, 6])
def test_fftconv_fused_matches_reference_kernel(factors, batch):
    nf = factors[0] * factors[1]
    x = RNG.standard_normal((batch, nf)).astype(np.float32)
    h = _filter(nf, 64)
    ours = fftconv_fused(torch.from_numpy(x), torch.from_numpy(h), factors)
    theirs = np.asarray(jax_fftconv_fused(jnp.asarray(x), jnp.asarray(h),
                                          factors))
    oracle = fftconv_fused_ref(torch.from_numpy(x), torch.from_numpy(h))
    _close_scaled(ours.numpy(), theirs)
    _close_scaled(ours.numpy(), oracle.numpy())


@pytest.mark.parametrize("factors", [(8, 8), (16, 32), (32, 8)])
def test_filter_spectrum_permuted_matches_reference(factors):
    h = _filter(factors[0] * factors[1], 16)
    ours = filter_spectrum_permuted(torch.from_numpy(h), factors)
    theirs = jax_filter_spectrum(jnp.asarray(h), factors)
    _close_scaled(ours[0].numpy(), np.asarray(theirs[0]), 1e-4)
    _close_scaled(ours[1].numpy(), np.asarray(theirs[1]), 1e-4)


def test_fftconv_fused_causal_via_padding():
    """Causal conv = circular conv on 2x padded signals, as the LM uses it."""
    length = 128
    x = RNG.standard_normal((2, length)).astype(np.float32)
    h = _filter(length, 16)
    xp = torch.from_numpy(np.pad(x, ((0, 0), (0, length))))
    hp = torch.from_numpy(np.pad(h, (0, length)))
    got = fftconv_fused(xp, hp, (16, 16)).numpy()[:, :length]
    ref = np.stack([np.convolve(x[i], h)[:length] for i in range(2)])
    np.testing.assert_allclose(got, ref, atol=1e-3 * np.abs(ref).max())


def test_fftconv_fused_rejects_bad_input():
    x, h = torch.zeros(2, 64), torch.zeros(64)
    with pytest.raises(ValueError):
        fftconv_fused(x, h, (8, 4))             # nf != 64
    with pytest.raises(ValueError):
        fftconv_fused(x, h, (256, 1))           # factor above 128
    with pytest.raises(ValueError):
        fftconv_fused(x[0], h, (8, 8))          # not (B, nf)
    with pytest.raises(ValueError):
        fftconv_fused(x.to("meta"), h.to("meta"), (8, 8))


# -- the module's pure helpers ----------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 100, 128, 129, 4097])
def test_next_fft_len_matches_reference(n):
    assert fc.next_fft_len(n) == jfc.next_fft_len(n)


def test_factor_split_matches_reference():
    for n in (16, 64, 256, 1000, 4096, 2 ** 14, 2 ** 20, 3 * 2 ** 10,
              2 * 131 ** 2, 17 * 64):
        for p in (0, 1, 2, 3, 4, 8, 16):
            assert fc.factor_split(n, p) == jfc.factor_split(n, p), (n, p)
    assert fc.factor_split(2 ** 14, 8) == (128, 128)
    assert fc.factor_split(100, 3) is None          # not a multiple of p**2
    assert fc.factor_split(4 * 257, 2) is None      # 257: a prime above 128


@pytest.mark.parametrize("length,rank", [(128, 16), (1000, 4), (1, 3)])
def test_filter_basis_and_materialize_match_reference(length, rank):
    ours = fc.filter_basis(length, rank).numpy()
    theirs = np.asarray(jfc.filter_basis(length, rank))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-6)
    w = (RNG.standard_normal((8, rank)) * 0.2).astype(np.float32)
    ours = fc.materialize_filter(torch.from_numpy(w), length).numpy()
    theirs = np.asarray(jfc.materialize_filter(jnp.asarray(w), length))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)


# -- fft_conv and the mixer -------------------------------------------------


@pytest.mark.parametrize("permuted", [True, False])
@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_fft_conv_matches_reference_and_numpy(permuted, backend):
    b, length, d = 2, 128, 16
    u = RNG.standard_normal((b, length, d)).astype(np.float32)
    k = (RNG.standard_normal((d, length))
         * np.exp(-np.arange(length) / 16)).astype(np.float32)
    kernels.reset_launch_counts()
    ours = fc.fft_conv(torch.from_numpy(u), torch.from_numpy(k),
                       planner=Planner(backends=(backend,)),
                       permuted=permuted, device="cpu")
    assert kernels.launch_counts()["complex_multiply"] == 0   # CPU: plain
    theirs = np.asarray(jfc.fft_conv(jnp.asarray(u), jnp.asarray(k),
                                     permuted=permuted))
    ref = np.stack([np.stack([np.convolve(u[i, :, c], k[c])[:length]
                              for c in range(d)], -1) for i in range(b)])
    assert ours.shape == (b, length, d) and ours.dtype == torch.float32
    tol = 2e-4 * np.abs(ref).max()
    np.testing.assert_allclose(ours.numpy(), theirs, atol=tol)
    np.testing.assert_allclose(ours.numpy(), ref, atol=tol)


def test_fft_conv_keeps_the_input_dtype():
    u = torch.from_numpy(RNG.standard_normal((1, 32, 4)).astype(np.float32))
    k = torch.from_numpy(RNG.standard_normal((4, 32)).astype(np.float32))
    y32 = fc.fft_conv(u, k, device="cpu")
    y16 = fc.fft_conv(u.bfloat16(), k, device="cpu")
    assert y16.dtype == torch.bfloat16
    np.testing.assert_allclose(y16.float().numpy(), y32.numpy(),
                               atol=2e-2 * float(y32.abs().max()))


def test_fft_conv_mixer_matches_reference_block():
    cfg = SMOKE                                 # d_model 64, rank 16
    p = init_tree(fftconv_meta(cfg), jax.random.PRNGKey(3))
    x = RNG.standard_normal((2, 128, cfg.d_model)).astype(np.float32)
    theirs = np.asarray(fftconv_fwd(p, cfg, jnp.asarray(x)))
    mixer = fftconv_mixer_from_reference(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")
    assert mixer.filt.shape == (cfg.d_model, cfg.fftconv_rank)
    with torch.no_grad():
        ours = mixer(torch.from_numpy(x)).numpy()
    assert ours.shape == x.shape
    np.testing.assert_allclose(ours, theirs,
                               atol=2e-4 * np.abs(theirs).max())


def test_kernels_refuse_autograd_only_while_it_is_on():
    t = torch.ones(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no_grad"):
        refuse_autograd("op", torch.ones(4), t)
    refuse_autograd("op", torch.ones(4))
    with torch.no_grad():
        refuse_autograd("op", t)


def test_fft_conv_mixer_backpropagates_on_the_cpu():
    # the CPU path is plain PyTorch: its gradients must match those of a
    # torch.fft rendering of the same block, to 2e-4 of each gradient's max
    x = torch.from_numpy(RNG.standard_normal((2, 64, 16)).astype(np.float32))
    mixer = FFTConvMixer(16, 4, device="cpu",
                         generator=torch.Generator().manual_seed(2))
    ours = mixer(x).square().sum()
    ours.backward()
    got = {n: p.grad.clone() for n, p in mixer.named_parameters()}
    mixer.zero_grad()
    v, gate = (x @ mixer.w_in).chunk(2, dim=-1)
    filt = fc.materialize_filter(mixer.filt, 64)
    conv = torch.fft.irfft(torch.fft.rfft(v, n=128, dim=1)
                           * torch.fft.rfft(filt, n=128, dim=1).T,
                           n=128, dim=1)[:, :64]
    y = (conv + v * mixer.skip) * torch.nn.functional.silu(gate)
    (y @ mixer.w_out).square().sum().backward()
    for name, p in mixer.named_parameters():
        want = p.grad
        assert float(want.abs().max()) > 0, name
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   atol=2e-4 * float(want.abs().max()))
