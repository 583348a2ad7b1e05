"""The plain references against NumPy at small sizes, and the training
reference against the port's own step in float32."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from bench.lib import common, fields, weights
from bench.reference import fft as ref
from bench.reference import fftconv_lm as lm

common.use_src()


@pytest.mark.parametrize("shape", [(8, 12), (6, 8, 10), (16,)])
def test_spectrum_matches_numpy(shape):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=g)
    y = torch.randn(shape, generator=g)
    want = np.fft.rfftn(x.double().numpy())
    assert np.abs(ref.spectrum(x, "r2c").numpy() - want).max() < 1e-12
    z = x.double().numpy() + 1j * y.double().numpy()
    assert np.abs(ref.spectrum((x, y), "c2c").numpy()
                  - np.fft.fftn(z)).max() < 1e-12
    assert np.abs(ref.spectrum((x, y), "c2c", inverse=True).numpy()
                  - np.fft.ifftn(z)).max() < 1e-14
    zz = torch.complex(x.double(), y.double())
    assert np.abs(ref.spectrum_inplace(zz).numpy()
                  - np.fft.fftn(z)).max() < 1e-12


def test_blocks_of_a_large_axis_transform_alike():
    z = torch.randn(64, 32, dtype=torch.complex128)
    want = torch.fft.fft(z, dim=1)
    ref._fft_axis_inplace(z, 1, inverse=False, block_bytes=1024)
    assert torch.allclose(z, want)


def test_round_tf32_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -12, 1.0 + 2 ** -11,
                      -3.0 - 2 ** -11])
    got = ref.round_tf32(t)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -10, -3.0]
    x = torch.randn(1000)
    rel = ((ref.round_tf32(x) - x).abs() / x.abs()).max()
    assert rel <= 2 ** -11


@pytest.mark.parametrize("kind", ["r2c", "c2c"])
def test_control_is_the_transform_in_tf32(kind):
    x = torch.randn(32, 64)
    src = x if kind == "r2c" else (x, torch.randn(32, 64))
    got = ref.dft_tf32(src, kind)
    want = ref.spectrum(src, kind)
    diff, norm = ref.rel_l2_parts(got, want)
    # right to TF32's precision, and no better
    assert 1e-5 < math.sqrt(diff / norm) < 2e-3
    if kind == "r2c":
        back = ref.inverse_r2c_tf32(got, x.shape)
        assert 1e-5 < ref.rel_l2_real(back, x) < 2e-3


def test_fields_are_the_same_whole_or_in_blocks():
    shape = (16, 8, 8)
    whole = fields.field(shape, 4, 123456789012, 1, True, "cpu")
    part = fields.planes(shape, 4, 123456789012, 1, 8, 8, True, "cpu")
    assert torch.equal(whole[0][8:], part[0])
    assert torch.equal(whole[1][8:], part[1])
    other = fields.field(shape, 4, 123456789013, 1, True, "cpu")
    assert not torch.equal(whole[0], other[0])


def test_causal_conv_matches_numpy():
    v = torch.randn(2, 20, 3, dtype=torch.float64)
    k = torch.randn(3, 20, dtype=torch.float64)
    got = lm.causal_conv(v, k).numpy()
    vn, kn = v.numpy(), k.numpy()
    want = np.zeros_like(vn)
    for c in range(3):
        for b in range(2):
            want[b, :, c] = np.convolve(vn[b, :, c], kn[c])[:20]
    assert np.abs(got - want).max() < 1e-10


def test_filter_basis_and_norm_match_numpy():
    b = lm.filter_basis(32, 4, "cpu").double().numpy()
    t = np.arange(32)[None] / 32
    r = np.arange(4)[:, None]
    want = np.exp(-np.exp(0.5 * r) * t) * np.cos(2 * np.pi * (r + 1) * t)
    assert np.abs(b - want).max() < 1e-6
    x = torch.randn(5, 7, dtype=torch.float64)
    xn = x.numpy()
    want = (xn - xn.mean(-1, keepdims=True)) / np.sqrt(
        xn.var(-1, keepdims=True) + 1e-5)
    assert np.abs(lm.layer_norm(x).numpy() - want).max() < 1e-12


def test_lr_schedule():
    opt = {"lr": 1.0, "warmup_steps": 10, "total_steps": 110,
           "min_lr_frac": 0.1}
    assert lm.lr_at(opt, 5) == pytest.approx(0.5)
    assert lm.lr_at(opt, 10) == pytest.approx(1.0)
    assert lm.lr_at(opt, 60) == pytest.approx(0.1 + 0.9 * 0.5)
    assert lm.lr_at(opt, 200) == pytest.approx(0.1)


def test_training_reference_follows_the_ports_float32_step():
    """At a small size in float32 the port's loss and gradients equal the
    reference's: the reference computes the model the port does."""
    from repro_torch.models import LM, loss_fn
    from repro_torch.models.config import ArchConfig
    arch = {"num_layers": 2, "d_model": 32, "d_ff": 64, "vocab_size": 200,
            "fftconv_rank": 4}
    cfg = ArchConfig(name="t", family="dense", num_layers=2, d_model=32,
                     num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=200,
                     norm="nonparam_ln", tie_embeddings=True,
                     segments=(("fftconv_mlp", 2),), fftconv_rank=4,
                     compute_dtype="float32", remat=False)
    drawn = weights.draw(arch, 5, "cpu")
    model = LM(cfg, device="meta")
    for name, t in drawn.items():
        path, _, leaf = name.rpartition(".")
        model.get_submodule(path)._parameters[leaf] = torch.nn.Parameter(
            t.clone())
    batch = weights.batches(arch, 2, 16, 1, 5, "cpu")[0]
    loss, _ = loss_fn(model, batch)
    loss.backward()
    p = {n: t.clone().requires_grad_() for n, t in drawn.items()}
    want = lm.loss(p, batch, 2, 200)
    want.backward()
    assert loss.item() == pytest.approx(want.item(), rel=1e-5)
    for name, param in model.named_parameters():
        g, w = param.grad, p[name].grad
        assert (g - w).abs().max() <= 1e-4 * w.abs().max() + 1e-12, name
    assert dataclasses.asdict(cfg)["vocab_size"] == 200
