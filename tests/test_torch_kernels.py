"""The port's kernels against the reference's Pallas kernels (interpret
mode on the CPU, as tests/test_kernels.py runs them).

On the CPU each op runs its plain PyTorch version, which is what these
tests hold against the reference; the CUDA kernels themselves are held
against the same plain versions on the card by tests/test_torch_gpu.py and
chip_smoke.py.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dft_matmul import fft_four_step as jax_four_step
from repro.kernels.transpose import transpose as jax_transpose
from repro_torch import kernels
from repro_torch.kernels import (fft_four_step, fft_four_step_ref, transpose,
                                 transpose_ref)

RNG = np.random.default_rng(12)


def _pairs(shape):
    re = RNG.standard_normal(shape).astype(np.float32)
    im = RNG.standard_normal(shape).astype(np.float32)
    return ((torch.from_numpy(re), torch.from_numpy(im)),
            (jnp.asarray(re), jnp.asarray(im)))


def _close(ours, theirs):
    # the reference's kernel tolerance (tests/test_kernels.py)
    scale = float(np.abs(np.asarray(theirs[0])).max()) + 1e-6
    for o, t in zip(ours, theirs):
        np.testing.assert_allclose(o.numpy(), np.asarray(t), atol=1e-4 * scale)


@pytest.mark.parametrize("factors", [(8, 8), (16, 32), (8, 128), (128, 8)])
@pytest.mark.parametrize("batch", [1, 5])
def test_four_step_matches_reference_kernel(factors, batch):
    tx, jx = _pairs((batch, factors[0] * factors[1]))
    _close(fft_four_step(tx, factors), jax_four_step(jx, factors))


@pytest.mark.parametrize("karatsuba", [False, True])
@pytest.mark.parametrize("permuted", [False, True])
def test_four_step_modes_match_reference_kernel(karatsuba, permuted):
    tx, jx = _pairs((4, 1024))
    _close(fft_four_step(tx, (32, 32), karatsuba=karatsuba,
                         permuted=permuted),
           jax_four_step(jx, (32, 32), karatsuba=karatsuba,
                         permuted=permuted))


def test_four_step_nd_batch_matches_reference_kernel():
    tx, jx = _pairs((2, 3, 256))
    ours = fft_four_step(tx, (16, 16))
    assert tuple(ours[0].shape) == (2, 3, 256)
    _close(ours, jax_four_step(jx, (16, 16)))


@pytest.mark.parametrize("shape", [(16, 16), (3, 40, 56), (2, 2, 32, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_transpose_matches_reference_kernel_exactly(shape, dtype):
    if dtype == "int32":
        x = RNG.integers(0, 100, shape).astype(np.int32)
        ours = transpose(torch.from_numpy(x)).numpy()
        theirs = np.asarray(jax_transpose(jnp.asarray(x)))
    else:
        x = RNG.standard_normal(shape).astype(np.float32)
        t = torch.from_numpy(x).to(getattr(torch, dtype))
        ours = transpose(t).float().numpy()
        theirs = np.asarray(jax_transpose(jnp.asarray(x, dtype)), np.float32)
    np.testing.assert_array_equal(ours, theirs)


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    kernels.reset_launch_counts()
    tx, _ = _pairs((3, 256))
    k, r = fft_four_step(tx, (16, 16)), fft_four_step_ref(tx, (16, 16))
    assert torch.equal(k[0], r[0]) and torch.equal(k[1], r[1])
    x = torch.arange(60.0).reshape(3, 4, 5)
    assert torch.equal(transpose(x), transpose_ref(x))
    assert transpose(x).is_contiguous()
    assert kernels.launch_counts() == {"four_step_fft": 0,
                                       "batched_transpose": 0,
                                       "complex_multiply": 0,
                                       "fftconv_fused": 0}


def test_other_devices_and_bad_shapes_raise():
    meta = (torch.empty(2, 64, device="meta"), torch.empty(2, 64, device="meta"))
    with pytest.raises(ValueError):
        fft_four_step(meta, (8, 8))
    with pytest.raises(ValueError):
        transpose(torch.empty(4, 4, device="meta"))
    tx, _ = _pairs((2, 64))
    with pytest.raises(ValueError):
        fft_four_step(tx, (8, 4))
    with pytest.raises(ValueError):
        transpose(torch.zeros(5))


def test_build_target_follows_the_kernels_headers(tmp_path):
    # the library's name hashes the source with every header under kernels/,
    # so an edited header rebuilds the kernels that include it (pure Python)
    from repro_torch.kernels import _build
    kernels_dir = tmp_path / "kernels"
    headers = sorted(p.relative_to(_build.KERNELS_DIR).as_posix()
                     for p in (_build.KERNELS_DIR / "common").glob("*.cuh"))
    assert "common/async_copy.cuh" in headers
    for rel in ("dft_matmul/dft_matmul.cu", *headers):
        (kernels_dir / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(_build.KERNELS_DIR / rel, kernels_dir / rel)
    src = kernels_dir / "dft_matmul" / "dft_matmul.cu"
    first = _build._target(src)
    assert first.name.startswith("dft_matmul-") and first.suffix == ".so"
    assert _build._target(src) == first
    assert first == _build._target(_build.sources()["dft_matmul"])
    header = kernels_dir / "common" / "fft_radix.cuh"
    original = header.read_bytes()
    header.write_bytes(original + b"\n// edited\n")
    assert _build._target(src) != first
    header.write_bytes(original)
    assert _build._target(src) == first
