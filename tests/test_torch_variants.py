"""The paper's shared-memory variants in the port
(repro_torch.core.variants) against the reference's (repro.core.variants,
under jax.jit with the jnp backend) and numpy, on the CPU."""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.core import variants as jvariants
from repro_torch import kernels, rfftn
from repro_torch.core import plan, variants

ALL = list(variants.VARIANTS) + ["strided"]
# (48, 96) has mh = 49, so future_opt's column tasks shrink from 8 to 7
SHAPES = [(32, 64), (64, 128), (48, 96)]
BACKENDS = [("torch",), ("hopper",)]


def _input(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(c):
    return np.asarray(c[0], np.float64) + 1j * np.asarray(c[1], np.float64)


@functools.lru_cache(maxsize=None)
def _reference(name, shape):
    planner = jplan.Planner(mode="estimate", backends=("jnp",))
    out = jax.jit(lambda a: jvariants.run_variant(name, a, planner,
                                                  task_size=8))(_input(shape))
    return _np(out)


def _run(name, x, backends, **kw):
    return variants.run_variant(name, x, plan.Planner(backends=backends),
                                device="cpu", **kw)


def test_the_port_keeps_the_reference_s_names():
    assert variants.VARIANTS == jvariants.VARIANTS
    for name in ("fft2_for_loop", "fft2_future_sync", "fft2_future_naive",
                 "fft2_future_opt", "fft2_future_agas", "fft2_strided",
                 "run_variant", "staged_for_loop"):
        assert callable(getattr(variants, name)), name


@pytest.mark.parametrize("backends", BACKENDS, ids="-".join)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ALL)
def test_variant_matches_reference_and_numpy(name, shape, backends):
    x = _input(shape)
    out = _run(name, x, backends)
    mh = shape[1] // 2 + 1
    for t in out:
        assert t.shape == (shape[0], mh) and t.dtype == torch.float32
        assert t.is_contiguous()
    ref = np.fft.rfft2(x)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(_np(out), _reference(name, shape),
                               atol=2e-5 * scale, rtol=0)
    np.testing.assert_allclose(_np(out), ref, atol=2e-4 * scale, rtol=0)


@pytest.mark.parametrize("task_size", [1, 2, 8, 32])
@pytest.mark.parametrize("name", ["future_naive", "future_opt"])
def test_task_size_invariance(name, task_size):
    """The paper's task-size knob never changes the result."""
    x = _input((48, 96), seed=task_size)
    ref = np.fft.rfft2(x)
    scale = np.abs(ref).max()
    out = _np(_run(name, x, ("hopper",), task_size=task_size))
    np.testing.assert_allclose(out, ref, atol=2e-4 * scale, rtol=0)
    bulk = _np(_run("for_loop", x, ("hopper",)))
    np.testing.assert_allclose(out, bulk, atol=2e-5 * scale, rtol=0)


def test_task_sizes_shrink_to_divisors_as_the_reference_s():
    assert variants.shrink_task_size(48, 8) == 8
    assert variants.shrink_task_size(49, 8) == 7
    assert variants.shrink_task_size(8193, 8) == 3     # 8193 = 3 * 2731
    assert variants.shrink_task_size(16384, 8) == 8
    assert variants.shrink_task_size(5, 32) == 5
    assert variants.shrink_task_size(7, 0) == 1


@pytest.mark.parametrize("backends", BACKENDS, ids="-".join)
def test_staged_for_loop_composes_to_rfft2(backends):
    x = _input((64, 128))
    stages = variants.staged_for_loop(x, plan.Planner(backends=backends),
                                      device="cpu")
    assert [s for s, _ in stages] == ["fft_r2c_rows", "transpose",
                                      "fft_c2c_cols", "transpose_back"]
    val = x
    for _, fn in stages:
        val = fn(val)
    ref = np.fft.rfft2(x)
    np.testing.assert_allclose(_np(val), ref, atol=2e-4 * np.abs(ref).max(),
                               rtol=0)
    np.testing.assert_array_equal(
        _np(val), _np(_run("for_loop", x, backends)))


@pytest.mark.parametrize("shape", SHAPES)
def test_for_loop_agrees_with_rfftn(shape):
    x = _input(shape)
    planner = plan.Planner(backends=("hopper",))
    ours = _np(variants.fft2_for_loop(x, planner, device="cpu"))
    spec = _np(rfftn(x, planner=planner, device="cpu"))
    scale = np.abs(spec).max()
    np.testing.assert_allclose(ours, spec, atol=1e-6 * scale, rtol=0)


@pytest.mark.parametrize("name,want", [("future_sync", 3), ("future_opt", 1),
                                       ("for_loop", 0), ("future_naive", 0),
                                       ("future_agas", 0), ("strided", 0)])
def test_barriers_per_variant(monkeypatch, name, want):
    calls = []
    monkeypatch.setattr(variants, "_barrier", calls.append)
    _run(name, _input((32, 64)), ("torch",))
    assert calls == [torch.device("cpu")] * want


def test_cpu_runs_launch_no_kernel():
    kernels.reset_launch_counts()
    for name in ALL:
        _run(name, _input((32, 64)), ("hopper",))
    assert set(kernels.launch_counts().values()) == {0}


def test_the_default_device_is_the_gpu_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    planner = plan.Planner(backends=("torch",))
    x = _input((32, 64))
    for name in ALL:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            variants.run_variant(name, x, planner)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        variants.staged_for_loop(x, planner)


def test_unknown_variant_raises_the_reference_s_error():
    x = _input((32, 64))
    with pytest.raises(ValueError) as theirs:
        jvariants.run_variant("bulk", x, jplan.Planner(backends=("jnp",)))
    with pytest.raises(ValueError) as ours:
        variants.run_variant("bulk", x, plan.Planner(), device="cpu")
    assert str(ours.value) == str(theirs.value)
