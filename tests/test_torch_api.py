"""The port end to end: its planned N-D FFT front-end
(repro_torch.core.api) against the reference's (repro.core.api, mesh=None,
kernel backend in interpret mode) and numpy, on the CPU."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import algo as jalgo
from repro.core import api as japi
from repro.core import plan as jplan
from repro_torch import kernels
from repro_torch.convert import nd_plan_from_reference
from repro_torch.core import api, plan

TPU_VALUES = plan.HardwareSpec(**dataclasses.asdict(jplan.TPU_V5E))
RNG = np.random.default_rng(14)

# (shape, transform ndim): a batch dim, 3D, an odd last axis, 1D
SHAPES = [((2, 64, 96), 2), ((24, 40, 16), 3), ((30, 45), 2), ((4096,), 1)]


def _ours():
    return plan.Planner(hardware=TPU_VALUES, backends=("hopper",))


def _theirs():
    return jplan.Planner(hardware=jplan.TPU_V5E, backends=("pallas",))


def _np(c):
    return np.asarray(c[0], np.float64) + 1j * np.asarray(c[1], np.float64)


def _close(got, want, ref):
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(ref).max())


def _axes(ndim):
    return tuple(range(-ndim, 0))


@pytest.mark.parametrize("shape,ndim", SHAPES)
def test_fftn_ifftn_match_reference_and_numpy(shape, ndim):
    x = (RNG.standard_normal(shape).astype(np.float32)
         + 1j * RNG.standard_normal(shape).astype(np.float32))
    ours = api.fftn(x, ndim=ndim, planner=_ours(), device="cpu")
    # the reference runs compiled whole (much faster than eager)
    theirs = jax.jit(lambda c: japi.fftn(c, ndim=ndim, planner=_theirs()))(
        jalgo.to_pair(x))
    ref = np.fft.fftn(x, axes=_axes(ndim))
    _close(_np(ours), ref, ref)
    _close(_np(ours), _np(theirs), ref)
    back = api.ifftn(ours, ndim=ndim, planner=_ours(), device="cpu")
    theirs_back = jax.jit(lambda c: japi.ifftn(c, ndim=ndim,
                                               planner=_theirs()))(theirs)
    _close(_np(back), x, x)
    _close(_np(back), _np(theirs_back), x)


@pytest.mark.parametrize("shape,ndim", SHAPES)
def test_rfftn_irfftn_match_reference_and_numpy(shape, ndim):
    x = RNG.standard_normal(shape).astype(np.float32)
    ours = api.rfftn(x, ndim=ndim, planner=_ours(), device="cpu")
    theirs = jax.jit(lambda a: japi.rfftn(a, ndim=ndim,
                                          planner=_theirs()))(x)
    ref = np.fft.rfftn(x, axes=_axes(ndim))
    _close(_np(ours), ref, ref)
    _close(_np(ours), _np(theirs), ref)
    back = api.irfftn(ours, shape=shape[len(shape) - ndim:],
                      planner=_ours(), device="cpu")
    assert tuple(back.shape) == shape
    _close(back.numpy(), x, x)
    theirs_back = jax.jit(lambda c: japi.irfftn(
        c, shape=shape[len(shape) - ndim:], planner=_theirs()))(theirs)
    _close(back.numpy(), np.asarray(theirs_back), x)


def test_the_path_runs_the_kernel_ops_in_cpu_mode():
    """On the CPU the ops take their plain versions: nothing launches."""
    kernels.reset_launch_counts()
    api.fftn(RNG.standard_normal((16, 32)), planner=_ours(), device="cpu")
    assert kernels.launch_counts() == {"four_step_fft": 0,
                                       "batched_transpose": 0,
                                       "complex_multiply": 0,
                                       "fftconv_fused": 0}


@pytest.mark.parametrize("shape,kind", [((64, 96), "r2c"), ((24, 40, 16), "c2c"),
                                        ((4096,), "c2c"), ((30, 45), "r2c")])
def test_plan_nd_gives_the_reference_verdict(shape, kind):
    ours = api.plan_nd(shape, kind, planner=_ours())
    theirs = japi.plan_nd(shape, kind, planner=_theirs())
    assert ours.decomp == theirs.decomp == "local"
    assert ours.est_cost == pytest.approx(theirs.est_cost, rel=1e-12)
    assert nd_plan_from_reference(dataclasses.asdict(theirs)) == ours


@pytest.mark.parametrize("shape,sizes", [((64, 64), {"fft": 8}),
                                         ((48, 40, 32), {"mx": 4, "my": 2}),
                                         ((16, 12, 10, 8), {"a": 2, "b": 3,
                                                            "c": 2})])
def test_decomposition_roofline_matches_the_reference(shape, sizes):
    """Candidates and the roofline for meshes are pure arithmetic; they are
    ported whole, ahead of the distributed executors."""
    for kind in ("c2c", "r2c"):
        assert api._candidates(shape, kind, sizes) == \
            japi._candidates(shape, kind, sizes)
        for decomp in ("local", "slab", "pencil"):
            if decomp == "pencil" and len(shape) < 3:
                continue
            theirs = japi.plan_nd(shape, kind, mesh=sizes, decomp=decomp,
                                  planner=_theirs())
            ours = nd_plan_from_reference(dataclasses.asdict(theirs))
            assert ours.padded_spectrum_shape == theirs.padded_spectrum_shape
            assert ours.padded_input_shape == theirs.padded_input_shape
            assert api._estimate_nd(ours, TPU_VALUES, on_mesh=True) == \
                pytest.approx(theirs.est_cost, rel=1e-12)


def test_plan_nd_wisdom_keys_and_v1_migration():
    p = _ours()
    api.plan_nd((32, 48), "r2c", planner=p)
    jp = _theirs()
    japi.plan_nd((32, 48), "r2c", planner=jp)
    assert list(p.wisdom.keys("dfft/")) == list(jp.wisdom.keys("dfft/"))
    v1 = "dfft/16x16/c2c/none/estimate/auto"
    p.wisdom.put(v1, {"decomp": "local", "mesh_axes": [], "mesh_shape": [],
                      "comm": [], "est": 1.5, "measured": -1.0})
    nd = api.plan_nd((16, 16), "c2c", planner=p)
    assert nd.est_cost == 1.5
    assert p.wisdom.get("dfft/v2/16x16/c2c/none/estimate/auto/natural")


def test_entry_points_without_a_device_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    x = np.ones((8, 8), np.float32)
    spec = api.rfftn(x, device="cpu")
    for call in (lambda: api.fftn(x), lambda: api.ifftn(x),
                 lambda: api.rfftn(x), lambda: api.irfftn(spec),
                 lambda: api.plan_nd((8, 8), mode="measured")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_distributed_requests_raise():
    x = np.ones((8, 8), np.float32)
    with pytest.raises(NotImplementedError, match="later slice"):
        api.plan_nd((8, 8), mesh={"fft": 2})
    with pytest.raises(NotImplementedError, match="later slice"):
        api.plan_nd((8, 8), decomp="slab")
    with pytest.raises(NotImplementedError, match="later slice"):
        api.fftn(x, mesh={"fft": 2}, device="cpu")
    slab = api.NdPlan((8, 8), "c2c", "slab", ("fft",), (2,))
    with pytest.raises(NotImplementedError, match="later slice"):
        api.execute_nd(slab, (torch.ones(8, 8), torch.zeros(8, 8)))
