"""The port end to end: its planned N-D FFT front-end
(repro_torch.core.api) against the reference's (repro.core.api, mesh=None,
kernel backend in interpret mode) and numpy, on the CPU; and the
distributed executors on a one-rank gloo mesh in this process (the 8-rank
suite is tests/test_torch_dist.py)."""

import dataclasses
import datetime
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import algo as jalgo
from repro.core import api as japi
from repro.core import plan as jplan
from repro_torch import kernels
from repro_torch.convert import nd_plan_from_reference
from repro_torch.core import api, comm, dfft, plan

TPU_VALUES = plan.HardwareSpec(**dataclasses.asdict(jplan.TPU_V5E),
                               collective_lat=japi.COLLECTIVE_LAT)
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


@pytest.fixture(scope="module")
def one_rank():
    """A gloo world of this one process, with a (1,) and a (1, 1) mesh."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield {"m1": comm.make_mesh((1,), ("fft",)),
               "m11": comm.make_mesh((1, 1), ("mx", "my"))}
    finally:
        dist.destroy_process_group()


def _cpu_planner():
    return plan.Planner(backends=("torch",), device="cpu")


ONE_RANK_CASES = [
    ("slab", "m1", "r2c", (2, 10, 12), 2, "natural"),
    ("slab", "m1", "c2c", (20, 24), 2, "transposed"),
    ("slab", "m1", "r2c", (9, 6, 7), 3, "natural"),
    ("pencil", "m11", "c2c", (2, 6, 10, 9), 3, "natural"),
    ("pencil", "m11", "r2c", (6, 10, 5, 12), 4, "natural"),
    ("factor1d", "m1", "c2c", (3, 4096), 1, "natural"),
]


@pytest.mark.parametrize("decomp,mesh,kind,shape,ndim,layout",
                         ONE_RANK_CASES)
def test_one_rank_mesh_runs_every_decomposition(one_rank, decomp, mesh,
                                                kind, shape, ndim, layout):
    """At world size 1 every exchange is a local collective; the results
    match numpy, and collect/distribute keep the block convention."""
    m = one_rank[mesh]
    x = RNG.standard_normal(shape).astype(np.float32)
    if kind == "c2c":
        x = (x + 1j * RNG.standard_normal(shape)).astype(np.complex64)
    p = _cpu_planner()
    nd = api.plan_nd(shape[len(shape) - ndim:], kind, mesh=m, planner=p,
                     decomp=decomp, output_layout=layout)
    assert nd.decomp == decomp and nd.mesh_shape == (1,) * len(nd.mesh_axes)
    local = dfft.distribute(x, nd, m)
    if kind == "r2c":
        spec = api.rfftn(local, mesh=m, plan=nd, planner=p)
        back = api.irfftn(spec, mesh=m, plan=nd, planner=p)
        ref = np.fft.rfftn(x, axes=_axes(ndim))
    else:
        spec = api.fftn(local, mesh=m, plan=nd, planner=p)
        back = api.ifftn(spec, mesh=m, plan=nd, planner=p)
        ref = np.fft.fftn(x, axes=_axes(ndim))
    got = dfft.collect(spec, nd, m)
    _close(_np(got), ref, ref)
    back = dfft.collect(back, nd, m, spatial=True)
    back = _np(back) if kind == "c2c" else back.numpy()
    _close(back, x, x)


@pytest.mark.parametrize("n1,n2,me,p,sign,chunk_axis", [
    (16, 8, 0, 1, -1, 1), (16, 8, 1, 2, -1, 1), (8, 16, 3, 4, 1, 0),
    (1 << 13, 1 << 13, 45, 64, -1, 1), (1 << 13, 1 << 13, 63, 64, 1, 0)])
def test_factor1d_twiddle_block_is_exact_and_built_once(n1, n2, me, p, sign,
                                                        chunk_axis):
    """Rank ``me``'s twiddle block equals exp(sign*2*pi*i*k1*j2/N) in
    float64 (also at N = 2**26, where float32 k1*j2 is not exact) and a
    second call with the same key returns the cached pair."""
    dev = torch.device("cpu")
    got = dfft._factor1d_twiddle_block(n1, n2, me, p, sign,
                                       chunk_axis=chunk_axis, device=dev)
    assert got is dfft._factor1d_twiddle_block(
        n1, n2, me, p, sign, chunk_axis=chunk_axis, device=dev)
    k1, j2 = np.arange(n1, dtype=np.int64), np.arange(n2, dtype=np.int64)
    if chunk_axis == 1:
        j2 = j2[me * (n2 // p):(me + 1) * (n2 // p)]
    else:
        k1 = k1[me * (n1 // p):(me + 1) * (n1 // p)]
    want = np.exp(sign * 2j * np.pi * ((k1[:, None] * j2[None]) % (n1 * n2))
                  / (n1 * n2))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6)
    dfft._factor1d_twiddle_block.cache_clear()


def test_one_rank_mesh_needs_the_global_shape_and_checks_blocks(one_rank):
    m = one_rank["m1"]
    x = torch.ones(8, 8)
    with pytest.raises(ValueError, match="shape="):
        api.rfftn(x, mesh=m, planner=_cpu_planner())
    with pytest.raises(ValueError, match="block"):
        api.rfftn(x, mesh=m, shape=(8, 16), planner=_cpu_planner())
    with pytest.raises(ValueError, match="mesh runs on cpu"):
        api.rfftn(x, mesh=m, shape=(8, 8), device="meta")
    spec = api.rfftn(x, mesh=m, shape=(8, 8), planner=_cpu_planner())
    assert tuple(spec[0].shape) == (8, 5)


def test_measure_with_an_abstract_mesh_raises():
    with pytest.raises(ValueError, match="live mesh"):
        api.plan_nd((64, 64), "r2c", mesh={"fft": 8}, decomp="slab",
                    comm="measure", planner=_ours())
    with pytest.raises(ValueError, match="live mesh"):
        api.plan_nd((16, 16, 16), "c2c", mesh={"mx": 2, "my": 2},
                    decomp="pencil", comm=("measure", "collective"),
                    planner=_ours())
    with pytest.raises(ValueError, match="live DeviceMesh"):
        api.execute_nd(api.plan_nd((64, 64), "r2c", mesh={"fft": 8},
                                   decomp="slab", planner=_ours()),
                       torch.ones(8, 64), mesh={"fft": 8})


def test_a_candidate_that_raises_makes_measured_planning_raise(
        one_rank, monkeypatch):
    """No candidate is skipped: a failing exchange in the comm sweep and a
    failing finalist both make planning raise (the one-rank mesh poses as
    two ranks, so that there is something to measure)."""
    m = one_rank["m1"]

    def broken(*args, **kwargs):
        raise RuntimeError("candidate broke")

    comm.forget_measurements()
    for module in (api, comm):
        monkeypatch.setattr(module, "mesh_sizes", lambda mesh: {"fft": 2})
    monkeypatch.setattr(comm.CollectiveBackend, "exchange",
                        lambda self, c, group, **kw: c)
    monkeypatch.setattr(comm.AgasBackend, "exchange", broken)
    with pytest.raises(RuntimeError, match="candidate broke"):
        api.plan_nd((16, 16), "r2c", mesh=m, decomp="slab", comm="measure",
                    planner=_cpu_planner())
    monkeypatch.undo()
    comm.forget_measurements()
    monkeypatch.setattr(api, "execute_nd", broken)
    with pytest.raises(RuntimeError, match="candidate broke"):
        api._measure_finalists(
            [(0.0, api.NdPlan((8, 8), "r2c", "local"))], m, _cpu_planner(),
            lambda dec, axes, est: api.NdPlan((8, 8), "r2c", dec))


def test_measured_planning_on_one_rank_times_nothing(one_rank):
    """A one-rank mesh has no live axis: local is the only candidate and
    comm="measure" resolves without timing (as the reference's p <= 1)."""
    m = one_rank["m1"]
    before = (api.PLAN_ND_STATS["timed"], comm.MEASURE_STATS["timed"])
    nd = api.plan_nd((16, 16), "r2c", mesh=m, mode="measured",
                     planner=_cpu_planner())
    assert nd.decomp == "local"
    forced = api.plan_nd((16, 16), "r2c", mesh=m, decomp="slab",
                         comm="measure", planner=_cpu_planner())
    assert forced.comm == ("collective",)
    assert (api.PLAN_ND_STATS["timed"], comm.MEASURE_STATS["timed"]) == before


def test_core_exports_what_the_reference_exports():
    """Every name of repro.core's export list but the JAX version shims
    (compat) and the TPU profile is exported by repro_torch.core."""
    import repro.core as jcore
    import repro_torch.core as core
    assert set(jcore.__all__) - set(core.__all__) == {"compat", "TPU_V5E"}
    for name in core.__all__:
        assert hasattr(core, name), name


@pytest.mark.parametrize("n", [7, 9, 12])
def test_hermitian_extend_keeps_its_index_on_the_device(n):
    """The mirror index of an odd-length c2r is built once per (n, device):
    a second call reuses the same tensor (no copy from host memory)."""
    dev = torch.device("cpu")
    assert dfft._mirror_index(n, dev) is dfft._mirror_index(n, dev)
    x = RNG.standard_normal((3, n))
    half = np.fft.rfft(x)
    full = dfft.hermitian_extend_last(
        (torch.from_numpy(half.real), torch.from_numpy(half.imag)), n)
    np.testing.assert_allclose(_np(full), np.fft.fft(x), atol=1e-12)


@pytest.mark.parametrize("shape,kind,mesh,want", [
    ((16384, 16384), "r2c", {"fft": 4}, ("slab", ("collective",))),
    ((512,) * 3, "c2c", {"mx": 2, "my": 2},
     ("pencil", ("collective", "collective"))),
    ((1 << 26,), "c2c", {"fft": 4}, ("factor1d", ("collective",))),
    ((16384, 16384), "r2c", None, ("local", ())),
    ((512,) * 3, "c2c", None, ("local", ())),
])
def test_h100_estimate_verdicts_at_the_chip_shapes(shape, kind, mesh, want):
    """The verdicts the H100 profile's roofline gives at the shapes the
    card runs (measured on 4 cards: slab over collective, pencil,
    factor1d; PERF.md section 6)."""
    nd = api.plan_nd(shape, kind, mesh=mesh,
                     planner=plan.Planner(backends=("hopper",)))
    assert (nd.decomp, nd.comm) == want


def test_a_local_plan_no_1d_plan_covers_is_priced_out():
    """2**26 has no factorization of at most three factors <= 128: under
    the H100's pricing its local candidate costs infinity, and measured
    planning does not time it."""
    p = plan.Planner(backends=("hopper",))
    local = api.plan_nd((1 << 26,), "c2c", mesh={"fft": 4}, decomp="local",
                        planner=p)
    assert local.est_cost == float("inf")


def test_measured_finalists_skip_a_candidate_priced_at_infinity(
        one_rank, monkeypatch):
    timed = []
    monkeypatch.setattr(api, "execute_nd",
                        lambda nd, x, **kw: timed.append(nd.shape) or x)
    nd = api._measure_finalists(
        [(float("inf"), api.NdPlan((1 << 26,), "c2c", "local")),
         (1.0, api.NdPlan((8, 8), "r2c", "local"))], one_rank["m1"],
        _cpu_planner(), lambda dec, axes, est: api.NdPlan((8, 8), "r2c",
                                                            dec))
    assert timed == [(8, 8)] * 4 and nd.measured_cost > 0


def _conv_inputs(b=2, length=64, d=3):
    rng = np.random.default_rng(15)
    u = rng.standard_normal((b, length, d)).astype(np.float32)
    k = (rng.standard_normal((d, length))
         * np.exp(-np.arange(length) / 16)[None]).astype(np.float32)
    return u, k


@functools.lru_cache(maxsize=None)
def _reference_conv_on_one_device() -> np.ndarray:
    """The reference's fft_conv_seq_sharded of ``_conv_inputs()`` on a
    one-device mesh, compiled whole (eager shard_map is much slower)."""
    from repro.core import fftconv as jfc
    mesh = jax.make_mesh((1,), ("fft",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    return np.asarray(jax.jit(lambda u, k: jfc.fft_conv_seq_sharded(
        u, k, mesh, "fft", jplan.Planner(backends=("jnp",))))(
            *_conv_inputs()))


@pytest.mark.parametrize("comm_spec", ["collective", "pipelined", "agas",
                                       "auto", "measure"])
def test_seq_sharded_conv_on_one_rank_is_fft_conv(one_rank, comm_spec):
    """At world size 1 the sharded convolution is the local one: the same
    values as fft_conv and the reference's fft_conv_seq_sharded (on a
    one-device mesh)."""
    from repro_torch.core import fftconv as fc
    u, k = _conv_inputs()
    ours = fc.fft_conv_seq_sharded(torch.from_numpy(u), torch.from_numpy(k),
                                   one_rank["m1"], "fft", _cpu_planner(),
                                   comm=comm_spec)
    local = fc.fft_conv(torch.from_numpy(u), torch.from_numpy(k),
                        planner=_cpu_planner(), device="cpu")
    theirs = _reference_conv_on_one_device()
    scale = np.abs(theirs).max()
    assert ours.shape == u.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), local.numpy(), atol=1e-4 * scale)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-4 * scale)


def test_seq_sharded_conv_checks_its_filters(one_rank):
    from repro_torch.core import fftconv as fc
    u, k = _conv_inputs()
    with pytest.raises(ValueError, match="filters"):
        fc.fft_conv_seq_sharded(torch.from_numpy(u),
                                torch.from_numpy(k[:, :32]), one_rank["m1"],
                                "fft")


def test_sharded_mixer_on_one_rank_is_the_local_mixer(one_rank):
    from repro_torch.models import FFTConvMixer
    x = torch.from_numpy(RNG.standard_normal((2, 64, 8)).astype(np.float32))
    sharded = FFTConvMixer(8, 4, device="cpu", mesh=one_rank["m1"],
                           axis="fft")
    local = FFTConvMixer(8, 4, device="cpu")
    with torch.no_grad():
        want = local(x)
        got = sharded(x, seq_axis_sharded=True)
        # as in the reference, the flag without a mesh is the local path
        flagged = local(x, seq_axis_sharded=True)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    torch.testing.assert_close(flagged, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="axis"):
        FFTConvMixer(8, 4, device="cpu", mesh=one_rank["m1"])


SHIM_FLAGS = [dict(), dict(permuted_cols=True), dict(keep_transposed=True),
              dict(keep_transposed=True, permuted_cols=True)]


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("flags", SHIM_FLAGS,
                         ids=lambda f: "-".join(f) or "plain")
def test_slab_shims_on_one_rank_are_the_plan_nd_path(one_rank, flags):
    """fft2_slab equals rfftn through plan_nd on the same block (its
    transposed block with keep_transposed), and ifft2_slab gives the block
    back; permuted columns are in the two-factor digit order."""
    m = one_rank["m1"]
    x = RNG.standard_normal((16, 24)).astype(np.float32)
    p = _cpu_planner()
    spec = dfft.fft2_slab(torch.from_numpy(x), m, "fft", p, **flags)
    nd = api.plan_nd((16, 24), "r2c", mesh=m, decomp="slab", planner=p)
    want = _np(api.rfftn(torch.from_numpy(x), mesh=m, plan=nd, planner=p))
    got = spec
    if flags.get("keep_transposed"):
        assert tuple(spec[0].shape) == (13, 16)
        got = (spec[0].T, spec[1].T)
    if flags.get("permuted_cols"):
        # row k1*n2 + k2 holds frequency k2*n1 + k1
        n1, n2 = p.plan(16, "c2c", permuted=True).factors
        want = want[np.arange(16).reshape(n2, n1).T.reshape(-1)]
    _close(_np(got), want, want)
    back = dfft.ifft2_slab(spec, m, "fft", 24, p,
                           from_transposed=flags.get("keep_transposed",
                                                     False),
                           permuted_cols=flags.get("permuted_cols", False))
    _close(back.numpy(), x, x)


def test_legacy_flags_keep_the_references_checks(one_rank):
    m = one_rank["m1"]
    p = _cpu_planner()
    nd3 = api.plan_nd((4, 4, 4), "r2c", mesh=m, decomp="slab", planner=p)
    with pytest.raises(ValueError, match="2D-only"):
        dfft.execute_slab(nd3, torch.ones(4, 4, 4), m, p,
                          keep_transposed=True)
    ndt = api.plan_nd((4, 4), "r2c", mesh=m, decomp="slab", planner=p,
                      output_layout="transposed")
    with pytest.raises(ValueError, match="already-transposed"):
        dfft.execute_slab(ndt, torch.ones(4, 4), m, p, permuted_cols=True)
    with pytest.raises(ValueError, match="already-transposed"):
        dfft.execute_slab_inverse(ndt, (torch.ones(4, 3),) * 2, m, p,
                                  from_transposed=True)
