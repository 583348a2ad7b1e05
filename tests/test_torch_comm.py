"""The port's exchange layer (repro_torch.core.comm) against the
reference's (repro.core.comm): the roofline planners, spec resolution, the
measurement sweep's candidates and memo, and the pack/unpack moves of the
tiled all_to_all. Single-process cases, as tests/test_comm.py has them;
the exchanges across 8 ranks are tests/test_torch_dist.py."""

import dataclasses
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import api as japi
from repro.core import comm as jcomm
from repro.core import plan as jplan
from repro.core.wisdom import WisdomStore as JWisdomStore
from repro_torch.core import comm, plan
from repro_torch.core.wisdom import WisdomStore

LINKS = {
    "fast_link": dict(name="x", flops=1e14, hbm_bw=1e12, link_bw=1e13,
                      matmul_dim=128, vmem_bytes=1 << 27),
    "slow_link": dict(name="y", flops=1e15, hbm_bw=1e12, link_bw=1e8,
                      matmul_dim=128, vmem_bytes=1 << 27),
    "extreme_link": dict(name="z", flops=1e16, hbm_bw=1e12, link_bw=1e3,
                         matmul_dim=128, vmem_bytes=1 << 27),
    "tpu_v5e": dataclasses.asdict(jplan.TPU_V5E),
}

# (function name, positional args) of every estimate planner
PLANNER_CALLS = [
    ("plan_comm", (1 << 14, 1 << 14, 256)),
    ("plan_comm", (64, 512, 8)),
    ("plan_comm", (1024, 1024, 4)),
    ("plan_comm_slab_nd", ((64, 512), 8)),
    ("plan_comm_slab_nd", ((12, 10, 9), 3)),
    ("plan_comm_slab_nd", ((1 << 12, 1 << 12), 1)),
    ("plan_comm_pencil_nd", ((1 << 10,) * 3, (16, 16))),
    ("plan_comm_pencil_nd", ((8, 6, 5, 8), (2, 2, 2))),
    ("plan_comm_pencil_nd", ((1 << 10,) * 3, (1, 16))),
    ("plan_comm_pencil", ((16, 32, 64), (4, 2))),
    ("plan_comm_factor1d", (1 << 20, 1024, 1024, 8)),
    ("plan_comm_factor1d", (1 << 16, 256, 256, 1)),
    ("plan_comm_conv", (8, 64, 256, 256, 8)),
    ("plan_comm_conv", (8, 64, 256, 256, 1)),
    ("plan_comm_gather", (1 << 20, 4)),
    ("plan_comm_gather", (1 << 20, 1)),
]


def _hw(values, port: bool):
    if port:
        return plan.HardwareSpec(**values, collective_lat=0.0)
    return jplan.HardwareSpec(**values)


@pytest.mark.parametrize("link", sorted(LINKS))
@pytest.mark.parametrize("name,args", PLANNER_CALLS,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(PLANNER_CALLS)])
def test_estimate_planners_match_the_reference(name, args, link):
    for kw in ({}, {"overlap_capable": False}):
        extra = {"kind": "r2c"} if name.startswith(
            ("plan_comm_slab_nd", "plan_comm_pencil")) else {}
        ours = getattr(comm, name)(*args, hw=_hw(LINKS[link], True), **kw,
                                   **extra)
        theirs = getattr(jcomm, name)(*args, hw=_hw(LINKS[link], False),
                                      **kw, **extra)
        assert ours == theirs


def test_estimate_planners_default_to_the_h100_profile():
    assert comm.plan_comm(64, 512, 8) == comm.plan_comm(64, 512, 8,
                                                        hw=plan.H100)
    assert comm.plan_comm_slab_nd((64, 512), 8, kind="r2c") == \
        comm.plan_comm_slab_nd((64, 512), 8, kind="r2c", hw=plan.H100)


@pytest.mark.parametrize("spec", ["collective", "agas", "pipelined",
                                  "pipelined:8", "pipelined:1"])
@pytest.mark.parametrize("chunks", [4, 6])
def test_get_backend_matches_the_reference(spec, chunks):
    ours, theirs = comm.get_backend(spec, chunks), \
        jcomm.get_backend(spec, chunks)
    assert ours.name == theirs.name
    assert getattr(ours, "chunks", None) == getattr(theirs, "chunks", None)
    assert comm.get_backend(ours) is ours


@pytest.mark.parametrize("spec,error", [("parcelport", ValueError),
                                        (42, TypeError),
                                        ("auto", ValueError),
                                        ("measure", ValueError)])
def test_get_backend_refuses_what_the_reference_refuses(spec, error):
    with pytest.raises(error):
        comm.get_backend(spec)
    with pytest.raises(error):
        jcomm.get_backend(spec)


@pytest.mark.parametrize("arg", ["pipelined", ("collective", "agas"),
                                 {"my": "pipelined:2"}, {},
                                 ["measure", "auto"], "measure"])
def test_normalize_axis_specs_matches_the_reference(arg):
    axes = ("mx", "my")
    assert comm._normalize_axis_specs(arg, axes) == \
        jcomm._normalize_axis_specs(arg, axes)
    if "measure" not in str(arg) and "auto" not in str(arg):
        ours = comm.resolve_axis_backends(arg, axes, chunks=3)
        theirs = jcomm.resolve_axis_backends(arg, axes, chunks=3)
        assert [(b.name, getattr(b, "chunks", None)) for b in ours] == \
            [(b.name, getattr(b, "chunks", None)) for b in theirs]


@pytest.mark.parametrize("arg", [("collective",), {"mz": "agas"}])
def test_normalize_axis_specs_refuses_bad_collections(arg):
    with pytest.raises(ValueError):
        comm._normalize_axis_specs(arg, ("mx", "my"))
    with pytest.raises(ValueError):
        jcomm._normalize_axis_specs(arg, ("mx", "my"))


@pytest.mark.parametrize("width", [1, 2, 4, 21, 32, 33, 64, 264])
@pytest.mark.parametrize("sweep", [(2, 4, 8), (3,), (1, 16)])
def test_candidate_specs_and_effective_chunks_match_the_reference(width,
                                                                  sweep):
    for base in (("collective", "agas"), ("collective",)):
        assert comm._candidate_specs(width, sweep, base) == \
            jcomm._candidate_specs(width, sweep, base)
    for c in sweep + (5, 7, 100):
        assert comm._effective_chunks(c, width) == \
            jcomm._effective_chunks(c, width)


def test_hardware_profiles_carry_a_measured_collective_latency():
    """The roofline's per-collective charge is the profile's own: no
    profile of the port carries the reference's TPU figure."""
    assert plan.H100.collective_lat > 0 and plan.CPU_LOCAL.collective_lat > 0
    assert japi.COLLECTIVE_LAT not in (plan.H100.collective_lat,
                                       plan.CPU_LOCAL.collective_lat)


# ---------------------------------------------------------------------------
# the measurement memo and wisdom (the sweep itself replaced by a fake)
# ---------------------------------------------------------------------------


class _FakeMesh:
    """The DeviceMesh surface the measurement family reads (and the
    reference's ``mesh.shape`` mapping)."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = tuple(sizes.values())
        self.shape = dict(sizes)

    def size(self, dim):
        return self._sizes[dim]

    def get_coordinate(self):
        return [0] * len(self._sizes)


@pytest.fixture
def clean_memo():
    comm.forget_measurements()
    yield
    comm.forget_measurements()


def test_measure_memo_one_sweep_per_key(monkeypatch, clean_memo, tmp_path):
    calls = []

    def fake_measure(mesh, axis, local_shape, **kw):
        calls.append((axis, tuple(local_shape), kw["split"], kw["concat"]))
        return "pipelined:3", {"collective": 2e-3, "pipelined:3": 1e-3}

    monkeypatch.setattr(comm, "measure_comm", fake_measure)
    mesh = _FakeMesh(fft=8)
    w = WisdomStore(str(tmp_path / "w.json"))
    assert comm.measure_comm_slab(64, 512, mesh, "fft", wisdom=w) \
        == "pipelined:3"
    # the probe is the reference's: (n/p, padded half), split last
    assert calls == [("fft", (8, 264), 1, 0)]
    assert comm.measure_comm_slab(64, 512, mesh, "fft", wisdom=w) \
        == "pipelined:3"
    assert len(calls) == 1
    rec = w.get("comm/slab/64x512/p8/r2c/h100")
    assert rec["backend"] == "pipelined:3" and rec["seconds"] == 1e-3
    # the file carries it to a fresh store after the memo is dropped
    comm.forget_measurements()
    w2 = WisdomStore(str(tmp_path / "w.json"))
    assert comm.measure_comm_slab(64, 512, mesh, "fft", wisdom=w2) \
        == "pipelined:3"
    assert len(calls) == 1
    # the port's keys are the reference's with the hardware tag appended
    jw = JWisdomStore()
    monkeypatch.setattr(jcomm, "measure_comm", fake_measure)
    jcomm.forget_measurements()
    jcomm.measure_comm_slab(64, 512, mesh, "fft", wisdom=jw)
    jcomm.forget_measurements()
    assert [k + "/h100" for k in jw.keys("comm/")] == list(w.keys("comm/"))
    comm.measure_comm_slab(64, 1024, mesh, "fft", hw=plan.CPU_LOCAL)
    assert len(calls) == 3


def test_only_the_meshs_first_rank_writes_the_wisdom_file(
        monkeypatch, clean_memo, tmp_path):
    monkeypatch.setattr(comm, "measure_comm", lambda *a, **k: (
        "collective", {"collective": 1e-3}))
    mesh = _FakeMesh(fft=8)
    mesh.get_coordinate = lambda: [3]
    path = tmp_path / "w.json"
    w = WisdomStore(str(path))
    assert comm.measure_comm_slab(64, 512, mesh, "fft", wisdom=w) \
        == "collective"
    assert w.get("comm/slab/64x512/p8/r2c/h100") is not None
    assert not path.exists()


def test_measure_pencil_which_mask_and_c2r_key(monkeypatch, clean_memo):
    calls = []

    def fake_measure(mesh, axis, local_shape, **kw):
        calls.append((axis, tuple(local_shape)))
        return "pipelined:2", {"pipelined:2": 1e-3}

    monkeypatch.setattr(comm, "measure_comm", fake_measure)
    monkeypatch.setattr(jcomm, "measure_comm", fake_measure)
    mesh = _FakeMesh(mx=4, my=2)
    assert comm.measure_comm_pencil((16, 32, 64), mesh, ("mx", "my"),
                                    which=(False, True)) == \
        (None, "pipelined:2")
    assert [c[0] for c in calls] == ["my"]
    calls.clear()
    fwd = comm.measure_comm_pencil((16, 32, 64), mesh, ("mx", "my"),
                                   kind="r2c")
    inv = comm.measure_comm_pencil((16, 32, 64), mesh, ("mx", "my"),
                                   kind="c2r")
    assert fwd == inv and len(calls) == 2
    # the probes of every exchange of the chain are the reference's
    ours = list(calls)
    calls.clear()
    jcomm.forget_measurements()
    jcomm.measure_comm_pencil((16, 32, 64), mesh, ("mx", "my"), kind="r2c")
    jcomm.forget_measurements()
    assert calls == ours


def test_measure_on_a_one_rank_axis_times_nothing():
    mesh = _FakeMesh(ax=1)
    assert comm.measure_comm(mesh, "ax", (4, 8), split=1, concat=0) == \
        ("collective", {})
    assert comm.measure_comm_slab(64, 64, mesh, "ax") == "collective"
    assert comm.measure_comm_factor1d(64, (8, 8), mesh, "ax") == "collective"


# ---------------------------------------------------------------------------
# the pack/unpack moves and the backends on a one-rank gloo group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,axis,p", [((4, 6), 1, 2), ((4, 6), 0, 4),
                                          ((2, 3, 8), 2, 4), ((2, 6, 5), 1, 3),
                                          ((3, 4), 1, 4), ((8,), 0, 2),
                                          ((2, 4, 1), 1, 2)])
def test_pack_and_unpack_are_the_tiled_all_to_all_moves(shape, axis, p):
    x = torch.arange(float(np.prod(shape))).reshape(shape)
    buf = comm._lead(x, axis, p)
    want = np.moveaxis(np.asarray(x).reshape(
        shape[:axis] + (p, shape[axis] // p) + shape[axis + 1:]), axis, 0)
    assert buf.is_contiguous()
    np.testing.assert_array_equal(buf.numpy(), want)
    # unpack of the same buffer along the same axis gives x back
    np.testing.assert_array_equal(comm._unlead(buf, axis).numpy(),
                                  x.numpy())


@pytest.fixture(scope="module")
def one_rank():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield comm.make_mesh((1,), ("ax",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("spec", ["collective", "pipelined:3", "agas"])
def test_exchange_and_gather_are_identities_on_one_rank(one_rank, spec):
    group = one_rank.get_group("ax")
    x = (torch.randn(4, 6, 8), torch.randn(4, 6, 8))
    backend = comm.get_backend(spec)
    for split, concat in ((2, 0), (0, 2), (1, 2)):
        y = backend.exchange(x, group, split=split, concat=concat, p=1)
        for a, b in zip(y, x):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    q = torch.arange(24.).reshape(6, 4)
    s = torch.arange(6.).reshape(6, 1)
    qg, sg = backend.gather((q, s), group, 1)
    torch.testing.assert_close(qg, q[None], rtol=0, atol=0)
    torch.testing.assert_close(sg, s[None], rtol=0, atol=0)


def test_make_mesh_checks_its_arguments(one_rank):
    with pytest.raises(ValueError, match="needs 2 ranks"):
        comm.make_mesh((2,), ("a",))
    with pytest.raises(ValueError, match="differ in length"):
        comm.make_mesh((1,), ("a", "b"))
    assert comm.mesh_sizes(one_rank) == {"ax": 1}
    assert comm.is_mesh_leader(one_rank)
    assert comm.mesh_max(one_rank, 2.5) == 2.5


# the exchanges of this port's chip shapes: (planner, args, kwargs)
CHIP_EXCHANGES = [
    ("plan_comm_slab_nd", ((16384, 16384), 4), {"kind": "r2c"}),
    ("plan_comm", (16384, 16384, 4), {}),
    ("plan_comm_pencil_nd", ((512,) * 3, (2, 2)), {}),
    ("plan_comm_factor1d", (1 << 26, 8192, 8192, 4), {}),
    ("plan_comm_conv", (4, 2048, 128, 128, 4), {}),
    ("plan_comm_conv", (2, 4, 32, 32, 8), {}),
    ("plan_comm_gather", (12_617_728, 4), {}),
]


@pytest.mark.parametrize("name,args,kw", CHIP_EXCHANGES,
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(CHIP_EXCHANGES)])
def test_h100_prices_the_ports_own_pipelined_exchange(name, args, kw):
    """The port's pipelined exchange overlaps no DFT pass: under H100 it
    loses to the collective at every chip shape (on 4 cards slab 16384^2
    took 14.975 ms pipelined:4 against 14.217 ms collective, PERF.md
    section 6), where the reference's 20% rule on the same numbers picks
    it for the large exchanges."""
    fn = getattr(comm, name)
    verdict = fn(*args, hw=plan.H100, **kw)
    assert verdict in ("collective", ("collective",) * 2)
    if name == "plan_comm_slab_nd":
        ref_rule = dataclasses.replace(plan.H100, fft_share=0.0,
                                       pipelined_hides_compute=True)
        assert fn(*args, hw=ref_rule, **kw) == "pipelined"


@pytest.mark.parametrize("wire,pack,lat", [(1e9, 1e9, 5e-5), (1e3, 1e9, 0),
                                           (1e9, 1e3, 0), (7e6, 7e6, 1e-6)])
def test_pipelined_saving_never_repays_its_concatenation(wire, pack, lat):
    """(c-1)/c of the smaller of the wire and the pack copy is less than
    the concatenating copy of the packed bytes the pipelined exchange
    adds, whatever the rates."""
    for hw in (plan.H100, dataclasses.replace(plan.H100, link_bw=1e15,
                                              collective_lat=lat)):
        assert comm._pipelined_saving(wire, pack, pack, hw) < 0


def test_comm_rooflines_take_the_planners_own_stage_prices():
    """With fft_share set, the compute an exchange is weighed against is
    the planner's own 1D price of each stage; without it, the reference's
    dense four-step flops."""
    planner = plan.Planner(backends=("hopper",))
    stages = [(128, 1 << 20), (128, 1 << 20)]
    assert comm._compute_seconds(1e12, stages, plan.H100, planner) == \
        pytest.approx(2 * planner.stage_seconds(128, "c2c", 1 << 20))
    assert comm._compute_seconds(1e12, stages, plan.H100) == \
        1e12 / plan.H100.flops
    dense = dataclasses.replace(plan.H100, fft_share=0.0)
    assert comm._compute_seconds(1e12, stages, dense, planner) == \
        1e12 / dense.flops
