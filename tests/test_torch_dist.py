"""The port's distributed FFT layer on 8 gloo ranks against the reference
on 8 fake CPU devices and against numpy.

One module-scoped fixture makes two runs at once, each in its own process
started from this file:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tests/test_torch_dist.py ref OUT.npz
    python tests/test_torch_dist.py port OUT.npz HARDWARE_JSON

The first computes every case of ``CASES`` with ``repro.core`` (JAX, 8
fake devices, meshes with Auto axis types, on which the reference's
distributed paths run on jax 0.9; see ROADMAP.md, Queue 3); the second
spawns 8 gloo ranks with ``torch.multiprocessing`` that compute them with
``repro_torch`` on each rank's block. The tests then read their cases
from the two result files. Tolerances are the reference's own
(tests/_dist_worker.py): each forward within 1e-4 of max|numpy| of numpy
in float64 and of the reference, each round trip within 1e-3. The cases
are modelled on tests/_dist_worker.py (check_fft2_slab, check_fft3_pencil,
check_rfft3_pencil, check_fftconv_seq_sharded, check_compressed_psum,
check_plan_nd, check_plan_nd_generalized). The deprecated shims, the
sequence-sharded convolution, the compressed all-reduce and the mixer's
sharded branch have tables of their own (``SHIMS``, ``CONVS``, ``PSUMS``,
``MIXERS``); the gradients of the sharded convolution (against the
reference's ``jax.grad`` through its ``fft_conv_seq_sharded`` and the
port's unsharded ``fft_conv``) and of the mixer's sharded branch (against
the unsharded mixer) run on the meshes of ``GRADS``, within 2e-4 of
max|ref|. JAX is imported only by the reference's run and the fixture,
never by the gloo ranks; torch only by the port's run.
"""

import dataclasses
import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.slow

ROOT = Path(__file__).resolve().parents[1]
RUN_TIMEOUT = 300      # seconds; the two runs take about 20 s together

# ---------------------------------------------------------------------------
# the cases (shared by both runs)
# ---------------------------------------------------------------------------

WORLD = 8

# name -> (shape, axis names): meshes over ranks 0..prod(shape)-1
MESHES = {
    "m8": ((8,), ("fft",)),
    "m4": ((4,), ("fft4",)),
    "m2": ((2,), ("sp2",)),
    "m3": ((3,), ("s",)),
    "m42": ((4, 2), ("mx", "my")),
    "m22": ((2, 2), ("qx", "qy")),
    "m222": ((2, 2, 2), ("ma", "mb", "mc")),
}


def _case(name, mesh, kind, shape, decomp, batch=(), comm="collective",
          chunks=4, layout="natural", ref_comm=None):
    return dict(name=name, mesh=mesh, kind=kind, shape=tuple(shape),
                batch=tuple(batch), decomp=decomp, comm=comm, chunks=chunks,
                layout=layout, ref_comm=ref_comm or comm)


# executed cases: forward held against numpy and the reference, then the
# inverse against the input
CASES = [
    # slab 2D r2c, every backend; m = 512 so the pipelined exchange chunks
    _case("slab_r2c_collective", "m8", "r2c", (64, 512), "slab"),
    _case("slab_r2c_agas", "m8", "r2c", (64, 512), "slab", comm="agas"),
    *[_case(f"slab_r2c_pipelined_c{c}", "m8", "r2c", (64, 512), "slab",
            comm="pipelined", chunks=c) for c in (1, 3, 4)],
    # non-divisible Mh (12 -> 7 over 3) and n (10 over 3)
    _case("slab_r2c_mixed_3ranks", "m3", "r2c", (10, 12), "slab"),
    # the planned transposed layout (one exchange each way)
    _case("slab_r2c_transposed", "m8", "r2c", (64, 512), "slab",
          layout="transposed"),
    _case("slab_c2c_transposed_mixed", "m8", "c2c", (20, 24), "slab",
          layout="transposed"),
    # odd/prime axes, batch dims, a 3D slab
    _case("slab_r2c_odd_batched", "m4", "r2c", (10, 7), "slab", batch=(2,)),
    _case("slab_c2c_odd_batched", "m4", "c2c", (10, 7), "slab", batch=(2,)),
    _case("slab_r2c_3d_batched", "m8", "r2c", (12, 8, 16), "slab",
          batch=(2,)),
    _case("slab_c2c_3d_batched", "m8", "c2c", (12, 8, 16), "slab",
          batch=(2,)),
    # pencil k=2: every backend, per-axis specs, mixed radix, batched, r2c
    *[_case(f"pencil_c2c_{c}", "m42", "c2c", (8, 12, 16), "pencil", comm=c)
      for c in ("collective", "pipelined", "agas")],
    _case("pencil_c2c_per_axis", "m42", "c2c", (8, 12, 16), "pencil",
          comm=("pipelined", "collective")),
    _case("pencil_c2c_dict_axis", "m42", "c2c", (8, 12, 16), "pencil",
          comm={"my": "agas"}),
    _case("pencil_r2c", "m42", "r2c", (8, 12, 16), "pencil"),
    _case("pencil_c2c_mixed_batched", "m42", "c2c", (6, 10, 9), "pencil",
          batch=(2,)),
    _case("pencil_r2c_mixed_batched", "m42", "r2c", (6, 10, 9), "pencil",
          batch=(2,)),
    _case("pencil_r2c_22_batched", "m22", "r2c", (7, 6, 13), "pencil",
          batch=(3,)),
    _case("pencil_c2c_22_batched", "m22", "c2c", (7, 6, 13), "pencil",
          batch=(3,)),
    _case("pencil_k2_4d_batched", "m42", "c2c", (8, 6, 5, 8), "pencil",
          batch=(2,)),
    # pencil k=3: c2c batched mixed radix, r2c, and measured comm
    _case("pencil_k3_4d_batched", "m222", "c2c", (8, 6, 5, 8), "pencil",
          batch=(2,)),
    _case("pencil_k3_r2c", "m222", "r2c", (6, 10, 5, 12), "pencil"),
    _case("pencil_k3_measure", "m222", "c2c", (8, 6, 5, 8), "pencil",
          batch=(2,), comm="measure", ref_comm="collective"),
    # distributed 1D
    _case("factor1d_2e20", "m8", "c2c", (1 << 20,), "factor1d"),
    _case("factor1d_2e16_measure", "m8", "c2c", (1 << 16,), "factor1d",
          comm="measure", ref_comm="collective"),
]

# free plan_nd choices (estimate mode) whose verdicts and dfft/v2 keys are
# held against the reference's
VERDICTS = [
    dict(name="small_2d_local", mesh="m8", kind="r2c", shape=(64, 64)),
    dict(name="large_2d_slab", mesh="m8", kind="r2c", shape=(1024, 1024)),
    dict(name="large_3d_pencil", mesh="m42", kind="c2c",
         shape=(128, 128, 128)),
    dict(name="long_1d_factor1d", mesh="m8", kind="c2c", shape=(1 << 20,)),
    dict(name="short_1d_local", mesh="m8", kind="c2c", shape=(4096,)),
    dict(name="transposed_2d", mesh="m8", kind="r2c", shape=(2048, 512),
         layout="transposed"),
    dict(name="4d_k3", mesh="m222", kind="c2c", shape=(64, 48, 40, 64)),
]

# measured planning: every finalist timed once, a second call times none
MEASURED = dict(mesh="m8", kind="r2c", shape=(64, 320))


BACKENDS = ("collective", "pipelined", "agas")


def _shim(name, fn, mesh, shape, comm="collective", chunks=4, **flags):
    # "measure" is timed on each side's own mesh; the reference, whose
    # timing sweep compiles every candidate, runs such a case with
    # "collective" (the values do not depend on the backend)
    return dict(name=name, fn=fn, mesh=mesh, shape=tuple(shape), comm=comm,
                chunks=chunks, flags=flags,
                ref_comm="collective" if "measure" in str(comm) else comm)


# the deprecated shims (check_fft2_slab, check_fft3_pencil,
# check_rfft3_pencil): the forward's raw layout held against the
# reference's and numpy, the matching inverse shim against the input
SHIMS = [
    *[_shim(f"fft2_slab_{c}_c{k}", "fft2_slab", "m8", (64, 512), comm=c,
            chunks=k)
      for c in BACKENDS for k in ((1, 3, 4) if c == "pipelined" else (4,))],
    _shim("fft2_slab_permuted_cols", "fft2_slab", "m8", (256, 256),
          permuted_cols=True),
    _shim("fft2_slab_keep_transposed", "fft2_slab", "m8", (64, 512),
          keep_transposed=True),
    *[_shim(f"fft3_pencil_{i}", "fft3_pencil", "m42", (16, 32, 64), comm=c)
      for i, c in enumerate(BACKENDS + (("pipelined", "collective"),
                                        {"my": "agas"}, "auto", "measure",
                                        ("measure", "collective"),
                                        {"mx": "measure"}))],
    *[_shim(f"rfft3_pencil_{c}", "rfft3_pencil", "m42", (16, 32, 64),
            comm=c) for c in BACKENDS],
]

# the sequence-sharded FFT convolution (check_fftconv_seq_sharded)
CONV = dict(mesh="m8", b=2, length=512, d=4)
CONVS = BACKENDS + ("auto", "measure")

# the int8 compressed all-reduce (check_compressed_psum): 8 ranks, each
# its row of a (8, 1000) array
PSUM = dict(mesh="m8", n=1000)
PSUMS = ("collective", "pipelined:2", "agas", "measure", "auto")

# the FFT-conv mixer's sharded branch: (2, 64, 8), rank-4 filters
MIXER = dict(b=2, length=64, d=8, rank=4)
MIXERS = ("m2", "m4")

# gradients of the sharded convolution (CONV's inputs) and of the mixer's
# sharded branch (MIXER's), on 2 and 4 ranks
GRADS = ("m2", "m4")
GRAD_TOL = 2e-4


def grad_weights(shape, name):
    """The output's cotangent: the gradient of sum(y * w)."""
    rng = np.random.default_rng(_seed("grad_" + name))
    return rng.standard_normal(shape).astype(np.float32)


def conv_inputs():
    rng = np.random.default_rng(_seed("conv"))
    b, length, d = CONV["b"], CONV["length"], CONV["d"]
    u = rng.standard_normal((b, length, d)).astype(np.float32)
    k = (rng.standard_normal((d, length))
         * np.exp(-np.arange(length) / 32)[None]).astype(np.float32)
    return u, k


def psum_input() -> np.ndarray:
    rng = np.random.default_rng(_seed("psum"))
    return rng.standard_normal((WORLD, PSUM["n"])).astype(np.float32)


def mixer_inputs():
    """The mixer's parameters (``fftconv_meta``'s shapes and scales, drawn
    with numpy so that both runs hold the same) and its input."""
    rng = np.random.default_rng(_seed("mixer"))
    d, r = MIXER["d"], MIXER["rank"]
    params = {"w_in": 0.02 * rng.standard_normal((d, 2 * d)),
              "filt": 0.2 * rng.standard_normal((d, r)),
              "skip": np.ones(d), "w_out": 0.02 * rng.standard_normal((d, d))}
    x = rng.standard_normal((MIXER["b"], MIXER["length"], d))
    return ({k: v.astype(np.float32) for k, v in params.items()},
            x.astype(np.float32))


def shim_input(case):
    rng = np.random.default_rng(_seed(case["name"]))
    x = rng.standard_normal(case["shape"]).astype(np.float32)
    if case["fn"] == "fft3_pencil":
        x = x + 1j * rng.standard_normal(case["shape"]).astype(np.float32)
        return x.astype(np.complex64)
    return x


def case_input(case) -> np.ndarray:
    """The case's full input (batch dims first), the same in both runs: a
    real float32 array for r2c, complex64 for c2c."""
    rng = np.random.default_rng(_seed(case["name"]))
    shape = case["batch"] + case["shape"]
    x = rng.standard_normal(shape).astype(np.float32)
    if case["kind"] == "c2c":
        x = x + 1j * rng.standard_normal(shape).astype(np.float32)
    return x.astype(np.complex64) if case["kind"] == "c2c" else x


def _seed(name: str) -> int:
    """A stable seed from the case name (Python's str hash is salted)."""
    return sum((i + 1) * ord(ch) for i, ch in enumerate(name))


# ---------------------------------------------------------------------------
# the reference's run (JAX on 8 fake CPU devices)
# ---------------------------------------------------------------------------


def _jax_mesh(name):
    import jax
    shape, names = MESHES[name]
    n = int(np.prod(shape))
    return jax.make_mesh(shape, names,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:n])


def _pair_np(c):
    return np.asarray(c[0]) + 1j * np.asarray(c[1])


def ref_main(out_path):
    """The reference's run: every case through ``repro.core.api`` on 8
    fake CPU devices (the device count must be in ``XLA_FLAGS`` before JAX
    is imported), outputs, plans, verdicts and dfft/v2 keys to
    ``out_path``."""
    assert "--xla_force_host_platform_device_count=8" in os.environ.get(
        "XLA_FLAGS", ""), "the reference's run needs 8 fake CPU devices"
    import jax
    from repro.core import api, plan
    planner = plan.Planner(backends=("jnp",))
    out, meta = {}, {"plans": {}, "verdicts": {}, "keys": []}
    for case in CASES:
        m, shape = _jax_mesh(case["mesh"]), case["shape"]
        d = len(shape)
        nd = api.plan_nd(shape, case["kind"], mesh=m, planner=planner,
                         decomp=case["decomp"], axes=MESHES[case["mesh"]][1]
                         if case["decomp"] == "pencil" else
                         MESHES[case["mesh"]][1][:1],
                         comm=case["ref_comm"],
                         output_layout=case["layout"])
        meta["plans"][case["name"]] = dataclasses.asdict(nd)
        run = api.rfftn if case["kind"] == "r2c" else api.fftn
        # compiled whole: eager shard_map runs op by op, ~20x slower
        spec = jax.jit(lambda a, m=m, nd=nd, d=d, run=run, c=case["chunks"]:
                       run(a, mesh=m, plan=nd, planner=planner, ndim=d,
                           chunks=c))(case_input(case))
        out[case["name"]] = _pair_np(spec)
    wplanner = plan.Planner(backends=("jnp",))
    for v in VERDICTS:
        nd = api.plan_nd(v["shape"], v["kind"], mesh=_jax_mesh(v["mesh"]),
                         planner=wplanner,
                         output_layout=v.get("layout", "natural"))
        meta["verdicts"][v["name"]] = dataclasses.asdict(nd)
    meta["keys"] = list(wplanner.wisdom.keys("dfft/"))
    meta["collective_lat"] = api.COLLECTIVE_LAT
    _ref_extras(out, planner)
    np.savez(out_path, meta=json.dumps(meta), **out)


def _ref_extras(out, planner):
    """The reference's shims, sequence-sharded convolution, compressed
    all-reduce and sharded mixer, compiled whole, into ``out``."""
    import warnings

    import jax
    from jax.sharding import PartitionSpec as P
    from repro.core import dfft, fftconv
    from repro.core.compat import shard_map
    from repro.models.blocks import fftconv_fwd
    from repro.models.params import sharding_rules
    from repro.optim import choose_psum_comm, compressed_psum, quantize_int8
    warnings.filterwarnings("ignore", category=DeprecationWarning)
    for case in SHIMS:
        m = _jax_mesh(case["mesh"])
        names = MESHES[case["mesh"]][1]
        ax = names[0] if case["fn"] == "fft2_slab" else names
        fn = getattr(dfft, case["fn"])
        x = shim_input(case)
        arg = (np.real(x), np.imag(x)) if np.iscomplexobj(x) else x
        spec = jax.jit(lambda a, fn=fn, m=m, ax=ax, c=case: fn(
            a, m, ax, planner, comm=c["ref_comm"], chunks=c["chunks"],
            **c["flags"]))(arg)
        out["shim/" + case["name"]] = _pair_np(spec)

    m = _jax_mesh(CONV["mesh"])
    u, k = conv_inputs()
    for comm in CONVS:
        c = "collective" if comm == "measure" else comm
        out["conv/" + comm] = np.asarray(jax.jit(
            lambda a, b, c=c: fftconv.fft_conv_seq_sharded(
                a, b, m, "fft", planner, comm=c))(u, k))

    xs = psum_input()
    quant = [quantize_int8(x) for x in xs]
    out["psum/q"] = np.stack([np.asarray(q) for q, _, _ in quant])
    out["psum/scale"] = np.stack([np.asarray(s, np.float32)
                                  for _, s, _ in quant])
    for comm in PSUMS:
        c = "collective" if comm == "measure" else \
            choose_psum_comm(m, "fft", (PSUM["n"],), mode=comm)

        def body(x, c=c):
            total, err = compressed_psum(x[0], "fft", comm=c)
            return total[None], err[None]

        total, err = jax.jit(shard_map(
            body, mesh=m, in_specs=P("fft", None),
            out_specs=(P("fft", None), P("fft", None))))(xs)
        out["psum/" + comm] = np.asarray(total)
        out["psum/" + comm + "/err"] = np.asarray(err)

    params, x = mixer_inputs()
    for name in MIXERS:
        mm = _jax_mesh(name)
        with sharding_rules(mm, {"sp": MESHES[name][1][0]}):
            out["mixer/" + name] = np.asarray(jax.jit(
                lambda a: fftconv_fwd(params, None, a,
                                      seq_axis_sharded=True))(x))

    u, k = conv_inputs()
    w = grad_weights(u.shape, "conv")
    for name in GRADS:
        mg = _jax_mesh(name)
        axis = MESHES[name][1][0]
        gu, gk = jax.jit(jax.grad(
            lambda a, b, mg=mg, axis=axis: (fftconv.fft_conv_seq_sharded(
                a, b, mg, axis, planner) * w).sum(), argnums=(0, 1)))(u, k)
        out["conv_grad/" + name + "/u"] = np.asarray(gu)
        out["conv_grad/" + name + "/k"] = np.asarray(gk)


# ---------------------------------------------------------------------------
# the port's run (8 gloo ranks)
# ---------------------------------------------------------------------------

TIMEOUT = datetime.timedelta(seconds=60)


def _pair(c):
    return c[0].numpy() + 1j * c[1].numpy()


def _run_case(case, mesh, planner, rt):
    """Forward, collect, inverse, collect; returns (spectrum, spatial)."""
    names = MESHES[case["mesh"]][1]
    nd = rt.plan_nd(case["shape"], case["kind"], mesh=mesh, planner=planner,
                    decomp=case["decomp"],
                    axes=names if case["decomp"] == "pencil" else names[:1],
                    comm=case["comm"], output_layout=case["layout"])
    x = rt.distribute(case_input(case), nd, mesh)
    kw = dict(mesh=mesh, plan=nd, planner=planner, chunks=case["chunks"])
    if case["kind"] == "r2c":
        spec = rt.rfftn(x, **kw)
        back = rt.collect(rt.irfftn(spec, **kw), nd, mesh, spatial=True)
        back = back.numpy()
    else:
        spec = rt.fftn(x, **kw)
        back = _pair(rt.collect(rt.ifftn(spec, **kw), nd, mesh,
                                spatial=True))
    return nd, _pair(rt.collect(spec, nd, mesh)), back


def _port_rank(rank, store_path, out_path, hw_json):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    import repro_torch as rt
    from repro_torch.core import api, comm
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD, timeout=TIMEOUT)
    hw = rt.HardwareSpec(**json.loads(hw_json))
    meshes = {name: rt.make_mesh(shape, names, timeout=TIMEOUT,
                                 ranks=range(int(np.prod(shape))))
              for name, (shape, names) in MESHES.items()}
    out, meta = {}, {"plans": {}, "verdicts": {}}
    planner = rt.Planner(hardware=hw, backends=("torch",), device="cpu")
    for case in CASES:
        mesh = meshes[case["mesh"]]
        if mesh is None:                    # this rank is not in the mesh
            continue
        nd, spec, back = _run_case(case, mesh, planner, rt)
        meta["plans"][case["name"]] = dataclasses.asdict(nd)
        out[case["name"]] = spec
        out[case["name"] + "/back"] = back

    # free choices and their dfft/v2 keys
    wplanner = rt.Planner(hardware=hw, backends=("torch",), device="cpu")
    for v in VERDICTS:
        nd = rt.plan_nd(v["shape"], v["kind"], mesh=meshes[v["mesh"]],
                        planner=wplanner,
                        output_layout=v.get("layout", "natural"))
        meta["verdicts"][v["name"]] = dataclasses.asdict(nd)
    meta["keys"] = list(wplanner.wisdom.keys("dfft/"))

    # measured planning: each finalist timed once; then nothing is timed
    mplanner = rt.Planner(hardware=hw, backends=("torch",), device="cpu")
    m8 = meshes[MEASURED["mesh"]]
    p0, c0 = api.PLAN_ND_STATS["timed"], comm.MEASURE_STATS["timed"]
    ndm = rt.plan_nd(MEASURED["shape"], MEASURED["kind"], mesh=m8,
                     planner=mplanner, mode="measured")
    p1, c1 = api.PLAN_ND_STATS["timed"], comm.MEASURE_STATS["timed"]
    ndm2 = rt.plan_nd(MEASURED["shape"], MEASURED["kind"], mesh=m8,
                      planner=mplanner, mode="measured")
    meta["measured"] = dict(
        plan=dataclasses.asdict(ndm), again=dataclasses.asdict(ndm2),
        finalists_timed=p1 - p0, comm_timed=c1 - c0,
        timed_again=(api.PLAN_ND_STATS["timed"] - p1)
        + (comm.MEASURE_STATS["timed"] - c1),
        comm_keys=list(mplanner.wisdom.keys("comm/")))
    meta["measure_keys"] = list(planner.wisdom.keys("comm/"))

    # the planned transposed layout: one exchange each way (a spy counts)
    class Spy(rt.CollectiveBackend):
        count = 0

        def exchange(self, c, group, **kw):
            Spy.count += 1
            return super().exchange(c, group, **kw)

    counts = {}
    for layout in ("natural", "transposed"):
        nd = rt.plan_nd((64, 512), "r2c", mesh=m8, planner=planner,
                        decomp="slab", comm=Spy(), output_layout=layout)
        x = rt.distribute(np.ones((64, 512), np.float32), nd, m8)
        Spy.count = 0
        spec = rt.execute_nd(nd, x, mesh=m8, planner=planner)
        fwd = Spy.count
        Spy.count = 0
        rt.execute_nd_inverse(nd, spec, mesh=m8, planner=planner)
        counts[layout] = [fwd, Spy.count]
    meta["exchanges"] = counts

    # the stacked gathers of the backends (the compressed all-reduce's)
    group = m8.get_group("fft")
    mine = (torch.arange(12.).reshape(4, 3) + 100 * rank,
            -torch.arange(12.).reshape(4, 3) - 100 * rank)
    for spec in ("collective", "pipelined:2"):
        g = rt.get_backend(spec).gather(mine, group, WORLD)
        out[f"gather/{spec}"] = _pair(g)

    _port_extras(rank, meshes, hw, out, meta)
    _port_grads(rank, meshes, out)

    # every rank's verdicts (free and measured plans, measured exchanges),
    # gathered to rank 0
    mine = json.dumps({
        "verdicts": meta["verdicts"], "measured": meta["measured"]["plan"],
        "measured_comm": {c["name"]: meta["plans"][c["name"]]["comm"]
                          for c in CASES if c["comm"] == "measure"},
        "comm_wisdom": {k: planner.wisdom.get(k)["backend"]
                        for k in meta["measure_keys"]}}, sort_keys=True)
    every = [None] * WORLD
    dist.all_gather_object(every, mine)
    meta["ranks_agree"] = [e == every[0] for e in every]
    if rank == 0:
        np.savez(out_path, meta=json.dumps(meta), **out)
    dist.destroy_process_group()


def _gathered(t, mesh, axes):
    """Gather a rank's block (a tensor or a pair) along ``axes``, a list of
    (tensor axis, mesh axis name), concatenating the ranks' blocks."""
    from repro_torch.core import comm
    pair = tuple(t) if isinstance(t, (tuple, list)) else (t, t)
    for axis, name in axes:
        pair = comm.all_gather_pair(pair, mesh.get_group(name),
                                    comm.mesh_sizes(mesh)[name], axis=axis,
                                    tiled=True)
    return _pair(pair) if isinstance(t, (tuple, list)) else pair[0].numpy()


def _port_shim(case, mesh, planner, rank):
    """One shim case on this rank's block: (gathered raw forward, gathered
    round trip)."""
    import torch
    from repro_torch.core import dfft
    x = shim_input(case)
    names = MESHES[case["mesh"]][1]
    flags = case["flags"]
    kw = dict(planner=planner, comm=case["comm"], chunks=case["chunks"])
    if case["fn"] == "fft2_slab":
        w = x.shape[0] // WORLD
        spec = dfft.fft2_slab(torch.from_numpy(x[rank * w:(rank + 1) * w]),
                              mesh, names[0], **kw, **flags)
        back = dfft.ifft2_slab(
            spec, mesh, names[0], x.shape[1], **kw,
            from_transposed=flags.get("keep_transposed", False),
            permuted_cols=flags.get("permuted_cols", False))
        tiled = [(1 if flags.get("keep_transposed") else 0, names[0])]
        return _gathered(spec, mesh, tiled), \
            _gathered(back, mesh, [(0, names[0])])
    i, j = (mesh.get_local_rank(a) for a in names)
    p0, p1 = MESHES[case["mesh"]][0]
    wx, wy = x.shape[0] // p0, x.shape[1] // p1
    block = x[i * wx:(i + 1) * wx, j * wy:(j + 1) * wy]
    spec_axes = [(1, names[0]), (2, names[1])]
    in_axes = [(0, names[0]), (1, names[1])]
    if case["fn"] == "fft3_pencil":
        pair = (torch.from_numpy(np.ascontiguousarray(block.real)),
                torch.from_numpy(np.ascontiguousarray(block.imag)))
        spec = dfft.fft3_pencil(pair, mesh, names, **kw)
        back = dfft.ifft3_pencil(spec, mesh, names, **kw)
    else:
        spec = dfft.rfft3_pencil(torch.from_numpy(block), mesh, names, **kw)
        back = dfft.irfft3_pencil(spec, mesh, names, x.shape[2], **kw)
    return _gathered(spec, mesh, spec_axes), _gathered(back, mesh, in_axes)


def _port_extras(rank, meshes, hw, out, meta):
    """The shims, the sequence-sharded convolution, the compressed
    all-reduce and the mixer's sharded branch on this rank's blocks."""
    import warnings

    import torch
    import torch.distributed as dist
    import repro_torch as rt
    from repro_torch.convert import fftconv_mixer_from_reference
    from repro_torch.core import comm, dfft
    from repro_torch.optim import (choose_psum_comm, compressed_psum,
                                   quantize_int8)
    planner = rt.Planner(hardware=hw, backends=("torch",), device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", DeprecationWarning)
        for case in SHIMS:
            spec, back = _port_shim(case, meshes[case["mesh"]], planner,
                                    rank)
            out["shim/" + case["name"]] = spec
            out["shim/" + case["name"] + "/back"] = back
        # a length the mesh does not divide: the block names the padded
        # one unless shape= gives it
        m4 = meshes["m4"]
        if m4 is not None:
            x = shim_input(dict(name="shim_shape", fn="fft2_slab",
                                shape=(10, 12)))
            block = dfft.distribute(x, rt.plan_nd(
                (10, 12), "r2c", mesh=m4, decomp="slab", planner=planner),
                m4)
            for given in (None, (10, 12)):
                spec = dfft.fft2_slab(block, m4, "fft4", planner,
                                      shape=given)
                out[f"shim_shape/{given is not None}"] = _gathered(
                    spec, m4, [(0, "fft4")])
            try:
                dfft.fft2_slab(block, m4, "fft4", planner, shape=(20, 12))
                meta["shim_shape_raises"] = False
            except ValueError:
                meta["shim_shape_raises"] = True
    meta["shim_warnings"] = {}
    for w in caught:
        text = str(w.message)
        if issubclass(w.category, DeprecationWarning) and \
                "repro_torch.core.api.plan_nd" in text:
            name = text.split()[0].rsplit(".", 1)[-1]
            meta["shim_warnings"][name] = \
                meta["shim_warnings"].get(name, 0) + 1

    # the measured verdicts of this section go to a wisdom store of their own
    xplanner = rt.Planner(hardware=hw, backends=("torch",), device="cpu")
    m8 = meshes[CONV["mesh"]]
    u, k = conv_inputs()
    w = CONV["length"] // WORLD
    for c in CONVS:
        y = rt.fft_conv_seq_sharded(torch.from_numpy(u[:, rank * w:
                                                       (rank + 1) * w]),
                                    torch.from_numpy(k), m8, "fft",
                                    xplanner, comm=c)
        out["conv/" + c] = _gathered(y, m8, [(1, "fft")])

    # uneven repartitions: L = 384 over 4 ranks, nf = 1024 (a rank's 96
    # positions land in one or two of the padded blocks of 256)
    m4 = meshes["m4"]
    if m4 is not None:
        rng = np.random.default_rng(_seed("conv_uneven"))
        u = rng.standard_normal((1, 384, 3)).astype(np.float32)
        k = rng.standard_normal((3, 384)).astype(np.float32)
        y = rt.fft_conv_seq_sharded(torch.from_numpy(u[:, rank * 96:
                                                       (rank + 1) * 96]),
                                    torch.from_numpy(k), m4, "fft4",
                                    planner)
        out["conv_uneven"] = _gathered(y, m4, [(1, "fft4")])

    xs = torch.from_numpy(psum_input())
    group = m8.get_group("fft")
    q, scale, _ = quantize_int8(xs[rank])
    out["psum/q"] = _gathered(q[None], m8, [(0, "fft")])
    out["psum/scale"] = _gathered(scale.float()[None], m8, [(0, "fft")])
    for c in PSUMS:
        spec = choose_psum_comm(m8, "fft", (PSUM["n"],), mode=c,
                                planner=xplanner)
        total, err = compressed_psum(xs[rank], group, comm=spec)
        out["psum/" + c] = _gathered(total[None], m8, [(0, "fft")])
        out["psum/" + c + "/err"] = _gathered(err[None], m8, [(0, "fft")])
    meta["extra_comm_keys"] = list(xplanner.wisdom.keys("comm/"))
    every = [None] * WORLD
    dist.all_gather_object(every, json.dumps(
        {k: xplanner.wisdom.get(k)["backend"]
         for k in meta["extra_comm_keys"]}, sort_keys=True))
    meta["extra_ranks_agree"] = [e == every[0] for e in every]

    params, x = mixer_inputs()
    for name in MIXERS:
        mesh = meshes[name]
        if mesh is None:                    # this rank is not in the mesh
            continue
        axis = MESHES[name][1][0]
        p = comm.mesh_sizes(mesh)[axis]
        w = x.shape[1] // p
        me = mesh.get_local_rank(axis)
        mixer = fftconv_mixer_from_reference(params, device="cpu",
                                             mesh=mesh, axis=axis)
        with torch.no_grad():
            y = mixer(torch.from_numpy(x[:, me * w:(me + 1) * w]),
                      seq_axis_sharded=True)
            out["mixer/" + name] = _gathered(y, mesh, [(1, axis)])
            out["mixer/" + name + "/local"] = mixer(
                torch.from_numpy(x)).numpy()


def _port_grads(rank, meshes, out):
    """The gradients of the sharded convolution and of the mixer's sharded
    branch on this rank's blocks, gathered, beside the unsharded ones."""
    import torch
    import torch.distributed as dist
    import repro_torch as rt
    from repro_torch.convert import fftconv_mixer_from_reference
    planner = rt.Planner(backends=("torch",), device="cpu")
    u, k = conv_inputs()
    w = grad_weights(u.shape, "conv")
    ut, kt = (torch.from_numpy(a).requires_grad_() for a in (u, k))
    (rt.fft_conv(ut, kt, planner, device="cpu")
     * torch.from_numpy(w)).sum().backward()
    out["conv_grad/local/u"], out["conv_grad/local/k"] = (
        ut.grad.numpy(), kt.grad.numpy())
    params, x = mixer_inputs()
    wy = grad_weights(x.shape, "mixer")
    whole = fftconv_mixer_from_reference(params, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    (whole(xt) * torch.from_numpy(wy)).sum().backward()
    out["mixer_grad/local/x"] = xt.grad.numpy()
    for n, p in whole.named_parameters():
        out["mixer_grad/local/" + n] = p.grad.numpy()
    for name in GRADS:
        mesh = meshes[name]
        if mesh is None:                    # this rank is not in the mesh
            continue
        axis = MESHES[name][1][0]
        pn = mesh.size(0)
        me = mesh.get_local_rank(axis)
        blk = slice(me * u.shape[1] // pn, (me + 1) * u.shape[1] // pn)
        ub = torch.from_numpy(u[:, blk]).requires_grad_()
        kb = torch.from_numpy(k).requires_grad_()
        (rt.fft_conv_seq_sharded(ub, kb, mesh, axis, planner)
         * torch.from_numpy(w[:, blk])).sum().backward()
        out["conv_grad/" + name + "/u"] = _gathered(ub.grad, mesh,
                                                    [(1, axis)])
        every = [torch.empty_like(kb.grad) for _ in range(pn)]
        dist.all_gather(every, kb.grad, group=mesh.get_group(axis))
        out["conv_grad/" + name + "/k"] = torch.stack(every).numpy()
        mixer = fftconv_mixer_from_reference(params, device="cpu",
                                             mesh=mesh, axis=axis)
        blk = slice(me * x.shape[1] // pn, (me + 1) * x.shape[1] // pn)
        xb = torch.from_numpy(x[:, blk]).requires_grad_()
        (mixer(xb, seq_axis_sharded=True)
         * torch.from_numpy(wy[:, blk])).sum().backward()
        out["mixer_grad/" + name + "/x"] = _gathered(xb.grad, mesh,
                                                     [(1, axis)])
        for n, p in mixer.named_parameters():
            every = [torch.empty_like(p.grad) for _ in range(pn)]
            dist.all_gather(every, p.grad, group=mesh.get_group(axis))
            out["mixer_grad/" + name + "/" + n] = torch.stack(every).numpy()


def port_main(out_path, hw_json):
    """The port's run: 8 gloo ranks (one thread each, a file store beside
    ``out_path``, 60 s group timeouts) compute every case on their blocks;
    rank 0 writes the collected outputs, plans, measurement counts and
    every rank's verdicts to ``out_path``. ``hw_json`` is the planners'
    ``HardwareSpec``. Imports no JAX."""
    import torch.multiprocessing as mp
    store = os.path.join(os.path.dirname(os.path.abspath(out_path)),
                         "gloo_store")
    mp.start_processes(_port_rank, args=(store, out_path, hw_json),
                       nprocs=WORLD, start_method="spawn")


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    from repro.core import api as japi
    from repro.core import plan as jplan
    hw = dict(dataclasses.asdict(jplan.TPU_V5E),
              collective_lat=japi.COLLECTIVE_LAT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = {
        "ref": subprocess.Popen(
            [sys.executable, __file__, "ref", str(tmp / "ref.npz")],
            env=ref_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True),
        "port": subprocess.Popen(
            [sys.executable, __file__, "port", str(tmp / "port.npz"),
             json.dumps(hw)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)}
    logs = {}
    try:
        for name, proc in procs.items():
            logs[name] = proc.communicate(timeout=RUN_TIMEOUT)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for name, proc in procs.items():
        assert proc.returncode == 0, f"{name} run failed:\n{logs[name]}"
    out = {}
    for name in procs:
        z = np.load(tmp / f"{name}.npz")
        out[name] = ({k: z[k] for k in z.files if k != "meta"},
                     json.loads(str(z["meta"])))
    out["hw"] = hw
    return out


def _numpy(case):
    x = case_input(case)
    axes = tuple(range(-len(case["shape"]), 0))
    if case["kind"] == "r2c":
        return np.fft.rfftn(x.astype(np.float64), axes=axes)
    return np.fft.fftn(x.astype(np.complex128), axes=axes)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_forward_matches_numpy_and_the_reference(runs, case):
    ours, theirs = runs["port"][0][case["name"]], runs["ref"][0][case["name"]]
    ref = _numpy(case)
    assert ours.shape == theirs.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(ours - ref).max() <= 1e-4 * scale
    assert np.abs(ours - theirs).max() <= 1e-4 * scale


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_round_trip_gives_the_input_back(runs, case):
    x = case_input(case)
    back = runs["port"][0][case["name"] + "/back"]
    assert back.shape == x.shape
    assert np.abs(back - x).max() < 1e-3


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_forced_plans_match_the_reference(runs, case):
    ours = runs["port"][1]["plans"][case["name"]]
    theirs = runs["ref"][1]["plans"][case["name"]]
    assert ours["est_cost"] == pytest.approx(theirs["est_cost"], rel=1e-12)
    fields = ("shape", "kind", "decomp", "mesh_axes", "mesh_shape",
              "output_layout", "factors")
    assert {f: ours[f] for f in fields} == {f: theirs[f] for f in fields}
    if case["comm"] == "measure":     # timed on the port's own mesh
        assert len(ours["comm"]) == len(theirs["comm"])
        assert not {"auto", "measure"} & set(ours["comm"])
    else:
        assert ours["comm"] == theirs["comm"]


@pytest.mark.parametrize("verdict", VERDICTS,
                         ids=[v["name"] for v in VERDICTS])
def test_free_verdicts_match_the_reference(runs, verdict):
    ours = dict(runs["port"][1]["verdicts"][verdict["name"]])
    theirs = dict(runs["ref"][1]["verdicts"][verdict["name"]])
    assert ours.pop("est_cost") == pytest.approx(theirs.pop("est_cost"),
                                                 rel=1e-12)
    assert ours == theirs


def test_dfft_wisdom_keys_match_the_reference(runs):
    assert runs["ref"][1]["collective_lat"] == runs["hw"]["collective_lat"]
    assert runs["port"][1]["keys"] == runs["ref"][1]["keys"]
    assert len(runs["port"][1]["keys"]) == len(VERDICTS)


def test_measured_planning_times_each_finalist_once(runs):
    m = runs["port"][1]["measured"]
    assert m["finalists_timed"] == 2          # local and slab over "fft"
    assert m["comm_timed"] >= 3               # collective, agas, pipelined
    assert m["timed_again"] == 0
    assert m["again"] == m["plan"] and m["plan"]["measured_cost"] > 0
    assert m["comm_keys"] == ["comm/slab/64x320/p8/r2c/tpu_v5e"]


def test_measured_exchanges_land_in_wisdom(runs):
    keys = runs["port"][1]["measure_keys"]
    assert keys == sorted(
        ["comm/factor1d/65536/256x256/p8/tpu_v5e"]
        + [f"comm/pencil/8x6x5x8/mesh2x2x2/c2c/ax{j}/tpu_v5e"
           for j in range(3)])


def test_every_rank_holds_the_same_verdicts(runs):
    agree = runs["port"][1]["ranks_agree"]
    assert len(agree) == 8 and all(agree)


def test_transposed_layout_saves_an_exchange_each_way(runs):
    assert runs["port"][1]["exchanges"] == {"natural": [2, 2],
                                            "transposed": [1, 1]}


@pytest.mark.parametrize("spec", ["collective", "pipelined:2"])
def test_backend_gathers_stack_every_rank(runs, spec):
    got = runs["port"][0][f"gather/{spec}"]
    base = np.arange(12.).reshape(4, 3)
    want = np.stack([(base + 100 * r) - 1j * (base + 100 * r)
                     for r in range(8)])
    np.testing.assert_array_equal(got, want)


def _numpy_shim(case):
    x = shim_input(case).astype(np.complex128 if case["fn"] == "fft3_pencil"
                                else np.float64)
    if case["fn"] == "fft3_pencil":
        return np.fft.fftn(x)
    return np.fft.rfftn(x)


def _unfold(folded, n0, p):
    """``keep_transposed``'s folded (w, p*n0) layout, rank r's block being
    its (w, n0) transposed slab, back to the (n0, p*w) spectrum."""
    w = folded.shape[0]
    return folded.reshape(w, p, n0).transpose(2, 1, 0).reshape(n0, p * w)


@pytest.mark.parametrize("case", SHIMS, ids=[c["name"] for c in SHIMS])
def test_shims_match_the_reference_and_numpy(runs, case):
    ours = runs["port"][0]["shim/" + case["name"]]
    theirs = runs["ref"][0]["shim/" + case["name"]]
    ref = _numpy_shim(case)
    scale = np.abs(ref).max()
    # the raw layouts, padded bands and legacy layouts included
    assert ours.shape == theirs.shape
    assert np.abs(ours - theirs).max() <= 1e-4 * scale
    if case["flags"].get("permuted_cols"):
        return                  # columns in digit order: the round trip
    if case["flags"].get("keep_transposed"):
        ours = _unfold(ours, case["shape"][0], WORLD)
    crop = ours[tuple(slice(0, n) for n in ref.shape)]
    assert np.abs(crop - ref).max() <= 1e-4 * scale


@pytest.mark.parametrize("case", SHIMS, ids=[c["name"] for c in SHIMS])
def test_shims_round_trip(runs, case):
    back = runs["port"][0]["shim/" + case["name"] + "/back"]
    x = shim_input(case)
    assert back.shape == x.shape
    assert np.abs(back - x).max() < 1e-4


def test_each_shim_warns_once_per_process(runs):
    assert runs["port"][1]["shim_warnings"] == {
        name: 1 for name in ("fft2_slab", "ifft2_slab", "fft3_pencil",
                             "ifft3_pencil", "rfft3_pencil",
                             "irfft3_pencil")}


def test_shims_take_the_global_shape_where_the_mesh_does_not_divide(runs):
    """A block of a 10-row array over 4 ranks holds 3 of the 12 padded
    rows: without shape= the shim transforms the 12 rows, with it the 10
    rows; a shape the block does not fit raises."""
    x = shim_input(dict(name="shim_shape", fn="fft2_slab", shape=(10, 12)))
    ours = runs["port"][0]
    padded = np.fft.rfft2(np.pad(x.astype(np.float64), ((0, 2), (0, 0))))
    given = ours["shim_shape/True"][:10, :7]
    assert np.abs(given - np.fft.rfft2(x.astype(np.float64))).max() <= \
        1e-4 * np.abs(padded).max()
    assert np.abs(ours["shim_shape/False"][:, :7] - padded).max() <= \
        1e-4 * np.abs(padded).max()
    assert runs["port"][1]["shim_shape_raises"]


def _numpy_conv():
    u, k = conv_inputs()
    length = u.shape[1]
    nf = 2 * length
    u, k = u.astype(np.float64), k.astype(np.float64)
    return np.fft.irfft(
        np.fft.rfft(np.pad(u, ((0, 0), (0, nf - length), (0, 0))), axis=1)
        * np.fft.rfft(np.pad(k.T[None], ((0, 0), (0, nf - length), (0, 0))),
                      axis=1), axis=1, n=nf)[:, :length, :]


@pytest.mark.parametrize("comm", CONVS)
def test_seq_sharded_conv_matches_numpy_and_the_reference(runs, comm):
    ours = runs["port"][0]["conv/" + comm]
    theirs = runs["ref"][0]["conv/" + comm]
    ref = _numpy_conv()
    assert ours.shape == theirs.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(ours - ref).max() <= 1e-4 * scale
    assert np.abs(ours - theirs).max() <= 1e-4 * scale


def test_seq_sharded_conv_repartitions_unevenly(runs):
    rng = np.random.default_rng(_seed("conv_uneven"))
    u = rng.standard_normal((1, 384, 3))
    k = rng.standard_normal((3, 384))
    ref = np.fft.irfft(np.fft.rfft(u, n=1024, axis=1)
                       * np.fft.rfft(k.T[None], n=1024, axis=1),
                       n=1024, axis=1)[:, :384]
    ours = runs["port"][0]["conv_uneven"]
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()


def test_conv_and_gather_measurements_land_in_wisdom(runs):
    meta = runs["port"][1]
    # the reference's keys (repro.core.comm.measure_comm_conv / _gather)
    # with the hardware tag the port appends
    assert meta["extra_comm_keys"] == ["comm/conv/b2d4/32x32/p8/tpu_v5e",
                                       "comm/gather/1000/b256/p8/tpu_v5e"]
    assert len(meta["extra_ranks_agree"]) == 8
    assert all(meta["extra_ranks_agree"])


def test_compressed_psum_quantizes_as_the_reference(runs):
    ours, theirs = runs["port"][0], runs["ref"][0]
    np.testing.assert_array_equal(ours["psum/q"], theirs["psum/q"])
    np.testing.assert_array_equal(ours["psum/scale"], theirs["psum/scale"])


@pytest.mark.parametrize("comm", PSUMS)
def test_compressed_psum_matches_the_reference(runs, comm):
    ours, theirs = runs["port"][0], runs["ref"][0]
    want = psum_input().astype(np.float64).sum(axis=0)
    total, err = ours["psum/" + comm], ours["psum/" + comm + "/err"]
    assert total.shape == err.shape == (WORLD, PSUM["n"])
    # the reference's own bounds (tests/_dist_worker.py)
    rel = np.abs(total[0] - want) / (np.abs(want) + 1e-3)
    assert np.median(rel) < 0.02
    assert np.abs(err).max() < 0.05
    # and the reference's values
    ref_total = theirs["psum/" + comm]
    assert (total == total[0]).all()
    assert np.abs(total - ref_total).max() <= 1e-6 * np.abs(ref_total).max()
    ref_err = theirs["psum/" + comm + "/err"]
    assert np.abs(err - ref_err).max() <= 1e-6 * np.abs(ref_err).max()


@pytest.mark.parametrize("mesh", MIXERS)
def test_sharded_mixer_matches_its_unsharded_self_and_the_reference(runs,
                                                                    mesh):
    ours = runs["port"][0]["mixer/" + mesh]
    local = runs["port"][0]["mixer/" + mesh + "/local"]
    theirs = runs["ref"][0]["mixer/" + mesh]
    assert ours.shape == local.shape == theirs.shape == (
        MIXER["b"], MIXER["length"], MIXER["d"])
    scale = np.abs(theirs).max()
    assert np.abs(ours - local).max() <= 1e-4 * scale
    assert np.abs(ours - theirs).max() <= 1e-4 * scale


def _close(ours, want, what):
    assert ours.shape == want.shape, (what, ours.shape, want.shape)
    assert np.abs(ours - want).max() <= GRAD_TOL * np.abs(want).max(), what


@pytest.mark.parametrize("mesh", GRADS)
def test_seq_sharded_conv_gradient_matches_unsharded_and_the_reference(
        runs, mesh):
    ours, theirs = runs["port"][0], runs["ref"][0]
    for x in ("u", "k"):
        local = ours["conv_grad/local/" + x]
        got = ours[f"conv_grad/{mesh}/{x}"]
        want = theirs[f"conv_grad/{mesh}/{x}"]
        if x == "k":                # whole, the same on every rank
            assert (got == got[0]).all()
            got = got[0]
        _close(got, local, f"{x} against fft_conv")
        _close(got, want, f"{x} against the reference")


@pytest.mark.parametrize("mesh", GRADS)
def test_sharded_mixer_gradient_matches_the_unsharded_mixer(runs, mesh):
    ours = runs["port"][0]
    _close(ours[f"mixer_grad/{mesh}/x"], ours["mixer_grad/local/x"], "x")
    for n in ("w_in", "filt", "skip", "w_out"):
        got = ours[f"mixer_grad/{mesh}/{n}"]
        assert (got == got[0]).all(), n     # whole on every rank
        _close(got[0], ours["mixer_grad/local/" + n], n)


if __name__ == "__main__":
    {"ref": ref_main, "port": port_main}[sys.argv[1]](*sys.argv[2:])
