"""A distributed N-D FFT over a mesh of cards, one rank per card, as a
closed loop: the per-step check of a pseudo-spectral solver.

Traffic parameters: ``ops`` (``["fftn", "ifftn"]``), ``pool`` fields a
rank holds its block of, ``warm`` untimed steps, ``trace_steps``,
``sample`` ([first, end, count]: window steps drawn from the seed whose
spectra are kept and judged beside each field's last).
Configuration: the global ``shape``, the ``mesh`` and its ``mesh_axes``,
the forced ``decomp`` (the exchange backends are the estimate planner's
choice), the planner's ``backends``, ``gen_chunk``, ``limits``.

The command forks one process a card itself (NCCL on the cards; the CPU
tests spawn them, on gloo), with the rendezvous on a free port of
localhost, and waits for every one. Each step, on every rank's block of field
i mod pool: ``fftn``, then ``ifftn``, then one all-reduce of the round
trip's squared error (with rank 0's flag that the window is over), read
on the host. Every step's round trip is judged from that sum; each
field's last spectrum and those of the sampled steps are kept, and after
the window every rank compares its blocks with its block of the float64
transform of the whole field, which it computes itself
(``reference.fft``).

Per step, each rank times on the card (CUDA events) from the step's
start to an event after its all-reduce, before the host reads the sum;
a step's time is its slowest rank's.
"""

from __future__ import annotations

import math
import socket
import statistics
import sys
import time
import traceback

import torch

from ..lib import common, counts, faults, fields, trace, window
from ..reference import fft as ref


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spec(ctx) -> dict:
    """What a rank needs of the run (sent to its process)."""
    return {k: getattr(ctx, k) for k in ("config", "traffic", "seed",
                                         "seconds", "trace", "device")}


def blocks(shape, mesh_axes, coords, spectrum):
    """The slices of this rank's block of a pencil plan's input or
    spectrum (k mesh axes): the input cut along transform axes 0..k-1 by
    the mesh axes in order; the spectrum along axes 1..k-1 by mesh axes
    0..k-2 and along the last axis by the last mesh axis."""
    k = len(mesh_axes)
    cut = ({j + 1: j for j in range(k - 1)} | {len(shape) - 1: k - 1}
           if spectrum else {j: j for j in range(k)})
    out = []
    for ax, n in enumerate(shape):
        if ax in cut:
            p, i = coords[cut[ax]]
            out.append(slice(i * n // p, (i + 1) * n // p))
        else:
            out.append(slice(None))
    return tuple(out)


def _rank(rank: int, world: int, port: int, spec: dict, fault, seeds,
          queue):
    common.SETUP.clear()                # a forked rank's own parts alone
    common.mark("start the rank")
    if sys.pycache_prefix:          # the run keeps bytecode in its checkout
        sys.dont_write_bytecode = False
    try:
        queue.put((rank, _rank_body(rank, world, port, spec, fault, seeds)))
    except BaseException:                           # report, do not hang
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def _rank_body(rank, world, port, spec, fault, seeds) -> list:
    """This rank's readings of each seed's run, one process group and
    mesh for them all."""
    import torch.distributed as dist

    from repro_torch.core import comm

    common.mark("import the port")
    cuda = spec["device"] != "cpu"
    if cuda:
        torch.cuda.set_device(rank)
    else:                       # four ranks share the CPU's cores
        torch.set_num_threads(1)
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    common.device_context(dev)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        cfg = spec["config"]
        mesh = comm.make_mesh(tuple(cfg["mesh"]), tuple(cfg["mesh_axes"]))
        common.mark("process group, mesh")
        out = []
        for seed in seeds:
            out.append(_window(rank, dev, mesh, dict(spec, seed=seed),
                               fault))
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
        return out
    finally:
        dist.destroy_process_group()


def _window(rank, dev, mesh, spec, fault) -> dict:
    import torch.distributed as dist

    from repro_torch.core import api
    from repro_torch.core.plan import Planner

    cfg, tr = spec["config"], spec["traffic"]
    shape, axes = tuple(cfg["shape"]), tuple(cfg["mesh_axes"])
    coords = [(mesh.size(i), mesh.get_local_rank(a))
              for i, a in enumerate(axes)]
    planner = Planner(backends=tuple(cfg["backends"]))
    plan = api.plan_nd(shape, "c2c", mesh=mesh, decomp=cfg["decomp"],
                       planner=planner)
    common.mark("plan")
    inb = blocks(shape, axes, coords, spectrum=False)
    pool = []
    for f in range(tr["pool"]):
        rows = inb[0]
        got = fields.planes(shape, cfg["gen_chunk"], spec["seed"], f,
                            rows.start, rows.stop - rows.start, True, dev)
        pool.append(tuple(g[(slice(None),) + inb[1:]].contiguous()
                          for g in got))
        del got
    norms = [float(sum(t.double().square().sum() for t in x)) for x in pool]
    common.mark("inputs")
    kept = [None] * len(pool)
    sample = common.sampled_steps(spec["seed"], *tr["sample"])
    judged = {}
    cuda = dev.type == "cuda"

    def step(i, stop, record=True):
        f = i % len(pool)
        y = api.fftn(pool[f], mesh=mesh, plan=plan, planner=planner)
        back = api.ifftn(y, mesh=mesh, plan=plan, planner=planner)
        err = sum((b - a).square().sum().double()
                  for a, b in zip(pool[f], back))
        buf = torch.stack([err, torch.tensor(float(stop), dtype=torch.float64,
                                             device=dev)])
        dist.all_reduce(buf)
        kept[f] = y
        if record and i in sample:
            judged[i] = (f, y)
        return buf

    with faults.planted(fault):
        for i in range(tr["warm"]):
            step(i, 0, record=False).tolist()
            common.mark(f"warm step {i}")
        kept[:] = [None] * len(pool)
        field_norm = [0.0] * len(pool)
        for f, n in enumerate(norms):      # every rank's share of |x|^2
            t = torch.tensor([n], dtype=torch.float64, device=dev)
            dist.all_reduce(t)
            field_norm[f] = float(t)
        trips, events = [], []

        def timed(i, over):
            """A step timed on the card, its all-reduced sum and rank 0's
            flag read on the host: the flag closes every rank's window."""
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            buf = step(i, rank == 0 and over)
            if cuda:
                ev[1].record()
                events.append(ev)
            err, stop = buf.tolist()
            trips.append(math.sqrt(err / field_norm[i % len(pool)]))
            return stop

        def begin():
            dist.barrier()
            if cuda:
                torch.cuda.synchronize()

        tracer = trace.Tracer(spec["trace"], tr["trace_steps"])
        got = window.run_window(timed, spec["seconds"], window.Pacer(dev, 0),
                                tracer, begin)
    i = got["steps"]
    step_ms = [a.elapsed_time(b) for a, b in events]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del pool, plan, planner
    if cuda:
        torch.cuda.empty_cache()
    out = {"steps": i, "seconds": got["seconds"],
           "start_at": got["start_at"], "step_ms": step_ms, "trips": trips,
           "peak": peak, "loaded": common.forbidden_modules(sys.modules),
           "marks": list(common.SETUP)}
    traced = tracer.result
    if traced is not None:
        out["trace"] = traced
    # each kept spectrum against this rank's block of the float64
    # transform of the whole field; each answer's sums over the blocks are
    # summed over the mesh, in the same order on every rank
    specb = blocks(shape, axes, coords, spectrum=True)
    answers = list(enumerate(kept))[:i] + [judged.get(k, (0, None))
                                           for k in sample if k < i]
    sums = torch.zeros(2, len(answers), dtype=torch.float64, device=dev)
    for f in range(len(kept)):
        mine = [k for k, (g, y) in enumerate(answers) if g == f]
        if not mine:
            continue
        if any(answers[k][1] is None for k in mine):
            sums[0, mine] = float("inf")    # never produced in the window
            sums[1, mine] = 1.0
            continue
        z = torch.empty(shape, dtype=torch.complex128, device=dev)
        chunk = cfg["gen_chunk"]
        for c in range(0, shape[0], chunk):
            re, im = fields.planes(shape, chunk, spec["seed"], f, c, chunk,
                                   True, dev)
            z[c:c + chunk] = torch.complex(re.double(), im.double())
            del re, im
        want = ref.spectrum_inplace(z)[specb]
        for k in mine:
            sums[:, k] = torch.tensor(ref.rel_l2_parts(answers[k][1], want),
                                      dtype=torch.float64)
        del z, want
    dist.all_reduce(sums)
    out["spectrum_rel_l2"] = float((sums[0] / sums[1]).max().sqrt())
    if cuda:
        out.update(common.card_info())
    return out


def run(ctx, fault=None) -> dict:
    return run_seeds(ctx, [ctx.seed], fault)[0]


def run_seeds(ctx, seeds, fault=None) -> list:
    """One run of the cell for each of ``seeds``, in one start of the
    ranks (``limits.py`` reads a dozen seeds so)."""
    import torch.multiprocessing as mp
    world = ctx.chips
    # on the cards the ranks are forked: they inherit the imported torch
    # (seconds of set-up each, and the part that varied most) and this
    # process has not initialised CUDA (``common.require_cuda`` asks
    # NVML). The CPU tests spawn them: a test process may run threads,
    # which make fork unsafe.
    mpc = mp.get_context("fork" if ctx.device != "cpu" else "spawn")
    queue = mpc.Queue()
    port = _free_port()
    procs = [mpc.Process(target=_rank, args=(r, world, port, _spec(ctx),
                                             fault, list(seeds), queue))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + len(seeds) * (ctx.seconds + 300)
        while len(got) < world:
            r, res = queue.get(timeout=max(deadline - time.monotonic(), 1))
            if isinstance(res, dict):
                raise RuntimeError(f"rank {r} failed:\n{res['error']}")
            got[r] = res
    finally:
        for p in procs:
            p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [assemble(ctx, [got[r][k] for r in range(world)])
            for k in range(len(seeds))]


def assemble(ctx, ranks) -> dict:
    cfg, tr = ctx.config, ctx.traffic
    shape = tuple(cfg["shape"])
    r0 = ranks[0]
    flops = len(tr["ops"]) * counts.fftw_flops(shape, "c2c")
    out = {"e2e": {"dist_fft_gflops": r0["steps"] * flops / r0["seconds"]
                   / 1e9,
                   "setup_s": max(r["start_at"] for r in ranks)
                   - ctx.t_start},
           "memory_peak_bytes": max(r["peak"] for r in ranks),
           "attempted": r0["steps"], "kind": r0.get("kind"),
           "power_limit": r0.get("power_limit"),
           "loaded": sorted({m for r in ranks for m in r["loaded"]}),
           "rank_marks": [r["marks"] for r in ranks]}
    if r0["step_ms"]:
        slowest = [max(ms) for ms in zip(*(r["step_ms"] for r in ranks))]
        out["e2e"]["dist_step_p95_ms"] = statistics.quantiles(
            slowest, n=20)[18] if len(slowest) > 1 else slowest[0]
        top = sorted(range(len(slowest)), key=slowest.__getitem__)[-8:]
        out["notes"] = [
            f"{len(slowest)} steps, the slowest rank's: median "
            f"{statistics.median(slowest):.3f} ms, max {max(slowest):.3f}; "
            "the slowest steps (index: ms) " + ", ".join(
                f"{k}: {slowest[k]:.3f}" for k in sorted(top))]
    if all("trace" in r for r in ranks):
        block = 2 * 8.0 * math.prod(shape) / len(ranks)   # read + write
        for r in ranks:
            r["trace"].update(fft_flops_per_step=flops,
                              fft_bytes_per_step_rank=len(tr["ops"]) * block)
        out["traces"] = [r["trace"] for r in ranks]
        out["breakdown"] = trace.breakdown(ranks[0]["trace"])
    trip = max(max(r["trips"]) for r in ranks)
    out["checks"] = [("spectrum_rel_l2", r0["spectrum_rel_l2"],
                      ctx.limits["spectrum_rel_l2"]),
                     ("roundtrip_rel_l2", trip,
                      ctx.limits["roundtrip_rel_l2"])]
    lim = ctx.limits["roundtrip_rel_l2"]
    out["failed"] = sum(t > lim for t in r0["trips"]) + int(
        r0["spectrum_rel_l2"] > ctx.limits["spectrum_rel_l2"])
    return out


def control(ctx) -> list:
    """The control's numbers on one card: the reference put in the port's
    place, the whole field's transform by TF32 products
    (``reference.fft.dft_tf32``), judged as the port is."""
    cfg, tr = ctx.config, ctx.traffic
    shape = tuple(cfg["shape"])
    dev = torch.device(ctx.device)
    spec_worst = trip_worst = 0.0
    for f in range(tr["pool"]):
        x = fields.field(shape, cfg["gen_chunk"], ctx.seed, f, pair=True,
                         device=dev)
        y = ref.dft_tf32(x, "c2c")
        back = ref.dft_tf32(y, "c2c", inverse=True)
        trip = math.sqrt(sum(float((b.double() - a.double()).square().sum())
                             for a, b in zip(x, back))
                         / sum(float(a.double().square().sum()) for a in x))
        del back
        z = torch.complex(x[0].double(), x[1].double())
        del x
        diff, norm = ref.rel_l2_parts(y, ref.spectrum_inplace(z))
        spec_worst = max(spec_worst, math.sqrt(diff / norm))
        trip_worst = max(trip_worst, trip)
        del y, z
    return [("spectrum_rel_l2", spec_worst, ctx.limits["spectrum_rel_l2"]),
            ("roundtrip_rel_l2", trip_worst, ctx.limits["roundtrip_rel_l2"])]


def fault(ctx, name: str) -> list:
    return run(ctx, fault=name)["checks"]
