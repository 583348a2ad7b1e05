"""Distributed N-D FFT through the port's planned front-end (the paper's
§5.3 experiment) over ``torch.distributed``: `plan_nd` scores local vs slab
vs pencil decompositions (with mesh-axis assignment), resolves the exchange
backends (roofline "auto" or on-mesh-timed "measure"), and the `fftn`
family executes the plan on each rank's block; `collect` gathers and crops.

On the CPU it spawns 8 gloo ranks itself:

    PYTHONPATH=src python examples/fft2d_distributed_torch.py
    PYTHONPATH=src python examples/fft2d_distributed_torch.py --comm measure \
        --wisdom /tmp/fft_wisdom.json   # rerun: zero re-measurement

On cards, one rank per card under torchrun (NCCL):

    PYTHONPATH=src torchrun --nproc-per-node 4 \
        examples/fft2d_distributed_torch.py

Rank 0 prints the plan table, each backend's time (the slowest rank's) and
rel_err against numpy.
"""

import argparse
import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import (CPU_LOCAL, H100, Planner, collect, distribute, fftn,
                         ifftn, irfftn, make_mesh, plan_nd, rfftn)
from repro_torch.core import comm as comm_mod

COMM_CHOICES = ("collective", "pipelined", "agas", "auto", "measure")
TIMEOUT = datetime.timedelta(seconds=60)
CPU_RANKS = 8


def _rel_err(pair, ref) -> float:
    z = pair[0].cpu().numpy() + 1j * pair[1].cpu().numpy()
    return float(np.max(np.abs(z - ref)) / np.max(np.abs(ref)))


def _timed(fn, mesh):
    """(result, seconds of the slowest rank) of one call after a warm-up
    call."""
    fn()
    comm_mod.mesh_max(mesh, 0.0)
    t0 = time.perf_counter()
    out = fn()
    if mesh.device_type == "cuda":
        torch.cuda.synchronize()
    return out, comm_mod.mesh_max(mesh, time.perf_counter() - t0)


def run(args) -> None:
    world, rank = dist.get_world_size(), dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    sweep = COMM_CHOICES if args.comm is None else (args.comm,)
    mesh = make_mesh((world,), ("fft",), timeout=TIMEOUT)
    shape2 = (world // 2, 2) if world % 2 == 0 else (world, 1)
    mesh2 = make_mesh(shape2, ("mx", "my"), timeout=TIMEOUT)
    on_cards = mesh.device_type == "cuda"
    # every rank reads the same wisdom (ranks that disagree on a verdict
    # would wait on each other's collectives); only rank 0 writes verdicts
    planner = Planner(hardware=H100 if on_cards else CPU_LOCAL,
                      backends=("hopper",) if on_cards else ("torch",),
                      device=None if on_cards else "cpu",
                      wisdom_path=args.wisdom)
    rng = np.random.default_rng(0)
    say(f"{world} ranks on {mesh.device_type}; meshes {dict(fft=world)} and "
        f"{dict(zip(('mx', 'my'), shape2))}")

    # the decomposition planner at work: one front-end, every layout
    for shape, kind, m in (((64, 64), "r2c", mesh),
                           ((512, 512), "r2c", mesh),
                           ((32, 64, 128), "c2c", mesh2),
                           ((10, 36), "r2c", mesh)):     # mixed radix
        nd = plan_nd(shape, kind, mesh=m, planner=planner)
        say(f"plan_nd{shape} {kind}: decomp={nd.decomp:7s} "
            f"axes={nd.mesh_axes} comm={nd.comm} "
            f"est={nd.est_cost * 1e6:8.1f}us")

    # 2D r2c through the front-end, per comm spec
    n, m = 512, 512
    x = rng.standard_normal((n, m)).astype(np.float32)
    ref = np.fft.rfft2(x)
    for comm in sweep:
        nd = plan_nd((n, m), "r2c", mesh=mesh, comm=comm, planner=planner,
                     decomp="slab", axes=("fft",))
        local = distribute(x, nd, mesh)
        out, dt = _timed(lambda: rfftn(local, mesh=mesh, plan=nd,
                                       planner=planner), mesh)
        err = _rel_err(collect(out, nd, mesh), ref)
        say(f"rfftn slab comm={comm:10s} ({nd.comm[0]}) t={dt * 1e3:7.1f}ms "
            f"rel_err={err:.2e}")

    # roundtrip through the inverse (the same plan serves both directions)
    nd = plan_nd((n, m), "r2c", mesh=mesh, planner=planner)
    local = distribute(x, nd, mesh)
    back = irfftn(rfftn(local, mesh=mesh, plan=nd, planner=planner),
                  mesh=mesh, plan=nd, planner=planner)
    back = collect(back, nd, mesh, spatial=True).cpu().numpy()
    say("irfftn roundtrip err:", float(np.max(np.abs(back - x))))

    # 3D pencil decomposition (P3DFFT-style), per comm spec
    xc = (rng.standard_normal((32, 64, 128)).astype(np.float32)
          + 1j * rng.standard_normal((32, 64, 128)).astype(np.float32))
    ref3 = np.fft.fftn(xc)
    for comm in sweep:
        nd3 = plan_nd((32, 64, 128), "c2c", mesh=mesh2, comm=comm,
                      planner=planner, decomp="pencil", axes=("mx", "my"))
        local = distribute(xc, nd3, mesh2)
        out, dt = _timed(lambda: fftn(local, mesh=mesh2, plan=nd3,
                                      planner=planner), mesh2)
        err3 = _rel_err(collect(out, nd3, mesh2), ref3)
        say(f"fftn pencil comm={comm:10s} {nd3.comm} t={dt * 1e3:7.1f}ms "
            f"rel_err={err3:.2e}")
    if args.wisdom:
        verdicts = {k: planner.wisdom.get(k).get("backend")
                    for k in planner.wisdom.keys("comm/")}
        say(f"comm wisdom at {args.wisdom}: {verdicts} (timing probes this "
            f"run: {comm_mod.MEASURE_STATS['timed']})")
        say("dfft wisdom:", list(planner.wisdom.keys("dfft/")))

    # mixed per-axis selection + full c2c roundtrip
    ndp = plan_nd((32, 64, 128), "c2c", mesh=mesh2,
                  comm=("collective", "pipelined"), planner=planner,
                  decomp="pencil", axes=("mx", "my"))
    local = distribute(xc, ndp, mesh2)
    back3 = ifftn(fftn(local, mesh=mesh2, plan=ndp, planner=planner),
                  mesh=mesh2, plan=ndp, planner=planner)
    back3 = collect(back3, ndp, mesh2, spatial=True)
    back3 = back3[0].cpu().numpy() + 1j * back3[1].cpu().numpy()
    say("ifftn roundtrip err:", float(np.max(np.abs(back3 - xc))))

    # 3D r2c/c2r roundtrip with a leading batch dim and a mixed-radix mesh
    # (X=6 and Y=10 need not divide the communicators; the padded bands are
    # planned, carried, and cropped by the NdPlan recipe)
    xr3 = rng.standard_normal((2, 6, 10, 128)).astype(np.float32)
    ndr = plan_nd((6, 10, 128), "r2c", mesh=mesh2, planner=planner,
                  decomp="pencil", axes=("mx", "my"))
    local = distribute(xr3, ndr, mesh2)
    spec = rfftn(local, mesh=mesh2, plan=ndr, planner=planner)
    err_r = _rel_err(collect(spec, ndr, mesh2),
                     np.fft.rfftn(xr3, axes=(-3, -2, -1)))
    back_r = collect(irfftn(spec, mesh=mesh2, plan=ndr, planner=planner),
                     ndr, mesh2, spatial=True).cpu().numpy()
    say(f"rfftn pencil(batch,mixed-radix) rel_err={err_r:.2e}  "
        "irfftn roundtrip err:", float(np.max(np.abs(back_r - xr3))))


def _cpu_rank(rank: int, store_path: str, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path,
                                                         CPU_RANKS),
                            rank=rank, world_size=CPU_RANKS, timeout=TIMEOUT)
    try:
        run(args)
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--comm", choices=COMM_CHOICES, default=None,
                    help="run a single exchange backend / selection mode "
                         "(default: sweep them all)")
    ap.add_argument("--wisdom", default=None,
                    help="wisdom JSON path shared by plan + comm + dfft "
                         "autotuners (measure verdicts persist across runs)")
    args = ap.parse_args()
    if "RANK" in os.environ:             # torchrun: one rank per card
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl", timeout=TIMEOUT)
        try:
            run(args)
        finally:
            dist.destroy_process_group()
        return
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_cpu_rank, args=(os.path.join(tmp, "store"), args),
                           nprocs=CPU_RANKS, start_method="spawn")


if __name__ == "__main__":
    main()
