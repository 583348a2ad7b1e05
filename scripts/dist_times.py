#!/usr/bin/env python3
"""Time the distributed FFT layer across the cards of one host.

    torchrun --nproc-per-node 4 scripts/dist_times.py

run from the root of a checkout on a machine with that many CUDA cards, one
rank per card over NCCL (every group with a 300 s timeout). Through the
hopper planner and the public entry points, on each rank's block:

* slab r2c 16384^2 over (W,) with each exchange backend and the transposed
  layout, pencil c2c 512^3 over (W/2, 2) ((W, 1) for odd W), factor1d c2c
  2^26 over (W,): the forward collected on rank 0 and held against float64
  torch.fft at 2e-4*max|ref|, then its time, the median of 10 runs, each
  after a barrier, timed with CUDA events on every rank and taken as the
  slowest rank's;
* the same shape's local plan on one card (factor1d: torch.fft.fft, no
  local plan takes 2^26), every rank at once, the slowest rank's median;
* one all_to_all_single of 1 KiB across the W cards (seconds a call over
  200 calls, the slowest rank's), and the exchange time of a traced slab
  call on rank 0 (torch.profiler: the NCCL kernels' device time);
* plan_nd's free verdicts for the three shapes, in estimate mode and, for
  the slab and pencil shapes, in measured mode (every finalist and every
  exchange timed on the live mesh).

Rank 0 prints one line a measurement and the card label. Needs CUDA cards;
with one rank every all-to-all is a copy.
"""

from __future__ import annotations

import datetime
import os
import statistics
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import (Planner, collect, distribute, fftn,  # noqa: E402
                         make_mesh, plan_nd, rfftn)
from repro_torch.calibrate import card_label, collective_latency  # noqa: E402
from repro_torch.core.comm import mesh_max  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=300)
SLAB_N, PENCIL_N, FACTOR1D_N = 16384, 512, 1 << 26
SLAB_COMMS = ("collective", "pipelined:4", "agas")
REPS = 10


def timed(fn, mesh) -> float:
    """The slowest rank's median ms of REPS runs of ``fn``, each after a
    barrier, with CUDA events."""
    fn()
    times = []
    for _ in range(REPS):
        mesh_max(mesh, 0.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return mesh_max(mesh, statistics.median(times))


def max_err(pair, ref) -> float:
    return max((pair[0].double() - ref.real).abs().max().item(),
               (pair[1].double() - ref.imag).abs().max().item())


def check(nd, mesh, spec, data, name, say) -> None:
    """Gather the forward on every rank; rank 0 holds it against float64
    torch.fft and raises beyond 2e-4*max|ref|."""
    full = collect(spec, nd, mesh)
    if dist.get_rank() != 0:
        return
    if nd.kind == "r2c":
        ref = torch.fft.rfftn(data.double())
    else:
        ref = torch.fft.fftn(torch.complex(data[0].double(),
                                           data[1].double()))
    tol = 2e-4 * ref.abs().max().item()
    err = max_err(full, ref)
    if not err <= tol:
        raise RuntimeError(f"{name}: err {err} > {tol}")
    say(f"check {name}: err {err:.4e} (tol {tol:.4e})")


def verdict(nd) -> str:
    measured = (f", measured {nd.measured_cost * 1e3:.3f} ms"
                if nd.measured_cost > 0 else "")
    return (f"{nd.decomp} {nd.mesh_axes} {nd.comm}, est "
            f"{nd.est_cost * 1e3:.3f} ms{measured}")


def nccl_ms(fn) -> float:
    """Device ms of the NCCL kernels in one traced call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # NCCL's kernels, not its "nccl:..." annotation ranges
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "nccl" in e.key.lower()
               and not e.key.startswith("nccl:")) / 1e3


def main() -> None:
    local_rank = int(os.environ["LOCAL_RANK"])
    torch.cuda.set_device(local_rank)
    dist.init_process_group("nccl", timeout=TIMEOUT)
    world, rank = dist.get_world_size(), dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    label = card_label()
    torch.backends.cuda.matmul.allow_tf32 = False
    m1 = make_mesh((world,), ("fft",), timeout=TIMEOUT)
    shape2 = (world // 2, 2) if world % 2 == 0 else (world, 1)
    m2 = make_mesh(shape2, ("mx", "my"), timeout=TIMEOUT)
    planner = Planner(backends=("hopper",))
    gen = torch.Generator(device="cuda").manual_seed(0)
    say(f"{world} ranks over NCCL, meshes ({world},) and {shape2} [{label}]")
    dev = torch.device("cuda", local_rank)
    lat = mesh_max(m1, statistics.median(
        collective_latency(dev) for _ in range(5)))
    say(f"time all_to_all_single 1 KiB across {world} cards: "
        f"{lat * 1e6:.2f} us a call [{label}]")

    x = torch.randn((SLAB_N,) * 2, device="cuda", generator=gen)
    base = timed(lambda: rfftn(x, planner=planner), m1)
    say(f"time local rfftn {SLAB_N}^2 on one card: {base:.3f} ms [{label}]")
    for comm, layout in [(c, "natural") for c in SLAB_COMMS] \
            + [("collective", "transposed")]:
        nd = plan_nd(x.shape, "r2c", mesh=m1, decomp="slab", comm=comm,
                     output_layout=layout, planner=planner)
        local = distribute(x, nd, m1)
        run = lambda: rfftn(local, mesh=m1, plan=nd,  # noqa: E731
                            planner=planner)
        name = f"slab r2c {SLAB_N}^2 over ({world},) {comm} {layout}"
        check(nd, m1, run(), x, name, say)
        ms = timed(run, m1)
        exch = nccl_ms(run) if comm == "collective" else float("nan")
        say(f"time {name}: {ms:.3f} ms, {base / ms:.2f}x the local plan; "
            f"rank 0's NCCL kernels {exch:.3f} ms [{label}]")
        del local
    for mode in ("estimate", "measured"):
        nd = plan_nd(x.shape, "r2c", mesh=m1, mode=mode, planner=planner)
        say(f"plan_nd {SLAB_N}^2 r2c {mode}: {verdict(nd)}")
    del x
    torch.cuda.empty_cache()

    z = tuple(torch.randn((PENCIL_N,) * 3, device="cuda", generator=gen)
              for _ in range(2))
    base = timed(lambda: fftn(z, planner=planner), m1)
    say(f"time local fftn {PENCIL_N}^3 on one card: {base:.3f} ms [{label}]")
    nd = plan_nd((PENCIL_N,) * 3, "c2c", mesh=m2, decomp="pencil",
                 comm="collective", planner=planner)
    local = distribute(z, nd, m2)
    run = lambda: fftn(local, mesh=m2, plan=nd,  # noqa: E731
                       planner=planner)
    name = f"pencil c2c {PENCIL_N}^3 over {shape2}"
    check(nd, m2, run(), z, name, say)
    say(f"time {name}: {timed(run, m2):.3f} ms [{label}]")
    for mode in ("estimate", "measured"):
        nd = plan_nd((PENCIL_N,) * 3, "c2c", mesh=m2, mode=mode,
                     planner=planner)
        say(f"plan_nd {PENCIL_N}^3 c2c {mode}: {verdict(nd)}")
    del z, local
    torch.cuda.empty_cache()

    z1 = tuple(torch.randn(FACTOR1D_N, device="cuda", generator=gen)
               for _ in range(2))
    zc = torch.complex(*z1)
    base = timed(lambda: torch.fft.fft(zc), m1)
    say(f"time torch.fft.fft 2^26 on one card: {base:.3f} ms [{label}]")
    nd = plan_nd((FACTOR1D_N,), "c2c", mesh=m1, decomp="factor1d",
                 comm="collective", planner=planner)
    local = distribute(z1, nd, m1)
    run = lambda: fftn(local, mesh=m1, plan=nd,  # noqa: E731
                       planner=planner)
    name = f"factor1d c2c 2^26 over ({world},) {nd.factors}"
    check(nd, m1, run(), z1, name, say)
    say(f"time {name}: {timed(run, m1):.3f} ms [{label}]")
    nd = plan_nd((FACTOR1D_N,), "c2c", mesh=m1, planner=planner)
    say(f"plan_nd 2^26 c2c estimate: {verdict(nd)}")
    t0 = time.perf_counter()
    mesh_max(m1, 0.0)
    say(f"done [{label}] ({time.perf_counter() - t0:.3f} s last barrier)")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
