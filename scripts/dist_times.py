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
* the four-step kernel's share of its bound on each card
  (calibrate.four_step_share: the H100 profile's fft_share);
* the same shape's local plan on one card (factor1d: torch.fft.fft, no
  local plan takes 2^26), every rank at once, the slowest rank's median;
* one all_to_all_single of 1 KiB across the W cards (seconds a call over
  200 calls, 5 runs, each the slowest rank's, and their median: the
  H100 profile's collective_lat), and the exchange time of a traced slab
  call on rank 0 (torch.profiler: the NCCL kernels' device time);
* plan_nd's free verdicts for the three shapes in estimate mode and in
  measured mode (every finalist and every exchange timed on the live
  mesh), and whether they agree;
* FFTConvMixer(2048, 16) on (4, 8192, 2048) with the sequence sharded over
  (W,) (seq_axis_sharded=True, each comm), its output gathered on rank 0
  and held against the unsharded mixer on the same weights at
  2e-4*max|ref|, timed beside the unsharded mixer on one card (every rank
  at once, the slowest rank's median);
* compressed_psum of a payload the size of that mixer's parameters
  (12,617,728 f32, each rank its own) over (W,) with every gather backend,
  auto and measure, held on rank 0 against the sum of the dequantized
  payloads (1e-6 of its max) and the exact sum (median relative error
  under 0.02, the reference's bound), and timed.

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
from repro_torch.core import comm  # noqa: E402
from repro_torch.models import FFTConvMixer  # noqa: E402
from repro_torch.optim import (choose_psum_comm,  # noqa: E402
                               compressed_psum, dequantize_int8,
                               quantize_int8)
from repro_torch.calibrate import (card_label,  # noqa: E402
                                   collective_latency, four_step_share)
from repro_torch.core.comm import mesh_max  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=300)
SLAB_N, PENCIL_N, FACTOR1D_N = 16384, 512, 1 << 26
SLAB_COMMS = ("collective", "pipelined:4", "agas")
REPS = 10
# the FFT-conv mixer at olmo-1b's width (d_model 2048, rank 16) on 4 x 8192
# tokens, and a payload the size of its parameters
MIXER_D, MIXER_RANK, MIXER_B, MIXER_S = 2048, 16, 4, 8192
MIXER_COMMS = ("collective", "pipelined:4", "agas", "auto", "measure")
PSUM_N = MIXER_D * 2 * MIXER_D + MIXER_D * MIXER_D + MIXER_D * MIXER_RANK \
    + MIXER_D
PSUM_COMMS = ("collective", "pipelined:4", "agas", "auto", "measure")


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


def verdicts(shape, kind, mesh, planner, say) -> None:
    """plan_nd's free verdict in estimate and in measured mode, and
    whether the two agree (decomposition, mesh axes and exchanges)."""
    got = {mode: plan_nd(shape, kind, mesh=mesh, mode=mode, planner=planner)
           for mode in ("estimate", "measured")}
    for mode, nd in got.items():
        say(f"plan_nd {shape} {kind} {mode}: {verdict(nd)}")
    pick = [(nd.decomp, nd.mesh_axes, nd.comm) for nd in got.values()]
    say(f"plan_nd {shape} {kind}: estimate and measured "
        f"{'agree' if pick[0] == pick[1] else 'DIFFER'}")


def gathered(t, mesh, axis) -> torch.Tensor:
    """Every rank's block of ``t`` concatenated along ``axis``."""
    work, buf = comm._gather_start(t, mesh.get_group("fft"),
                                   comm.mesh_sizes(mesh)["fft"])
    work.wait()
    return comm._unlead(buf, axis)


def sharded_mixer(mesh, planner, gen, say, label) -> None:
    """The mixer with its sequence sharded over the mesh, each comm: held
    against the unsharded mixer on rank 0, timed beside it."""
    world, rank = dist.get_world_size(), dist.get_rank()
    mixer = FFTConvMixer(MIXER_D, MIXER_RANK, planner=planner,
                         generator=torch.Generator(
                             device="cuda").manual_seed(0),
                         mesh=mesh, axis="fft")
    x = torch.randn(MIXER_B, MIXER_S, MIXER_D, device="cuda", generator=gen)
    w = MIXER_S // world
    block = x[:, rank * w:(rank + 1) * w].contiguous()
    with torch.no_grad():
        local = mixer(x)
        base = timed(lambda: mixer(x), mesh)
        say(f"time unsharded mixer {tuple(x.shape)} on one card: "
            f"{base:.3f} ms [{label}]")
        tol = 2e-4 * local.abs().max().item()
        for c in MIXER_COMMS:
            mixer.comm = c
            full = gathered(mixer(block, seq_axis_sharded=True), mesh, 1)
            err = (full - local).abs().max().item()
            if rank == 0 and not err <= tol:
                raise RuntimeError(f"sharded mixer {c}: err {err} > {tol}")
            say(f"check sharded mixer over ({world},) {c}: err {err:.4e} "
                f"against the unsharded mixer (tol {tol:.4e})")
            ms = timed(lambda: mixer(block, seq_axis_sharded=True), mesh)
            say(f"time sharded mixer {tuple(x.shape)} over ({world},) {c}: "
                f"{ms:.3f} ms, {base / ms:.2f}x the unsharded mixer on one "
                f"card [{label}]")
            del full
    del mixer, x, block, local


def psum(mesh, say, label) -> None:
    """compressed_psum of a PSUM_N payload a rank, each gather backend,
    auto and measure: checked on rank 0 and timed."""
    world, rank = dist.get_world_size(), dist.get_rank()
    xs = [torch.randn(PSUM_N, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(10 + r)) for r in range(world)]
    deq = sum(dequantize_int8(*quantize_int8(x), x.shape).double()
              for x in xs)
    exact = sum(x.double() for x in xs)
    group = mesh.get_group("fft")
    for c in PSUM_COMMS:
        spec = choose_psum_comm(mesh, "fft", (PSUM_N,), mode=c)
        total, err = compressed_psum(xs[rank], group, comm=spec)
        off = (total.double() - deq).abs().max().item()
        med = ((total.double() - exact).abs()
               / (exact.abs() + 1e-3)).median().item()
        if rank == 0 and not (off <= 1e-6 * deq.abs().max().item()
                              and med < 0.02):
            raise RuntimeError(f"compressed_psum {c}: {off} from the "
                               f"dequantized sum, median rel err {med}")
        ms = timed(lambda: compressed_psum(xs[rank], group, comm=spec),
                   mesh)
        say(f"time compressed_psum {PSUM_N} f32 a rank over ({world},) {c} "
            f"-> {spec}: {ms:.3f} ms; {off:.3e} from the sum of the "
            f"dequantized payloads, median rel err {med:.3e}, residual "
            f"{err.abs().max().item():.3e} [{label}]")


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
    shares = [None] * world
    dist.all_gather_object(shares, four_step_share())
    say("four-step share of its bound at (8193, 16384) on each card: "
        + ", ".join(f"{c['four_step_share']:.4f} ({c['four_step_ms']:.3f} "
                    f"ms)" for c in shares) + f" [{label}]")
    dev = torch.device("cuda", local_rank)
    runs = [mesh_max(m1, collective_latency(dev)) for _ in range(5)]
    say(f"time all_to_all_single 1 KiB across {world} cards: "
        f"{statistics.median(runs) * 1e6:.2f} us a call, the median of 5 "
        f"runs of 200 ({', '.join(f'{r * 1e6:.2f}' for r in runs)} us) "
        f"[{label}]")

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
    verdicts(x.shape, "r2c", m1, planner, say)
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
    verdicts((PENCIL_N,) * 3, "c2c", m2, planner, say)
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
    verdicts((FACTOR1D_N,), "c2c", m1, planner, say)
    del z1, zc, local
    torch.cuda.empty_cache()

    sharded_mixer(m1, planner, gen, say, label)
    torch.cuda.empty_cache()
    psum(m1, say, label)
    t0 = time.perf_counter()
    mesh_max(m1, 0.0)
    say(f"done [{label}] ({time.perf_counter() - t0:.3f} s last barrier)")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
