#!/usr/bin/env python3
"""Train on a (data, model) mesh across the cards of one host.

    torchrun --nproc-per-node 4 scripts/dist_train.py

run from the root of a checkout on a machine with that many CUDA cards, one
rank per card over NCCL (every group with a 300 s timeout). Through the
port's ``Trainer`` (tensor parallelism over ``model``, FSDP2 over
``data``; bfloat16 compute, float32 parameters, remat, AdamW warmup 1),
STEPS steps each, no checkpoint written:

* the FFT-conv LM at olmo-1b's width (its 16 layers ``fftconv_mlp``, the
  hopper planner) on (W, 1), 2 x 8192 tokens a card a step;
* olmo-1b as published on (W, 1) at 4 x 2048 a card and on (W/2, 2) at
  4 x 2048 a data rank;
* FFTConvMixer(2048, 16) on (4, 8192, 2048) with the sequence sharded over
  (W,): the gradient of sum(y * w) in the input (gathered) and in every
  parameter held on rank 0 against the unsharded mixer's at
  2e-4*max|ref|, and forward + backward timed beside the unsharded
  mixer's on one card (every rank at once, the slowest rank's median).

For each run: finite losses; every parameter changed at every step; the
first step's loss within LOSS_TOL and grad_norm within NORM_TOL of the
same model's first step on rank 0's card alone over the same global batch
(``grad_accum`` = dp, so each microbatch is one data rank's rows); the
kernel launches of every step on every rank (80 / 96 / 64 four-step /
transpose / complex multiply for the FFT-conv LM, none for olmo-1b: the
data ranks run the one-card step on their rows); the step ms of steps
2-STEPS (each rank's median, the slowest rank's taken), tokens/s of the
whole mesh, the peak GiB a card (the largest rank's), and the NCCL
kernels' share of the device time of a traced step on rank 0 beside the
device's busy share of its wall. Rank 0 prints one line a measurement and
the card label. Needs CUDA cards.

The limits: on (W, 1) each rank's forward and backward are the one-card
microbatch's, so only the sums' order differs (float32); on (W/2, 2) the
bfloat16 matmuls of the tensor-parallel blocks round differently, which
moves the loss by far less than LOSS_TOL. A fault of the mesh path (a
missing all-reduce, gradients averaged instead of summed) moves grad_norm
by a factor, far beyond NORM_TOL.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import math
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch import Planner, make_mesh  # noqa: E402
from repro_torch.calibrate import card_label  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.comm import mesh_max  # noqa: E402
from repro_torch.models import LM, FFTConvMixer  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402

from chip_smoke import grad_errors, mixer_grads, step_recorder  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=300)
SEED, STEPS = 0, 6
FFTCONV_ROWS, FFTCONV_S = 2, 8192        # a card's rows a step
OLMO_ROWS, OLMO_S = 4, 2048              # a data rank's rows a step
# launches of one FFT-conv layer in a training step with remat
# (chip_smoke.TRAIN_LAYER_LAUNCHES)
LAYER_LAUNCHES = {"four_step_fft": 5, "batched_transpose": 6,
                  "complex_multiply": 4, "fftconv_fused": 0}
MIXER_D, MIXER_RANK, MIXER_B, MIXER_S = 2048, 16, 4, 8192
GRAD_TOL, REPS = 2e-4, 5
LOSS_TOL, NORM_TOL = 1e-3, 1e-2


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"dist_train: FAILED: {what}")


def traced(fn):
    """(wall ms, device busy ms, NCCL kernels' device ms) of one traced
    call of ``fn`` (after one untraced call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    # NCCL's kernels, not its "nccl:..." annotation ranges
    nccl = sum(e.self_device_time_total for e in rows
               if "nccl" in e.key.lower()
               and not e.key.startswith("nccl:")) / 1e3
    return wall, busy, nccl


def run(cfg, planner, shape, mesh, steps: int, accum: int = 1):
    """(model, AdamW state, history, trainer) of ``steps`` steps of
    ``cfg`` through the step recorder (no checkpoint) on ``mesh`` (None:
    this card alone, the batch in ``accum`` microbatches)."""
    model = LM(cfg, planner=planner, generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    with tempfile.TemporaryDirectory(prefix="dist_train_") as tmp:
        tr = step_recorder()(
            cfg, shape, mesh, TrainerConfig(ckpt_dir=tmp, ckpt_every=10 ** 9,
                                            grad_accum=accum),
            AdamWConfig(warmup_steps=1, total_steps=STEPS),
            planner=planner, model=model)
        return (*tr.run(steps), tr)


def train(name, cfg, planner, mesh, rows: int, seq: int, per_step, say,
          label) -> None:
    """STEPS steps of ``cfg`` on ``mesh`` with ``rows`` x ``seq`` tokens a
    data rank, its first step held against one card's; prints the
    measurement line."""
    t0 = time.perf_counter()
    dp = mesh.size(0)
    shape = ShapeConfig("train", seq, rows * dp, "train")
    alone = None
    if dist.get_rank() == 0:
        alone = run(cfg, planner, shape, None, 1, accum=dp)[2][0]
    dist.barrier()
    gc.collect()            # the one-card run's model, before the peak
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt_state, hist, tr = run(cfg, planner, shape, mesh, STEPS)
    losses = [h["loss"] for h in hist]
    check(len(losses) == STEPS and all(map(math.isfinite, losses)),
          f"{name}: losses {losses}")
    check(not any(tr.unchanged), f"{name}: rank {dist.get_rank()} "
          f"parameters unchanged by a step: "
          f"{[u[:3] for u in tr.unchanged]}")
    check(all(c == per_step for c in tr.launches),
          f"{name}: rank {dist.get_rank()} launches a step {tr.launches}, "
          f"expected {per_step}")
    if alone is not None:
        loss_err = abs(losses[0] - alone["loss"]) / abs(alone["loss"])
        norm_err = (abs(hist[0]["grad_norm"] - alone["grad_norm"])
                    / alone["grad_norm"])
        check(loss_err <= LOSS_TOL and norm_err <= NORM_TOL,
              f"{name} on {tuple(mesh.mesh.shape)}: first step loss "
              f"{losses[0]}, grad_norm {hist[0]['grad_norm']} against one "
              f"card's {alone['loss']}, {alone['grad_norm']}")
    step_ms = mesh_max(mesh, statistics.median(tr.ms[1:]))
    peak = mesh_max(mesh, torch.cuda.max_memory_allocated() / 2 ** 30)
    batch = tr.batch_at(STEPS)
    wall, busy, nccl = traced(
        lambda: Trainer.train_step(tr, model, opt_state, batch))
    tokens = shape.global_batch * seq
    busy_share = busy / wall if wall else float("nan")
    nccl_share = nccl / busy if busy else float("nan")
    against = (f"first step against one card alone ({dp} microbatches): "
               f"loss {loss_err:.3e} (tol {LOSS_TOL}), grad_norm "
               f"{norm_err:.3e} (tol {NORM_TOL}); "
               if alone is not None else "")
    say(f"train {name} on {tuple(mesh.mesh.shape)} (data, model), "
        f"{tokens} tokens a step ({rows} x {seq} a data rank): losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; " + against
        + "every parameter changed at every step; rank 0 step ms "
        f"{', '.join(f'{x:.1f}' for x in tr.ms)}; slowest rank's median of "
        f"steps 2-{STEPS} {step_ms:.3f} ms, {tokens / (step_ms / 1e3):.0f} "
        f"tokens/s; peak {peak:.2f} GiB a card (largest); launches a step "
        f"{per_step} on every rank (exact); traced step on rank 0: wall "
        f"{wall:.1f} ms, device busy {busy:.1f} ms ({busy_share:.1%}), "
        f"NCCL kernels {nccl:.1f} ms ({nccl_share:.1%} of busy); "
        f"{time.perf_counter() - t0:.1f} s [{label}]")
    del model, opt_state, tr, batch
    torch.cuda.empty_cache()


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


def sharded_mixer_grad(mesh, planner, say, label) -> None:
    world, rank = mesh.size(0), dist.get_rank()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mixer = FFTConvMixer(MIXER_D, MIXER_RANK, planner=planner,
                         generator=torch.Generator(
                             device="cuda").manual_seed(SEED),
                         mesh=mesh, axis="fft")
    shape = (MIXER_B, MIXER_S, MIXER_D)
    x = torch.randn(shape, generator=gen, device="cuda")
    w = torch.randn(shape, generator=gen, device="cuda")
    width = MIXER_S // world
    blk = slice(rank * width, (rank + 1) * width)
    xb, wb = x[:, blk].contiguous(), w[:, blk].contiguous()
    got = mixer_grads(mixer, xb, wb, True)
    parts = [torch.empty_like(got["x"]) for _ in range(world)]
    dist.all_gather(parts, got["x"].contiguous(), group=mesh.get_group("fft"))
    got["x"] = torch.cat(parts, 1)
    ms = timed(lambda: mixer_grads(mixer, xb, wb, True), mesh)
    one = timed(lambda: mixer_grads(mixer, x, w, False), mesh)
    if rank == 0:
        errs = grad_errors(got, mixer_grads(mixer, x, w, False))
        check(max(errs.values()) <= GRAD_TOL, f"sharded mixer gradient: "
              f"err/max {errs} > {GRAD_TOL}")
        say(f"sharded mixer gradient FFTConvMixer({MIXER_D}, {MIXER_RANK}) "
            f"{shape} over ({world},): err/max "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (tol {GRAD_TOL}) against the unsharded mixer; forward + "
            f"backward {ms:.3f} ms (slowest rank's median of {REPS}), the "
            f"unsharded mixer on one card {one:.3f} ms ({one / ms:.2f}x) "
            f"[{label}]")
    del mixer, x, w, xb, wb, got
    torch.cuda.empty_cache()


def main() -> None:
    local_rank = int(os.environ["LOCAL_RANK"])
    torch.cuda.set_device(local_rank)
    dist.init_process_group("nccl", timeout=TIMEOUT)
    world, rank = dist.get_world_size(), dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    label = card_label()
    say(label)
    torch.backends.cuda.matmul.allow_tf32 = False
    planner = Planner(backends=("hopper",))
    olmo = get_config("olmo-1b")
    fftconv_lm = dataclasses.replace(
        olmo, segments=(("fftconv_mlp", olmo.num_layers),))
    data_only = make_mesh((world, 1), ("data", "model"), timeout=TIMEOUT)
    train("FFT-conv LM", fftconv_lm, planner, data_only, FFTCONV_ROWS,
          FFTCONV_S, {k: v * olmo.num_layers
                      for k, v in LAYER_LAUNCHES.items()}, say, label)
    none = dict.fromkeys(LAYER_LAUNCHES, 0)
    train("olmo-1b", olmo, None, data_only, OLMO_ROWS, OLMO_S, none, say,
          label)
    if world % 2 == 0:
        both = make_mesh((world // 2, 2), ("data", "model"), timeout=TIMEOUT)
        train("olmo-1b", olmo, None, both, OLMO_ROWS, OLMO_S, none, say,
              label)
    sharded_mixer_grad(make_mesh((world,), ("fft",), timeout=TIMEOUT),
                       planner, say, label)
    say(label)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
