#!/usr/bin/env python3
"""Train on a (data, model) mesh across the cards of one host.

    torchrun --nproc-per-node 4 scripts/dist_train.py

run from the root of a checkout on a machine with that many CUDA cards, one
rank per card over NCCL (every group with a 300 s timeout). Through the
port's ``Trainer`` (tensor parallelism over ``model``, FSDP2 over
``data``; bfloat16 compute, float32 parameters, remat, AdamW warmup 1),
STEPS steps each (``--steps``), no checkpoint written:

* the FFT-conv LM at olmo-1b's width (its 16 layers ``fftconv_mlp``, the
  hopper planner) on (W, 1), 2 x 8192 tokens a card a step;
* olmo-1b as published on (W, 1) at 4 x 2048 a card and on (W/2, 2) at
  4 x 2048 a data rank;
* xlstm-1.3b as published on (W, 1) and (W/2, 2) at 4 x 512 a data rank
  (mLSTM and sLSTM by heads over ``model``);
* zamba2-7b on (W/2, 2) at 2 x 2048 a data rank: its first segment pair
  (6 Mamba2 layers and the shared attention block) held against one
  card, then all 81 layers, which one card cannot train (about 94 GB of
  float32 parameters, gradients and AdamW moments);
* FFTConvMixer(2048, 16) on (4, 8192, 2048) with the sequence sharded over
  (W,): the gradient of sum(y * w) in the input (gathered) and in every
  parameter held on rank 0 against the unsharded mixer's at
  2e-4*max|ref|, and forward + backward timed beside the unsharded
  mixer's on one card (every rank at once, the slowest rank's median);
* the GPipe pipeline over pod (``build_cell(..., pipeline=True)``'s train
  cell, its LM drawn by ``Cell.build``; ``--runs pipeline``): olmo-1b as
  published on (W, 1, 1) and (W/2, 2, 1) (pod, data, model) at 4 x 2048 a
  data rank; granite-8b's first 4 layers on (W/2, 2, 1) against one card;
  granite-8b at all 36 layers on (W/2, 2, 1), 4 x 2048 a data rank, which
  one card cannot train (about 128 GB of float32 parameters, gradients and
  AdamW moments). Each prints, beside the rest, the bubble: the S - 1 of
  the M + S - 1 ticks in which a stage computes no microbatch, as that
  share of the traced step's compute (its device time outside NCCL).

For each run: finite losses; every parameter block changed at every step
on every rank, save a block whose every element had a gradient and took
an AdamW step no larger than half the spacing of float32 at its value
(a one-element FSDP block of a bias, at 1.0, can; each such stall is
printed with its reading); the first step held against the same model's
first step on rank 0's card alone over the same global batch
(``grad_accum`` = dp, so each microbatch is one data rank's rows; not for
zamba2-7b at full depth): its float32 twin (the same model, mesh and
placement with float32 compute) within F32_TOL of one card's float32
step in loss and grad_norm, the bfloat16 loss within LOSS_TOL of one
card's bfloat16 step, and the bfloat16 grad_norm within NORM_TOL of it or
else within NOISE_RATIO x one card's own bfloat16-to-float32 distance of
one card's float32 grad_norm (as dist_serve.py holds its rows); the
kernel launches of every step on every rank (80 / 96 / 64 four-step /
transpose / complex multiply for the FFT-conv LM, none for the others);
the step ms of steps 2-STEPS (each rank's median, the slowest rank's
taken), tokens/s of the whole mesh, the peak GiB a card (the largest
rank's), and the NCCL kernels' share of the device time of a traced step
on rank 0 beside the device's busy share of its wall and the device time
of FSDP2's copies in and out of its collectives' buffers (its kernels
other than NCCL's). Rank 0 prints one
line a measurement and the card label. ``--runs`` picks the runs whose
names contain one of its comma-separated words (default: every run).
Needs CUDA cards.

The limits: in float32 the mesh and the card differ only in the order of
their sums, far below F32_TOL; a fault of the mesh path (a missing
all-reduce, gradients averaged instead of summed, a whole run counted tp
times in the norm) moves the loss or grad_norm by a factor or by percents,
far beyond it. In bfloat16 the mesh's matmuls round differently from the
card's: through xlstm-1.3b's 48 layers that noise alone moves the served
logits by half their max (PERF.md), so its bfloat16 grad_norm is held by
the card's own bfloat16 distance, where that is the larger.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import functools
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

from chip_smoke import (NOISE_RATIO, below_resolution,  # noqa: E402
                        grad_errors, mixer_grads, step_recorder)

TIMEOUT = datetime.timedelta(seconds=300)
SEED, STEPS = 0, 6
FFTCONV_ROWS, FFTCONV_S = 2, 8192        # a card's rows a step
OLMO_ROWS, OLMO_S = 4, 2048              # a data rank's rows a step
XLSTM_ROWS, XLSTM_S = 4, 512
ZAMBA_ROWS, ZAMBA_S = 2, 2048
GRANITE_ROWS, GRANITE_S = 4, 2048        # a data rank's rows, pipelined
# launches of one FFT-conv layer in a training step with remat
# (chip_smoke.TRAIN_LAYER_LAUNCHES)
LAYER_LAUNCHES = {"four_step_fft": 5, "batched_transpose": 6,
                  "complex_multiply": 4, "fftconv_fused": 0}
MIXER_D, MIXER_RANK, MIXER_B, MIXER_S = 2048, 16, 4, 8192
GRAD_TOL, REPS = 2e-4, 5
LOSS_TOL, NORM_TOL, F32_TOL = 1e-3, 1e-2, 1e-3


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"dist_train: FAILED: {what}")


def traced(fn):
    """(wall ms, device busy ms, NCCL kernels' device ms, FSDP2's copies'
    device ms) of one traced call of ``fn`` (after one untraced call)."""
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
    return wall, busy, nccl, fsdp_copies_ms(prof.events())


def fsdp_copies_ms(events) -> float:
    """Device ms of the kernels other than NCCL's that ops inside FSDP2's
    own ranges ("FSDP::...") launch: the copies into and out of its
    all-gather and reduce-scatter buffers (a block cut along a dim other
    than the first is copied once more each way) and the gradients'
    division."""
    def inside(e):
        while e is not None:
            if e.name.startswith("FSDP::"):
                return True
            e = e.cpu_parent
        return False
    return sum(k.duration for e in events if inside(e)
               for k in e.kernels if "nccl" not in k.name.lower()) / 1e3


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


def first_step(cfg, planner, shape, mesh, accum: int = 1) -> dict:
    """The metrics of the first step of ``cfg`` (``run``), the model freed."""
    hist = run(cfg, planner, shape, mesh, 1, accum)[2]
    gc.collect()
    torch.cuda.empty_cache()
    return hist[0]


def rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def stalls_on_every_rank(name, tr) -> str:
    """Check that every parameter block on every rank changed at every
    step, save blocks that stalled below float32's resolution
    (``chip_smoke.below_resolution``); returns the readings of those."""
    mine = [[n for n in same if n not in stalled]
            for same, stalled in zip(tr.unchanged, tr.stalled)]
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, (mine, tr.stalled))
    for r, (stuck, _) in enumerate(ranks):
        check(not any(stuck), f"{name}: rank {r} parameters unchanged by a "
              f"step: {[u[:3] for u in stuck]}")
    return "; ".join(
        f"rank {r} step {i + 1} {n}: {k} element(s), |x| {x:.6g}, |lr u| "
        f"{m:.3e} <= half its float32 spacing {h:.3e}"
        for r, (_, stalled) in enumerate(ranks)
        for i, step in enumerate(stalled)
        for n, (k, x, m, h) in step.items())


def against_one_card(at: str, dp: int, first: dict, twin: dict,
                     alone: dict, alone32: dict) -> str:
    """Check a mesh's first step (``first``: bfloat16; ``twin``: float32)
    against one card's (``alone``, ``alone32``) as ``train`` describes;
    returns the line's words on it."""
    g, g1, g32 = first["grad_norm"], alone["grad_norm"], \
        alone32["grad_norm"]
    loss_err, norm_err = rel(first["loss"], alone["loss"]), rel(g, g1)
    twin_loss, twin_norm = (rel(twin["loss"], alone32["loss"]),
                            rel(twin["grad_norm"], g32))
    drift_mesh, drift_one = rel(g, g32), rel(g1, g32)
    at = f"{at}: first step"
    check(twin_loss <= F32_TOL and twin_norm <= F32_TOL,
          f"{at} in float32: loss {twin['loss']}, grad_norm "
          f"{twin['grad_norm']} against one card's {alone32['loss']}, "
          f"{g32} (tol {F32_TOL})")
    check(loss_err <= LOSS_TOL, f"{at}: loss {first['loss']} against one "
          f"card's {alone['loss']} (tol {LOSS_TOL})")
    check(norm_err <= NORM_TOL or drift_mesh <= NOISE_RATIO * drift_one,
          f"{at}: grad_norm {g} against one card's {g1} ({norm_err}, "
          f"tol {NORM_TOL}); from one card's float32 {g32}: {drift_mesh}"
          f", more than {NOISE_RATIO} x one card's own {drift_one}")
    return (f"first step against one card alone ({dp} microbatches): "
            f"float32 twin loss {twin_loss:.3e}, grad_norm {twin_norm:.3e} "
            f"(tol {F32_TOL}); bfloat16 loss {loss_err:.3e} (tol "
            f"{LOSS_TOL}), grad_norm {g:.6f} against {g1:.6f}: "
            f"{norm_err:.3e} (tol {NORM_TOL}), from one card's float32 "
            f"{g32:.6f}: {drift_mesh:.3e} against the card's own "
            f"{drift_one:.3e} (limit {NOISE_RATIO} x); ")


def train(name, cfg, planner, mesh, rows: int, seq: int, per_step, *, say,
          label, steps: int, against_one: bool = True) -> None:
    """``steps`` steps of ``cfg`` on ``mesh`` with ``rows`` x ``seq``
    tokens a data rank, its first step held against one card's (unless
    ``against_one`` is False): the loss within LOSS_TOL; the float32
    twin's loss and grad_norm (the same model and placement in float32)
    within F32_TOL of one card's float32 step; the bfloat16 grad_norm
    within NORM_TOL of one card's bfloat16 step, or, where one card's own
    bfloat16 step lies farther from float32 than that, within
    NOISE_RATIO x that distance from the float32 step. Prints the
    measurement line."""
    t0 = time.perf_counter()
    dp = mesh.size(0)
    shape = ShapeConfig("train", seq, rows * dp, "train")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    alone = alone32 = None
    if dist.get_rank() == 0 and against_one:
        alone = first_step(cfg, planner, shape, None, accum=dp)
        alone32 = first_step(cfg32, planner, shape, None, accum=dp)
    dist.barrier()
    gc.collect()            # the one-card runs' models, before the peak
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt_state, hist, tr = run(cfg, planner, shape, mesh, steps)
    losses = [h["loss"] for h in hist]
    check(len(losses) == steps and all(map(math.isfinite, losses)),
          f"{name}: losses {losses}")
    stalls = stalls_on_every_rank(name, tr)
    check(all(c == per_step for c in tr.launches),
          f"{name}: rank {dist.get_rank()} launches a step {tr.launches}, "
          f"expected {per_step}")
    tr_ms = tr.ms
    step_ms = mesh_max(mesh, statistics.median(tr_ms[1:]))
    peak = mesh_max(mesh, torch.cuda.max_memory_allocated() / 2 ** 30)
    batch = tr.batch_at(steps)
    wall, busy, nccl, copies = traced(
        lambda: Trainer.train_step(tr, model, opt_state, batch))
    del model, opt_state, tr, batch
    gc.collect()
    torch.cuda.empty_cache()
    against = ""
    if against_one:
        twin = first_step(cfg32, planner, shape, mesh)
    if alone is not None:
        against = against_one_card(f"{name} on {tuple(mesh.mesh.shape)}",
                                   dp, hist[0], twin, alone, alone32)
    tokens = shape.global_batch * seq
    busy_share = busy / wall if wall else float("nan")
    nccl_share = nccl / busy if busy else float("nan")
    say(f"train {name} on {tuple(mesh.mesh.shape)} (data, model), "
        f"{tokens} tokens a step ({rows} x {seq} a data rank): losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; " + against
        + "every parameter block changed at every step on every rank"
        + (f" (stalled below float32's resolution: {stalls})" if stalls
           else "") + "; rank 0 step ms "
        f"{', '.join(f'{x:.1f}' for x in tr_ms)}; slowest rank's median of "
        f"steps 2-{steps} {step_ms:.3f} ms, {tokens / (step_ms / 1e3):.0f} "
        f"tokens/s; peak {peak:.2f} GiB a card (largest); launches a step "
        f"{per_step} on every rank (exact); traced step on rank 0: wall "
        f"{wall:.1f} ms, device busy {busy:.1f} ms ({busy_share:.1%}), "
        f"NCCL kernels {nccl:.1f} ms ({nccl_share:.1%} of busy), FSDP2's "
        f"copies {copies:.1f} ms; {time.perf_counter() - t0:.1f} s "
        f"[{label}]")


class CellRun:
    """``steps`` steps of ``build_cell(cfg, shape, mesh, pipeline=True)``'s
    train cell (its LM drawn by ``Cell.build`` from SEED's generator, as
    the Trainer draws it), each on this rank's rows of the Trainer's
    dataset at that step, recorded as ``step_recorder`` records a
    Trainer's: ``ms``, ``launches``, ``unchanged`` and ``stalled``
    blocks, and the metrics of each step (``hist``)."""

    def __init__(self, cfg, shape, mesh, steps: int):
        from repro_torch.data import SyntheticDataset
        from repro_torch.launch.specs import build_cell
        from repro_torch.optim import adamw_init
        from repro_torch.optim.adamw import local
        from repro_torch import kernels
        self.cell = build_cell(cfg, shape, mesh, pipeline=True)
        check(self.cell.pipelined, f"{cfg.name} on {tuple(mesh.mesh.shape)}"
              ": build_cell gave no pipelined cell")
        self.model = self.cell.build(torch.Generator(device="cuda")
                                     .manual_seed(SEED))
        self.opt = adamw_init(dict(self.model.named_parameters()))
        self.data = SyntheticDataset(cfg, shape, seed=SEED)
        self.mesh = mesh
        self.ms, self.launches, self.unchanged, self.stalled = [], [], [], []
        self.hist = []
        for step in range(steps):
            batch = self.batch_at(step)
            before = {n: local(p).detach().clone()
                      for n, p in self.model.named_parameters()}
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t1 = time.perf_counter()
            _, _, metrics = self.cell.fn(self.model, self.opt, batch)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t1) * 1e3)
            self.launches.append(kernels.launch_counts())
            self.hist.append({k: float(v) for k, v in metrics.items()})
            same = [n for n, p in self.model.named_parameters()
                    if torch.equal(local(p), before[n])]
            self.unchanged.append(same)
            readings = {n: below_resolution(AdamWConfig(), n, before[n],
                                            self.opt, metrics)
                        for n in same}
            self.stalled.append({n: r for n, r in readings.items()
                                 if r is not None})

    def batch_at(self, step: int) -> dict:
        out = {}
        for k, a in self.data.sharded_batch_at(step, self.mesh,
                                               self.cell.rules).items():
            out[k] = torch.from_numpy(a).long().to("cuda")
        return out

    def step(self, batch) -> None:
        self.cell.fn(self.model, self.opt, batch)


def pipeline_first_step(cfg, shape, mesh) -> dict:
    """The metrics of the first step of ``cfg``'s pipelined cell, the
    model freed."""
    first = CellRun(cfg, shape, mesh, 1).hist[0]
    gc.collect()
    torch.cuda.empty_cache()
    return first


def train_pipeline(name, cfg, mesh, rows: int, seq: int, *, say, label,
                   steps: int, against_one: bool = True) -> None:
    """``steps`` steps of ``cfg``'s pipelined train cell on ``mesh`` (pod,
    data, model) with ``rows`` x ``seq`` tokens a data rank, checked as
    ``train`` checks a Trainer's (no kernel launched), its first step held
    against one card's unless ``against_one`` is False. Prints step ms,
    tokens/s, the peak a card, the NCCL share of a traced step and the
    bubble: the (S - 1) of M + S - 1 ticks that compute no microbatch, a
    share of the traced step's compute (its device time outside NCCL)."""
    from repro_torch.parallel.pipelined_lm import (NUM_MICROBATCHES,
                                                   microbatches)
    t0 = time.perf_counter()
    pods, dp = mesh.size(0), mesh.size(1)
    shape = ShapeConfig("train", seq, rows * dp, "train")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    alone = alone32 = None
    if dist.get_rank() == 0 and against_one:
        alone = first_step(cfg, None, shape, None, accum=dp)
        alone32 = first_step(cfg32, None, shape, None, accum=dp)
    dist.barrier()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = CellRun(cfg, shape, mesh, steps)
    losses = [h["loss"] for h in run.hist]
    check(len(losses) == steps and all(map(math.isfinite, losses)),
          f"{name}: losses {losses}")
    stalls = stalls_on_every_rank(name, run)
    none = dict.fromkeys(LAYER_LAUNCHES, 0)
    check(all(c == none for c in run.launches), f"{name}: rank "
          f"{dist.get_rank()} launches a step {run.launches}, expected none")
    step_ms = mesh_max(mesh, statistics.median(run.ms[1:]))
    peak = mesh_max(mesh, torch.cuda.max_memory_allocated() / 2 ** 30)
    batch = run.batch_at(steps)
    wall, busy, nccl, copies = traced(lambda: run.step(batch))
    first = run.hist[0]
    ms = run.ms
    del run, batch
    gc.collect()
    torch.cuda.empty_cache()
    against = ""
    if against_one:
        twin = pipeline_first_step(cfg32, shape, mesh)
    if alone is not None:
        against = against_one_card(f"{name} on {tuple(mesh.mesh.shape)}",
                                   dp, first, twin, alone, alone32)
    m = microbatches(rows, NUM_MICROBATCHES)
    ticks = m + pods - 1
    compute = busy - nccl
    bubble = compute * (pods - 1) / ticks
    tokens = shape.global_batch * seq
    say(f"train pipeline {name} on {tuple(mesh.mesh.shape)} (pod, data, "
        f"model), {tokens} tokens a step ({rows} x {seq} a data rank, {m} "
        f"microbatches, {pods} stages, {ticks} ticks): losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; " + against
        + "every parameter block changed at every step on every rank"
        + (f" (stalled below float32's resolution: {stalls})" if stalls
           else "") + "; rank 0 step ms "
        f"{', '.join(f'{x:.1f}' for x in ms)}; slowest rank's median of "
        f"steps 2-{steps} {step_ms:.3f} ms, {tokens / (step_ms / 1e3):.0f} "
        f"tokens/s; peak {peak:.2f} GiB a card (largest); launches 0 a step "
        f"on every rank (exact); traced step on rank 0: wall {wall:.1f} ms,"
        f" device busy {busy:.1f} ms ({busy / wall:.1%}), NCCL kernels "
        f"{nccl:.1f} ms ({nccl / busy:.1%} of busy), FSDP2's copies "
        f"{copies:.1f} ms; bubble "
        f"{pods - 1}/{ticks} of its compute {compute:.1f} ms: {bubble:.1f} "
        f"ms ({bubble / wall:.1%} of the wall, (S-1)/M = "
        f"{(pods - 1) / m:.3f} of the useful compute); "
        f"{time.perf_counter() - t0:.1f} s [{label}]")


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
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="",
                    help="comma-separated words: the runs whose names "
                         "contain one (default: all)")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help=f"steps a training run (default {STEPS}; at "
                         "least 2)")
    args = ap.parse_args()
    if args.steps < 2:
        ap.error("--steps: at least 2 (the times are of steps 2 on)")
    words = [w for w in args.runs.split(",") if w]
    steps = args.steps
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
    both = (make_mesh((world // 2, 2), ("data", "model"), timeout=TIMEOUT)
            if world % 2 == 0 else None)
    none = dict.fromkeys(LAYER_LAUNCHES, 0)
    xlstm, zamba = get_config("xlstm-1.3b"), get_config("zamba2-7b")
    pair = dataclasses.replace(zamba, num_layers=7, segments=(
        ("mamba2", 6), ("shared_attn", 1)))
    fit = functools.partial(train, say=say, label=label, steps=steps)
    pipe = functools.partial(train_pipeline, say=say, label=label,
                             steps=steps)
    pods = make_mesh((world, 1, 1), ("pod", "data", "model"),
                     timeout=TIMEOUT)
    pods_data = (make_mesh((world // 2, 2, 1), ("pod", "data", "model"),
                           timeout=TIMEOUT) if world % 2 == 0 else None)
    granite = get_config("granite-8b")
    granite4 = dataclasses.replace(granite, num_layers=4)
    runs = {
        "zamba2-7b pair (W/2, 2)": lambda: fit(
            "zamba2-7b first segment pair (6 mamba2 + shared_attn)", pair,
            None, both, ZAMBA_ROWS, ZAMBA_S, none),
        "zamba2-7b (W/2, 2)": lambda: fit(
            "zamba2-7b (81 layers; one card cannot train it)", zamba, None,
            both, ZAMBA_ROWS, ZAMBA_S, none, against_one=False),
        "FFT-conv LM (W, 1)": lambda: fit(
            "FFT-conv LM", fftconv_lm, planner, data_only, FFTCONV_ROWS,
            FFTCONV_S, {k: v * olmo.num_layers
                        for k, v in LAYER_LAUNCHES.items()}),
        "olmo-1b (W, 1)": lambda: fit(
            "olmo-1b", olmo, None, data_only, OLMO_ROWS, OLMO_S, none),
        "olmo-1b (W/2, 2)": lambda: fit(
            "olmo-1b", olmo, None, both, OLMO_ROWS, OLMO_S, none),
        "sharded mixer": lambda: sharded_mixer_grad(
            make_mesh((world,), ("fft",), timeout=TIMEOUT), planner, say,
            label),
        "xlstm-1.3b (W, 1)": lambda: fit(
            "xlstm-1.3b", xlstm, None, data_only, XLSTM_ROWS, XLSTM_S, none),
        "xlstm-1.3b (W/2, 2)": lambda: fit(
            "xlstm-1.3b", xlstm, None, both, XLSTM_ROWS, XLSTM_S, none),
        "pipeline olmo-1b (W, 1, 1)": lambda: pipe(
            "olmo-1b", olmo, pods, OLMO_ROWS, OLMO_S),
        "pipeline olmo-1b (W/2, 2, 1)": lambda: pipe(
            "olmo-1b", olmo, pods_data, OLMO_ROWS, OLMO_S),
        "pipeline granite-8b 4 layers (W/2, 2, 1)": lambda: pipe(
            "granite-8b first 4 layers", granite4, pods_data, GRANITE_ROWS,
            GRANITE_S),
        "pipeline granite-8b (W/2, 2, 1)": lambda: pipe(
            "granite-8b (36 layers; one card cannot train it)", granite,
            pods_data, GRANITE_ROWS, GRANITE_S, against_one=False),
    }
    for name, run in runs.items():
        if (both is None and "W/2" in name) or (
                words and not any(w in name for w in words)):
            continue
        run()
        gc.collect()
        torch.cuda.empty_cache()
    say(label)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
