#!/usr/bin/env python3
"""Serve on a (data, model) mesh across the cards of one host.

    torchrun --nproc-per-node 4 scripts/dist_serve.py

run from the root of a checkout on a machine with four CUDA cards, one
rank per card over NCCL (every group with a 300 s timeout). Every run is
``launch.serve.ServeLoop`` on a mesh (``launch.specs.build_cell``'s decode
cell: its rules and ``serve_step``), the traffic of ``chip_smoke.py``'s
phase 16: 4 prompts of 2048 tokens (8192 for the FFT-conv LM), batch 4
(1 for the flash-decoding layout), 16 new tokens each, greedy.

* phi3.5-moe-42b-a6.6b with the serve profile (bf16 weights and
  reductions; FSDP dropped where the tensor-parallel weights fit half a
  card) on (1, 4): its first 8 layers against rank 0's card alone serving
  the same 8 layers (the same weights), then all 32 layers, which pass one
  card, built a parameter at a time (``Cell.build``): prefill ms, decode
  ms a step, tokens/s, peak GiB a card, the NCCL share of a traced decode
  step and prefill (as for the FFT-conv LM);
* the FFT-conv LM at olmo-1b's width (16 ``fftconv_mlp`` layers, the
  hopper planner) on (1, 4): each rank convolves 512 of the 2048 channels;
  its kernel launches on every rank exactly the one-card prefills' (32 /
  32 / 16 four-step / transpose / complex multiply each), none a decode
  step;
* olmo-1b on (2, 2) at batch 4 (the batch over the data ranks) and on
  (4, 1) at batch 1 (each rank caches a quarter of the positions);
* the other layer kinds as published, each rank its heads (Mamba2's B
  and C whole): zamba2-7b at all 81 layers on (1, 4) (its shared
  attention block at every place), xlstm-1.3b at all 48 layers on (1, 4)
  and (2, 2), qwen2-vl-7b (M-RoPE, text prompts) and musicgen-large on
  (1, 4); no kernel launched on any rank.

``--runs`` picks the runs whose names contain one of its comma-separated
words (default: every run).

Each configuration is served first on rank 0's card alone, and every
other run is fed that run's tokens (teacher forcing): the same weights
in float32 (compute, reductions over ``model`` and cache) on the card and
on the mesh, whose rows must agree within F32_TOL of max, and the
bfloat16 run on the mesh, whose rows are held against the float32 card's
within NOISE_RATIO x the bfloat16 card's own error (as phase 15 holds its
bfloat16 paths): two bfloat16 runs in another order differ by the
rounding noise of their depth, a few 1e-2 of max (their direct error is
printed beside SERVE_TOL). A MoE's router near-ties flip experts between
two orders of arithmetic, so every run of phi3.5-moe replays the routing
of its one-card bfloat16 run (``chip_smoke.routes_replayed``, as phase 16
forces its routing), and its float32 twin on the mesh is the timed
run's cell (serve-profile rules and placement) in float32. A faulty mesh
path (a missing sum over ``model``, partials merged unscaled) misses the
float32 limit by orders of magnitude (``chip_smoke.py`` phase 19's
controls). Rank 0 prints a line a run, the card label, and as its last
line one JSON object with each run's verdict; a failed check exits
non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import gc
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from repro_torch import Planner, make_mesh  # noqa: E402
from repro_torch.calibrate import card_label  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.comm import mesh_max  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.optim.adamw import local  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dist_train import traced  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=300)
SEED = 0
PROMPT, FFTCONV_PROMPT, REQUESTS, NEW, BATCH = 2048, 8192, 4, 16, 4
PHI, PHI_CHECKED = "phi3.5-moe-42b-a6.6b", 8
# float32 arithmetic in another order at full depth (chip_smoke.py's
# KIND_F32_TOL); bfloat16 runs in two orders differ by the rounding noise
# of their depth, a few 1e-2 of max at 16 layers (chip_smoke.py's phase
# 15), so each is held against the float32 run instead
F32_TOL, NOISE_RATIO, SERVE_TOL = cs.KIND_F32_TOL, cs.NOISE_RATIO, \
    cs.SERVE_TOL


class Failed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


@contextlib.contextmanager
def serve_profile(on: bool):
    """``build_cell``'s serve profile on or off for the block."""
    saved = os.environ.pop("REPRO_SERVE_WEIGHT_STATIONARY", None)
    if on:
        os.environ["REPRO_SERVE_WEIGHT_STATIONARY"] = "1"
    try:
        yield
    finally:
        os.environ.pop("REPRO_SERVE_WEIGHT_STATIONARY", None)
        if saved is not None:
            os.environ["REPRO_SERVE_WEIGHT_STATIONARY"] = saved


def prompts_of(cfg, length: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, length).astype(np.int32)
            for _ in range(REQUESTS)]


def gen():
    return torch.Generator(device="cuda").manual_seed(SEED)


@dataclasses.dataclass
class Served:
    """One configuration as served: its config, its model on rank 0's
    card alone (``one``) and on the mesh (``mesh``: whole, for ServeLoop
    to place, or placed already), each built when called, and whether its
    cache is float32 (the float32 twin)."""
    cfg: Any
    one: Callable[[], LM]
    mesh: Callable[[], LM]
    cache32: bool = False
    planner: Optional[Planner] = None
    profile: bool = False


def routed(routes=None, log=None):
    """The MoE's routing replayed from ``routes`` or else logged to
    ``log`` (``chip_smoke.routes_replayed``), or neither."""
    if routes is not None:
        return cs.patched("moe_route", cs.routes_replayed(routes, True))
    if log is not None:
        return cs.patched("moe_route", cs.routes_replayed(log, False))
    return contextlib.nullcontext()


def freed() -> None:
    """Free the models of earlier runs: FSDP2's hooks hold an LM in a
    reference cycle, which only the collector breaks."""
    gc.collect()
    torch.cuda.empty_cache()


def run(served: Served, prompts, batch: int, mesh=None, forced=None,
        routes=None, log=False):
    """ServeLoop over ``prompts`` on rank 0's card alone (no ``mesh``;
    every rank gets its tokens, the MoE routing it logged (``log``) and
    rank 0 its rows) or on ``mesh``; ``routes``: a routing to replay."""
    if mesh is None:
        out = [None]
        if dist.get_rank() == 0:
            logged = [] if log else None
            with serve_profile(served.profile), routed(routes, logged):
                res = cs.serve(served.one(), served.cfg, prompts,
                               planner=served.planner, forced=forced,
                               new=NEW, batch=batch, cache32=served.cache32)
            out = [{"tokens": res["tokens"], "decode_ms": res["decode_ms"],
                    "log": logged,
                    "rows": {rid: [r.cpu() for r in rows]
                             for rid, rows in res["rows"].items()}}]
            del res
            freed()
        dist.broadcast_object_list(out, src=0)
        return out[0]
    with serve_profile(served.profile), routed(routes):
        res = cs.serve(served.mesh(), served.cfg, prompts,
                       planner=served.planner, forced=forced, new=NEW,
                       batch=batch, cache32=served.cache32, mesh=mesh)
    res["rows"] = {rid: [r.cpu() for r in rows]
                   for rid, rows in res["rows"].items()}
    freed()
    return res


def worst(cfg, res, ref, mesh) -> float:
    """The worst row's err/max against ``ref``'s (rank 0's reading, on
    every rank)."""
    err = 0.0
    if dist.get_rank() == 0:
        err = max(cs.rel_err(cfg, a, b) for rid, rows in ref["rows"].items()
                  for a, b in zip(res["rows"][rid], rows))
    return mesh_max(mesh, err)


def held(name, mesh, prompts, batch: int, bf16: Served, f32: Served, say,
         label, per_prefill=None) -> dict:
    """``bf16`` served on rank 0's card alone, then on ``mesh`` fed its
    tokens, and the float32 twin ``f32`` (the same weights, float32
    compute, reductions and cache) likewise: the twin's mesh rows within
    F32_TOL of its one-card rows; the bfloat16 mesh rows against the
    float32 one-card rows within NOISE_RATIO x the bfloat16 one-card
    rows' error; the launches on every rank; the bfloat16 mesh run's
    times. A MoE's runs all replay the one-card bfloat16 run's routing: a
    router near-tie within two orders' noise flips an expert (on an H100,
    phi3.5-moe's float32 rows of one or two prompts in four off by 3e-3
    to 1, its bfloat16 rows by 1.3)."""
    moe = bool(f32.cfg.num_experts)
    ref = run(bf16, prompts, batch, log=moe)
    routes = ref["log"]
    ref32 = run(f32, prompts, batch, forced=ref["tokens"], routes=routes)
    res32 = run(f32, prompts, batch, mesh, ref["tokens"], routes)
    err32 = worst(f32.cfg, res32, ref32, mesh)
    del res32
    res = run(bf16, prompts, batch, mesh, ref["tokens"], routes)
    direct = worst(bf16.cfg, res, ref, mesh)
    drift_mesh = worst(bf16.cfg, res, ref32, mesh)
    drift_one = worst(bf16.cfg, ref, ref32, mesh)
    check(err32 <= F32_TOL, f"{name}: float32 twin on the mesh err/max "
          f"{err32} against one card > {F32_TOL}")
    check(drift_mesh <= NOISE_RATIO * drift_one, f"{name}: bfloat16 on "
          f"the mesh err/max {drift_mesh} against the float32 card, more "
          f"than {NOISE_RATIO} x one card's {drift_one}")
    if per_prefill is not None:
        want = {k: v * len(prompts) for k, v in per_prefill.items()}
        ok = mesh_max(mesh, float(res["launches"] != want)) == 0.0
        check(ok, f"{name}: launches {res['launches']} on rank "
              f"{dist.get_rank()}, expected {want} on every rank")
    decode = mesh_max(mesh, statistics.median(res["decode_ms"]))
    peak = mesh_max(mesh, res["peak"]) / 2 ** 30
    seconds = mesh_max(mesh, res["seconds"])
    n = sum(len(t) for t in res["tokens"].values())
    say(f"serve mesh {name}: {len(prompts)} requests of "
        f"{len(prompts[0])} tokens, batch {batch}, {NEW} new each, fed the "
        f"one-card bfloat16 run's tokens: float32 twin err/max {err32:.3e} "
        f"(tol {F32_TOL}) against one card; bfloat16 against the float32 "
        f"card: mesh {drift_mesh:.3e}, one card {drift_one:.3e} (limit "
        f"{NOISE_RATIO} x)" + (", MoE routing replayed" if moe else "")
        + f"; bfloat16 mesh against bfloat16 card {direct:.3e} (SERVE_TOL "
        f"{SERVE_TOL}: {'within' if direct <= SERVE_TOL else 'over'}); "
        f"decode "
        f"{decode:.3f} ms a step (the slowest rank's median; one card "
        f"{statistics.median(ref['decode_ms']):.3f}); {n / seconds:.1f} "
        f"tok/s drained ({n} tokens in {seconds:.3f} s, prefills "
        f"included); peak {peak:.2f} GiB a card; rank 0 launches "
        f"{res['launches']}"
        + (" (exact on every rank)" if per_prefill is not None else "")
        + f" [{label}]")
    return res


def timings(name, model, mesh, prompt, max_len: int, say, label,
            batch_size: int = BATCH, trace_prefill: bool = True) -> None:
    """Prefill ms (median of 3, the slowest rank's), and the NCCL share
    of a traced prefill (unless ``trace_prefill`` is False: an sLSTM
    prefill is a long host loop of small ops) and decode step on rank 0;
    the cache of a batch of ``batch_size``."""
    batch = {"tokens": torch.as_tensor(prompt, device="cuda").long()[None]}
    with torch.no_grad():
        ms, wall = cs.time_variant(
            lambda: model.prefill(batch, max_len, global_batch=batch_size),
            3)
        ms, wall = mesh_max(mesh, ms), mesh_max(mesh, wall)
        cache = model.init_cache(batch_size, max_len)
        cache["len"].fill_(len(prompt))
        step = {"tokens": torch.zeros((cache["len"].shape[0], 1),
                                      dtype=torch.long, device="cuda")}
        pre = (traced(lambda: model.prefill(batch, max_len,
                                            global_batch=batch_size))
               if trace_prefill else None)
        dec = traced(lambda: model.decode_step(cache, step,
                                               global_batch=batch_size))
    del cache
    traced_prefill = (f"prefill wall {pre[0]:.1f} ms, busy {pre[1]:.1f}, "
                      f"NCCL {pre[2]:.1f} ms ({pre[2] / pre[1]:.1%} of "
                      f"busy); " if pre else "")
    say(f"serve mesh {name} times: prefill {ms:.3f} ms a request (wall "
        f"{wall:.3f}; the slowest rank's median of 3); traced on rank 0: "
        + traced_prefill + f"decode step "
        f"wall {dec[0]:.3f} ms, busy {dec[1]:.3f}, NCCL {dec[2]:.3f} ms "
        f"({dec[2] / dec[1]:.1%} of busy) [{label}]")


def float32_of(cfg):
    """``cfg`` computing, reducing and caching in float32, its weights as
    they are."""
    return dataclasses.replace(cfg, compute_dtype="float32",
                               reduce_dtype=None)


def serve_phi(mesh, say, label) -> None:
    full = get_config(PHI)
    prompts = prompts_of(full, PROMPT, SEED + 2)
    max_len = PROMPT + NEW
    shape = ShapeConfig("serve", max_len, BATCH, "decode")
    with serve_profile(True):
        cut = build_cell(dataclasses.replace(full, num_layers=PHI_CHECKED),
                         shape, mesh)
    cfg, cfg32 = cut.arch, float32_of(cut.arch)
    # the float32 twin: the timed run's cell (its serve-profile rules and
    # placement) computing, reducing and caching in float32. ServeLoop
    # then runs it with the profile off (the profile would cast its
    # reductions to bfloat16), and its own placement of the placed LM
    # adds nothing: a frozen LM on one data rank takes no FSDP.
    cut32 = dataclasses.replace(cut, arch=cfg32, placed={})
    say(f"serve profile on {PHI} x {PHI_CHECKED} layers: param "
        f"{cfg.param_dtype}, reduce {cfg.reduce_dtype}, rules {cut.rules} "
        f"(the float32 twin's too)")
    held(f"{PHI} {PHI_CHECKED} of {full.num_layers} layers (1, 4), serve "
         "profile", mesh, prompts, BATCH,
         Served(cfg, lambda: LM(cfg, generator=gen()),
                lambda: cut.build(gen()), profile=True),
         Served(cfg32, lambda: LM(cfg32, generator=gen()),
                lambda: cut32.build(gen()), cache32=True),
         say, label)
    with serve_profile(True):
        cell = build_cell(full, shape, mesh)
        budget = torch.cuda.get_device_properties(0).total_memory / 2
        freed()
        say(f"serve profile on {PHI} x {full.num_layers} layers: rules "
            f"{cell.rules} (budget {budget / 1e9:.3f} GB a rank: half of "
            f"the {torch.cuda.get_device_name(0)}'s total_memory)")
        t0 = time.perf_counter()
        model = cell.build(gen())
        built = mesh_max(mesh, time.perf_counter() - t0)
        weights = mesh_max(mesh, torch.cuda.memory_allocated()) / 2 ** 30
        say(f"serve mesh {PHI} {full.num_layers} layers (1, 4): built in "
            f"{built:.1f} s, {weights:.2f} GiB of weights a card")
        res = cs.serve(model, cell.arch, prompts, new=NEW, mesh=mesh)
    decode = mesh_max(mesh, statistics.median(res["decode_ms"]))
    peak = mesh_max(mesh, res["peak"]) / 2 ** 30
    seconds = mesh_max(mesh, res["seconds"])
    n = sum(len(t) for t in res["tokens"].values())
    say(f"serve mesh {PHI} {full.num_layers} layers (1, 4), serve profile: "
        f"{REQUESTS} requests of {PROMPT} tokens, batch {BATCH}, {NEW} new "
        f"each: decode {decode:.3f} ms a step (the slowest rank's median); "
        f"{n / seconds:.1f} tok/s drained ({n} tokens in {seconds:.3f} s, "
        f"prefills included); peak {peak:.2f} GiB a card [{label}]")
    del res
    timings(f"{PHI} {full.num_layers} layers (1, 4)", model, mesh,
            prompts[0], max_len, say, label)
    del model
    freed()


def whole(cfg, planner=None):
    """The served LM of ``cfg`` (weights cast once), and its float32 twin
    (the same weights), each built whole when called."""
    def bf16():
        return LM(cfg, planner=planner,
                  generator=gen()).to_compute_dtype()

    def f32():
        return cs.float32_twin(bf16(), cfg, planner)[0]
    return bf16, f32


def serve_fftconv(mesh, say, label) -> None:
    olmo = get_config("olmo-1b")
    cfg = dataclasses.replace(olmo,
                              segments=(("fftconv_mlp", olmo.num_layers),))
    planner = Planner(backends=("hopper",))
    prompts = prompts_of(cfg, FFTCONV_PROMPT, SEED)
    bf16, f32 = whole(cfg, planner)
    per_prefill = {k: v * cfg.num_layers
                   for k, v in cs.LM_LAYER_LAUNCHES.items()}
    res = held("FFT-conv LM (16 fftconv_mlp) (1, 4), hopper", mesh, prompts,
               BATCH, Served(cfg, bf16, bf16, planner=planner),
               Served(float32_of(cfg), f32, f32, cache32=True,
                      planner=planner), say, label, per_prefill)
    del res
    model = build_cell(cfg, ShapeConfig("serve", FFTCONV_PROMPT + NEW, BATCH,
                                        "decode"), mesh).place(bf16())
    timings("FFT-conv LM (1, 4)", model, mesh, prompts[0],
            FFTCONV_PROMPT + NEW, say, label)
    del model
    freed()


def serve_olmo(mesh, batch: int, what: str, say, label) -> None:
    olmo = get_config("olmo-1b")
    prompts = prompts_of(olmo, PROMPT, SEED + 1)
    bf16, f32 = whole(olmo)
    none = dict.fromkeys(cs.LM_LAYER_LAUNCHES, 0)
    held(f"olmo-1b {what}", mesh, prompts, batch, Served(olmo, bf16, bf16),
         Served(float32_of(olmo), f32, f32, cache32=True), say, label, none)
    freed()


def serve_kind(name, mesh, batch: int, what: str, say, label) -> None:
    """``name`` as published served on ``mesh`` (the train rules: a
    frozen LM on one data rank takes no FSDP2), held as ``held`` holds
    it, then timed."""
    cfg = get_config(name)
    prompts = prompts_of(cfg, PROMPT, SEED + 3)
    bf16, f32 = whole(cfg)
    none = dict.fromkeys(cs.LM_LAYER_LAUNCHES, 0)
    kinds = "+".join(f"{n} {k}" for k, n in cfg.resolved_segments()[:2])
    t0 = time.perf_counter()
    model = build_cell(cfg, ShapeConfig("serve", PROMPT + NEW, batch,
                                        "decode"), mesh).place(bf16())
    built = mesh_max(mesh, time.perf_counter() - t0)
    weights = mesh_max(mesh, sum(local(p).numel() * p.element_size()
                                 for p in model.parameters())) / 2 ** 30
    say(f"serve mesh {name} {what}: {cfg.num_layers} layers ({kinds}, "
        f"...), built and placed in {built:.1f} s, {weights:.2f} GiB of "
        f"weights a card")
    slstm = any(k == "slstm" for k, _ in cfg.resolved_segments())
    timings(f"{name} {what}", model, mesh, prompts[0], PROMPT + NEW, say,
            label, batch, trace_prefill=not slstm)
    del model
    freed()
    held(f"{name} {what}", mesh, prompts, batch, Served(cfg, bf16, bf16),
         Served(float32_of(cfg), f32, f32, cache32=True), say, label, none)
    freed()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="",
                    help="comma-separated words: the runs whose names "
                         "contain one (default: all)")
    words = [w for w in ap.parse_args().runs.split(",") if w]
    local_rank = int(os.environ["LOCAL_RANK"])
    torch.cuda.set_device(local_rank)
    dist.init_process_group("nccl", timeout=TIMEOUT)
    world, rank = dist.get_world_size(), dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    label = card_label()
    say(label)
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {
        "phi3.5-moe (1, 4)": lambda: serve_phi(
            make_mesh((1, world), ("data", "model"), timeout=TIMEOUT),
            say, label),
        "FFT-conv LM (1, 4)": lambda: serve_fftconv(
            make_mesh((1, world), ("data", "model"), timeout=TIMEOUT),
            say, label),
        "olmo-1b (2, 2) batch 4": lambda: serve_olmo(
            make_mesh((world // 2, 2), ("data", "model"), timeout=TIMEOUT),
            BATCH, "(2, 2) batch 4", say, label),
        "olmo-1b (4, 1) batch 1": lambda: serve_olmo(
            make_mesh((world, 1), ("data", "model"), timeout=TIMEOUT), 1,
            "(4, 1) batch 1, flash decoding", say, label),
    }
    one_by_world = make_mesh((1, world), ("data", "model"), timeout=TIMEOUT)
    for name in ("zamba2-7b", "xlstm-1.3b", "qwen2-vl-7b", "musicgen-large"):
        runs[f"{name} (1, 4)"] = (lambda name=name: serve_kind(
            name, one_by_world, BATCH, "(1, 4)", say, label))
    runs["xlstm-1.3b (2, 2)"] = lambda: serve_kind(
        "xlstm-1.3b", make_mesh((world // 2, 2), ("data", "model"),
                                timeout=TIMEOUT), BATCH, "(2, 2)", say,
        label)
    runs = {k: v for k, v in runs.items()
            if not words or any(w in k for w in words)}
    verdicts = {}
    for name, run in runs.items():
        t0 = time.perf_counter()
        try:
            run()
            verdicts[name] = "pass"
        except Failed as e:
            verdicts[name] = f"FAILED: {e}"
        say(f"{name} took {time.perf_counter() - t0:.1f} s")
        dist.barrier()
        freed()
    say(label)
    say(json.dumps({"runs": verdicts}))
    dist.barrier()
    dist.destroy_process_group()
    return 0 if all(v == "pass" for v in verdicts.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
