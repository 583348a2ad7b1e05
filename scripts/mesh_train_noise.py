#!/usr/bin/env python3
"""How far the first training step of xlstm-1.3b at its full depth on a
(data, model) mesh lies from the same step in one process, in float32
and in bfloat16, on the CPU: the grounding of ``scripts/dist_train.py``'s
limits on the first step (its float32 twin, and its bfloat16 grad_norm
held by one card's own bfloat16-to-float32 distance).

    PYTHONPATH=src python3 scripts/mesh_train_noise.py [--d-model 64]

run from the root of a checkout. Spawns 4 gloo ranks (a FileStore in a
temporary directory, one thread each) on a (2, 2) mesh. The model is
xlstm-1.3b's smoke config (d ``--d-model``, 4 heads) at the full depth's
48 layers (six of 7 mLSTM + 1 sLSTM), random weights from a seed, one
SyntheticDataset batch of 2 x 64 tokens a data rank; the ``Trainer`` step
(AdamW warmup 1, remat) on the mesh and on rank 0 alone over the same
batch in 2 microbatches, with float32 and with bfloat16 compute. Rank 0
prints each step's (loss, grad_norm), the mesh's relative distance from
the one process in each dtype, and the one process's own bfloat16
grad_norm's distance from its float32 one beside the mesh's.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

WORLD, DM, ROWS, SEQ, SEED = 4, (2, 2), 2, 64, 0


def config(dtype: str, d_model: int):
    from repro_torch.configs import get_config, get_smoke_config
    full = get_config("xlstm-1.3b")
    return dataclasses.replace(
        get_smoke_config("xlstm-1.3b"), num_layers=full.num_layers,
        segments=full.segments, d_model=d_model, compute_dtype=dtype)


def first_step(cfg, mesh, accum: int):
    """(loss, grad_norm) of the first Trainer step of ``cfg``."""
    from repro_torch.models import LM
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    model = LM(cfg, device="cpu",
               generator=torch.Generator().manual_seed(SEED))
    with tempfile.TemporaryDirectory(prefix="mesh_train_noise_") as tmp:
        tr = Trainer(cfg, ShapeConfig("train", SEQ, ROWS * DM[0], "train"),
                     mesh, TrainerConfig(ckpt_dir=tmp, ckpt_every=10 ** 9,
                                         grad_accum=accum),
                     AdamWConfig(warmup_steps=1, total_steps=6), model=model,
                     device="cpu" if mesh is None else None)
        hist = tr.run(1)[2]
    return hist[0]["loss"], hist[0]["grad_norm"]


def rank_main(rank: int, store: str, d_model: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=900))
    from repro_torch.core.comm import make_mesh
    mesh = make_mesh(DM, ("data", "model"))
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = config(dtype, d_model)
        out[f"{dtype} mesh"] = first_step(cfg, mesh, 1)
        if rank == 0:
            out[f"{dtype} one"] = first_step(cfg, None, DM[0])
        dist.barrier()
    if rank == 0:
        def rel(a, b):
            return abs(a - b) / abs(b)
        summary = {"d_model": d_model, "steps": out}
        for dtype in ("float32", "bfloat16"):
            (lm, gm), (lo, go) = out[f"{dtype} mesh"], out[f"{dtype} one"]
            summary[f"{dtype} mesh from one"] = {"loss": rel(lm, lo),
                                                 "grad_norm": rel(gm, go)}
        g32 = out["float32 one"][1]
        summary["bfloat16 grad_norm from one's float32"] = {
            "one": rel(out["bfloat16 one"][1], g32),
            "mesh": rel(out["bfloat16 mesh"][1], g32)}
        print(json.dumps(summary, indent=1))
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=64)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(prefix="mesh_train_noise_") as tmp:
        mp.start_processes(rank_main, args=(os.path.join(tmp, "store"),
                                            args.d_model),
                           nprocs=WORLD, start_method="spawn")


if __name__ == "__main__":
    main()
