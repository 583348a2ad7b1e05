"""Pipelined training on the PyTorch port: the GPipe pipeline over ``pod``
(``build_cell(..., pipeline=True)``), run under torchrun, one rank per
process.

Each pod rank holds its stage's layers (tensor parallelism over ``model``,
FSDP2 over ``data`` within the stage); the microbatches' activations
cross the stages by point-to-point sends. Every rank reads its data
rank's rows of the same synthetic batches; rank 0 prints the losses.

    # 4 gloo ranks on the CPU, (2, 2, 1) = (pod, data, model)
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/pipeline_lm_torch.py \\
        --device cpu --smoke --pods 2 --data 2
    # 4 cards over NCCL: olmo-1b as published on (4, 1, 1)
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/pipeline_lm_torch.py \\
        --pods 4 --batch 4 --seq 2048

Without --device it runs on the GPU (NCCL), and raises without one.
"""

import argparse
import json
import os

import torch
import torch.distributed as dist

from repro_torch import make_mesh
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticDataset
from repro_torch.launch.specs import build_cell
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adamw_init


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None, help="cpu: gloo on the CPU")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4,
                    help="rows a step, over the data ranks")
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args()
    cpu = args.device == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("gloo" if cpu else "nccl")
    try:
        world = dist.get_world_size()
        model_axis = world // (args.pods * args.data)
        mesh = make_mesh((args.pods, args.data, model_axis),
                         ("pod", "data", "model"))
        cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
        shape = ShapeConfig("train", args.seq, args.batch, "train")
        cell = build_cell(cfg, shape, mesh, pipeline=True)
        generator = torch.Generator(device="cpu" if cpu else "cuda")
        model = cell.build(generator.manual_seed(0))
        opt = adamw_init(dict(model.named_parameters()))
        data = SyntheticDataset(cfg, shape, seed=0)
        losses = []
        for step in range(args.steps):
            batch = {k: torch.from_numpy(a).long().to(model.device)
                     for k, a in data.sharded_batch_at(step, mesh,
                                                       cell.rules).items()}
            _, opt, metrics = cell.fn(model, opt, batch)
            losses.append(round(metrics["loss"].item(), 6))
        if dist.get_rank() == 0:
            print(json.dumps({"arch": cfg.name, "mesh": [args.pods,
                                                         args.data,
                                                         model_axis],
                              "pipelined": cell.pipelined,
                              "losses": losses}))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
