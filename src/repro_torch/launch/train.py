"""Training launcher, ported from ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \
      --device cpu --steps 20 --batch 8 --seq 128

On a mesh, one process a rank under ``torchrun``:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch olmo-1b \
      --smoke --device cpu --mesh local --data-axis 2

Without ``--device`` it runs on the GPU, and raises without one.
``--planner`` names the backend of the FFT-conv layers' plans (``torch``,
the reference's default; ``hopper``, the four-step kernel;
``torch_native``, cuFFT). ``--mesh local`` trains on a (data, model) mesh
over the ranks ``torchrun`` started (``--data-axis`` of them on ``data``,
0: all; the rest on ``model``), or on this device where there is one
rank; ``--mesh single|multi`` makes the production mesh, which raises
without 256 or 512 ranks. Ranks talk over NCCL on the GPU and gloo on the
CPU. Without ``--ckpt-dir`` the checkpoints go to a new temporary
directory (rank 0's, on every rank); a directory given resumes from its
latest checkpoint, and one already at ``--steps`` raises. Rank 0 prints
the reference's JSON summary.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import tempfile

import torch
import torch.distributed as dist

from ..configs import get_config, get_smoke_config
from ..core.plan import Planner
from ..models.config import ShapeConfig
from ..optim import AdamWConfig
from ..runtime import Trainer, TrainerConfig
from .mesh import make_local_mesh, make_production_mesh


def _start_ranks(device):
    """Join the process group ``torchrun`` describes (NCCL on the GPU,
    gloo on the CPU); (world size, device of this rank)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 or dist.is_initialized():
        return (dist.get_world_size() if dist.is_initialized() else world,
                device)
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        device = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("gloo" if cpu else "nccl",
                            timeout=datetime.timedelta(seconds=300))
    return world, device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, resumed from where it holds "
                         "one (default: a new temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", choices=["local", "single", "multi"],
                    default="local")
    ap.add_argument("--data-axis", type=int, default=0,
                    help="local mesh data-parallel size (0 = all ranks)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--planner", default="torch",
                    choices=["torch", "hopper", "torch_native"],
                    help="backend of the FFT-conv layers' plans")
    args = ap.parse_args(argv)
    world, device = _start_ranks(args.device)
    if args.mesh == "local":
        data = args.data_axis or world
        mesh = make_local_mesh(data=data, model=world // data) \
            if world > 1 else None
    else:
        mesh = make_production_mesh(multi_pod=args.mesh == "multi")
    rank = dist.get_rank() if dist.is_initialized() else 0
    ckpt_dir = [args.ckpt_dir or (tempfile.mkdtemp(prefix="repro_torch_train_")
                                  if rank == 0 else None)]
    if dist.is_initialized():
        dist.broadcast_object_list(ckpt_dir, src=0)
    ckpt_dir = ckpt_dir[0]

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    tr = Trainer(cfg, shape, mesh,
                 TrainerConfig(ckpt_dir=ckpt_dir,
                               ckpt_every=args.ckpt_every),
                 AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                             total_steps=args.steps),
                 device=device,
                 planner=Planner(backends=(args.planner,)))
    _, _, history = tr.run(args.steps)
    if not history:
        raise SystemExit(f"{ckpt_dir} holds a checkpoint at step "
                         f"{tr.ckpt.latest_step()} >= --steps {args.steps}: "
                         "nothing to train")
    summary = {"first_loss": history[0]["loss"],
               "last_loss": history[-1]["loss"],
               "steps": len(history),
               "straggler_events": len(tr.straggler_events)}
    if rank == 0:
        print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
