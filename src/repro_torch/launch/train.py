"""Training launcher, ported from ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \
      --device cpu --steps 20 --batch 8 --seq 128

Without ``--device`` it runs on the GPU, and raises without one.
``--planner`` names the backend of the FFT-conv layers' plans (``torch``,
the reference's default; ``hopper``, the four-step kernel;
``torch_native``, cuFFT). Training runs on one device: ``--mesh`` other
than ``local`` (this device) waits for the port of ``parallel/``
(ROADMAP.md, Queue 1 item 7). Without ``--ckpt-dir`` the checkpoints go
to a new temporary directory; a directory given resumes from its latest
checkpoint, and one already at ``--steps`` raises. It prints the
reference's JSON summary.
"""

from __future__ import annotations

import argparse
import json
import tempfile

from ..configs import get_config, get_smoke_config
from ..core.plan import Planner
from ..models.config import ShapeConfig
from ..optim import AdamWConfig
from ..runtime import Trainer, TrainerConfig


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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--planner", default="torch",
                    choices=["torch", "hopper", "torch_native"],
                    help="backend of the FFT-conv layers' plans")
    args = ap.parse_args(argv)
    if args.mesh != "local":
        raise NotImplementedError(
            f"--mesh {args.mesh}: training on a mesh waits for the port of "
            "parallel/ (ROADMAP.md, Queue 1 item 7)")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    tr = Trainer(cfg, shape, None,
                 TrainerConfig(ckpt_dir=ckpt_dir,
                               ckpt_every=args.ckpt_every),
                 AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                             total_steps=args.steps),
                 device=args.device,
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
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
