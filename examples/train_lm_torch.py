"""End-to-end training on the PyTorch port: a ~100M-parameter
granite-family model, synthetic data, the fault-tolerant runtime (async
checkpoints, restart). The port of examples/train_lm.py.

The default (--scale small, ~20M parameters, 100 steps) finishes on a CPU
in a few minutes; --scale 100m is the full-size run for a GPU (the same
code path).

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 100

Without --device it runs on the GPU, and raises without one.
"""

import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_config
from repro_torch.models import model_meta, param_count
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Trainer, TrainerConfig


def build_arch(scale: str):
    base = get_config("granite_8b")
    if scale == "100m":
        return dataclasses.replace(
            base, name="granite-100m", num_layers=8, d_model=768,
            num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32768)
    return dataclasses.replace(
        base, name="granite-20m", num_layers=4, d_model=384, num_heads=6,
        num_kv_heads=2, d_ff=1024, vocab_size=8192)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", choices=["small", "100m"], default="small")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, resumed from where it holds "
                         "one (default: a new temporary directory)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(
        prefix="repro_torch_train_lm_")

    arch = build_arch(args.scale)
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    trainer = Trainer(
        arch, shape, mesh=None,
        tcfg=TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=25),
        ocfg=AdamWConfig(lr=6e-4, warmup_steps=max(args.steps // 20, 1),
                         total_steps=args.steps),
        device=args.device)
    print(f"arch={arch.name} params={param_count(model_meta(arch)) / 1e6:.1f}M"
          f" device={trainer.device}")
    _, _, hist = trainer.run(args.steps)
    print(f"step 0 loss={hist[0]['loss']:.4f} -> "
          f"step {len(hist) - 1} loss={hist[-1]['loss']:.4f}")
    print(f"checkpoints: {trainer.ckpt.all_steps()} (async, atomic, keep-3)")
    print(f"straggler events: {len(trainer.straggler_events)}")


if __name__ == "__main__":
    main()
