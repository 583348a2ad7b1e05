"""The paper's technique inside the port's LM stack: train a small
Hyena-style LM whose sequence mixer is the FFT convolution
(repro_torch.core.fftconv, differentiable through its own backward), and
check its decode path (the history-cache direct convolution) against the
training-mode forward. The port of examples/fftconv_lm.py.

    PYTHONPATH=src python examples/fftconv_lm_torch.py --device cpu

Without --device it runs on the GPU, and raises without one; --planner
hopper runs the FFT-conv layers' forward transforms on the four-step
kernel there.
"""

import argparse
import tempfile

import torch

from repro_torch import Planner
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--planner", default="torch",
                    choices=["torch", "hopper", "torch_native"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, resumed from where it holds "
                         "one (default: a new temporary directory)")
    args = ap.parse_args()
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_fftconv_")

    arch = ArchConfig(
        name="fftconv-lm", family="dense", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=4096,
        segments=(("fftconv_mlp", 4),), fftconv_rank=16,
        compute_dtype="float32")
    shape = ShapeConfig("train", 128, 8, "train")
    trainer = Trainer(arch, shape, None,
                      TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=50),
                      AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60),
                      device=args.device,
                      planner=Planner(backends=(args.planner,)))
    model, _, hist = trainer.run(30)
    print(f"fftconv-LM: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")

    # decode == forward (the FFT convolution of the training path against
    # the history-cache direct convolution of the decode path)
    toks = torch.randint(0, arch.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    toks = toks.to(trainer.device)
    with torch.no_grad():
        logits_full, _ = model({"tokens": toks})
        cache = model.init_cache(2, 16)
        outs = []
        for t in range(16):
            lg, cache = model.decode_step(cache, {"tokens": toks[:, t:t + 1]})
            outs.append(lg)
    err = float((logits_full.float() - torch.cat(outs, 1)).abs().max())
    print(f"decode-vs-forward max |delta logits| = {err:.2e}")
    assert err < 2e-2


if __name__ == "__main__":
    main()
