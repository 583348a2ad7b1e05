#!/usr/bin/env python3
"""How far one float32 training step of the FFT-conv LM lies from the same
step with float64 convolutions, on the CPU: the grounding of
``chip_smoke.TRAIN_STEP_TOL``, which phase 17 holds on the card at full
width.

    PYTHONPATH=src python3 scripts/train_step_noise.py [--seq 8192]

run from the root of a checkout. The model is olmo-1b's smoke config (d
64) at olmo-1b's full depth, every layer ``fftconv_mlp``, float32 compute,
random weights from a seed, one SyntheticDataset batch of 1 x ``--seq``
tokens; ``chip_smoke.step_errors`` holds each gradient and the loss
against the same step with every ``fft_conv`` rendered by float64
torch.fft, and the same step with the convolution's output detached (the
control). Runs the ``torch`` planner and the ``hopper`` one (the
four-step kernel's plain version here) and prints, for each, the loss's
error, the worst and median gradient error (of each gradient's max) and
the control's worst.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch import Planner  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import LM  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=8192)
    args = ap.parse_args()
    depth = get_config("olmo-1b").num_layers
    cfg = dataclasses.replace(
        get_smoke_config("olmo-1b"), num_layers=depth,
        segments=(("fftconv_mlp", depth),), compute_dtype="float32")
    batch = cs.train_batch(cfg, 1, args.seq, "cpu")
    for backend in ("torch", "hopper"):
        model = LM(cfg, planner=Planner(backends=(backend,)), device="cpu",
                   generator=torch.Generator().manual_seed(cs.SEED))
        errs = cs.step_errors(model, batch)
        worst = max(errs["grads"], key=errs["grads"].get)
        print(f"{backend}: {depth} fftconv_mlp layers, d {cfg.d_model}, 1 x "
              f"{args.seq} tokens, float32, on the CPU: loss err/|ref| "
              f"{errs['loss']:.3e}; gradient err/max worst "
              f"{errs['grads'][worst]:.3e} ({worst}), median "
              f"{statistics.median(errs['grads'].values()):.3e} over "
              f"{len(errs['grads'])} tensors; control (convolution "
              f"detached) worst {max(errs['control'].values()):.3e}; "
              f"chip_smoke.TRAIN_STEP_TOL {cs.TRAIN_STEP_TOL}")


if __name__ == "__main__":
    main()
