"""Quickstart of the PyTorch/H100 port: the paper's 2D FFT through the
public API, on the card (the hopper planner, the CUDA kernels) or, with
``--cpu``, on the CPU (the torch planner, the kernels' plain versions).

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --cpu
"""

import argparse

import numpy as np
import torch

from repro_torch import VARIANTS, Planner, fft_conv, run_variant
from repro_torch.core.plan import resolve_device


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    args = ap.parse_args()
    device = resolve_device("cpu" if args.cpu else None)  # None: the GPU
    backend = "torch" if args.cpu else "hopper"

    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 512)).astype(np.float32)
    ref = np.fft.rfft2(x)

    # 1) FFTW-style planning: estimate (cost model) picks the factorization
    planner = Planner(mode="estimate", backends=(backend,), device=device)
    plan = planner.plan(512, kind="r2c")
    print(f"plan for n=512 r2c: factors={plan.factors} backend={plan.backend}")

    # 2) the paper's implementation variants all agree with numpy
    xt = torch.from_numpy(x).to(device)
    for name in VARIANTS:
        re, im = run_variant(name, xt, planner, device=device)
        z = re.double().cpu().numpy() + 1j * im.double().cpu().numpy()
        err = np.max(np.abs(z - ref)) / np.max(np.abs(ref))
        print(f"variant {name:13s} rel_err={err:.2e}")

    # 3) FFT convolution (the technique as an LM sequence mixer)
    u = rng.standard_normal((2, 256, 8)).astype(np.float32)
    k = (rng.standard_normal((8, 256))
         * np.exp(-np.arange(256) / 16.0)).astype(np.float32)
    y = fft_conv(torch.from_numpy(u), torch.from_numpy(k), planner,
                 device=device)
    print(f"fft_conv output {tuple(y.shape)} on {y.device}, "
          f"finite={bool(torch.isfinite(y).all())}")


if __name__ == "__main__":
    main()
