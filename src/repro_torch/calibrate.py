"""Measure the constants of the ``H100`` hardware profile on the card.

    python -m repro_torch.calibrate

prints one JSON object: the card's name and power limit (as ``nvidia-smi``
reports them), the float32 ``torch.matmul`` rate with TF32 off (an
8192^3 product) and the device-to-device copy rate of 1 GiB (bytes read plus
bytes written), each the median of 10 timed runs after warm-up. These are
the ``flops`` and ``hbm_bw`` of ``repro_torch.core.plan.H100``. Needs a GPU.
"""

from __future__ import annotations

import json
import statistics
import subprocess
from typing import Callable

import torch


def card_label() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn: Callable[[], object], reps: int = 10, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the current CUDA stream, each run
    timed alone with CUDA events after ``warmup`` untimed runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def measure() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("calibration measures the GPU and found none")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g = torch.Generator(device="cuda").manual_seed(0)
        n = 8192
        a = torch.randn(n, n, device="cuda", generator=g)
        b = torch.randn(n, n, device="cuda", generator=g)
        mm_ms = time_ms(lambda: torch.matmul(a, b))
        del a, b
        src = torch.randn(2 ** 28, device="cuda", generator=g)   # 1 GiB
        dst = torch.empty_like(src)
        copy_ms = time_ms(lambda: dst.copy_(src))
        nbytes = 2 * src.numel() * src.element_size()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return {"card": card_label(),
            "matmul_f32_flops": 2.0 * n ** 3 / (mm_ms * 1e-3),
            "matmul_ms": mm_ms,
            "copy_bytes_per_s": nbytes / (copy_ms * 1e-3),
            "copy_ms": copy_ms}


if __name__ == "__main__":
    print(json.dumps(measure()))
