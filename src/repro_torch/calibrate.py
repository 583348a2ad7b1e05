"""Measure the constants of the hardware profiles.

    python -m repro_torch.calibrate
    python -m repro_torch.calibrate --gloo

The first prints one JSON object: the card's name and power limit (as
``nvidia-smi`` reports them), the float32 ``torch.matmul`` rate with TF32 off
(an 8192^3 product) and the device-to-device copy rate of 1 GiB (bytes read
plus bytes written), each the median of 10 timed runs after warm-up, the
four-step kernel's share of its radix-FFT bound at (8193, 16384), and the
cost of one NCCL ``all_to_all_single`` call of 1 KiB at world size 1 (the
median of 5 runs of 200 calls, with the 5). These are the ``flops``,
``hbm_bw``, ``fft_share`` and ``collective_lat`` of
``repro_torch.core.plan.H100`` (whose ``collective_lat`` is the median
across 4 cards, from ``scripts/dist_times.py``). It needs a GPU. With ``--gloo`` it measures
only the call cost of gloo on the CPU, the ``collective_lat`` of
``CPU_LOCAL``.
"""

from __future__ import annotations

import datetime
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Callable

import torch
import torch.distributed as dist


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
    return dict({"card": card_label(),
                 "matmul_f32_flops": 2.0 * n ** 3 / (mm_ms * 1e-3),
                 "matmul_ms": mm_ms,
                 "copy_bytes_per_s": nbytes / (copy_ms * 1e-3),
                 "copy_ms": copy_ms}, **four_step_share())


def four_step_share(hw=None) -> dict:
    """The four-step kernel's share of its radix-FFT bound,
    max(5*B*n*log2(n) / flops, 16*B*n / hbm_bw) at the profile's (default
    ``H100``'s) rates, at the rfftn 16384^2 column pass: B = 8193 rows of
    n = 16384, factors (128, 128). The ``fft_share`` the estimate prices
    the kernel's passes with."""
    from .core.plan import H100
    from .kernels.dft_matmul import fft_four_step
    hw = hw or H100
    b, n = 8193, 16384
    g = torch.Generator(device="cuda").manual_seed(0)
    x = tuple(torch.randn(b, n, device="cuda", generator=g) for _ in "ri")
    ms = time_ms(lambda: fft_four_step(x, (128, 128)))
    bound_s = max(5.0 * b * n * math.log2(n) / hw.flops,
                  16.0 * b * n / hw.hbm_bw)
    return {"four_step_ms": ms, "four_step_share": bound_s / (ms * 1e-3)}


def collective_latency(device: torch.device, group=None,
                       reps: int = 200) -> float:
    """Seconds per ``all_to_all_single`` call of a 1 KiB float32 message
    over ``group`` (the default group when None): ``reps`` calls back to
    back after 20 warm-up calls, ended by a device synchronize, over the
    host clock. At world size 1 the call is a local copy, so this is the
    cost a collective adds beyond its bytes."""
    x = torch.zeros(256, device=device)
    out = torch.empty_like(x)
    for _ in range(20):
        dist.all_to_all_single(out, x, group=group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_to_all_single(out, x, group=group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / reps


def world_of_one_latency(backend: str) -> list:
    """5 :func:`collective_latency` runs at world size 1 in a process group
    of its own (an in-process store, no sockets): NCCL on the current
    card, or gloo on the CPU."""
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    device = torch.device("cuda", torch.cuda.current_device()) \
        if backend == "nccl" else torch.device("cpu")
    try:
        return [collective_latency(device) for _ in range(5)]
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    backend = "gloo" if sys.argv[1:] == ["--gloo"] else "nccl"
    runs = world_of_one_latency(backend)
    lat = {f"{backend}_all_to_all_s": statistics.median(runs),
           f"{backend}_all_to_all_runs_s": runs}
    print(json.dumps(lat if backend == "gloo" else dict(measure(), **lat)))
