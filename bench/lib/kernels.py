"""Device time by kind of kernel, from a reduced trace (``lib.trace``).

The patterns name kernels as the profiler reports them on the card:
cuBLAS's GEMMs (``sm80_xmma_gemm_*``, ``nvjet_*``, ``*sgemm*``, CUTLASS),
their float32 ones (``gemm_f32f32``, ``sgemm``), NCCL's kernels, and the
port's four hand-written kernels (``four_step_big``/``four_step_rows``,
``transpose_kernel``, ``cmul_kernel``, ``fftconv_big``/``fftconv_rows``,
each in an anonymous namespace). A reader whose kernels ran for no time
returns nothing rather than a share of 0 of something absent.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

GEMM = re.compile(r"gemm|nvjet|xmma|cutlass", re.I)
GEMM_F32 = re.compile(r"gemm_f32f32|sgemm", re.I)
NCCL = re.compile(r"nccl", re.I)
PORT = re.compile(r"\(anonymous namespace\)::(four_step_(big|rows)|"
                  r"transpose_kernel|cmul_kernel|fftconv_(big|rows))\b")


def total(trace: Dict) -> float:
    return sum(t for _, t, _ in trace["kernels"])


def seconds(trace: Dict, pattern: re.Pattern) -> float:
    return sum(t for n, t, _ in trace["kernels"] if pattern.search(n))


def share(trace: Dict, pattern: re.Pattern) -> Optional[float]:
    """Percent of the device's kernel time in kernels matching
    ``pattern``; None where the trace holds no device time."""
    whole = total(trace)
    if whole <= 0:
        return None
    return 100.0 * seconds(trace, pattern) / whole


def idle(trace: Dict) -> Optional[float]:
    """Percent of the traced window in which nothing ran on the device."""
    if trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def traces(out: Dict):
    """The reduced traces of a run's chips (empty without a trace)."""
    return [t for t in out.get("traces") or [] if t.get("steps")]
