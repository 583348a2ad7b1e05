"""Exchange arithmetic shared by the planner and the executors.

Port of the single-card part of ``repro.core.comm``: the padding rules that
``NdPlan`` and the pad-and-crop layer use, and the per-element four-step
cost of the N-D roofline. The exchange backends, their planners and
autotuners need several ranks and come with the distributed layer.
"""

from __future__ import annotations

from . import algo


def pad_to(n: int, p: int) -> int:
    """``n`` rounded up to a multiple of ``p`` (collective divisibility)."""
    return -(-n // p) * p


def padded_half(m: int, p: int) -> int:
    """Column count after r2c (m//2+1) padded up to a multiple of p."""
    return pad_to(m // 2 + 1, p)


def fac_sum(n: int) -> float:
    """Four-step MAC count per element for a length-``n`` stage, falling
    back to the direct DFT for lengths the factorizer cannot split (the
    shared cost kernel of the N-D decomposition roofline)."""
    try:
        return float(sum(algo.default_factorization(n)))
    except ValueError:
        return float(n)
