"""Plain PyTorch version of the complex-multiply kernel: the CPU path and
the oracle the kernel is held against on the card."""

from __future__ import annotations

from ...core import algo


def complex_multiply_ref(a: algo.Complex, b: algo.Complex) -> algo.Complex:
    """``algo.cmul``, with ``b`` broadcast against ``a`` as PyTorch
    broadcasts."""
    return algo.cmul(a, b)
