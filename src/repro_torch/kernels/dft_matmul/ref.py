"""Plain PyTorch version of the four-step FFT kernel: the CPU path and the
oracle the kernel is held against on the card."""

from __future__ import annotations

from typing import Tuple

from ...core import algo


def fft_four_step_ref(x: algo.Complex, factors: Tuple[int, int], *,
                      karatsuba: bool = False,
                      permuted: bool = False) -> algo.Complex:
    """The core four-step algorithm with a two-factor split."""
    return algo.fft(x, factors=factors, karatsuba=karatsuba,
                    permuted=permuted)
