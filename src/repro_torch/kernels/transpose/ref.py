"""Plain PyTorch version of the transpose kernel: the CPU path and the
oracle the kernel is held against on the card."""

from __future__ import annotations

import torch


def transpose_ref(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2).contiguous()
