"""Public wrapper of the tiled transpose kernel.

A CUDA tensor launches the hand-written kernel (``transpose.cu``); a build
or launch failure raises. A CPU tensor runs the plain PyTorch version in
``ref.py``, which is what a caller asks for by putting data on the CPU.
"""

from __future__ import annotations

import math

import torch

from .._grad import refuse_autograd
from . import binding
from .ref import transpose_ref

#: kernel launches since the last reset (the CPU path does not count)
LAUNCHES = 0


def transpose(x: torch.Tensor) -> torch.Tensor:
    """(..., n, m) -> (..., m, n), contiguous, bit-exact for any dtype of
    1, 2, 4 or 8 bytes."""
    global LAUNCHES
    if x.dim() < 2:
        raise ValueError(f"transpose needs (..., n, m), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return transpose_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"transpose runs on CUDA or the CPU, got {x.device}")
    if x.element_size() not in (1, 2, 4, 8) or x.is_complex():
        raise TypeError(f"transpose moves 1/2/4/8-byte real elements, got "
                        f"{x.dtype}")
    refuse_autograd("transpose", x)
    *batch, n, m = x.shape
    src = x.contiguous()
    out = torch.empty((*batch, m, n), dtype=x.dtype, device=x.device)
    if out.numel():
        lib = binding.lib()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.batched_transpose(src.data_ptr(), out.data_ptr(),
                                       math.prod(batch), n, m,
                                       x.element_size(), stream)
        if rc:
            raise RuntimeError(
                "batched_transpose launch failed: "
                + lib.batched_transpose_error_string(rc).decode())
        LAUNCHES += 1
    return out
