"""The kernels record nothing for autograd: their outputs carry no
``grad_fn``. A wrapper about to launch one calls :func:`refuse_autograd`
so that a caller who asked for gradients gets an error, not gradients that
silently leave the kernel's op out. The CPU path runs plain PyTorch and is
differentiable. A caller that needs gradients on the card goes through an
op that carries its own backward: ``core.fftconv.fft_conv`` and
``fft_conv_seq_sharded`` (and with them both branches of
``FFTConvMixer``) are ``torch.autograd.Function``s whose forward and
backward launch these kernels with autograd off.
"""

from __future__ import annotations

import torch


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd is on and one of ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} launches a CUDA kernel that records no autograd, but "
            "an input requires grad: run it under torch.no_grad() (or on "
            "the CPU, whose plain path is differentiable)")
