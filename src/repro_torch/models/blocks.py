"""The FFT-convolution mixer (the paper's FFT as a sequence mixer), ported
from ``repro.models.blocks`` (``fftconv_meta``, ``fftconv_fwd``) for one
device: the sequence is never sharded here, so the distributed branch of
the reference waits for the distributed layer.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.fftconv import fft_conv, materialize_filter
from ..core.plan import Planner, resolve_device


class FFTConvMixer(nn.Module):
    """Gated long convolution: ``y = W_out((conv(v, k) + v * skip) *
    silu(g))`` with ``(v, g) = x @ W_in`` and the causal filters ``k``
    materialised from ``filt`` (D, rank) over the sequence length.

    Parameters and their initialisation follow ``fftconv_meta``: ``w_in``
    (d, 2d) and ``w_out`` (d, d) normal with scale 0.02, ``filt`` (d, rank)
    normal with scale 0.2, ``skip`` (d,) ones. They are drawn from
    ``generator`` (a new one seeded 0 when None) on its own device, then
    moved to ``device`` (None: the GPU). On the card the forward pass
    launches the port's kernels, which record nothing for autograd, so it
    raises unless it runs under ``torch.no_grad()``; on the CPU it is plain
    PyTorch and differentiable.
    """

    def __init__(self, d_model: int, rank: int = 16,
                 planner: Optional[Planner] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)

        def normal(shape, scale):
            w = torch.randn(shape, generator=gen, device=gen.device) * scale
            return nn.Parameter(w.to(dev))

        d = d_model
        self.planner = planner
        self.w_in = normal((d, 2 * d), 0.02)
        self.filt = normal((d, rank), 0.2)
        self.skip = nn.Parameter(torch.ones(d, device=dev))
        self.w_out = normal((d, d), 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        s = x.shape[1]
        v, gate = (x @ self.w_in.to(dt)).chunk(2, dim=-1)
        filt = materialize_filter(self.filt.float(), s)
        y = fft_conv(v, filt, planner=self.planner, device=x.device)
        y = y + v * self.skip.to(dt)
        y = y * torch.nn.functional.silu(gate)
        return y @ self.w_out.to(dt)
