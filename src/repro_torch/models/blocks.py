"""The FFT-convolution mixer (the paper's FFT as a sequence mixer), ported
from ``repro.models.blocks`` (``fftconv_meta``, ``fftconv_fwd``), with the
reference's sequence-sharded branch. The reference finds its mesh and the
sequence axis through the model stack's context (``current_mesh``,
``current_rules``); the port, which has no model stack yet, is given them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.comm import mesh_sizes
from ..core.fftconv import fft_conv, fft_conv_seq_sharded, materialize_filter
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

    ``mesh`` and ``axis`` name the ``DeviceMesh`` axis the sequence is
    sharded over, and ``comm`` the exchange backend of the sharded
    convolution (``fft_conv_seq_sharded``). ``forward(x,
    seq_axis_sharded=True)`` with a mesh takes this rank's (B, S/p, d)
    block of the sequence and returns its block of the output, on the
    mesh's device; as in the reference, without a mesh the flag is
    ignored and the convolution runs on one device.
    """

    def __init__(self, d_model: int, rank: int = 16,
                 planner: Optional[Planner] = None, device=None,
                 generator: Optional[torch.Generator] = None,
                 mesh=None, axis: Optional[str] = None,
                 comm="collective"):
        super().__init__()
        if mesh is not None and axis is None:
            raise ValueError("a mesh needs the axis the sequence is sharded "
                             "over")
        self.mesh, self.axis, self.comm = mesh, axis, comm
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

    def forward(self, x: torch.Tensor,
                seq_axis_sharded: bool = False) -> torch.Tensor:
        dt = x.dtype
        v, gate = (x @ self.w_in.to(dt)).chunk(2, dim=-1)
        if seq_axis_sharded and self.mesh is not None:
            s = x.shape[1] * mesh_sizes(self.mesh)[self.axis]
            filt = materialize_filter(self.filt.float(), s)
            y = fft_conv_seq_sharded(v, filt, self.mesh, self.axis,
                                     planner=self.planner, comm=self.comm)
        else:
            filt = materialize_filter(self.filt.float(), x.shape[1])
            y = fft_conv(v, filt, planner=self.planner, device=x.device)
        y = y + v * self.skip.to(dt)
        y = y * torch.nn.functional.silu(gate)
        return y @ self.w_out.to(dt)
