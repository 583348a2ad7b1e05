"""Plain PyTorch versions of the fused FFT-convolution kernel.

``fftconv_fused_plain`` runs the kernel's own schedule (forward four-step
without the digit transpose, the product, the inverse that consumes the
permuted order, the real part): the CPU path, and what the kernel is held
against on the card. ``fftconv_fused_ref`` is the oracle through
``torch.fft``, as the reference's ``fftconv/ref.py`` is through
``jnp.fft``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...core import algo


def filter_spectrum_plain(h: torch.Tensor, factors: Tuple[int, int]
                          ) -> algo.Complex:
    """Real filter (nf,) -> its spectrum in the permuted order C[k1, k2]."""
    h = h.float()
    return algo.fft((h, torch.zeros_like(h)), factors=factors, permuted=True)


def fftconv_fused_plain(x: torch.Tensor, h_spec: algo.Complex,
                        factors: Tuple[int, int]) -> torch.Tensor:
    """Circular convolution of real rows x (B, nf) with the filter whose
    permuted-order spectrum is ``h_spec``; real (B, nf)."""
    x = x.float()
    xf = algo.fft((x, torch.zeros_like(x)), factors=factors, permuted=True)
    return algo.ifft_from_permuted(algo.cmul(xf, h_spec), factors=factors)[0]


def fftconv_fused_ref(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Circular convolution via the complex FFT (rows of x with filter h)."""
    xf = torch.fft.fft(x.float(), dim=-1)
    hf = torch.fft.fft(h.float())
    return torch.fft.ifft(xf * hf[None, :], dim=-1).real.float()
