"""The operations and bytes the benchmark counts from a cell's shapes, and
the published peaks it holds them against.

FFT operations follow FFTW's convention: 5 N log2 N for a complex
transform of N points, 2.5 N log2 N for a real one (r2c or c2r). A
transform's least bytes are its input read once and its output written
once, in float32 (a complex value is a pair of float32).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAKS = {"fp32_flops": 67e12, "bf16_flops": 989e12, "hbm_bytes": 3.35e12}


def fftw_flops(shape: Sequence[int], kind: str) -> float:
    """FFTW-convention operations of one transform of ``shape``; ``kind``
    is c2c, r2c or c2r."""
    n = math.prod(shape)
    ops = 5.0 * n * math.log2(n)
    return ops / 2 if kind in ("r2c", "c2r") else ops


def fft_bytes(shape: Sequence[int], kind: str) -> float:
    """Least bytes of one transform: input read once, output written once."""
    n = math.prod(shape)
    half = n // shape[-1] * (shape[-1] // 2 + 1)
    real, cplx = 4.0, 8.0
    if kind == "c2c":
        return 2 * cplx * n
    if kind == "r2c":
        return real * n + cplx * half
    if kind == "c2r":
        return cplx * half + real * n
    raise ValueError(kind)


def least_seconds(flops: float, nbytes: float, flop_rate: float) -> float:
    """The roofline's least time: the larger of the operations at
    ``flop_rate`` and the bytes at the HBM rate."""
    return max(flops / flop_rate, nbytes / PEAKS["hbm_bytes"])


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def lm_matmul_params(cfg: Dict) -> int:
    """Parameters of the FFT-conv LM that enter matrix products with the
    tokens: per layer the mixer's w_in (d, 2d) and w_out (d, d), the
    SwiGLU MLP's w_up, w_gate (d, f) and w_down (f, d); and the head (the
    tied embedding's rows of the vocabulary, used once; the port's padding
    rows are not the model's work)."""
    d, f = cfg["d_model"], cfg["d_ff"]
    per_layer = 3 * d * d + 3 * d * f
    return cfg["num_layers"] * per_layer + cfg["vocab_size"] * d


def lm_conv_flops(cfg: Dict, batch: int, seq: int) -> float:
    """FFTW-convention operations of the mixers' FFT convolutions in one
    training step, forward and backward: per layer, the forward transforms
    the activations (batch x d rows) and the filters (d rows) and inverts
    the product (batch x d rows); the backward transforms the incoming
    gradient and inverts two products, one per batch row and one summed
    over the batch. Each is a c2c transform of next_pow2(2 seq) points."""
    nf = next_pow2(2 * seq)
    rows = 2 * (2 * batch + 1) * cfg["d_model"]
    return cfg["num_layers"] * rows * fftw_flops((nf,), "c2c")


def lm_step_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Model operations of one training step: 6 x the parameters in
    matrix products x the tokens, plus the FFT convolutions; recomputation
    under remat is not counted."""
    tokens = batch * seq
    return 6.0 * lm_matmul_params(cfg) * tokens + lm_conv_flops(cfg, batch,
                                                                 seq)
