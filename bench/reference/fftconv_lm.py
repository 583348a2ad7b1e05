"""A plain, frozen copy of the FFT-conv LM's training step in PyTorch: the
reference of the training cell, in float32 with TF32 off.

The model, as the port's ``models/lm.py`` with every layer
``fftconv_mlp`` and olmo's non-parametric layer norm:

    x = embed[tokens]
    per layer:  h = LN(x);  v, g = split(h @ w_in)
                k = filt @ basis(S)            (the damped-oscillator basis)
                x = x + ((causal_conv(v, k) + v * skip) * silu(g)) @ w_out
                h = LN(x);  x = x + (silu(h @ w_gate) * (h @ w_up)) @ w_down
    logits = LN(x) @ embed^T;  loss = mean next-token NLL (labels >= 0)

with the causal convolution by ``torch.fft`` over next_pow2(2 S) points,
and AdamW as the port's ``optim/adamw.py`` states it (global-norm
clipping, bias corrections, decoupled weight decay, warmup then cosine).

``precision="fp8"`` is the control: the port's bfloat16 dataflow one step
lower. Every tensor the port holds in its compute dtype (the embedded
tokens, the residual stream after each add, the norms' outputs, the
projections, the MLP's product) and every operand of a matrix product is
rounded to float8 e4m3 with a per-tensor scale, its gradient passed
straight through; what the port computes in float32 (the filters, the
convolution, the loss's reductions, AdamW) stays float32.
Nothing here imports the port.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())


def low(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` in the run's compute precision (float32: unchanged)."""
    return _fp8(t) if precision == "fp8" else t


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return low(low(a, precision) @ low(b, precision), precision)


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


def filter_basis(length: int, rank: int, device) -> torch.Tensor:
    t = torch.arange(length, dtype=torch.float32, device=device)[None] / length
    r = torch.arange(rank, dtype=torch.float32, device=device)[:, None]
    return torch.exp(-torch.exp(0.5 * r) * t) * torch.cos(
        2.0 * math.pi * (r + 1.0) * t)


def causal_conv(v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """y[:, t, c] = sum_{j <= t} k[c, j] v[:, t - j, c]; v (B, S, D),
    k (D, S)."""
    s = v.shape[1]
    n = 1 << (2 * s - 1).bit_length()
    vf = torch.fft.rfft(v, n=n, dim=1)
    kf = torch.fft.rfft(k.T, n=n, dim=0)
    return torch.fft.irfft(vf * kf, n=n, dim=1)[:, :s]


def layer(x, p: Dict[str, torch.Tensor], prefix: str, precision: str):
    d = x.shape[-1]
    h = low(layer_norm(x), precision)
    vg = matmul(h, p[prefix + "mix.w_in"], precision)
    v, g = vg[..., :d], vg[..., d:]
    k = p[prefix + "mix.filt"] @ filter_basis(x.shape[1],
                                              p[prefix + "mix.filt"].shape[1],
                                              x.device)
    y = low(causal_conv(v, k), precision) + v * p[prefix + "mix.skip"]
    y = low(low(y, precision) * F.silu(g), precision)
    x = low(x + matmul(y, p[prefix + "mix.w_out"], precision), precision)
    h = low(layer_norm(x), precision)
    up = low(F.silu(matmul(h, p[prefix + "mlp.w_gate"], precision)) * matmul(
        h, p[prefix + "mlp.w_up"], precision), precision)
    return low(x + matmul(up, p[prefix + "mlp.w_down"], precision), precision)


def loss(p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
         num_layers: int, vocab: int,
         precision: str = "float32") -> torch.Tensor:
    x = low(p["embed"][batch["tokens"]], precision)
    for i in range(num_layers):
        x = checkpoint(layer, x, p, f"layers.{i}.", precision,
                       use_reentrant=False)
    # the embedding's rows past the vocabulary (padding) are no token
    logits = matmul(low(layer_norm(x), precision), p["embed"][:vocab].T,
                    precision)
    labels = batch["labels"]
    mask = labels >= 0
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels.clamp(min=0)[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1)


def lr_at(opt: Dict, step: int) -> float:
    warm = step / max(opt["warmup_steps"], 1)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    cos = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return opt["lr"] * (warm if step < opt["warmup_steps"] else cos)


def train(p: Dict[str, torch.Tensor], batches: List[Dict[str, torch.Tensor]],
          num_layers: int, vocab: int, opt: Dict,
          precision: str = "float32") -> Dict:
    """AdamW steps on ``batches`` from the weights ``p`` (trained in
    place): {"losses", "grads" (each leaf's first gradient as the
    optimizer takes it, clipped), "raw" (unclipped)}."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for t in p.values():
            t.requires_grad_(True)
        mu = {n: torch.zeros_like(t) for n, t in p.items()}
        nu = {n: torch.zeros_like(t) for n, t in p.items()}
        losses, first = [], None
        for step, batch in enumerate(batches, start=1):
            value = loss(p, batch, num_layers, vocab, precision)
            grads = torch.autograd.grad(value, list(p.values()))
            losses.append(float(value.item()))
            with torch.no_grad():
                gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
                scale = min(opt["clip_norm"] / max(float(gnorm), 1e-9), 1.0)
                lr = lr_at(opt, step)
                bc1 = 1 - opt["b1"] ** step
                bc2 = 1 - opt["b2"] ** step
                if first is None:
                    first = {"grads": {n: float(g.norm()) * scale
                                       for n, g in zip(p, grads)},
                             "raw": {n: float(g.norm())
                                     for n, g in zip(p, grads)}}
                for (n, t), g in zip(p.items(), grads):
                    g = g * scale
                    mu[n].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                    nu[n].mul_(opt["b2"]).add_((1 - opt["b2"]) * g.square())
                    u = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + opt["eps"])
                    t.sub_(lr * (u + opt["weight_decay"] * t))
            del grads
        for t in p.values():
            t.requires_grad_(False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return {"losses": losses, **first}
