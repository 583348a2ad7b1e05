"""Transformer building blocks, ported from ``repro.models.blocks``: norms,
RoPE and M-RoPE, GQA attention (flash-style chunked for long prefill), the
SwiGLU / GELU MLP, the capacity-based top-k MoE, and the FFT-convolution
mixer (the paper's FFT as a sequence mixer) with its one-token decode step
and the reference's sequence-sharded branch.

Each function takes its parameters as a mapping (an ``nn.ParameterDict``
in the LM) under the reference's names. Attention is plain JAX in the
reference, with no Pallas kernel, so its port is plain PyTorch. Where the
reference asks an einsum for float32 results of bfloat16 operands
(``preferred_element_type``), the port rounds the operands as the
reference does and multiplies them in float32, which is exact for the
products. The out-projections multiply in the compute dtype, which
accumulates in float32 and rounds once, as the reference's float32 result
cast back does; its ``reduce_dtype`` only changes the partial sums that
cross devices and waits for the port of ``parallel/``, and so does
the MoE's expert parallelism: on one device its dispatch is a scatter
into (E, capacity, d) buffers and its combine a gather.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.comm import mesh_sizes
from ..core.fftconv import fft_conv, fft_conv_seq_sharded, materialize_filter
from ..core.plan import Planner, resolve_device
from .config import ArchConfig
from .params import ParamMeta, make_param

Params = Mapping[str, torch.Tensor]


def _write_at(buf: torch.Tensor, u: torch.Tensor,
              start: torch.Tensor) -> torch.Tensor:
    """``buf[b, start[b]:start[b] + S] = u[b]`` for every row b, in place,
    each start clamped so that the slice fits, as the reference's
    ``dynamic_update_slice`` clamps it. Returns ``buf``."""
    s = u.shape[1]
    start = start.long().clamp(0, buf.shape[1] - s)
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf[rows, start[:, None] + torch.arange(s, device=buf.device)] = \
        u.to(buf.dtype)
    return buf


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_meta(cfg: ArchConfig) -> Dict[str, ParamMeta]:
    d = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": ParamMeta((d,), init="ones")}
    if cfg.norm == "layernorm":
        return {"scale": ParamMeta((d,), init="ones"),
                "bias": ParamMeta((d,), init="zeros")}
    return {}  # nonparam_ln (olmo): no learnable parameters


def apply_norm(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"].float()
    else:
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, correction=0, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + 1e-5)
        if cfg.norm == "layernorm":
            y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def _rope_angles(positions: torch.Tensor, hd: int,
                 theta: float = 1e4) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin (..., S, hd//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=positions.device) / hd))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def _mrope_angles(positions3: torch.Tensor, hd: int,
                  sections: Tuple[int, ...],
                  theta: float = 1e4) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE (qwen2-vl): positions3 (3, B, S) -> cos/sin (B, S, hd//2).

    ``sections`` give the number of frequency slots (out of hd//2) driven
    by the temporal / height / width position streams respectively.
    """
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not cover the "
                         f"{hd // 2} frequencies of a head of {hd}")
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=positions3.device) / hd))
    ang = positions3[..., None].float() * inv                   # (3,B,S,hd/2)
    sel = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                       device=positions3.device)
    ang = ang.gather(0, sel.expand((1,) + ang.shape[1:]))[0]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd); cos/sin (B, S, hd//2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def rope_tables(cfg: ArchConfig, positions: torch.Tensor):
    if cfg.rope == "none":
        return None
    if cfg.rope == "mrope":
        if positions.dim() == 2:                        # text-only: t=h=w
            positions = positions[None].expand((3,) + positions.shape)
        return _mrope_angles(positions, cfg.hd, cfg.mrope_sections)
    return _rope_angles(positions, cfg.hd)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def attention_meta(cfg: ArchConfig) -> Dict[str, ParamMeta]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    m = {"wq": ParamMeta((d, h, hd)), "wk": ParamMeta((d, kv, hd)),
         "wv": ParamMeta((d, kv, hd)), "wo": ParamMeta((h, hd, d))}
    if cfg.qkv_bias:
        m["bq"] = ParamMeta((h, hd), init="zeros")
        m["bk"] = ParamMeta((kv, hd), init="zeros")
        m["bv"] = ParamMeta((kv, hd), init="zeros")
    return m


def _qkv(p: Params, cfg: ArchConfig, x: torch.Tensor, rope) -> Tuple:
    dt = x.dtype

    def proj(w):                        # einsum("bsd,dhk->bshk")
        return (x @ w.to(dt).flatten(1)).unflatten(-1, w.shape[1:])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _out_proj(p: Params, out: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", out, wo) in out's dtype."""
    return out.flatten(2) @ p["wo"].to(out.dtype).flatten(0, 1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_kv: int = 1024,
                    q_offset: int = 0) -> torch.Tensor:
    """Chunked online-softmax attention (the reference's pure-JAX flash).

    q (B, Sq, H, hd); k/v (B, Sk, KV, hd) with H = KV * G. Memory is
    O(Sq * block_kv) instead of O(Sq * Sk). ``block_kv`` shrinks to the
    largest divisor of Sk not above it, as in the reference.
    """
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k.shape
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qr = q.reshape(b, sq, kvh, g, hd).float() * scale
    qk = qr.to(k.dtype).float()

    block_kv = min(block_kv, sk)
    while sk % block_kv:
        block_kv -= 1
    q_pos = q_offset + torch.arange(sq, device=q.device)

    acc = torch.zeros((b, sq, kvh, g, hd), dtype=torch.float32,
                      device=q.device)
    m_run = torch.full((b, sq, kvh, g), -1e30, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, sq, kvh, g), dtype=torch.float32,
                        device=q.device)
    for j in range(sk // block_kv):
        blk = slice(j * block_kv, (j + 1) * block_kv)
        s = torch.einsum("bqkgd,bskd->bqkgs", qk, k[:, blk].float())
        if causal:
            kv_pos = j * block_kv + torch.arange(block_kv, device=q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]
            s = torch.where(mask[None, :, None, None, :], s, -1e30)
        m_new = torch.maximum(m_run, s.amax(-1))
        pexp = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgs,bskd->bqkgd", pexp.to(v.dtype).float(), v[:, blk].float())
        l_run = l_run * corr + pexp.sum(-1)
        m_run = m_new
    out = acc / l_run.clamp_min(1e-30)[..., None]
    return out.reshape(b, sq, h, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a (B, S, KV, hd) cache."""
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k_cache.shape
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qr = (q.reshape(b, sq, kvh, g, hd) * scale).to(k_cache.dtype)
    s = torch.einsum("bqkgd,bskd->bqkgs", qr.float(), k_cache.float())
    mask = (torch.arange(sk, device=q.device)[None, :]
            < cache_len[:, None])                               # (B, S)
    s = torch.where(mask[:, None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgs,bskd->bqkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def attention_fwd(p: Params, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, cache: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (output, updated cache). cache=None -> causal
    self-attention; else x's k/v are written into the cache's (B, S, KV,
    hd) ``k``/``v`` at ``len`` (in place) and attended to up to it."""
    rope = rope_tables(cfg, positions)
    q, k, v = _qkv(p, cfg, x, rope)
    if cache is None:
        out = flash_attention(q, k, v, causal=True)
    else:
        idx = cache["len"]                                      # (B,)
        kc = _write_at(cache["k"], k, idx)
        vc = _write_at(cache["v"], v, idx)
        out = decode_attention(q, kc, vc, idx + 1)
        cache = {"k": kc, "v": vc, "len": idx + 1}
    return _out_proj(p, out), cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------


def mlp_meta(cfg: ArchConfig) -> Dict[str, ParamMeta]:
    d, f = cfg.d_model, cfg.d_ff
    m = {"w_up": ParamMeta((d, f)), "w_down": ParamMeta((f, d))}
    if cfg.mlp_act == "silu":
        m["w_gate"] = ParamMeta((d, f))
    return m


def mlp_fwd(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    up = x @ p["w_up"].to(dt)
    if cfg.mlp_act == "silu":
        up = F.silu(x @ p["w_gate"].to(dt)) * up
    else:
        up = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    return up @ p["w_down"].to(dt)


# ---------------------------------------------------------------------------
# MoE: top-k routing, capacity dispatch
# ---------------------------------------------------------------------------


def moe_meta(cfg: ArchConfig) -> Dict[str, ParamMeta]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": ParamMeta((d, e), scale=0.02 / math.sqrt(d)),
            "w_up": ParamMeta((e, d, f)),
            "w_gate": ParamMeta((e, d, f)),
            "w_down": ParamMeta((e, f, d))}


@contextlib.contextmanager
def _full_float32_matmul():
    """Float32 products in float32 on the card (TF32 off) for the block,
    whatever the process's setting: the router's top-k must not depend on
    it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def moe_capacity(cfg: ArchConfig, tokens: int) -> int:
    """Slots an expert has for ``tokens`` tokens of one group: capacity
    factor x tokens x top_k / experts, at least 4, at most tokens x top_k."""
    k = cfg.top_k
    cap = max(int(cfg.capacity_factor * tokens * k / cfg.num_experts), 4)
    return min(cap, tokens * k)


def moe_route(p: Params, cfg: ArchConfig, xt: torch.Tensor):
    """The routing of each group's tokens, xt (G, Tg, d): (gates (G, Tg, E)
    of the float32 router softmax, weights (G, Tg, k) of the top_k experts
    renormalised, experts (G, Tg, k) with ties to the lower index as
    ``lax.top_k``, slot (G, Tg*k) of each (token, choice) in its expert's
    buffer in token-major order, keep (G, Tg*k): whether that slot is
    within the expert's capacity, ``moe_capacity``)."""
    g, tg, _ = xt.shape
    e, k = cfg.num_experts, cfg.top_k
    with _full_float32_matmul():
        logits = xt.float() @ p["router"].float()
    gates = torch.softmax(logits, dim=-1)                       # (G, Tg, E)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]                   # (G, Tg, K)
    topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    flat = F.one_hot(topi.reshape(g, tg * k), e)                # (G, Tg*K, E)
    pos = ((flat.cumsum(1) - flat) * flat).sum(-1)              # (G, Tg*K)
    return gates, topv, topi, pos, pos < moe_capacity(cfg, tg)


def moe_fwd(p: Params, cfg: ArchConfig, x: torch.Tensor, num_groups: int = 1
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out, float32 aux loss): the reference's GShard-style
    grouped dispatch on one device.

    The B*S tokens split into ``num_groups`` groups (shrunk to a divisor)
    and are routed by ``moe_route``: a choice past its expert's capacity
    is dropped, so the output of a token depends on the tokens before it
    in its group.
    """
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    t = b * s
    g = num_groups
    while t % g:
        g -= 1
    tg = t // g
    cap = moe_capacity(cfg, tg)

    xt = x.reshape(g, tg, d)
    gates, topv, topi, pos, keep = moe_route(p, cfg, xt)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = gates.mean(1)                                          # (G, E)
    ce = F.one_hot(topi[..., 0], e).float().mean(1)
    aux = e * (me * ce).sum(-1).mean()

    # dispatch: a dropped choice goes to a spare slot past the capacity
    eid = topi.reshape(g, tg * k)
    grp = torch.arange(g, device=x.device)[:, None]
    buf = x.new_zeros((g, e, cap + 1, d))
    buf[grp, eid, torch.where(keep, pos, cap)] = \
        xt.repeat_interleave(k, dim=1)
    # expert-major: one batched product an expert over its G x C slots
    ebuf = buf[:, :, :cap].transpose(0, 1).reshape(e, g * cap, d)
    dt = x.dtype
    h = ebuf @ p["w_up"].to(dt)
    h = F.silu(ebuf @ p["w_gate"].to(dt)) * h
    eout = (h @ p["w_down"].to(dt)).reshape(e, g, cap, d).transpose(0, 1)

    # combine: each kept choice's row, weighted, summed over the choices
    got = eout[grp, eid, torch.where(keep, pos, 0)] * keep[..., None].to(dt)
    got = got.reshape(g, tg, k, d) * topv[..., None].to(dt)
    return got.sum(2).reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# FFT-convolution mixer (paper technique in the LM stack)
# ---------------------------------------------------------------------------


def fftconv_meta(d_model: int, rank: int) -> Dict[str, ParamMeta]:
    """The reference's ``fftconv_meta(cfg)`` at ``cfg.d_model`` and
    ``cfg.fftconv_rank``."""
    d = d_model
    return {"w_in": ParamMeta((d, 2 * d)),
            "filt": ParamMeta((d, rank), scale=0.2),
            "skip": ParamMeta((d,), init="ones"),
            "w_out": ParamMeta((d, d))}


class FFTConvMixer(nn.Module):
    """Gated long convolution: ``y = W_out((conv(v, k) + v * skip) *
    silu(g))`` with ``(v, g) = x @ W_in`` and the causal filters ``k``
    materialised from ``filt`` (D, rank) over the sequence length.

    Parameters and their initialisation follow ``fftconv_meta``: ``w_in``
    (d, 2d) and ``w_out`` (d, d) normal with scale 0.02, ``filt`` (d, rank)
    normal with scale 0.2, ``skip`` (d,) ones. They are drawn from
    ``generator`` (a new one seeded 0 when None) on its own device, then
    moved to ``device`` (None: the GPU). The unsharded forward pass is
    differentiable on every device (``fft_conv`` carries its backward over
    the port's kernels); the sharded branch has no backward yet and raises
    under grad.

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
        self.planner = planner
        for name, meta in fftconv_meta(d_model, rank).items():
            setattr(self, name, nn.Parameter(make_param(meta, gen, dev)))

    def project(self, x: torch.Tensor):
        """(v, gate): ``x @ w_in`` split in two."""
        return (x @ self.w_in.to(x.dtype)).chunk(2, dim=-1)

    def forward(self, x: torch.Tensor,
                seq_axis_sharded: bool = False) -> torch.Tensor:
        return self.mix(*self.project(x), seq_axis_sharded=seq_axis_sharded)

    def mix(self, v: torch.Tensor, gate: torch.Tensor,
            seq_axis_sharded: bool = False) -> torch.Tensor:
        """The mixer's output from its projection (``project``)."""
        dt = v.dtype
        if seq_axis_sharded and self.mesh is not None:
            s = v.shape[1] * mesh_sizes(self.mesh)[self.axis]
            filt = materialize_filter(self.filt.float(), s)
            y = fft_conv_seq_sharded(v, filt, self.mesh, self.axis,
                                     planner=self.planner, comm=self.comm)
        else:
            filt = materialize_filter(self.filt.float(), v.shape[1])
            y = fft_conv(v, filt, planner=self.planner, device=v.device)
        y = y + v * self.skip.to(dt)
        y = y * F.silu(gate)
        return y @ self.w_out.to(dt)

    def decode(self, x: torch.Tensor, hist: torch.Tensor,
               pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One-token long-conv step (the reference's ``fftconv_decode``):
        y_t = sum_{j<=t} k[t-j] v_j over the cached value history, with the
        filters materialised over the history's length. x (B, 1, d); hist
        (B, S_max, d), updated in place with this step's v at ``pos``; pos
        (B,) the current index. Returns (output, hist)."""
        dt = x.dtype
        s_max = hist.shape[1]
        v, gate = self.project(x)
        hist = _write_at(hist, v, pos)
        filt = materialize_filter(self.filt.float(), s_max)     # (d, S)
        # the taps by lag, gathered in the history's (B, S, d) layout: lags
        # past the end take the last tap (the reference clips them), and
        # negative ones the zero row appended at index S
        taps = torch.cat([filt.T, filt.new_zeros((1, filt.shape[0]))])
        lag = (pos.long()[:, None]
               - torch.arange(s_max, device=x.device)[None, :])  # (B, S)
        kk = taps[torch.where(lag >= 0, lag.clamp(max=s_max - 1), s_max)]
        y = (hist * kk).sum(1, keepdim=True)                    # float32
        y = y.to(dt) + v * self.skip.to(dt)
        y = y * F.silu(gate)
        return y @ self.w_out.to(dt), hist
