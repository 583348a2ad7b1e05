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
cast back does.

Tensor parallelism over the mesh's ``model`` axis (``TensorParallel``)
covers attention (heads), the MLP (d_ff), the MoE (experts) and the
FFT-conv mixer (channels), in the forward pass and in decoding: the LM
holds each rank's block of the column- and row-sharded weights, a
column-parallel input passes through ``CopyToRanks`` (identity, gradient
summed over the axis) and a row-parallel output through ``AllReduce``
(summed, gradient the identity), its partials cast to ``_reduce_pe(cfg)``
first. The MoE runs each data rank's tokens as one of the reference's
``num_groups`` groups; its dispatch is a scatter into (E, capacity, d)
buffers and its combine a gather. ``Runs`` describes how a weight is cut:
runs along one dim, each cut over ``model`` or whole on every rank (the
recurrent mixers of ``ssm`` keep some whole inside a cut weight, whose
gradients ``TensorParallel.sync`` sums over ``model``).

The flash-decoding layout (``SeqShard``): a decode cache whose sequence
axis is cut over the data ranks. Each rank writes a new token's k/v (or
v) only where it owns the position and attends to its own positions; the
ranks' partials are merged by ``lse_combine`` (attention) or summed (the
FFT-conv taps), in float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..core.comm import mesh_sizes
from ..core.fftconv import fft_conv, fft_conv_seq_sharded, materialize_filter
from ..core.plan import Planner, resolve_device
from .config import ArchConfig
from .params import ParamMeta, make_param

Params = Mapping[str, torch.Tensor]


def _reduce_pe(cfg: ArchConfig) -> torch.dtype:
    """The dtype in which a tensor-parallel out-projection's partial sums
    cross ranks: ``cfg.reduce_dtype``, else float32 (training keeps float32
    partials; serving may opt into bfloat16, halving the wire bytes)."""
    return getattr(torch, cfg.reduce_dtype) if cfg.reduce_dtype \
        else torch.float32


# ---------------------------------------------------------------------------
# tensor parallelism over the mesh's "model" axis
# ---------------------------------------------------------------------------


class AllReduce(torch.autograd.Function):
    """SUM over each process group of ``groups`` in turn; the backward is
    the identity. The row-parallel side of tensor parallelism (each rank's
    partial output summed) and the loss's sums over the data ranks."""

    @staticmethod
    def forward(ctx, x, groups):
        x = x.clone()
        for group in groups:
            dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class CopyToRanks(torch.autograd.Function):
    """The identity, whose backward sums the gradient over each group of
    ``groups``: the column-parallel side, for a tensor whole on every rank
    that each rank uses only in part."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


class GatherFromRanks(torch.autograd.Function):
    """The whole tensor from each rank's block along ``dim`` (all-gather
    over ``group``); the backward keeps this rank's block of the gradient,
    for a whole tensor that every rank of the group uses alike."""

    @staticmethod
    def forward(ctx, x, group, dim):
        n, me = dist.get_world_size(group), dist.get_rank(group)
        ctx.dim, ctx.n, ctx.me = dim, n, me
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.dim)[ctx.me].contiguous(), None, None


@dataclasses.dataclass(frozen=True)
class Runs:
    """How a weight is laid out over ``model``: its dim ``dim`` is
    ``runs`` end to end, each (length, cut). A cut run gives each rank
    its 1/tp block of it, a whole one stands on every rank; a rank holds
    its share of each run in their order (``w_in``'s v and gate columns:
    two cut runs; Mamba2's ``in_proj`` columns ``[z | x | B C | dt]``: its
    heads' z, x and dt, and B and C whole)."""
    dim: int
    runs: Tuple[Tuple[int, bool], ...]

    @classmethod
    def cut(cls, dim: int, *lengths: int) -> "Runs":
        """``dim`` as runs of ``lengths``, all cut (one: a plain block)."""
        return cls(dim, tuple((n, True) for n in lengths))

    @property
    def mixed(self) -> bool:
        """Whether whole runs stand beside cut ones."""
        return len({cut for _, cut in self.runs}) > 1

    def local(self, size: int) -> Tuple[int, ...]:
        """Each run's length on a rank of a ``model`` axis of ``size``."""
        return tuple(n // size if cut else n for n, cut in self.runs)

    def block(self, t: torch.Tensor, size: int, rank: int) -> torch.Tensor:
        """Rank ``rank``'s block of the whole ``t``."""
        pieces = t.split([n for n, _ in self.runs], self.dim)
        return torch.cat([p.chunk(size, self.dim)[rank] if cut else p
                          for p, (_, cut) in zip(pieces, self.runs)],
                         self.dim)

    def join(self, parts) -> torch.Tensor:
        """The whole tensor from every rank's ``block``, in rank order (a
        whole run from the first)."""
        split = [p.split(self.local(len(parts)), self.dim) for p in parts]
        return torch.cat([torch.cat([s[i] for s in split], self.dim) if cut
                          else split[0][i]
                          for i, (_, cut) in enumerate(self.runs)], self.dim)

    def weight(self, size: int) -> torch.Tensor:
        """Per position of a rank's block along ``dim``: 1 in a cut run,
        1/size in a whole one (what counts each element once in a sum of
        squares over the ranks: ``optim.adamw.global_norm``)."""
        return torch.cat([torch.full((n,), 1.0 if cut else 1.0 / size)
                          for n, (_, cut) in zip(self.local(size),
                                                 self.runs)])


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the mesh's ``model`` axis: its process group,
    the axis's size and this rank's index on it."""
    group: Any
    size: int
    rank: int

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return CopyToRanks.apply(x, (self.group,))

    def reduce(self, y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The sum of every rank's partial ``y``, summed in ``dtype``."""
        return AllReduce.apply(y.to(dtype), (self.group,)).to(y.dtype)

    def sum_squares(self, y: torch.Tensor) -> torch.Tensor:
        """The float32 sum of squares of ``y`` over its last dim, whose
        channels the ranks hold in blocks: summed over ``model``, and so is
        its gradient (every rank's channels depend on it)."""
        ss = y.float().square().sum(-1, keepdim=True)
        return self.copy(self.reduce(ss, torch.float32))

    def block(self, t: torch.Tensor, layout: Runs) -> torch.Tensor:
        """This rank's block of the whole ``t`` (``Runs.block``)."""
        return layout.block(t, self.size, self.rank)

    def gather(self, t: torch.Tensor, layout: Runs) -> torch.Tensor:
        """The whole tensor from every rank's ``block`` (all-gather)."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return layout.join(parts)

    def sync(self, w: torch.Tensor, layout: Runs) -> torch.Tensor:
        """``w``, this rank's block, with the gradient of its whole runs
        summed over ``model`` (each rank's is that of its own channels)."""
        if not (layout.mixed and torch.is_grad_enabled()):
            return w
        pieces = w.split(layout.local(self.size), layout.dim)
        return torch.cat([p if cut else self.copy(p)
                          for p, (_, cut) in zip(pieces, layout.runs)],
                         layout.dim)


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """This rank's block of a decode cache's positions in the
    flash-decoding layout: the sequence axis cut into ``size`` equal blocks
    over the data ranks (``groups``, the dp axes in turn), this rank
    holding block ``rank``."""
    groups: Tuple[Any, ...]
    size: int
    rank: int

    def reduce(self, t: torch.Tensor,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced by ``op`` over every block's rank (a new
        tensor)."""
        t = t.contiguous().clone()
        for group in self.groups:
            dist.all_reduce(t, op=op, group=group)
        return t


def lse_combine(m: torch.Tensor, num: torch.Tensor, den: torch.Tensor,
                seq: SeqShard) -> torch.Tensor:
    """Attention over every rank's block of positions from each block's
    float32 partials: ``m`` (..., 1) the block's running max of the scores,
    ``num`` (..., hd) and ``den`` (..., 1) its sums of exp(score - m)
    times v and alone. The max over the blocks is all-reduced with MAX,
    each block's partials rescaled to it, and numerator and denominator
    summed in one all-reduce."""
    top = seq.reduce(m, dist.ReduceOp.MAX)
    scale = torch.exp(m - top)
    both = seq.reduce(torch.cat([num * scale, den * scale], -1))
    return both[..., :-1] / both[..., -1:]


def _write_cache(buf: torch.Tensor, u: torch.Tensor, start: torch.Tensor,
                 seq: Optional[SeqShard]) -> torch.Tensor:
    """One token's ``u`` (B, 1, ...) into a decode cache ``buf`` at
    ``start`` (B,), in place: ``_write_at``, or with ``seq`` (``buf`` this
    rank's block of the positions) only into the rows whose position falls
    in the block. Returns ``buf``."""
    if seq is None:
        return _write_at(buf, u, start)
    local = start.long() - seq.rank * buf.shape[1]
    own = (local >= 0) & (local < buf.shape[1])
    # every row writes: its token where the block owns the position, else
    # what it holds (no data-dependent shape: a meta-device trace runs it)
    at = local.clamp(0, buf.shape[1] - 1)
    rows = torch.arange(buf.shape[0], device=buf.device)
    keep = own.view((-1,) + (1,) * (u.dim() - 2))
    buf[rows, at] = torch.where(keep, u[:, 0].to(buf.dtype), buf[rows, at])
    return buf


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
        return {"scale": ParamMeta((d,), (None,), init="ones")}
    if cfg.norm == "layernorm":
        return {"scale": ParamMeta((d,), (None,), init="ones"),
                "bias": ParamMeta((d,), (None,), init="zeros")}
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
    m = {
        "wq": ParamMeta((d, h, hd), ("fsdp", "tp", None)),
        "wk": ParamMeta((d, kv, hd), ("fsdp", "tp", None)),
        "wv": ParamMeta((d, kv, hd), ("fsdp", "tp", None)),
        "wo": ParamMeta((h, hd, d), ("tp", None, "fsdp")),
    }
    if cfg.qkv_bias:
        m["bq"] = ParamMeta((h, hd), ("tp", None), init="zeros")
        m["bk"] = ParamMeta((kv, hd), ("tp", None), init="zeros")
        m["bv"] = ParamMeta((kv, hd), ("tp", None), init="zeros")
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
                     v_cache: torch.Tensor, cache_len: torch.Tensor,
                     seq: Optional[SeqShard] = None) -> torch.Tensor:
    """Single-token attention against a (B, S, KV, hd) cache; with ``seq``
    the cache is this rank's block of the positions and the blocks'
    partials are merged by ``lse_combine``."""
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k_cache.shape
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qr = (q.reshape(b, sq, kvh, g, hd) * scale).to(k_cache.dtype)
    s = torch.einsum("bqkgd,bskd->bqkgs", qr.float(), k_cache.float())
    first = 0 if seq is None else seq.rank * sk
    mask = (first + torch.arange(sk, device=q.device)[None, :]
            < cache_len[:, None])                               # (B, S)
    mask = mask[:, None, None, None, :]
    s = torch.where(mask, s, -1e30)
    if seq is None:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bqkgs,bskd->bqkgd", p.to(v_cache.dtype).float(),
                           v_cache.float())
    else:
        m = s.amax(-1, keepdim=True)
        e = torch.where(mask, torch.exp(s - m), 0.0)
        num = torch.einsum("bqkgs,bskd->bqkgd", e.to(v_cache.dtype).float(),
                           v_cache.float())
        out = lse_combine(m, num, e.sum(-1, keepdim=True), seq)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _heads_split(p: Params, cfg: ArchConfig,
                 tp: Optional[TensorParallel]) -> bool:
    """Whether this rank holds a block of the heads (tensor parallelism),
    read off the local ``wq``; the rules leave heads whole where the axis
    does not divide them."""
    return tp is not None and p["wq"].shape[1] < cfg.num_heads


def _kv_heads_read(cfg: ArchConfig, tp: TensorParallel, hl: int):
    """Where the axis does not divide the K/V heads (whole on every rank):
    (lo, hi, index), the K/V heads [lo, hi) that this rank's ``hl`` query
    heads read, and each query head's among them, or None for index where
    they group evenly (``hl / (hi - lo)`` consecutive query heads each, as
    GQA groups them)."""
    g = cfg.num_heads // cfg.num_kv_heads
    first = tp.rank * hl
    lo, hi = first // g, (first + hl - 1) // g + 1
    index = [(first + j) // g - lo for j in range(hl)]
    n = hi - lo
    if hl % n == 0 and index == [j // (hl // n) for j in range(hl)]:
        index = None
    return lo, hi, index


def _local_qkv(p: Params, cfg: ArchConfig, x: torch.Tensor, rope,
               tp: Optional[TensorParallel]):
    """(q, k, v, p, split, index): q of this rank's heads (all of them
    without tensor parallelism), k/v of the K/V heads it holds, the
    parameters it uses, whether the heads are split, and the K/V head of
    each query head where they do not group evenly (``_kv_heads_read``).
    The K/V heads a rank holds: its block where the axis divides them,
    else those its query heads read, their weights' gradients summed over
    the axis."""
    split = _heads_split(p, cfg, tp)
    index = None
    if split:
        x = tp.copy(x)
        if p["wk"].shape[1] == cfg.num_kv_heads:        # K/V whole
            lo, hi, index = _kv_heads_read(cfg, tp, p["wq"].shape[1])
            p = dict(p)
            for n in ("wk", "wv"):
                p[n] = tp.copy(p[n])[:, lo:hi]
            for n in ("bk", "bv"):
                if n in p:
                    p[n] = tp.copy(p[n])[lo:hi]
    q, k, v = _qkv(p, cfg, x, rope)
    return q, k, v, p, split, index


def _per_query_head(t: torch.Tensor, index) -> torch.Tensor:
    """K or V (B, S, n, hd) laid out for attention: as it is, or each
    query head's K/V head (``_kv_heads_read``'s index)."""
    return t if index is None else t[:, :, index]


def cached_kv_heads(p: Params, cfg: ArchConfig,
                    tp: Optional[TensorParallel]) -> int:
    """The K/V heads this rank's decode cache holds (``_local_qkv``)."""
    if not _heads_split(p, cfg, tp):
        return cfg.num_kv_heads
    if p["wk"].shape[1] < cfg.num_kv_heads:
        return p["wk"].shape[1]
    lo, hi, _ = _kv_heads_read(cfg, tp, p["wq"].shape[1])
    return hi - lo


def attention_prefill(p: Params, cfg: ArchConfig, x: torch.Tensor, rope,
                      tp: Optional[TensorParallel] = None):
    """(output, k, v): causal self-attention over x, and the k/v of the
    K/V heads this rank holds (``_local_qkv``), for the decode cache."""
    q, k, v, p, split, index = _local_qkv(p, cfg, x, rope, tp)
    out = flash_attention(q, _per_query_head(k, index),
                          _per_query_head(v, index), causal=True)
    y = _out_proj(p, out)
    return (tp.reduce(y, _reduce_pe(cfg)) if split else y), k, v


def attention_fwd(p: Params, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, cache: Optional[Dict] = None,
                  tp: Optional[TensorParallel] = None,
                  seq: Optional[SeqShard] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (output, updated cache). cache=None -> causal
    self-attention; else x's k/v are written into the cache's (B, S, KV,
    hd) ``k``/``v`` at ``len`` (in place) and attended to up to it.

    With ``tp`` and a block of the heads in ``p`` (``wq``, ``wk``, ``wv``
    and the biases column-sharded, ``wo`` row-sharded over ``model``) each
    rank attends with its heads and the partial outputs are summed in
    ``_reduce_pe(cfg)``; its cache holds the K/V heads it reads. K/V heads
    that the axis does not divide are whole on every rank (the GQA case):
    each rank computes, and caches, only those its query heads read. The
    reference's ``cache_pspecs`` shards the head dim over ``model`` in
    that case instead; either way every query head attends to its own K/V
    head, so the results are the same.

    With ``seq`` the cache is this rank's block of the positions (the
    flash-decoding layout): the new k/v are written only by the rank that
    owns position ``len``, and ``decode_attention`` merges the blocks."""
    rope = rope_tables(cfg, positions)
    if cache is None:
        return attention_prefill(p, cfg, x, rope, tp)[0], None
    q, k, v, p, split, index = _local_qkv(p, cfg, x, rope, tp)
    idx = cache["len"]                                          # (B,)
    kc = _write_cache(cache["k"], k, idx, seq)
    vc = _write_cache(cache["v"], v, idx, seq)
    out = decode_attention(q, _per_query_head(kc, index),
                           _per_query_head(vc, index), idx + 1, seq)
    y = _out_proj(p, out)
    return ((tp.reduce(y, _reduce_pe(cfg)) if split else y),
            {"k": kc, "v": vc, "len": idx + 1})


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------


def mlp_meta(cfg: ArchConfig) -> Dict[str, ParamMeta]:
    d, f = cfg.d_model, cfg.d_ff
    m = {"w_up": ParamMeta((d, f), ("fsdp", "tp")),
         "w_down": ParamMeta((f, d), ("tp", "fsdp"))}
    if cfg.mlp_act == "silu":
        m["w_gate"] = ParamMeta((d, f), ("fsdp", "tp"))
    return m


def mlp_fwd(p: Params, cfg: ArchConfig, x: torch.Tensor,
            tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """With ``tp`` and a block of d_ff in ``p`` (``w_up`` and ``w_gate``
    column-sharded, ``w_down`` row-sharded), each rank's partial output is
    summed over ``model`` in ``_reduce_pe(cfg)``."""
    dt = x.dtype
    split = tp is not None and p["w_up"].shape[1] < cfg.d_ff
    if split:
        x = tp.copy(x)
    up = x @ p["w_up"].to(dt)
    if cfg.mlp_act == "silu":
        up = F.silu(x @ p["w_gate"].to(dt)) * up
    else:
        up = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    down = up @ p["w_down"].to(dt)
    return tp.reduce(down, _reduce_pe(cfg)) if split else down


# ---------------------------------------------------------------------------
# MoE: top-k routing, capacity dispatch
# ---------------------------------------------------------------------------


def moe_meta(cfg: ArchConfig) -> Dict[str, ParamMeta]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamMeta((d, e), (None, None), scale=0.02 / math.sqrt(d)),
        "w_up": ParamMeta((e, d, f), ("expert", "moe_d", "moe_f")),
        "w_gate": ParamMeta((e, d, f), ("expert", "moe_d", "moe_f")),
        "w_down": ParamMeta((e, f, d), ("expert", "moe_f", "moe_d")),
    }


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


def moe_fwd(p: Params, cfg: ArchConfig, x: torch.Tensor, num_groups: int = 1,
            tp: Optional[TensorParallel] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out, float32 aux loss): the reference's GShard-style
    grouped dispatch on one device (on a mesh, on each data rank's tokens:
    ``LM.forward``).

    The B*S tokens split into ``num_groups`` groups (shrunk to a divisor)
    and are routed by ``moe_route``: a choice past its expert's capacity
    is dropped, so the output of a token depends on the tokens before it
    in its group.

    With ``tp`` and a block of the experts in ``p`` (``w_up``, ``w_gate``
    and ``w_down`` cut over ``model`` along the expert dim, the router
    whole), every rank routes all the tokens, so capacity and drops are
    the one-device ones; it dispatches only the choices bound for its
    experts into (G, E/tp, capacity, d), runs them, combines those
    choices, and the partial outputs are summed over ``model`` in
    ``_reduce_pe(cfg)``. The tokens are whole on every rank of ``model``,
    so no all-to-all is needed: this is GSPMD's ``expert``-sharded
    dispatch with the tokens replicated over the axis.
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

    # this rank's experts [lo, lo + el): the others' choices are dropped
    # here (the inputs and the weights used in part: gradients summed)
    el = p["w_up"].shape[0]
    split = tp is not None and el < e
    eid = topi.reshape(g, tg * k)
    if split:
        xt, topv = tp.copy(xt), tp.copy(topv)
        eid = eid - tp.rank * el
        keep = keep & (eid >= 0) & (eid < el)
        eid = eid.clamp(0, el - 1)

    # dispatch: a dropped choice goes to a spare slot past the capacity
    grp = torch.arange(g, device=x.device)[:, None]
    buf = x.new_zeros((g, el, cap + 1, d))
    buf[grp, eid, torch.where(keep, pos, cap)] = \
        xt.repeat_interleave(k, dim=1)
    # expert-major: one batched product an expert over its G x C slots
    ebuf = buf[:, :, :cap].transpose(0, 1).reshape(el, g * cap, d)
    dt = x.dtype
    h = ebuf @ p["w_up"].to(dt)
    h = F.silu(ebuf @ p["w_gate"].to(dt)) * h
    eout = (h @ p["w_down"].to(dt)).reshape(el, g, cap, d).transpose(0, 1)

    # combine: each kept choice's row, weighted, summed over the choices
    got = eout[grp, eid, torch.where(keep, pos, 0)] * keep[..., None].to(dt)
    got = got.reshape(g, tg, k, d) * topv[..., None].to(dt)
    out = got.sum(2).reshape(b, s, d)
    return (tp.reduce(out, _reduce_pe(cfg)) if split else out), aux


# ---------------------------------------------------------------------------
# FFT-convolution mixer (paper technique in the LM stack)
# ---------------------------------------------------------------------------


def fftconv_meta(d_model: int, rank: int) -> Dict[str, ParamMeta]:
    """The reference's ``fftconv_meta(cfg)`` at ``cfg.d_model`` and
    ``cfg.fftconv_rank``."""
    d = d_model
    return {"w_in": ParamMeta((d, 2 * d), ("fsdp", "tp")),
            "filt": ParamMeta((d, rank), (None, None), scale=0.2),
            "skip": ParamMeta((d,), (None,), init="ones"),
            "w_out": ParamMeta((d, d), ("tp", "fsdp"))}


class FFTConvMixer(nn.Module):
    """Gated long convolution: ``y = W_out((conv(v, k) + v * skip) *
    silu(g))`` with ``(v, g) = x @ W_in`` and the causal filters ``k``
    materialised from ``filt`` (D, rank) over the sequence length.

    Parameters and their initialisation follow ``fftconv_meta``: ``w_in``
    (d, 2d) and ``w_out`` (d, d) normal with scale 0.02, ``filt`` (d, rank)
    normal with scale 0.2, ``skip`` (d,) ones. They are drawn from
    ``generator`` (a new one seeded 0 when None) on its own device, then
    moved to ``device`` (None: the GPU). The forward pass is
    differentiable on every device and in both branches (``fft_conv`` and
    ``fft_conv_seq_sharded`` carry their backward over the port's
    kernels).

    ``mesh`` and ``axis`` name the ``DeviceMesh`` axis the sequence is
    sharded over, and ``comm`` the exchange backend of the sharded
    convolution (``fft_conv_seq_sharded``). ``forward(x,
    seq_axis_sharded=True)`` with a mesh takes this rank's (B, S/p, d)
    block of the sequence and returns its block of the output, on the
    mesh's device; as in the reference, without a mesh the flag is
    ignored and the convolution runs on one device. In the sharded branch
    every parameter's gradient is the whole one on every rank (the
    filters' through the sharded convolution's backward, the others summed
    over the mesh), as GSPMD gives it in the reference.

    ``tp`` (a ``TensorParallel``, set by the LM on a mesh with a ``model``
    axis) makes the mixer channel-parallel: ``w_in`` holds this rank's
    d/tp columns of v and of the gate, ``w_out`` its d/tp rows; each rank
    convolves and gates its channels (``filt`` and ``skip`` sliced to
    them) and the partial outputs are summed over ``model``. Both
    branches take it; in the sharded one ``tp``'s group must be an axis
    of ``mesh`` other than ``axis``, and the gradients of this rank's
    blocks of ``w_in`` and ``w_out`` are summed over the mesh's other
    axes only (``filt``'s and ``skip``'s are whole, as without ``tp``).
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
        self.tp: Optional[TensorParallel] = None
        self.reduce_dtype = torch.float32
        dev = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        self.planner = planner
        for name, meta in fftconv_meta(d_model, rank).items():
            setattr(self, name, nn.Parameter(make_param(meta, gen, dev)))

    def _channels(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (d, ...) or, channel-parallel, this rank's d/tp rows, the
        gradient summed over ``model``."""
        if self.tp is None:
            return t
        return self.tp.block(self.tp.copy(t), Runs.cut(0, t.shape[0]))

    def project(self, x: torch.Tensor):
        """(v, gate): ``x @ w_in`` split in two (this rank's channels of
        each when channel-parallel)."""
        if self.tp is not None:
            x = self.tp.copy(x)
        return (x @ self.w_in.to(x.dtype)).chunk(2, dim=-1)

    def _tp_axis(self) -> Optional[str]:
        """The axis of the mesh whose ranks hold other channels (``tp``'s
        group), None without ``tp``."""
        if self.tp is None:
            return None
        ranks = dist.get_process_group_ranks(self.tp.group)
        for a in self.mesh.mesh_dim_names:
            if dist.get_process_group_ranks(self.mesh.get_group(a)) == ranks:
                if a == self.axis:
                    break
                return a
        raise ValueError("channel-parallel, the sequence-sharded branch "
                         "needs tp's group as an axis of the mesh other "
                         f"than {self.axis!r}")

    def _whole_grad(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, its gradient summed over every axis of the mesh but
        ``tp``'s (whose ranks hold other channels)."""
        tp_axis = self._tp_axis()
        return CopyToRanks.apply(t, [self.mesh.get_group(a)
                                     for a in self.mesh.mesh_dim_names
                                     if a != tp_axis])

    def forward(self, x: torch.Tensor,
                seq_axis_sharded: bool = False) -> torch.Tensor:
        if seq_axis_sharded and self.mesh is not None:
            if self.tp is not None:
                x = self.tp.copy(x)
            vg = x @ self._whole_grad(self.w_in).to(x.dtype)
            return self.mix(*vg.chunk(2, dim=-1), seq_axis_sharded=True)
        return self.mix(*self.project(x))

    def mix(self, v: torch.Tensor, gate: torch.Tensor,
            seq_axis_sharded: bool = False) -> torch.Tensor:
        """The mixer's output from its projection (``project``)."""
        dt = v.dtype
        skip, w_out = self._channels(self.skip), self.w_out
        filt = self._channels(self.filt).float()
        if seq_axis_sharded and self.mesh is not None:
            skip, w_out = self._whole_grad(skip), self._whole_grad(w_out)
            s = v.shape[1] * mesh_sizes(self.mesh)[self.axis]
            y = fft_conv_seq_sharded(v, materialize_filter(filt, s),
                                     self.mesh, self.axis,
                                     planner=self.planner, comm=self.comm,
                                     channel_axis=self._tp_axis())
        else:
            y = fft_conv(v, materialize_filter(filt, v.shape[1]),
                         planner=self.planner, device=v.device)
        y = y + v * skip.to(dt)
        y = y * F.silu(gate)
        y = y @ w_out.to(dt)
        if self.tp is not None:
            y = self.tp.reduce(y, self.reduce_dtype)
        return y

    def decode(self, x: torch.Tensor, hist: torch.Tensor, pos: torch.Tensor,
               seq: Optional[SeqShard] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One-token long-conv step (the reference's ``fftconv_decode``):
        y_t = sum_{j<=t} k[t-j] v_j over the cached value history, with the
        filters materialised over the history's length. x (B, 1, d); hist
        (B, S_max, d), updated in place with this step's v at ``pos``; pos
        (B,) the current index. Returns (output, hist).

        Channel-parallel (``tp``), hist holds this rank's d/tp channels and
        the partial outputs are summed over ``model``. With ``seq`` hist is
        this rank's block of the positions (the flash-decoding layout):
        v is written by the rank that owns ``pos``, and the blocks' tap
        sums are summed over the data ranks in float32."""
        dt = x.dtype
        first = 0 if seq is None else seq.rank * hist.shape[1]
        s_max = hist.shape[1] * (1 if seq is None else seq.size)
        v, gate = self.project(x)
        hist = _write_cache(hist, v, pos, seq)
        filt = materialize_filter(self._channels(self.filt).float(),
                                  s_max)                        # (d, S)
        # the taps by lag, gathered in the history's (B, S, d) layout: lags
        # past the end take the last tap (the reference clips them), and
        # negative ones the zero row appended at index S
        taps = torch.cat([filt.T, filt.new_zeros((1, filt.shape[0]))])
        lag = (pos.long()[:, None] - first - torch.arange(
            hist.shape[1], device=x.device)[None, :])           # (B, S)
        kk = taps[torch.where(lag >= 0, lag.clamp(max=s_max - 1), s_max)]
        y = (hist * kk).sum(1, keepdim=True)                    # float32
        if seq is not None:
            y = seq.reduce(y)
        y = y.to(dt) + v * self._channels(self.skip).to(dt)
        y = y * F.silu(gate)
        y = y @ self.w_out.to(dt)
        if self.tp is not None:
            y = self.tp.reduce(y, self.reduce_dtype)
        return y, hist
