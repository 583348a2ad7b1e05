"""Decoder LM assembled from heterogeneous block segments, ported from
``repro.models.lm``: every layer kind of the reference (``attn_mlp``,
``attn_moe``, ``shared_attn``, ``fftconv_mlp``, ``mamba2``, ``mlstm``,
``slstm``), token or embedding inputs, RoPE, M-RoPE or sinusoidal
positions.

The reference stacks each segment's parameters along a leading layer axis
and scans over it; the port keeps one ``Block`` per layer in an
``nn.ModuleList``. ``shared_attn`` layers (zamba2) are one ``Block``, the
LM's ``shared`` (the reference's ``params["shared"]``), that stands at
each of their places in ``layers``. The decode cache holds one entry per
layer, each occurrence of the shared block its own:
``{"len": (B,) int32, "layers": [...]}`` with, per layer, ``{"k", "v"}``
(B, S, KV, hd) bf16 for an attention layer, ``{"v_hist"}`` (B, S, d) bf16
for an FFT-conv layer, and the float32 recurrent state of ``models.ssm``
for the others (Mamba2 ``{"conv", "ssd"}``, mLSTM ``{"mlstm"}``, sLSTM
``{"c", "n", "h", "m"}``), every tensor with the batch axis first.
``decode_step`` updates that cache in place and returns it.

``prefill`` computes what the reference's does, two of its properties
included: it runs attention and then the MLP even where ``parallel_block``
makes ``forward`` run them side by side, and an FFT-conv layer's filters
are materialised over the length each call sees (the prompt in
``prefill``, the cache's ``max_len`` in ``decode_step``, the whole
sequence in ``forward``), so the three agree only where those lengths do.
A MoE layer's capacity depends on the tokens of the call (the prompt in
``prefill``, the batch in ``decode_step``), so its drops do too; and
``decode_step`` gives a token the position ``len`` in all three M-RoPE
streams, whatever layout ``prefill`` was given (ROADMAP.md, Queue 3).
Unlike the reference's ``decode_step``, which runs a ``shared_attn``
segment once whatever its count, the port runs every occurrence; every
shipped config has a count of 1.

Training: ``loss_fn`` is the reference's memory-lean cross-entropy plus
0.01 times the MoE aux loss. With ``cfg.remat`` and autograd on,
``forward`` checkpoints each layer (``torch.utils.checkpoint``,
non-reentrant: the reference's ``"full"`` policy, nothing saved but the
layer's input). Parameters stay float32 and are cast at each use, so a
trainer never calls ``to_compute_dtype``. A ``shared_attn`` block's
gradient is the sum over its places, as the reference's
``params["shared"]`` is.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.plan import Planner, resolve_device
from . import blocks, ssm
from .config import ArchConfig
from .params import ParamMeta, init_tree, make_param

ATTENTION = ("attn_mlp", "attn_moe", "shared_attn")
RECURRENT = tuple(ssm.MIXERS)
KINDS = ATTENTION + ("fftconv_mlp",) + RECURRENT
# parameters the forward passes use in float32 whatever the compute dtype:
# the norms, the FFT-conv filters, the MoE router, Mamba2's convolution,
# decay, skip and gated norm, mLSTM's gates and norm, sLSTM's gates
FLOAT32_PARAMS = ("ln", "ln1", "ln2", "final_norm", "filt", "router",
                  "conv_w", "a_log", "dt_bias", "d_skip", "norm",
                  "wi", "wf", "bi", "bf", "w_gates", "r_gates", "b_gates")

# ---------------------------------------------------------------------------
# metadata assembly
# ---------------------------------------------------------------------------


def _layer_meta(cfg: ArchConfig, kind: str) -> Dict[str, Any]:
    if kind in ("attn_mlp", "shared_attn"):
        return {"ln1": blocks.norm_meta(cfg), "attn": blocks.attention_meta(cfg),
                "ln2": blocks.norm_meta(cfg), "mlp": blocks.mlp_meta(cfg)}
    if kind == "attn_moe":
        return {"ln1": blocks.norm_meta(cfg), "attn": blocks.attention_meta(cfg),
                "ln2": blocks.norm_meta(cfg), "moe": blocks.moe_meta(cfg)}
    if kind == "fftconv_mlp":
        return {"ln1": blocks.norm_meta(cfg),
                "mix": blocks.fftconv_meta(cfg.d_model, cfg.fftconv_rank),
                "ln2": blocks.norm_meta(cfg), "mlp": blocks.mlp_meta(cfg)}
    if kind in RECURRENT:
        return {"ln": blocks.norm_meta(cfg),
                "mixer": ssm.MIXERS[kind][0](cfg)}
    raise ValueError(f"unknown block kind {kind!r}")


def padded_vocab(cfg: ArchConfig) -> int:
    """Vocab padded to a lane-aligned, TP-divisible multiple (MaxText-style);
    the pad columns are masked to -1e30 in the logits."""
    return ((cfg.vocab_size + 255) // 256) * 256


def model_meta(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameter tree's metadata, one entry of ``layers`` per layer (an
    empty one at each ``shared_attn`` place) and the shared block's once
    under ``shared``."""
    d, v = cfg.d_model, padded_vocab(cfg)
    tree: Dict[str, Any] = {"embed": ParamMeta((v, d), scale=0.02),
                            "final_norm": blocks.norm_meta(cfg)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamMeta((d, v), scale=0.02 / math.sqrt(d))
    kinds = [kind for kind, count in cfg.resolved_segments()
             for _ in range(count)]
    if "shared_attn" in kinds:
        tree["shared"] = _layer_meta(cfg, "shared_attn")
    tree["layers"] = [{} if kind == "shared_attn" else _layer_meta(cfg, kind)
                      for kind in kinds]
    if cfg.param_dtype != "float32":
        # serving deployments hold bf16 weights (no optimizer to feed)
        pd = getattr(torch, cfg.param_dtype)

        def cast(t):
            if isinstance(t, ParamMeta):
                return dataclasses.replace(t, dtype=pd)
            if isinstance(t, list):
                return [cast(m) for m in t]
            return {k: cast(m) for k, m in t.items()}
        tree = cast(tree)
    return tree


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Absolute sinusoidal position encoding (musicgen-style, rope='none')."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _mask_pad_vocab(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    vp = padded_vocab(cfg)
    if vp == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.vocab_size, vp, device=logits.device)
    return logits.index_fill(-1, pad, -1e30)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One layer (the reference's ``_block_fwd`` and the bodies of its
    prefill and decode loops): pre-norm attention or FFT-conv mixer, then
    the MLP or the MoE; or a pre-norm recurrent mixer (``ln``, ``mixer``)."""

    def __init__(self, cfg: ArchConfig, kind: str, meta: Dict[str, Any],
                 generator: torch.Generator, device,
                 planner: Optional[Planner]):
        super().__init__()
        self.cfg, self.kind = cfg, kind

        def params(part):
            return nn.ParameterDict(init_tree(meta[part], generator, device))
        if kind in RECURRENT:
            self.ln, self.mixer = params("ln"), params("mixer")
            return
        self.ln1 = params("ln1")
        if kind == "fftconv_mlp":
            self.mix = blocks.FFTConvMixer(
                cfg.d_model, cfg.fftconv_rank, planner=planner,
                device=device, generator=generator)
        else:
            self.attn = params("attn")
        self.ln2 = params("ln2")
        if kind == "attn_moe":
            self.moe = params("moe")
        else:
            self.mlp = params("mlp")

    def _ffn(self, x: torch.Tensor):
        """x plus the MLP or MoE of its norm; (x, MoE aux loss or None)."""
        h2 = blocks.apply_norm(self.ln2, self.cfg, x)
        if self.kind == "attn_moe":
            out, aux = blocks.moe_fwd(self.moe, self.cfg, h2)
            return x + out, aux
        return x + blocks.mlp_fwd(self.mlp, self.cfg, h2), None

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Dict] = None,
                lens: Optional[torch.Tensor] = None):
        """Without a cache the whole sequence; with this layer's decode
        cache (updated in place) and the sequences' lengths, one token.
        Returns (x, the MoE aux loss or None)."""
        cfg = self.cfg
        if self.kind in RECURRENT:
            h = blocks.apply_norm(self.ln, cfg, x)
            out, state = ssm.MIXERS[self.kind][1](self.mixer, cfg, h,
                                                  state=cache)
            if cache is not None:
                cache.update(state)
            return x + out, None
        h = blocks.apply_norm(self.ln1, cfg, x)
        if self.kind == "fftconv_mlp":
            if cache is None:
                return self._ffn(x + self.mix(h))
            return self._ffn(x + self.mix.decode(h, cache["v_hist"], lens)[0])
        lc = None if cache is None else {**cache, "len": lens}
        out, _ = blocks.attention_fwd(self.attn, cfg, h, positions, lc)
        if cfg.parallel_block:
            # command-r: attention and FFN in parallel off one norm
            return x + out + blocks.mlp_fwd(self.mlp, cfg, h), None
        return self._ffn(x + out)

    def prefill(self, x: torch.Tensor, rope, pad: int):
        """The prompt through this layer, and the layer's decode cache:
        attention k/v and the FFT-conv value history padded by ``pad``
        positions, a recurrent mixer's final state. Attention runs before
        the MLP whatever ``parallel_block`` says, as in the reference's
        prefill."""
        cfg = self.cfg
        if self.kind in RECURRENT:
            h = blocks.apply_norm(self.ln, cfg, x)
            out, state = ssm.MIXERS[self.kind][1](self.mixer, cfg, h,
                                                  return_state=True)
            return x + out, state
        h = blocks.apply_norm(self.ln1, cfg, x)
        if self.kind == "fftconv_mlp":
            v, gate = self.mix.project(h)
            x = x + self.mix.mix(v, gate)
            cache = {"v_hist": _pad_seq(v, pad)}
        else:
            q, k, v = blocks._qkv(self.attn, cfg, h, rope)
            out = blocks.flash_attention(q, k, v, causal=True)
            x = x + blocks._out_proj(self.attn, out)
            cache = {"k": _pad_seq(k, pad), "v": _pad_seq(v, pad)}
        return self._ffn(x)[0], cache


def _remat(layer: Block, cfg: ArchConfig):
    """``layer`` itself, or, with ``cfg.remat`` and autograd on, ``layer``
    under non-reentrant checkpointing: the reference's ``"full"`` policy
    (``nothing_saveable``), which keeps only the layer's input."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return layer
    if cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat policy {cfg.remat_policy!r}: the port recomputes whole "
            "layers (\"full\") only")
    return functools.partial(checkpoint, layer, use_reentrant=False)


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, S, ...) in bf16, zero-padded to S + pad along the sequence."""
    t = t.to(torch.bfloat16)
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)


class LM(nn.Module):
    """The decoder LM of ``cfg``, its parameters drawn by the reference's
    rules (``model_meta``) from ``generator`` (a new one seeded 0 when
    None) on the generator's device and held on ``device`` (None: the GPU,
    which raises without one). ``planner`` is what the FFT-conv layers hand
    ``fft_conv`` (None: the reference's default, the ``torch`` backend).

    ``forward`` is differentiable on every device (``loss_fn`` is the
    training loss); ``prefill`` and ``decode_step`` run under
    ``torch.no_grad()``. Batches are ``{"tokens": (B, S) int}`` or ``{"embeds":
    (B, S, d)}`` (a frontend's output), with optional ``"positions"``: (B,
    S), or (3, B, S) M-RoPE streams (whose first is the sinusoid's where
    ``rope`` is ``"none"``).
    """

    def __init__(self, cfg: ArchConfig, planner: Optional[Planner] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kinds = [kind for kind, count in cfg.resolved_segments()
                 for _ in range(count)]
        for kind in kinds:
            if kind not in KINDS:
                raise ValueError(f"unknown block kind {kind!r}")
        dev = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        meta = model_meta(cfg)
        self.embed = nn.Parameter(make_param(meta["embed"], gen, dev))
        self.final_norm = nn.ParameterDict(init_tree(meta["final_norm"], gen,
                                                     dev))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(make_param(meta["lm_head"], gen, dev))
        # registered before ``layers``, so that its parameters are named
        # ``shared.*`` once
        self.shared = (Block(cfg, "shared_attn", meta["shared"], gen, dev,
                             planner)
                       if "shared" in meta else None)
        self.layers = nn.ModuleList(
            self.shared if kind == "shared_attn"
            else Block(cfg, kind, m, gen, dev, planner)
            for kind, m in zip(kinds, meta["layers"]))
        if cfg.param_dtype != "float32":
            # the reference draws each normal in float32 and casts it
            self.to(getattr(torch, cfg.param_dtype))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def planner(self) -> Optional[Planner]:
        return next((layer.mix.planner for layer in self.layers
                     if layer.kind == "fftconv_mlp"), None)

    @planner.setter
    def planner(self, planner: Optional[Planner]) -> None:
        for layer in self.layers:
            if layer.kind == "fftconv_mlp":
                layer.mix.planner = planner

    def to_compute_dtype(self) -> "LM":
        """Cast, in place, every weight that the forward passes cast to the
        compute dtype at each use. The values are those of the reference's
        per-use ``astype``, bit for bit; the parameters used in float32
        (``FLOAT32_PARAMS``) stay."""
        for name, p in self.named_parameters():
            if not set(name.split(".")) & set(FLOAT32_PARAMS):
                p.data = p.data.to(self.dtype)
        return self

    def _inputs(self, batch: Dict[str, torch.Tensor],
                positions: Optional[torch.Tensor] = None):
        """(x in the compute dtype, positions): the batch's tokens embedded
        or its embeddings, the positions given (else the batch's, else 0..S-1
        in every row), and the sinusoid added where ``rope`` is
        ``"none"``."""
        if "embeds" in batch:
            x = batch["embeds"].to(self.dtype)
        else:
            x = self.embed[batch["tokens"]].to(self.dtype)
        if positions is None:
            positions = batch.get("positions")
        if positions is None:
            bsz, s = x.shape[:2]
            positions = torch.arange(s, device=x.device)[None].expand(bsz, s)
        if self.cfg.rope == "none":
            x = x + _sinusoidal(positions if positions.dim() == 2
                                else positions[0],
                                self.cfg.d_model).to(x.dtype)
        return x, positions

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ head.to(self.dtype)

    def forward(self, batch: Dict[str, torch.Tensor]):
        """Returns (logits (B, S, V) in the compute dtype, the float32 MoE
        aux loss summed over the layers). With ``cfg.remat`` and autograd
        on, each layer is recomputed in the backward pass (``_remat``)."""
        x, positions = self._inputs(batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            x, layer_aux = _remat(layer, self.cfg)(x, positions)
            if layer_aux is not None:
                aux = aux + layer_aux
        x = blocks.apply_norm(self.final_norm, self.cfg, x)
        return _mask_pad_vocab(self.cfg, self._logits(x)), aux

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int,
                last_index: Optional[torch.Tensor] = None):
        """Run the prompt through the stack once, returning (float32 logits
        (B, 1, V) at ``last_index`` (default: the final position), decode
        cache of ``max_len`` positions). ``last_index`` (B,) selects the
        true prompt end when the input is right-padded to a length
        bucket; a recurrent layer's state is the one after the whole
        input, pads included."""
        x, positions = self._inputs(batch)
        bsz, s = x.shape[:2]
        pad = max_len - s
        if pad < 0:
            raise ValueError(f"a prompt of {s} tokens does not fit a cache "
                             f"of {max_len}")
        rope = blocks.rope_tables(self.cfg, positions)
        caches = []
        for layer in self.layers:
            x, c = layer.prefill(x, rope, pad)
            caches.append(c)
        x = blocks.apply_norm(self.final_norm, self.cfg, x)
        if last_index is None:
            x_last = x[:, -1:, :]
            cache_len = torch.full((bsz,), s, dtype=torch.int32,
                                   device=x.device)
        else:
            last_index = torch.as_tensor(last_index, device=x.device)
            x_last = x[torch.arange(bsz, device=x.device),
                       last_index.long()][:, None]
            cache_len = last_index.to(torch.int32) + 1
        logits = _mask_pad_vocab(self.cfg, self._logits(x_last).float())
        return logits, {"len": cache_len, "layers": caches}

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        """An empty decode cache of ``batch`` sequences of ``max_len``."""
        cfg, dev = self.cfg, self.device
        layers: List[Dict[str, torch.Tensor]] = []
        for layer in self.layers:
            if layer.kind in ATTENTION:
                shape = (batch, max_len, cfg.num_kv_heads, cfg.hd)
                layers.append({k: torch.zeros(shape, dtype=torch.bfloat16,
                                              device=dev) for k in "kv"})
            elif layer.kind == "fftconv_mlp":
                layers.append({"v_hist": torch.zeros(
                    (batch, max_len, cfg.d_model), dtype=torch.bfloat16,
                    device=dev)})
            else:
                layers.append(ssm.MIXERS[layer.kind][2](cfg, batch, dev))
        return {"len": torch.zeros((batch,), dtype=torch.int32, device=dev),
                "layers": layers}

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, Any],
                    batch: Dict[str, torch.Tensor]):
        """One new token per sequence, ``batch = {"tokens": (B, 1)}`` or
        ``{"embeds": (B, 1, d)}``, at position ``len``; returns (float32
        logits (B, 1, V), the cache, updated in place, with ``len`` one
        longer)."""
        lens = cache["len"]
        x, positions = self._inputs(batch, lens[:, None])       # (B, 1)
        for layer, c in zip(self.layers, cache["layers"]):
            x, _ = layer(x, positions, c, lens)
        x = blocks.apply_norm(self.final_norm, self.cfg, x)
        logits = _mask_pad_vocab(self.cfg, self._logits(x).float())
        return logits, {"len": lens + 1, "layers": cache["layers"]}


# ---------------------------------------------------------------------------
# the reference's entry points, over an LM
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                planner: Optional[Planner] = None, device=None) -> LM:
    return LM(cfg, planner=planner, device=device, generator=generator)


def forward(model: LM, batch: Dict[str, torch.Tensor]):
    return model(batch)


def loss_fn(model: LM, batch: Dict[str, torch.Tensor]):
    """(loss, {"nll", "aux"}): the mean next-token negative log-likelihood
    over the labels >= 0 of ``batch["labels"]`` (B, S), plus 0.01 times the
    MoE aux loss. The reference's memory-lean cross-entropy, step by step:
    no (B, S, V) one-hot, the float32 cast inside the reductions."""
    logits, aux = model(batch)
    labels = batch["labels"].long()
    m = logits.amax(-1).float()
    shifted = logits.float() - m[..., None]
    logz = m + torch.log(torch.exp(shifted).sum(-1))
    label_logit = torch.take_along_dim(
        logits, labels.clamp(min=0)[..., None], dim=-1)[..., 0].float()
    mask = (labels >= 0).float()
    nll = ((logz - label_logit) * mask).sum() / mask.sum().clamp(min=1.0)
    loss = nll + 0.01 * aux
    return loss, {"nll": nll, "aux": aux}


def prefill(model: LM, batch: Dict[str, torch.Tensor], max_len: int,
            last_index: Optional[torch.Tensor] = None):
    return model.prefill(batch, max_len, last_index)


def init_cache(model: LM, batch: int, max_len: int) -> Dict[str, Any]:
    return model.init_cache(batch, max_len)


def decode_step(model: LM, cache: Dict[str, Any],
                batch: Dict[str, torch.Tensor]):
    return model.decode_step(cache, batch)
