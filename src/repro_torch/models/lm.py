"""Decoder LM assembled from block segments, ported from
``repro.models.lm`` for the layer kinds ``attn_mlp`` and ``fftconv_mlp``.

The reference stacks each segment's parameters along a leading layer axis
and scans over it; the port keeps one ``Block`` per layer in an
``nn.ModuleList``, and its decode cache one entry per layer:
``{"len": (B,) int32, "layers": [{"k", "v"} (B, S, KV, hd) bf16 for an
attention layer | {"v_hist"} (B, S, d) bf16 for an FFT-conv layer]}``.
``decode_step`` writes into that cache in place and returns it.

``prefill`` computes what the reference's does, two of its properties
included: it runs attention and then the MLP even where ``parallel_block``
makes ``forward`` run them side by side, and an FFT-conv layer's filters
are materialised over the length each call sees (the prompt in
``prefill``, the cache's ``max_len`` in ``decode_step``, the whole
sequence in ``forward``), so the three agree only where those lengths do
(ROADMAP.md, Queue 3).

MoE, the recurrent mixers, ``shared_attn``, M-RoPE and the modality
frontends are not ported yet: ``LM`` refuses their configs. The training
loss waits for the training slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ..core.plan import Planner, resolve_device
from . import blocks
from .config import ArchConfig
from .params import ParamMeta, init_tree, make_param

KINDS = ("attn_mlp", "fftconv_mlp")
# parameters the forward passes use in float32 whatever the compute dtype
FLOAT32_PARAMS = ("ln1", "ln2", "final_norm", "filt")


def _unported(cfg: ArchConfig) -> Optional[str]:
    """What of ``cfg`` the port cannot run yet, or None."""
    for kind, _ in cfg.resolved_segments():
        if kind not in KINDS:
            return f"{kind!r} layers"
    if cfg.rope == "mrope":
        return "M-RoPE"
    if cfg.frontend is not None:
        return f"the {cfg.frontend} frontend"
    return None


# ---------------------------------------------------------------------------
# metadata assembly
# ---------------------------------------------------------------------------


def _layer_meta(cfg: ArchConfig, kind: str) -> Dict[str, Any]:
    if kind == "attn_mlp":
        return {"ln1": blocks.norm_meta(cfg), "attn": blocks.attention_meta(cfg),
                "ln2": blocks.norm_meta(cfg), "mlp": blocks.mlp_meta(cfg)}
    if kind == "fftconv_mlp":
        return {"ln1": blocks.norm_meta(cfg),
                "mix": blocks.fftconv_meta(cfg.d_model, cfg.fftconv_rank),
                "ln2": blocks.norm_meta(cfg), "mlp": blocks.mlp_meta(cfg)}
    raise NotImplementedError(f"{kind!r} layers are not ported yet "
                              "(ROADMAP.md, Queue 1 item 5)")


def padded_vocab(cfg: ArchConfig) -> int:
    """Vocab padded to a lane-aligned, TP-divisible multiple (MaxText-style);
    the pad columns are masked to -1e30 in the logits."""
    return ((cfg.vocab_size + 255) // 256) * 256


def model_meta(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameter tree's metadata, one entry of ``layers`` per layer."""
    d, v = cfg.d_model, padded_vocab(cfg)
    tree: Dict[str, Any] = {"embed": ParamMeta((v, d), scale=0.02),
                            "final_norm": blocks.norm_meta(cfg)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamMeta((d, v), scale=0.02 / math.sqrt(d))
    tree["layers"] = [_layer_meta(cfg, kind)
                      for kind, count in cfg.resolved_segments()
                      for _ in range(count)]
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
    """One layer: pre-norm attention or FFT-conv mixer, then the MLP (the
    reference's ``_block_fwd`` and the bodies of its prefill and decode
    loops)."""

    def __init__(self, cfg: ArchConfig, kind: str, meta: Dict[str, Any],
                 generator: torch.Generator, device,
                 planner: Optional[Planner]):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.ln1 = nn.ParameterDict(init_tree(meta["ln1"], generator, device))
        if kind == "attn_mlp":
            self.attn = nn.ParameterDict(init_tree(meta["attn"], generator,
                                                   device))
        else:
            self.mix = blocks.FFTConvMixer(
                cfg.d_model, cfg.fftconv_rank, planner=planner,
                device=device, generator=generator)
        self.ln2 = nn.ParameterDict(init_tree(meta["ln2"], generator, device))
        self.mlp = nn.ParameterDict(init_tree(meta["mlp"], generator, device))

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Dict] = None,
                lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Without a cache the whole sequence; with this layer's decode
        cache (updated in place) and the sequences' lengths, one token."""
        cfg = self.cfg
        h = blocks.apply_norm(self.ln1, cfg, x)
        if self.kind == "attn_mlp":
            lc = None if cache is None else {**cache, "len": lens}
            out, _ = blocks.attention_fwd(self.attn, cfg, h, positions, lc)
            if cfg.parallel_block:
                # command-r: attention and FFN in parallel off one norm
                return x + out + blocks.mlp_fwd(self.mlp, cfg, h)
            x = x + out
        elif cache is None:
            x = x + self.mix(h)
        else:
            x = x + self.mix.decode(h, cache["v_hist"], lens)[0]
        return x + blocks.mlp_fwd(self.mlp, cfg,
                                  blocks.apply_norm(self.ln2, cfg, x))

    def prefill(self, x: torch.Tensor, rope, pad: int):
        """The prompt through this layer, and the layer's decode cache
        padded by ``pad`` positions. Attention runs before the MLP whatever
        ``parallel_block`` says, as in the reference's prefill."""
        cfg = self.cfg
        h = blocks.apply_norm(self.ln1, cfg, x)
        if self.kind == "attn_mlp":
            q, k, v = blocks._qkv(self.attn, cfg, h, rope)
            out = blocks.flash_attention(q, k, v, causal=True)
            x = x + blocks._out_proj(self.attn, out)
            cache = {"k": _pad_seq(k, pad), "v": _pad_seq(v, pad)}
        else:
            v, gate = self.mix.project(h)
            x = x + self.mix.mix(v, gate)
            cache = {"v_hist": _pad_seq(v, pad)}
        x = x + blocks.mlp_fwd(self.mlp, cfg,
                               blocks.apply_norm(self.ln2, cfg, x))
        return x, cache


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, S, ...) in bf16, zero-padded to S + pad along the sequence."""
    t = t.to(torch.bfloat16)
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)


class LM(nn.Module):
    """The decoder LM of ``cfg`` (layer kinds ``attn_mlp`` and
    ``fftconv_mlp``), its parameters drawn by the reference's rules
    (``model_meta``) from ``generator`` (a new one seeded 0 when None) on
    the generator's device and held on ``device`` (None: the GPU, which
    raises without one). ``planner`` is what the FFT-conv layers hand
    ``fft_conv`` (None: the reference's default, the ``torch`` backend).

    ``forward`` is differentiable on the CPU; ``prefill`` and
    ``decode_step`` run under ``torch.no_grad()``, which the kernels need
    on the card. Batches are ``{"tokens": (B, S) int}`` with optional
    ``"positions"`` (B, S).
    """

    def __init__(self, cfg: ArchConfig, planner: Optional[Planner] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        what = _unported(cfg)
        if what is not None:
            raise NotImplementedError(
                f"{cfg.name} needs {what}, which the port does not run yet "
                "(ROADMAP.md, Queue 1 item 5); it serves attn_mlp and "
                "fftconv_mlp layers")
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
        kinds = [kind for kind, count in cfg.resolved_segments()
                 for _ in range(count)]
        self.layers = nn.ModuleList(
            Block(cfg, kind, m, gen, dev, planner)
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
        per-use ``astype``, bit for bit; the norms' parameters and the
        filters, which are used in float32, stay."""
        for name, p in self.named_parameters():
            if not set(name.split(".")) & set(FLOAT32_PARAMS):
                p.data = p.data.to(self.dtype)
        return self

    def _embed(self, tokens: torch.Tensor, positions: torch.Tensor):
        x = self.embed[tokens].to(self.dtype)
        if self.cfg.rope == "none":
            x = x + _sinusoidal(positions, self.cfg.d_model).to(x.dtype)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ head.to(self.dtype)

    def _positions(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        positions = batch.get("positions")
        if positions is None:
            bsz, s = batch["tokens"].shape
            positions = torch.arange(s, device=self.device)[None].expand(
                bsz, s)
        return positions

    def forward(self, batch: Dict[str, torch.Tensor]):
        """Returns (logits (B, S, V) in the compute dtype, aux loss 0)."""
        positions = self._positions(batch)
        x = self._embed(batch["tokens"], positions)
        for layer in self.layers:
            x = layer(x, positions)
        x = blocks.apply_norm(self.final_norm, self.cfg, x)
        logits = _mask_pad_vocab(self.cfg, self._logits(x))
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int,
                last_index: Optional[torch.Tensor] = None):
        """Run the prompt through the stack once, returning (float32 logits
        (B, 1, V) at ``last_index`` (default: the final position), decode
        cache of ``max_len`` positions). ``last_index`` (B,) selects the
        true prompt end when the input is right-padded to a length
        bucket."""
        positions = self._positions(batch)
        x = self._embed(batch["tokens"], positions)
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
            if layer.kind == "attn_mlp":
                shape = (batch, max_len, cfg.num_kv_heads, cfg.hd)
                layers.append({k: torch.zeros(shape, dtype=torch.bfloat16,
                                              device=dev) for k in "kv"})
            else:
                layers.append({"v_hist": torch.zeros(
                    (batch, max_len, cfg.d_model), dtype=torch.bfloat16,
                    device=dev)})
        return {"len": torch.zeros((batch,), dtype=torch.int32, device=dev),
                "layers": layers}

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, Any],
                    batch: Dict[str, torch.Tensor]):
        """One new token per sequence, ``batch = {"tokens": (B, 1)}``;
        returns (float32 logits (B, 1, V), the cache, updated in place, with
        ``len`` one longer)."""
        lens = cache["len"]
        positions = lens[:, None]                               # (B, 1)
        x = self._embed(batch["tokens"], positions)
        for layer, c in zip(self.layers, cache["layers"]):
            x = layer(x, positions, c, lens)
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


def prefill(model: LM, batch: Dict[str, torch.Tensor], max_len: int,
            last_index: Optional[torch.Tensor] = None):
    return model.prefill(batch, max_len, last_index)


def init_cache(model: LM, batch: int, max_len: int) -> Dict[str, Any]:
    return model.init_cache(batch, max_len)


def decode_step(model: LM, cache: Dict[str, Any],
                batch: Dict[str, torch.Tensor]):
    return model.decode_step(cache, batch)
