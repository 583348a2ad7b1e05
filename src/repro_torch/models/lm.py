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
non-reentrant): the reference's ``"full"`` policy keeps nothing but the
layer's input, ``"dots"`` also the weight products (``_remat``).
Parameters stay float32 and are cast at each use, so a trainer never
calls ``to_compute_dtype``. A ``shared_attn`` block's
gradient is the sum over its places, as the reference's
``params["shared"]`` is.

On a mesh (``LM.place``, which the ``Trainer`` and ``launch.specs``
call) each rank holds its rows of the batch (the ``dp`` axes) and, over
``model``, its block of each weight that ``tp_layouts`` cuts: attention
heads (zamba2's shared block at each of its places too), the MLP's d_ff,
the MoE's experts and the FFT-conv mixer's channels run tensor-parallel
(``blocks``), and so do the recurrent mixers by heads (``ssm``, where
``model`` divides them; Mamba2's B and C whole on every rank); the
embedding and head, whose vocab the rules shard too, are gathered over
``model`` on use. A frontend's ``{"embeds"}`` batch enters whole on every
``model`` rank. The loss is the global one on every rank (``loss_fn``);
the MoE's groups are split among the data ranks.

Serving on a mesh: ``init_cache`` allocates each rank's block of the
decode cache (``launch.specs.cache_pspecs`` describes it): the K/V heads
its query heads read, the FFT-conv history of its d/tp channels, and
either its rows of the batch (a global batch that the data ranks divide)
or, for a smaller batch, its block of the positions (the flash-decoding
layout, ``seq_split``): ``prefill`` then runs the whole batch on every
data rank and keeps each rank's block, and ``decode_step`` merges the
blocks' partials over the data ranks (``blocks.SeqShard``). Both take the
global batch, which fixes the layout, from their caller.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.plan import Planner, resolve_device
from . import blocks, ssm
from .config import ArchConfig
from .params import ParamMeta, init_tree, make_param, shard_act

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
                "mixer": ssm.MIXERS[kind].meta(cfg)}
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
    tree: Dict[str, Any] = {
        "embed": ParamMeta((v, d), ("tp", "fsdp"), scale=0.02),
        "final_norm": blocks.norm_meta(cfg),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamMeta((d, v), ("fsdp", "tp"),
                                    scale=0.02 / math.sqrt(d))
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
        self.tp: Optional[blocks.TensorParallel] = None

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

    def set_tensor_parallel(self, tp: Optional[blocks.TensorParallel]):
        """Run this layer over ``tp``'s ``model`` axis (its parameters
        already hold this rank's blocks); a recurrent mixer that
        ``ssm.mixer_cut`` leaves whole keeps no ``tp``."""
        if (self.kind in RECURRENT and tp is not None
                and not ssm.mixer_cut(self.kind, self.cfg, tp.size)):
            tp = None
        self.tp = tp
        if self.kind == "fftconv_mlp":
            self.mix.tp = tp
            self.mix.reduce_dtype = blocks._reduce_pe(self.cfg)

    def _ffn(self, x: torch.Tensor, num_groups: int = 1):
        """x plus the MLP or MoE of its norm; (x, MoE aux loss or None)."""
        h2 = blocks.apply_norm(self.ln2, self.cfg, x)
        if self.kind == "attn_moe":
            out, aux = blocks.moe_fwd(self.moe, self.cfg, h2, num_groups,
                                      self.tp)
            return x + out, aux
        return x + blocks.mlp_fwd(self.mlp, self.cfg, h2, self.tp), None

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Dict] = None,
                lens: Optional[torch.Tensor] = None, num_groups: int = 1,
                seq: Optional[blocks.SeqShard] = None):
        """Without a cache the whole sequence; with this layer's decode
        cache (updated in place) and the sequences' lengths, one token.
        ``num_groups``: the MoE's groups among these tokens; ``seq``: the
        cache's block of positions in the flash-decoding layout. Returns
        (x, the MoE aux loss or None)."""
        cfg = self.cfg
        if self.kind in RECURRENT:
            h = blocks.apply_norm(self.ln, cfg, x)
            out, state = ssm.MIXERS[self.kind].fwd(self.mixer, cfg, h,
                                                   state=cache, tp=self.tp)
            if cache is not None:
                cache.update(state)
            return x + out, None
        h = blocks.apply_norm(self.ln1, cfg, x)
        if self.kind == "fftconv_mlp":
            if cache is None:
                return self._ffn(x + self.mix(h))
            return self._ffn(x + self.mix.decode(h, cache["v_hist"], lens,
                                                 seq)[0])
        lc = None if cache is None else {**cache, "len": lens}
        out, _ = blocks.attention_fwd(self.attn, cfg, h, positions, lc,
                                      self.tp, seq)
        if cfg.parallel_block:
            # command-r: attention and FFN in parallel off one norm
            return x + out + blocks.mlp_fwd(self.mlp, cfg, h, self.tp), None
        return self._ffn(x + out, num_groups)

    def prefill(self, x: torch.Tensor, rope, pad: int, num_groups: int = 1):
        """The prompt through this layer, and the layer's decode cache:
        attention k/v (of the K/V heads this rank holds) and the FFT-conv
        value history (of its channels) padded by ``pad`` positions, a
        recurrent mixer's final state. Attention runs before the MLP
        whatever ``parallel_block`` says, as in the reference's prefill.
        ``num_groups``: the MoE's groups among these tokens."""
        cfg = self.cfg
        if self.kind in RECURRENT:
            h = blocks.apply_norm(self.ln, cfg, x)
            out, state = ssm.MIXERS[self.kind].fwd(self.mixer, cfg, h,
                                                   return_state=True,
                                                   tp=self.tp)
            return x + out, state
        h = blocks.apply_norm(self.ln1, cfg, x)
        if self.kind == "fftconv_mlp":
            v, gate = self.mix.project(h)
            x = x + self.mix.mix(v, gate)
            cache = {"v_hist": _pad_seq(v, pad)}
        else:
            out, k, v = blocks.attention_prefill(self.attn, cfg, h, rope,
                                                 self.tp)
            x = x + out
            cache = {"k": _pad_seq(k, pad), "v": _pad_seq(v, pad)}
        return self._ffn(x, num_groups)[0], cache


def _flat(tree, prefix: str = "") -> Dict[str, Any]:
    """A tree of dicts and lists by the LM's ``/``-free parameter names
    (``layers.<i>.<part>.<name>``)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: Dict[str, Any] = {}
    for key, value in items:
        if isinstance(value, (dict, list)):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


# the products of an activation with a weight: no batch dims of their own
# (attention's batched products are ``aten.bmm``)
_WEIGHT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: the reference's
    ``dots_with_no_batch_dims_saveable``."""
    return (CheckpointPolicy.MUST_SAVE if op in _WEIGHT_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(layer: Block, cfg: ArchConfig):
    """``layer`` itself, or, with ``cfg.remat`` and autograd on, ``layer``
    under non-reentrant checkpointing by ``cfg.remat_policy``: ``"full"``
    (the reference's ``nothing_saveable``) keeps only the layer's input;
    ``"dots"`` (``dots_with_no_batch_dims_saveable``) also keeps the
    outputs of its weight products (``aten.mm``, ``aten.addmm``) and
    recomputes the rest, attention's batched products included."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return layer
    if cfg.remat_policy == "full":
        return functools.partial(checkpoint, layer, use_reentrant=False)
    if cfg.remat_policy == "dots":
        return functools.partial(
            checkpoint, layer, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_weight_products))
    raise NotImplementedError(
        f"remat policy {cfg.remat_policy!r}: the port has \"full\" and "
        "\"dots\"")


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
    ``torch.no_grad()``. ``place`` lays it out on a mesh.
    Batches are ``{"tokens": (B, S) int}`` or ``{"embeds":
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
        # the global index of ``layers[0]``: a pipeline stage holds a run
        # of the layers (``keep_layers``)
        self.first_layer = 0
        # one device until ``place``
        self.mesh, self.rules = None, {}
        self.tp: Optional[blocks.TensorParallel] = None
        self.dp_groups: List[Any] = []
        self.dp_size, self.dp_rank = 1, 0

    def keep_layers(self, first: int, count: int) -> "LM":
        """Keep layers ``[first, first + count)`` alone, in place: a
        pipeline stage's LM (``parallel.pipelined_lm``). Their parameters
        are then named ``layers.<i - first>.*`` (``meta``), and
        ``forward``, ``prefill`` and ``decode_step`` would run this run of
        layers alone: the stage's step is the pipeline's."""
        if self.mesh is not None or self.shared is not None:
            raise ValueError("a pipeline stage cuts an unplaced LM without "
                             "a shared block")
        if self.first_layer or not 0 <= first < first + count <= len(
                self.layers):
            raise ValueError(f"layers [{first}, {first + count}) of an LM "
                             f"holding {len(self.layers)} from "
                             f"{self.first_layer}")
        self.layers = nn.ModuleList(list(self.layers)[first:first + count])
        self.first_layer = first
        return self

    def meta(self) -> Dict[str, Any]:
        """``model_meta`` of the parameters this LM holds (a pipeline
        stage's layers alone, by its names)."""
        meta = model_meta(self.cfg)
        meta["layers"] = meta["layers"][
            self.first_layer:self.first_layer + len(self.layers)]
        return meta

    def local_name(self, name: str) -> Optional[str]:
        """The name of the parameter ``name`` (a name of the whole LM) in
        this LM, or None where it holds no such parameter (a layer of
        another pipeline stage)."""
        if not name.startswith("layers."):
            return name
        index, _, rest = name[len("layers."):].partition(".")
        i = int(index) - self.first_layer
        return f"layers.{i}.{rest}" if 0 <= i < len(self.layers) else None

    def whole_name(self, name: str) -> str:
        """The name in the whole LM of this LM's parameter ``name``."""
        if not name.startswith("layers."):
            return name
        index, _, rest = name[len("layers."):].partition(".")
        return f"layers.{int(index) + self.first_layer}.{rest}"

    def place(self, mesh, rules: Dict[str, Any],
              meta: Optional[Dict[str, Any]] = None) -> "LM":
        """Lay this whole LM out on ``mesh`` by ``rules``
        (``parallel.make_rules``), in place: its data-parallel axes
        (``dp``), and over ``model`` each parameter the sanitized rules
        shard cut to this rank's block (``tp_layouts``). With rules that
        name no axis everything stays whole."""
        if self.mesh is not None:
            raise ValueError("the LM is already laid out on a mesh")
        meta = meta if meta is not None else self.meta()
        self.mesh, self.rules = mesh, dict(rules)
        from ..parallel.rules import mesh_shape
        sizes = mesh_shape(mesh)
        dp = self.rules.get("dp")
        for ax in (dp if isinstance(dp, tuple) else (dp,) if dp else ()):
            self.dp_groups.append(mesh.get_group(ax))
            self.dp_rank = self.dp_rank * sizes[ax] + mesh.get_local_rank(ax)
            self.dp_size *= sizes[ax]
        if sizes.get("model", 1) > 1 and self.rules.get("tp") == "model":
            self.tp = blocks.TensorParallel(mesh.get_group("model"),
                                            sizes["model"],
                                            mesh.get_local_rank("model"))
            for layer in self.layers:
                layer.set_tensor_parallel(self.tp)
        layouts = self.tp_layouts(meta)
        with torch.no_grad():
            for name, param in self.named_parameters():
                if layouts[name] is not None:
                    param.data = self.tp.block(param.data,
                                               layouts[name]).clone()
        return self

    def draw(self, generator: torch.Generator, device) -> "LM":
        """Give every parameter, in place, the value the constructor draws
        from ``generator``: each drawn whole on the generator's device in
        the constructor's order, cut to this rank's block (``tp_layouts``)
        and kept on ``device``. An LM built on the ``meta`` device (which
        draws nothing) and placed thus gets the weights of ``LM(cfg,
        generator=generator)`` without a rank ever holding them whole. A
        pipeline stage draws every layer in turn and keeps its own."""
        layouts = self.tp_layouts()
        with torch.no_grad():
            for full, m in _flat(model_meta(self.cfg)).items():
                t = make_param(m, generator, device)
                name = self.local_name(full)
                if name is None:
                    continue
                if layouts[name] is not None:
                    t = self.tp.block(t, layouts[name]).clone()
                path, _, leaf = name.rpartition(".")
                owner = self.get_submodule(path)
                owner._parameters[leaf] = nn.Parameter(
                    t, requires_grad=owner._parameters[leaf].requires_grad)
        return self

    def tp_layouts(self, meta: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Optional[blocks.Runs]]:
        """``{parameter name: blocks.Runs or None}``: how each parameter is
        cut over ``model`` on this LM's mesh (None: whole on every rank).
        A recurrent mixer's weights are cut by heads (``ssm.mixer_runs``);
        any other weight along the dim the sanitized rules shard over
        ``model``, as one run (``w_in``: its v and gate columns, two)."""
        from ..parallel.rules import logical_shardings
        meta = meta if meta is not None else self.meta()
        if self.tp is None:
            return {name: None for name in _flat(meta)}
        shapes = {name: m.shape for name, m in _flat(meta).items()}
        out: Dict[str, Optional[blocks.Runs]] = {}
        for name, sh in _flat(logical_shardings(
                self.mesh, meta, self.rules)).items():
            dim = next((i for i, ax in enumerate(sh.spec) if ax == "model"),
                       None)
            n = None if dim is None else shapes[name][dim]
            out[name] = (None if dim is None
                         else blocks.Runs.cut(dim, n // 2, n // 2)
                         if name.endswith("mix.w_in")
                         else blocks.Runs.cut(dim, n))
        for i, layer in enumerate(self.layers):
            if layer.kind in RECURRENT:
                runs = ssm.mixer_runs(layer.kind, self.cfg, self.tp.size)
                out.update({f"layers.{i}.mixer.{k}": v
                            for k, v in runs.items()})
        return out

    def call(self, fn, *args, **kwargs):
        """``fn(self, *args, **kwargs)`` entered as a forward pass of this
        LM: where ``runtime.trainer.shard_lm`` put it under FSDP2, its root
        parameters are gathered around the call (the pipelined loss,
        ``parallel.pipelined_lm``, runs its layers itself)."""
        return fn(self, *args, **kwargs)

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

    def _whole(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """The embedding or head ``w``, gathered over ``model`` where this
        rank holds a block of its vocab (its gradient: this rank's block)."""
        if self.tp is None or w.shape[dim] == padded_vocab(self.cfg):
            return w
        return blocks.GatherFromRanks.apply(w, self.tp.group, dim)

    def _inputs(self, batch: Dict[str, torch.Tensor],
                positions: Optional[torch.Tensor] = None):
        """(x in the compute dtype, positions): the batch's tokens embedded
        or its embeddings, the positions given (else the batch's, else 0..S-1
        in every row), and the sinusoid added where ``rope`` is
        ``"none"``."""
        if "embeds" in batch:
            x = batch["embeds"].to(self.dtype)
        else:
            x = self._whole(self.embed, 0)[batch["tokens"]].to(self.dtype)
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
        head = (self._whole(self.embed, 0).T if self.cfg.tie_embeddings
                else self._whole(self.lm_head, 1))
        return x @ head.to(self.dtype)

    def _local_groups(self, num_groups: int, rows: bool = True) -> int:
        """The MoE groups among this rank's tokens: on a mesh each data
        rank's rows are ``num_groups / dp`` of the reference's groups
        (``rows``; else every data rank holds the whole batch)."""
        if not any(layer.kind == "attn_moe" for layer in self.layers):
            return 1
        if not rows:
            return num_groups
        if num_groups % self.dp_size:
            raise ValueError(f"{num_groups} MoE groups over {self.dp_size} "
                             "data ranks")
        return num_groups // self.dp_size

    def forward(self, batch: Dict[str, torch.Tensor], num_groups: int = 1):
        """Returns (logits (B, S, V) in the compute dtype, the float32 MoE
        aux loss summed over the layers). With ``cfg.remat`` and autograd
        on, each layer is recomputed in the backward pass (``_remat``).
        ``num_groups``: the MoE's token groups (the reference's; on a mesh,
        over all data ranks: this rank's batch is its ``num_groups / dp``
        groups, and its aux loss their mean)."""
        local = self._local_groups(num_groups)
        x, positions = self._inputs(batch)
        x = shard_act(x, "dp", None, None)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            x, layer_aux = _remat(layer, self.cfg)(x, positions,
                                                  num_groups=local)
            if layer_aux is not None:
                aux = aux + layer_aux
        x = blocks.apply_norm(self.final_norm, self.cfg, x)
        return _mask_pad_vocab(self.cfg, self._logits(x)), aux

    def seq_split(self, batch: int) -> bool:
        """The layout of the decode caches of a global batch of ``batch``
        sequences on this LM's mesh (``launch.specs.cache_pspecs``'s rule):
        False, the batch over the data ranks (each passes and caches its
        rows: ``batch % dp == 0 and batch >= dp``), or True, the
        flash-decoding layout (every data rank passes the whole batch and
        caches its block of the positions)."""
        dp = self.dp_size
        return dp > 1 and not (batch % dp == 0 and batch >= dp)

    def _split(self, rows: int, global_batch: Optional[int]) -> bool:
        """``seq_split`` of ``global_batch``, or (None) of the batch whose
        rows each data rank holds ``rows`` of."""
        return self.seq_split(global_batch if global_batch is not None
                              else rows * self.dp_size)

    def _seq(self, split: bool) -> Optional[blocks.SeqShard]:
        if not split:
            return None
        return blocks.SeqShard(tuple(self.dp_groups), self.dp_size,
                               self.dp_rank)

    def _positions(self, max_len: int, split: bool) -> int:
        """The positions of a cache of ``max_len`` that this rank holds."""
        if not split:
            return max_len
        if max_len % self.dp_size:
            raise ValueError(f"a cache of {max_len} positions does not "
                             f"split over {self.dp_size} data ranks")
        return max_len // self.dp_size

    def _seq_block(self, cache: Dict[str, torch.Tensor], max_len: int,
                   split: bool) -> Dict[str, torch.Tensor]:
        """This rank's block of the positions of a layer's attention or
        FFT-conv cache (a recurrent state as it is)."""
        if not split or not set(cache) & {"k", "v_hist"}:
            return cache
        n = self._positions(max_len, split)
        return {k: t.narrow(1, self.dp_rank * n, n).clone()
                for k, t in cache.items()}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int,
                num_groups: int = 1,
                last_index: Optional[torch.Tensor] = None,
                global_batch: Optional[int] = None):
        """Run the prompt through the stack once, returning (float32 logits
        (B, 1, V) at ``last_index`` (default: the final position), decode
        cache of ``max_len`` positions). ``last_index`` (B,) selects the
        true prompt end when the input is right-padded to a length
        bucket; a recurrent layer's state is the one after the whole
        input, pads included. ``num_groups``: the MoE's groups (on a mesh,
        over all data ranks, as in ``forward``). On a mesh the batch and
        the cache are laid out as ``init_cache(global_batch, max_len)``'s
        (``seq_split``; None: ``batch`` is this rank's rows of a batch over
        the data ranks)."""
        x, positions = self._inputs(batch)
        bsz, s = x.shape[:2]
        split = self._split(bsz, global_batch)
        local = self._local_groups(num_groups, rows=not split)
        pad = max_len - s
        if pad < 0:
            raise ValueError(f"a prompt of {s} tokens does not fit a cache "
                             f"of {max_len}")
        rope = blocks.rope_tables(self.cfg, positions)
        caches = []
        for layer in self.layers:
            x, c = layer.prefill(x, rope, pad, local)
            caches.append(self._seq_block(c, max_len, split))
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
        """An empty decode cache of ``batch`` sequences of ``max_len``: on
        a mesh ``batch`` is the global batch, which fixes the layout
        (``seq_split``), and the cache is this rank's block of it."""
        cfg, dev = self.cfg, self.device
        split = self.seq_split(batch)
        rows = batch if split else batch // self.dp_size
        n = self._positions(max_len, split)
        layers: List[Dict[str, torch.Tensor]] = []
        for layer in self.layers:
            if layer.kind in ATTENTION:
                shape = (rows, n, blocks.cached_kv_heads(
                    layer.attn, cfg, layer.tp), cfg.hd)
                layers.append({k: torch.zeros(shape, dtype=torch.bfloat16,
                                              device=dev) for k in "kv"})
            elif layer.kind == "fftconv_mlp":
                layers.append({"v_hist": torch.zeros(
                    (rows, n, layer.mix.w_out.shape[0]),
                    dtype=torch.bfloat16, device=dev)})
            else:
                layers.append(ssm.MIXERS[layer.kind].init_state(
                    cfg, rows, dev, 1 if layer.tp is None else layer.tp.size))
        return {"len": torch.zeros((rows,), dtype=torch.int32, device=dev),
                "layers": layers}

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, Any],
                    batch: Dict[str, torch.Tensor], num_groups: int = 1,
                    global_batch: Optional[int] = None):
        """One new token per sequence, ``batch = {"tokens": (B, 1)}`` or
        ``{"embeds": (B, 1, d)}``, at position ``len``; returns (float32
        logits (B, 1, V), the cache, updated in place, with ``len`` one
        longer). ``num_groups`` and ``global_batch``: as in ``prefill``
        (the cache is ``init_cache(global_batch, ...)``'s)."""
        lens = cache["len"]
        split = self._split(lens.shape[0], global_batch)
        local = self._local_groups(num_groups, rows=not split)
        seq = self._seq(split)
        x, positions = self._inputs(batch, lens[:, None])       # (B, 1)
        for layer, c in zip(self.layers, cache["layers"]):
            x, _ = layer(x, positions, c, lens, local, seq)
        x = blocks.apply_norm(self.final_norm, self.cfg, x)
        logits = _mask_pad_vocab(self.cfg, self._logits(x).float())
        return logits, {"len": lens + 1, "layers": cache["layers"]}


# ---------------------------------------------------------------------------
# the reference's entry points, over an LM
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                planner: Optional[Planner] = None, device=None) -> LM:
    return LM(cfg, planner=planner, device=device, generator=generator)


def forward(model: LM, batch: Dict[str, torch.Tensor], num_groups: int = 1):
    return model(batch, num_groups)


def loss_fn(model: LM, batch: Dict[str, torch.Tensor], num_groups: int = 1):
    """(loss, {"nll", "aux"}): the mean next-token negative log-likelihood
    over the labels >= 0 of ``batch["labels"]`` (B, S), plus 0.01 times the
    MoE aux loss (``num_groups``: the MoE's groups, ``LM.forward``). The
    reference's memory-lean cross-entropy, step by step: no (B, S, V)
    one-hot, the float32 cast inside the reductions.

    On a mesh ``batch`` is this rank's rows and the loss is the global one,
    the same on every rank: the masked sum, the mask count and the aux
    loss are summed over the data ranks (``blocks.AllReduce``, whose
    gradient is the identity), so that each rank's backward yields its
    share of the global gradient and the shares sum to it."""
    logits, aux = model(batch, num_groups)
    labels = batch["labels"].long()
    m = logits.amax(-1).float()
    shifted = logits.float() - m[..., None]
    logz = m + torch.log(torch.exp(shifted).sum(-1))
    label_logit = torch.take_along_dim(
        logits, labels.clamp(min=0)[..., None], dim=-1)[..., 0].float()
    mask = (labels >= 0).float()
    total, count = ((logz - label_logit) * mask).sum(), mask.sum()
    if model.dp_size > 1:
        groups = model.dp_groups
        total = blocks.AllReduce.apply(total, groups)
        count = blocks.AllReduce.apply(count, groups)
        aux = blocks.AllReduce.apply(aux, groups) / model.dp_size
    nll = total / count.clamp(min=1.0)
    loss = nll + 0.01 * aux
    return loss, {"nll": nll, "aux": aux}


def prefill(model: LM, batch: Dict[str, torch.Tensor], max_len: int,
            num_groups: int = 1, last_index: Optional[torch.Tensor] = None):
    return model.prefill(batch, max_len, num_groups, last_index)


def init_cache(model: LM, batch: int, max_len: int) -> Dict[str, Any]:
    return model.init_cache(batch, max_len)


def decode_step(model: LM, cache: Dict[str, Any],
                batch: Dict[str, torch.Tensor], num_groups: int = 1):
    return model.decode_step(cache, batch, num_groups)
