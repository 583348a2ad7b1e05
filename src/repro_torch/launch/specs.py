"""Per-cell (arch x shape x mesh) step functions and abstract inputs,
ported from ``repro.launch.specs``.

The abstract arguments are tensors on the ``meta`` device (shape and
dtype, nothing allocated): decode caches of 500k-token sequences are
described, never materialised. Each step is a callable over real tensors
laid out by the cell's shardings: an ``LM`` placed by ``Cell.place``
(tensor parallelism over ``model``, then FSDP2 over the data ranks where
the rules keep ``fsdp``, but for a frozen LM on one data rank) and this
rank's block of every other argument.

  train_step(model, opt_state, batch) -> (model, opt_state, metrics)
  prefill_step(model, batch) -> the last position's logits of ``forward``
  serve_step(model, cache, batch) -> (logits, cache): ``decode_step``
      of a cache of ``shape.global_batch`` sequences (``LM.seq_split``)

with the MoE's ``num_groups`` = the data-parallel size, as in the
reference. ``build_cell(..., pipeline=True)`` on a mesh with ``pod`` gives
a train cell of a uniform ``attn_mlp`` stack whose step runs the layers as
a GPipe pipeline over ``pod`` (``parallel.pipelined_lm``): each pod rank's
LM holds its stage's layers alone. ``REPRO_SERVE_WEIGHT_STATIONARY``
picks the ``serve`` profile for prefill and decode cells,
``REPRO_REMAT_POLICY`` the remat policy of train cells.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..configs import get_config
from ..data.pipeline import batch_specs
from ..models import ssm
from ..models.config import ArchConfig, SHAPES_BY_NAME, ShapeConfig
from ..models.lm import ATTENTION, LM, loss_fn, model_meta
from ..models.params import abstract_tree, param_count
from ..optim import AdamWConfig, adamw_update, opt_meta
from ..parallel import (logical_shardings, make_rules, mesh_shape,
                        sanitized_shardings)


@dataclasses.dataclass
class Cell:
    arch: ArchConfig
    shape: ShapeConfig
    kind: str                       # train | prefill | decode | skip
    fn: Any
    args: Tuple
    in_shardings: Tuple
    donate: Tuple[int, ...]
    skip_reason: Optional[str] = None
    mesh: Any = None
    rules: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # a train cell whose layer stack runs as a GPipe pipeline over pod:
    # each pod rank's LM holds its stage's layers alone
    pipelined: bool = False
    # what ``place`` learnt that the train step needs: the process groups
    # each gradient's blocks span
    placed: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def build(self, generator: torch.Generator, planner=None) -> LM:
        """An LM of ``arch`` laid out as ``place`` lays it, its weights
        those of ``LM(arch, generator=generator)``, drawn a parameter at a
        time and cut to this rank's block at once (``LM.draw``): a rank
        never holds the whole model (phi3.5-moe's bf16 weights pass a
        card). A pipelined cell's LM holds this rank's stage alone, drawn
        as the whole LM's layers are."""
        from ..core.comm import mesh_device
        model = LM(self.arch, planner=planner, device="meta")
        self._stage(model)
        model.place(self.mesh, self.rules)
        return self.place(model.draw(generator, mesh_device(self.mesh)))

    def place(self, model: LM, fsdp: bool = True) -> LM:
        """Lay ``model``, a whole LM of ``arch`` on this rank's device (or
        one ``build`` placed), out on the mesh as the cell's steps expect
        (``runtime.trainer.shard_lm``), in place. A prefill or decode
        cell's model is frozen (no gradients; FSDP2 then takes its mixed
        dtypes, and skips a data axis of one rank, where it has nothing
        to shard). A pipelined cell cuts a whole LM to this rank's stage
        first (``parallel.pipelined_lm.keep_stage``): then tensor
        parallelism, then FSDP2 over ``data``. ``fsdp=False`` leaves FSDP2
        out whatever the rules say (``launch.dryrun`` traces a step on
        the ``meta`` device, whose parameters FSDP2 refuses, and counts
        its collectives instead)."""
        from ..runtime.trainer import shard_lm
        if model.cfg != self.arch:
            raise ValueError(f"an LM of {model.cfg.name} as built for "
                             "another cell: build it from cell.arch")
        if self.kind != "train":
            model.requires_grad_(False)
        if model.mesh is None:
            self._stage(model)
        rules = dict(self.rules)
        if not fsdp:
            rules.pop("fsdp", None)
        self.placed["shardings"], groups = shard_lm(model, self.mesh, rules,
                                                    model.meta())
        if self.pipelined:
            from ..parallel.pipelined_lm import pod_norm_groups
            groups = pod_norm_groups(model, groups, self.mesh)
        self.placed["groups"] = groups
        return model

    def _stage(self, model: LM) -> None:
        """Cut a whole, unplaced ``model`` to this rank's pipeline stage
        where the cell is pipelined."""
        if self.pipelined and len(model.layers) == self.arch.num_layers:
            from ..parallel.pipelined_lm import keep_stage
            keep_stage(model, self.mesh)


def _axis_size(mesh, ax) -> int:
    if ax is None:
        return 1
    sizes = mesh_shape(mesh)
    if isinstance(ax, tuple):
        s = 1
        for a in ax:
            s *= sizes[a]
        return s
    return sizes[ax]


def _tp_for(dim: int, tp: Optional[str], mesh) -> Optional[str]:
    """Shard dim over tp only if it divides evenly."""
    if tp is None:
        return None
    n = mesh_shape(mesh)[tp]
    return tp if dim % n == 0 and dim >= n else None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_abstract(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    st = 1 if shape.kind == "decode" else s
    out: Dict[str, Any] = {}
    if cfg.frontend:
        out["embeds"] = _meta((b, st, cfg.d_model), torch.float32)
    else:
        out["tokens"] = _meta((b, st), torch.int32)
    if shape.kind in ("train", "prefill"):
        out["labels"] = _meta((b, st), torch.int32)
        if cfg.rope == "mrope":
            out["positions"] = _meta((3, b, st), torch.int32)
    return out


def cache_abstract(cfg: ArchConfig, batch: int,
                   max_len: int) -> Dict[str, Any]:
    """``LM.init_cache(batch, max_len)``'s tree on one device, on the
    ``meta`` device (the reference's ``jax.eval_shape`` of
    ``lm.init_cache``)."""
    layers = []
    for kind, count in cfg.resolved_segments():
        for _ in range(count):
            if kind in ATTENTION:
                kv = _meta((batch, max_len, cfg.num_kv_heads, cfg.hd),
                           torch.bfloat16)
                layers.append({"k": kv, "v": kv})
            elif kind == "fftconv_mlp":
                layers.append({"v_hist": _meta((batch, max_len, cfg.d_model),
                                               torch.bfloat16)})
            else:
                layers.append(ssm.MIXERS[kind].init_state(cfg, batch, "meta"))
    return {"len": _meta((batch,), torch.int32), "layers": layers}


def cache_pspecs(cfg: ArchConfig, batch: int, mesh, rules) -> Dict[str, Any]:
    """Spec tree of ``LM.init_cache``'s cache on a placed LM: ``{"len":
    spec, "layers": [{name: spec}, ...]}``, one entry per layer (the
    reference's per-segment specs without their stacked axis).

    Batch >= dp: shard batch over dp (throughput decode).  Batch < dp (the
    long_500k single-sequence cell): shard the SEQUENCE of attention caches
    / history buffers over dp instead (flash-decoding layout), and state
    dims over tp.

    Where ``model`` does not divide the K/V heads the reference shards the
    head dim instead; the port's placed LM then caches, whole, the K/V
    heads that each rank's query heads read (``blocks.cached_kv_heads``),
    a layout no spec states, and this spec is the reference's. So for the
    recurrent states: where ``model`` divides the heads, the port's Mamba2
    convolution state holds its heads' channels and B and C whole (this
    spec cuts the concatenated dim), and its sLSTM state its heads, each
    whole (this spec cuts the head dim), as ``ssm.mixer_runs`` cuts the
    weights; the mLSTM state and Mamba2's SSD state are cut by heads
    either way.
    """
    dp, tp = rules.get("dp"), rules.get("tp")
    dpn = _axis_size(mesh, dp)
    shard_b = batch % dpn == 0 and batch >= dpn
    bax = dp if shard_b else None
    sax = None if shard_b else dp
    kv, hd = cfg.num_kv_heads, cfg.hd

    layers = []
    for kind, count in cfg.resolved_segments():
        if kind in ATTENTION:
            kvax = _tp_for(kv, tp, mesh)
            hax = None if kvax else _tp_for(hd, tp, mesh)
            spec = (bax, sax, kvax, hax)
            entry = {"k": spec, "v": spec}
        elif kind == "mamba2":
            di, nh, n = ssm.mamba2_dims(cfg)
            entry = {"conv": (bax, None, _tp_for(di + 2 * n, tp, mesh)),
                     "ssd": (bax, _tp_for(nh, tp, mesh), None, None)}
        elif kind == "mlstm":
            dh = 2 * cfg.d_model // cfg.num_heads
            hax = _tp_for(cfg.num_heads, tp, mesh)
            kax = None if hax else _tp_for(dh, tp, mesh)
            entry = {"mlstm": (bax, hax, kax, None)}
        elif kind == "slstm":
            dh = cfg.d_model // cfg.slstm_heads
            leaf = (bax, None, _tp_for(dh, tp, mesh))
            entry = dict.fromkeys("cnhm", leaf)
        elif kind == "fftconv_mlp":
            entry = {"v_hist": (bax, sax, _tp_for(cfg.d_model, tp, mesh))}
        else:
            entry = {}
        layers.extend(dict(entry) for _ in range(count))
    return {"len": (bax if shard_b else None,), "layers": layers}


def weight_budget(mesh) -> float:
    """Bytes of TP-resident bf16 weights a rank may hold before the serve
    profile keeps FSDP: half of the memory of the card this rank runs on
    (the reference's 8e9 is half of a TPU chip's 16 GB)."""
    dev = torch.cuda.current_device() if getattr(
        mesh, "device_type", "cuda") == "cuda" else None
    if dev is None:
        raise ValueError("a CPU mesh has no card to size the serve "
                         "profile's weights by: pass serve_budget")
    return torch.cuda.get_device_properties(dev).total_memory / 2


def build_cell(arch: Union[str, ArchConfig], shape: Union[str, ShapeConfig],
               mesh, pipeline: bool = False,
               serve_budget: Optional[float] = None) -> Cell:
    """The cell of ``arch`` (a config name or an ``ArchConfig``) and
    ``shape`` (a name of ``SHAPES_BY_NAME`` or a ``ShapeConfig``) on
    ``mesh``. ``serve_budget``: the serve profile's bytes of weights a
    rank may hold without FSDP (None: ``weight_budget``). ``pipeline``:
    the rules of ``make_rules(mesh, pipeline_pods=True)`` (``dp`` and
    ``fsdp`` over ``data`` alone), and a train cell of a config that
    ``supports_pipeline`` on a mesh with ``pod`` runs its layer stack as a
    GPipe pipeline over ``pod`` (``pipelined_loss_fn``); any other cell
    keeps the plain steps under those rules, its pod ranks replicas."""
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    shape = shape if isinstance(shape, ShapeConfig) else \
        SHAPES_BY_NAME[shape]
    # REPRO_SERVE_WEIGHT_STATIONARY=1 flips inference cells to the
    # weight-stationary serving layout: bf16 params and reductions, MoE
    # experts stationary on model, FSDP dropped when the TP-sharded bf16
    # weights fit the budget.
    profile = "train"
    if shape.kind != "train" and os.environ.get(
            "REPRO_SERVE_WEIGHT_STATIONARY", "0") not in ("0", "", "false"):
        profile = "serve"
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                                  reduce_dtype="bfloat16")
    if shape.kind == "train" and os.environ.get(
            "REPRO_REMAT_POLICY", "") in ("dots", "full"):
        cfg = dataclasses.replace(
            cfg, remat_policy=os.environ["REPRO_REMAT_POLICY"])
    rules = make_rules(mesh, pipeline_pods=pipeline, profile=profile)
    if profile == "serve" and "fsdp" in rules:
        pbytes = param_count(model_meta(cfg)) * 2
        tp_size = mesh_shape(mesh).get("model", 1)
        budget = serve_budget if serve_budget is not None else \
            weight_budget(mesh)
        if pbytes / tp_size <= budget:
            del rules["fsdp"]          # weights TP-resident, no per-use gather

    if shape.kind == "decode" and shape.name == "long_500k" and \
            not cfg.subquadratic:
        return Cell(cfg, shape, "skip", None, (), (), (),
                    skip_reason="pure full-attention arch: quadratic "
                    "attention at 500k context; skipped per assignment",
                    mesh=mesh, rules=rules)

    meta = model_meta(cfg)
    pspecs = logical_shardings(mesh, meta, rules)
    params_abs = abstract_tree(meta)
    batch_abs = batch_abstract(cfg, shape)
    raw_bspecs = batch_specs(cfg, shape, rules)
    # decode batches may omit labels/positions present in raw specs
    raw_bspecs = {k: raw_bspecs[k] for k in batch_abs}
    bspecs = sanitized_shardings(mesh, batch_abs, raw_bspecs)

    num_groups = _axis_size(mesh, rules.get("dp"))
    placed: Dict[str, Any] = {}

    def cell(kind, fn, args, shardings, donate, pipelined=False):
        return Cell(cfg, shape, kind, fn, args, shardings, donate,
                    mesh=mesh, rules=rules, placed=placed,
                    pipelined=pipelined)

    if shape.kind == "train":
        from ..parallel.pipelined_lm import (pipeline_param_shardings,
                                             pipelined_loss_fn,
                                             supports_pipeline,
                                             sync_pod_grads)
        ocfg = AdamWConfig()
        om = opt_meta(meta)
        opt_abs = abstract_tree(om)
        use_pipeline = (pipeline and "pod" in mesh_shape(mesh)
                        and supports_pipeline(cfg))
        if use_pipeline:
            pspecs = pipeline_param_shardings(mesh, meta, rules)
            ospecs = {"mu": pipeline_param_shardings(mesh, om["mu"], rules),
                      "nu": pipeline_param_shardings(mesh, om["nu"], rules),
                      "step": logical_shardings(mesh, om["step"], rules)}

            def loss_impl(model, batch):
                return pipelined_loss_fn(model, batch, mesh, rules)
        else:
            ospecs = logical_shardings(mesh, om, rules)

            def loss_impl(model, batch):
                return loss_fn(model, batch, num_groups)

        def train_step(model, opt_state, batch):
            params = dict(model.named_parameters())
            model.zero_grad(set_to_none=True)
            loss, metrics = loss_impl(model, batch)
            loss.backward()
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in params.items()}
            if use_pipeline:
                sync_pod_grads(model, grads, mesh)
            _, opt_state, om_ = adamw_update(ocfg, grads, params, opt_state,
                                             placed.get("groups"))
            model.zero_grad(set_to_none=True)
            return model, opt_state, dict(metrics, loss=loss, **om_)

        return cell("train", train_step, (params_abs, opt_abs, batch_abs),
                    (pspecs, ospecs, bspecs), (0, 1), use_pipeline)

    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill_step(model, batch):
            logits, _ = model(batch, num_groups)
            return logits[:, -1:, :]

        return cell("prefill", prefill_step, (params_abs, batch_abs),
                    (pspecs, bspecs), ())

    # decode
    cache_abs = cache_abstract(cfg, shape.global_batch, shape.seq_len)
    cspecs = sanitized_shardings(
        mesh, cache_abs, cache_pspecs(cfg, shape.global_batch, mesh, rules))

    def serve_step(model, cache, batch):
        return model.decode_step(cache, batch, num_groups,
                                 shape.global_batch)

    return cell("decode", serve_step, (params_abs, cache_abs, batch_abs),
                (pspecs, cspecs, bspecs), (1,))
