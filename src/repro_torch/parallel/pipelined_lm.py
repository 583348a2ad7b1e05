"""Pipelined LM training step: GPipe over the pod axis for uniform-stack
dense architectures, ported from ``repro.parallel.pipelined_lm``.

FSDP over (pod, data) all-gathers every weight across the pods each
layer; pipelining instead keeps the layers POD-LOCAL (pod rank s holds
layers [s·L/S, (s+1)·L/S) and no others: ``pipeline_param_shardings``,
``keep_stage``) and sends only microbatch activations at stage
boundaries, plus ONE scalar (the loss).

Within a stage the mesh's other axes work as in ``loss_fn``: tensor
parallelism over ``model`` (``LM.place``) and FSDP2 over ``data`` only
(``make_rules(mesh, pipeline_pods=True)`` gives ``dp = "data"``). The
loss is computed on the last stage and summed over ``pod`` (zero on the
other stages), so that every rank returns it.

The whole-over-pod parameters (``embed``, ``final_norm`` and an untied
``lm_head``) enter the reference's ``shard_map`` replicated, so their
cotangents are summed over ``pod``. In the port each stage holds a part of
their gradient (the embedding's on stage 0, the head's and the final
norm's on the last stage, a tied embedding's on both): ``sync_pod_grads``
all-reduces them over ``pod`` before clipping, and ``pod_norm_groups``
makes ``optim.adamw.global_norm`` sum the stage-local layers' squares over
``pod`` while counting the whole-over-pod parameters once.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from ..models import blocks
from ..models.config import ArchConfig
from ..models.lm import LM, _remat, token_nll_sum
from ..optim.adamw import NormShare, local
from .pipeline import pipeline_stages
from .rules import NamedSharding, logical_shardings, mesh_shape

POD = "pod"
# the reference's default number of microbatches a step
NUM_MICROBATCHES = 8


def supports_pipeline(cfg: ArchConfig) -> bool:
    segs = cfg.resolved_segments()
    return len(segs) == 1 and segs[0][0] in ("attn_mlp",)


def microbatches(bsz: int, num_microbatches: int) -> int:
    """The number of microbatches of a batch of ``bsz`` rows: the
    reference's ``while bsz % m: m -= 1`` from ``num_microbatches``."""
    m = num_microbatches
    while bsz % m:
        m -= 1
    return m


def stage_layers(n: int, stages: int, stage: int) -> Tuple[int, int]:
    """(first, count): the layers of pipeline stage ``stage`` of
    ``stages`` in a stack of ``n``, cut into equal runs as a leading dim
    sharded over ``pod`` is (which needs ``stages`` to divide ``n``)."""
    if n % stages:
        raise ValueError(f"{n} layers do not split over {stages} pipeline "
                         "stages")
    return stage * (n // stages), n // stages


def pipeline_param_shardings(mesh, meta_tree, rules: Dict):
    """Like ``logical_shardings`` but each layer of the stack stands on one
    pod rank alone (its ``NamedSharding.stage``): the port's counterpart
    of the reference's stacked leading dim sharded over ``pod``. The
    layers' specs are the reference's without that dim."""
    base = logical_shardings(mesh, meta_tree, rules)
    layers = meta_tree["layers"]
    stages = mesh_shape(mesh)[POD]
    per = stage_layers(len(layers), stages, 0)[1]

    def restage(tree, stage):
        if isinstance(tree, NamedSharding):
            return NamedSharding(tree.mesh, tree.spec, stage)
        return {k: restage(v, stage) for k, v in tree.items()}

    return dict(base, layers=[restage(sh, i // per)
                              for i, sh in enumerate(base["layers"])])


def keep_stage(model: LM, mesh) -> LM:
    """``model`` (an unplaced LM) cut, in place, to this rank's pipeline
    stage: the layers of its coordinate along ``pod``
    (``LM.keep_layers``)."""
    stages = mesh_shape(mesh)[POD]
    first, count = stage_layers(model.cfg.num_layers, stages,
                                mesh.get_local_rank(POD))
    return model.keep_layers(first, count)


def whole_over_pod(model: LM):
    """The names of the parameters every stage holds: all but the
    layers'."""
    return [n for n, _ in model.named_parameters()
            if not n.startswith("layers.")]


@torch.no_grad()
def sync_pod_grads(model: LM, grads: Dict[str, torch.Tensor], mesh) -> None:
    """Sum, in place over ``pod``, the gradient of every parameter whole
    over ``pod`` (each stage holds a part of it). ``grads`` by name, a
    tensor for every such parameter (zeros where a stage has none)."""
    group = mesh.get_group(POD)
    for name in whole_over_pod(model):
        dist.all_reduce(local(grads[name]), group=group)


def pod_norm_groups(model: LM, groups: Dict[str, Any], mesh
                    ) -> Dict[str, Any]:
    """``global_norm``'s ``shard_groups`` (``shard_lm``'s) with ``pod``
    added to every layer's: the stages hold disjoint layers, so their
    squares are summed over ``pod``; the whole-over-pod parameters
    (summed by ``sync_pod_grads``) count once."""
    pod = mesh.get_group(POD)
    out = dict(groups)
    for name, entry in groups.items():
        if not name.startswith("layers."):
            continue
        if isinstance(entry, NormShare):
            out[name] = NormShare(tuple(entry.groups) + (pod,), entry.weight)
        else:
            out[name] = list(entry) + [pod]
    return out


def pipelined_loss_fn(model: LM, batch: Dict[str, torch.Tensor], mesh,
                      rules: Dict,
                      num_microbatches: int = NUM_MICROBATCHES):
    """Cross-entropy loss with the layer stack executed as a pod-axis
    pipeline: (nll, {"nll", "aux": 0}), the same on every rank.

    ``model`` is this rank's stage (``keep_stage``), laid out on ``mesh``
    by ``rules`` (``make_rules(mesh, pipeline_pods=True)``); ``batch`` is
    this data rank's rows, ``{"tokens", "labels"}``. The rows go through
    in ``microbatches(rows, num_microbatches)`` microbatches. The loss is
    the masked sum over the whole batch over its mask count (summed over
    the data ranks), not a mean of the microbatches' means."""
    cfg = model.cfg
    if not supports_pipeline(cfg):
        raise ValueError(f"{cfg.name}: the pipeline takes one attn_mlp "
                         "segment, not "
                         f"{[k for k, _ in cfg.resolved_segments()]}")
    if "tokens" not in batch:
        raise ValueError("the pipelined loss takes a batch of tokens (the "
                         "reference reads batch['tokens']): an 'embeds' "
                         "batch has no pipelined path")
    dp = rules.get("dp")
    if POD in (dp if isinstance(dp, tuple) else (dp,)):
        raise ValueError("the pipeline takes the rules of "
                         "make_rules(mesh, pipeline_pods=True): dp over "
                         f"{dp} includes pod")
    return model.call(_loss, batch, mesh, num_microbatches)


def _loss(model: LM, batch: Dict[str, torch.Tensor], mesh,
          num_microbatches: int):
    cfg = model.cfg
    tokens, labels = batch["tokens"], batch["labels"]
    bsz, s = tokens.shape
    m = microbatches(bsz, num_microbatches)
    mb = bsz // m
    # the embedding on every pod rank (stage 0 alone reads it)
    x, _ = model._inputs({"tokens": tokens})
    positions = torch.arange(s, device=x.device)[None].expand(mb, s)
    x_mb = x.reshape(m, mb, s, cfg.d_model)

    def stage(layers, xin):
        for layer in layers:
            xin, _ = _remat(layer, cfg)(xin, positions)
        return xin

    outs, me, stages = pipeline_stages(stage, model.layers, x_mb, mesh, POD)
    if me == stages - 1:
        # head + loss on the LAST stage only
        y = blocks.apply_norm(model.final_norm, cfg,
                              outs.reshape(bsz, s, cfg.d_model))
        total, count = token_nll_sum(model, model._head(y), labels)
        nll = total / count.clamp(min=1.0)
    else:
        # 0, in the graph of this stage's ticks: its backward runs them
        nll = outs.float().sum()
    nll = blocks.AllReduce.apply(nll, (mesh.get_group(POD),))
    return nll, {"nll": nll, "aux": torch.zeros((), dtype=torch.float32,
                                                device=nll.device)}
