"""AdamW with a cosine schedule and global-norm clipping, ported from
``repro.optim.adamw``.

Plain functions on tensors: the parameters, gradients and moments are
dicts from parameter name (``LM.named_parameters()``) to tensor, and the
optimizer state is ``{"mu", "nu", "step"}`` as in the reference, the
moments float32 and ``step`` a 0-d int32 tensor. ``adamw_update`` follows
the reference's order of operations (clip scale, bias corrections,
``u + wd * p``, ``p - lr * u`` in float32 cast back to ``p``'s dtype) and
writes the new parameters and moments into the tensors it was given, so
that a model of a billion parameters holds one copy of each.

The state mirrors the parameters (``opt_meta``), so the same rules shard
it: on a mesh each moment is this rank's block of its parameter's, and
the update runs on each rank's local blocks (``DTensor.to_local()`` where
FSDP hands out DTensors). ``global_norm`` is the norm of the whole tree:
each rank sums its local squares and the sums are all-reduced over the
process groups that shard each tensor, so a tensor whole on the ranks of
an axis counts once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models.params import ParamMeta, map_tree

Tensors = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor): linear warmup over
    ``warmup_steps``, then a cosine down to ``min_lr_frac`` of ``lr`` at
    ``total_steps``; float32."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def opt_meta(meta_tree) -> Dict[str, Any]:
    """``ParamMeta`` tree for the optimizer state (mu, nu mirror the
    parameters, float32; their logical axes are the parameters')."""
    mirror = map_tree(lambda m: ParamMeta(m.shape, m.logical, init="zeros",
                                          dtype=torch.float32), meta_tree)
    return {"mu": mirror, "nu": mirror,
            "step": ParamMeta((), (), init="zeros", dtype=torch.int32)}


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's block of a DTensor (the tensor itself otherwise)."""
    return t.to_local() if hasattr(t, "to_local") else t


def adamw_init(params: Tensors) -> Dict[str, Any]:
    """Zero float32 moments beside each parameter (its local block on a
    mesh), on its device, and step 0."""
    device = local(next(iter(params.values()))).device

    def zeros():
        return {n: torch.zeros(local(p).shape, dtype=torch.float32,
                               device=local(p).device)
                for n, p in params.items()}
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Tensors,
                shard_groups: Optional[Mapping[str, Sequence[Any]]] = None
                ) -> torch.Tensor:
    """The float32 L2 norm of every tensor of ``tree`` together.
    ``shard_groups`` maps a name to the process groups whose ranks hold
    disjoint blocks of that tensor (none: whole on every rank); each rank
    passes its blocks, and every rank gets the norm of the whole tree."""
    by_groups: Dict[Tuple[Any, ...], torch.Tensor] = {}
    for name, t in tree.items():
        key = tuple((shard_groups or {}).get(name, ()))
        sq = torch.sum(torch.square(local(t).float()))
        by_groups[key] = by_groups[key] + sq if key in by_groups else sq
    total = []
    for groups, sq in by_groups.items():
        for group in groups:
            dist.all_reduce(sq, group=group)
        total.append(sq)
    return torch.sqrt(sum(total))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Tensors, params: Tensors,
                 state: Dict[str, Any],
                 shard_groups: Optional[Mapping[str, Sequence[Any]]] = None
                 ) -> Tuple[Tensors, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (params, state, {"grad_norm", "lr"}). The parameters
    and the moments are updated in place and returned; ``step`` is a new
    tensor. ``grads`` has the names of ``params``; on a mesh each is this
    rank's block (or a DTensor of it) and ``shard_groups`` names the
    groups that shard it (``global_norm``)."""
    if set(grads) != set(params):
        raise ValueError(f"gradients of {sorted(set(grads) ^ set(params))} "
                         "are missing or unknown")
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads, shard_groups)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p in params.items():
        mu, nu = state["mu"][name], state["nu"][name]
        p = local(p)
        g = local(grads[name]).float() * scale
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * torch.square(g))
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    return (params, {"mu": state["mu"], "nu": state["nu"], "step": step},
            {"grad_norm": gnorm, "lr": lr})
