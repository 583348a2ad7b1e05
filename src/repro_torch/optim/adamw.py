"""AdamW with a cosine schedule and global-norm clipping, ported from
``repro.optim.adamw``.

Plain functions on tensors: the parameters, gradients and moments are
dicts from parameter name (``LM.named_parameters()``) to tensor, and the
optimizer state is ``{"mu", "nu", "step"}`` as in the reference, the
moments float32 and ``step`` a 0-d int32 tensor. ``adamw_update`` follows
the reference's order of operations (clip scale, bias corrections,
``u + wd * p``, ``p - lr * u`` in float32 cast back to ``p``'s dtype) and
writes the new parameters and moments into the tensors it was given, so
that a model of a billion parameters holds one copy of each. The
reference's ``opt_meta`` (sharding metadata of the state) waits for the
port of ``parallel/``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple

import torch

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


def adamw_init(params: Tensors) -> Dict[str, Any]:
    """Zero float32 moments beside each parameter, on its device, and
    step 0."""
    device = next(iter(params.values())).device
    return {"mu": {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for n, p in params.items()},
            "nu": {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Tensors) -> torch.Tensor:
    """The float32 L2 norm of every tensor of ``tree`` together."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree.values()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Tensors, params: Tensors,
                 state: Dict[str, Any]
                 ) -> Tuple[Tensors, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (params, state, {"grad_norm", "lr"}). The parameters
    and the moments are updated in place and returned; ``step`` is a new
    tensor. ``grads`` has the names of ``params``."""
    if set(grads) != set(params):
        raise ValueError(f"gradients of {sorted(set(grads) ^ set(params))} "
                         "are missing or unknown")
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p in params.items():
        mu, nu = state["mu"][name], state["nu"][name]
        g = grads[name].float() * scale
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * torch.square(g))
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    return (params, {"mu": state["mu"], "nu": state["nu"], "step": step},
            {"grad_norm": gnorm, "lr": lr})
