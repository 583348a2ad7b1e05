"""Parameter metadata: one tree declares each parameter's shape and
initialisation, ported from ``repro.models.params``.

The initialisation rules are the reference's (``normal`` draws a standard
normal in float32, scales it and casts it to the parameter's dtype;
``zeros``; ``ones``), drawn from an explicit ``torch.Generator``. The
reference's logical sharding axes and its helpers (``pspec_tree``,
``shard_act``, ``sharding_rules``, ``current_mesh``) wait for the port of
``parallel/``: on one device ``shard_act`` is the identity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: Tuple[int, ...]
    init: str = "normal"              # normal | zeros | ones
    scale: float = 0.02
    dtype: torch.dtype = torch.float32


def is_meta(x) -> bool:
    return isinstance(x, ParamMeta)


def make_param(meta: ParamMeta, generator: torch.Generator,
               device) -> torch.Tensor:
    """One parameter from its metadata; ``normal`` draws on the generator's
    device, then moves to ``device``."""
    if meta.init == "zeros":
        return torch.zeros(meta.shape, dtype=meta.dtype, device=device)
    if meta.init == "ones":
        return torch.ones(meta.shape, dtype=meta.dtype, device=device)
    w = torch.randn(meta.shape, generator=generator, device=generator.device,
                    dtype=torch.float32) * meta.scale
    return w.to(device=device, dtype=meta.dtype)


def init_tree(meta_tree: Dict[str, Any], generator: torch.Generator,
              device) -> Dict[str, Any]:
    """Materialize a (nested dict) parameter tree from metadata, drawing
    the leaves in the tree's order."""
    return {k: make_param(m, generator, device) if is_meta(m)
            else init_tree(m, generator, device)
            for k, m in meta_tree.items()}


def param_count(meta_tree) -> int:
    """Parameters in a tree of metadata (nested dicts and lists)."""
    if is_meta(meta_tree):
        return math.prod(meta_tree.shape)
    items = meta_tree.values() if isinstance(meta_tree, dict) else meta_tree
    return sum(param_count(m) for m in items)
