"""Parameter metadata: one tree declares each parameter's shape,
initialisation and logical sharding, ported from ``repro.models.params``.

The initialisation rules are the reference's (``normal`` draws a standard
normal in float32, scales it and casts it to the parameter's dtype;
``zeros``; ``ones``), drawn from an explicit ``torch.Generator``. Logical
axes (``"fsdp"``, ``"tp"``, ``"expert"``, ``"moe_d"``, ``"moe_f"`` or None
per dim) are mapped to mesh axes by a rule table (``parallel.make_rules``),
so the same model definition runs on the single-pod (data, model) mesh,
the multi-pod (pod, data, model) mesh or one device (rules = {}).

A spec is a tuple with one entry per dim: None, a mesh axis name or a tuple
of them (the reference's ``PartitionSpec``). ``sharding_rules``,
``current_mesh`` and ``current_rules`` keep the reference's ambient (mesh,
rules) API; nothing in the port reads it, for the LM holds its own mesh
and rules (``LM.place``). The reference's ``shard_act`` is a sharding
constraint with no effect on values; the port runs each block on this
rank's local tensors, where there is nothing to constrain, so its
``shard_act`` returns the tensor unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Optional, Tuple

import torch

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"              # normal | zeros | ones
    scale: float = 0.02
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in length")


def is_meta(x) -> bool:
    return isinstance(x, ParamMeta)


def map_tree(fn, tree):
    """``fn`` on every ``ParamMeta`` of a tree of dicts and lists."""
    if is_meta(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return [map_tree(fn, v) for v in tree]


def make_param(meta: ParamMeta, generator: torch.Generator,
               device) -> torch.Tensor:
    """One parameter from its metadata; ``normal`` draws on the generator's
    device, then moves to ``device``. On the ``meta`` device nothing is
    drawn (the generator does not advance)."""
    if torch.device(device).type == "meta":
        return torch.empty(meta.shape, dtype=meta.dtype, device="meta")
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


def abstract_tree(meta_tree):
    """The tree as tensors on the ``meta`` device (shape and dtype, nothing
    allocated): the counterpart of the reference's ShapeDtypeStruct tree."""
    return map_tree(lambda m: torch.empty(m.shape, dtype=m.dtype,
                                          device="meta"), meta_tree)


def logical_spec(logical, rules: Dict[str, Any]) -> Spec:
    """Mesh axes of logical axes; names the rules lack are replicated."""
    return tuple(rules.get(ax) if ax is not None else None for ax in logical)


def pspec_tree(meta_tree, rules: Dict[str, Any]):
    """Spec tree via logical -> physical axis rules.

    rules example: {"fsdp": ("pod", "data"), "tp": "model", "expert":
    "model"}. Logical names missing from the table are replicated.
    """
    return map_tree(lambda m: logical_spec(m.logical, rules), meta_tree)


def param_count(meta_tree) -> int:
    """Parameters in a tree of metadata (nested dicts and lists)."""
    if is_meta(meta_tree):
        return math.prod(meta_tree.shape)
    items = meta_tree.values() if isinstance(meta_tree, dict) else meta_tree
    return sum(param_count(m) for m in items)


# ---------------------------------------------------------------------------
# ambient mesh + rules for activation sharding constraints
# ---------------------------------------------------------------------------

_CTX = threading.local()


@contextlib.contextmanager
def sharding_rules(mesh, rules: Dict[str, Any]):
    prev = getattr(_CTX, "val", None)
    _CTX.val = (mesh, rules)
    try:
        yield
    finally:
        _CTX.val = prev


def axes_size(sizes: Dict[str, int], ax) -> int:
    """The number of ranks of a spec entry (None, a name or a tuple)."""
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        return math.prod(sizes[a] for a in ax)
    return sizes[ax]


def shard_act(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``x`` unchanged: the reference's sharding constraint on an
    activation laid out by ``logical``, which a rank's local block already
    satisfies."""
    return x


def current_rules() -> Dict[str, Any]:
    ctx = getattr(_CTX, "val", None)
    return ctx[1] if ctx else {}


def current_mesh():
    ctx = getattr(_CTX, "val", None)
    return ctx[0] if ctx else None
