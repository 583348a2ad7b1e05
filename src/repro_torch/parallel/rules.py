"""Logical-axis -> mesh-axis rule tables, ported from
``repro.parallel.rules``.

One model definition, three deployments:
  * 1 device           : {}                        (everything replicated)
  * single pod (d, m)  : fsdp/dp -> data, tp/expert -> model
  * multi-pod (p, d, m): fsdp/dp -> (pod, data)   (ZeRO across all DP ranks)

"dp" shards batch-like activation dims; "fsdp" shards weight dims
(gathered on use); "tp" is tensor parallelism; "expert" places MoE
experts; "sp" is the sequence/FFT slab axis.

A mesh is a ``DeviceMesh`` whose dim names are the axis names, a plain
``{axis: size}`` mapping, or any object whose ``shape`` is such a mapping
(as a JAX mesh's is): the rules need only the sizes. A spec is a
tuple with one entry per dim (None, an axis name or a tuple of names);
``logical_shardings`` and ``sanitized_shardings`` return trees of
``NamedSharding`` (a mesh and a spec), whose ``shard`` and ``gather`` cut
a whole tensor into this rank's block and put it back together.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import torch
import torch.distributed as dist

from ..core.comm import mesh_sizes
from ..models.params import ParamMeta, axes_size, is_meta, pspec_tree

Spec = Tuple[Any, ...]


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, of a mapping or of an object
    whose ``shape`` is a mapping."""
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        mesh = shape
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return mesh_sizes(mesh)


def make_rules(mesh, pipeline_pods: bool = False,
               profile: str = "train") -> Dict[str, Any]:
    """profile: "train" gathers FSDP-sharded weights on use (ZeRO);
    "serve" keeps MoE expert weights stationary (d_ff sharded over data,
    contraction psums activations): far fewer collective bytes when there
    is no optimizer to shard for."""
    axes = tuple(mesh_shape(mesh))
    if "pod" in axes:
        dp = ("data",) if pipeline_pods else ("pod", "data")
        dp = dp if len(dp) > 1 else dp[0]
        rules = {"fsdp": dp, "dp": dp, "tp": "model", "expert": "model",
                 "sp": "data", "pipe": "pod"}
    elif "data" in axes:
        rules = {"fsdp": "data", "dp": "data", "tp": "model",
                 "expert": "model", "sp": "data"}
    else:
        return {}
    if profile == "serve":
        # weight-stationary MoE: experts live on the model axis, no FSDP
        # sharding of d/ff -> zero weight-gather collectives at inference
        rules["moe_d"] = None
        rules["moe_f"] = None
    else:
        rules["moe_d"] = rules["fsdp"]
        rules["moe_f"] = None
    return {k: v for k, v in rules.items() if v is not None}


def _axis_size(mesh, ax) -> int:
    return axes_size(mesh_shape(mesh), ax)


def sanitize_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop mesh axes that do not evenly divide their dimension (e.g. 4
    mLSTM heads cannot shard over 16-way tensor parallelism: replicate
    instead)."""
    out = []
    for i, ax in enumerate(tuple(spec)):
        if ax is None or i >= len(shape):
            out.append(None)
            continue
        size = _axis_size(mesh, ax)
        out.append(ax if (size > 0 and shape[i] % size == 0
                          and shape[i] >= size) else None)
    return tuple(out)


def _names(ax) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor laid out over ``mesh`` by ``spec``: dim i cut into
    ``size(spec[i])`` equal blocks, block c on the ranks whose coordinate
    along those axes (row-major over a tuple) is c. ``stage``: None (on
    every coordinate of the axes the spec leaves out), or the coordinate
    along ``pod`` of the ranks that alone hold it (a pipeline stage's
    layer, ``parallel.pipelined_lm.pipeline_param_shardings``)."""
    mesh: Any
    spec: Spec
    stage: Any = None

    def _coordinate(self, ax) -> int:
        sizes = mesh_shape(self.mesh)
        c = 0
        for a in _names(ax):
            c = c * sizes[a] + self.mesh.get_local_rank(a)
        return c

    def shard(self, whole):
        """This rank's block of ``whole`` (a tensor or a numpy array; a
        view)."""
        out = whole
        for dim, ax in enumerate(self.spec):
            n = _axis_size(self.mesh, ax)
            if n == 1:
                continue
            if out.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(whole.shape)} does "
                                 f"not split over {ax}")
            w, c = out.shape[dim] // n, self._coordinate(ax)
            index = [slice(None)] * out.ndim
            index[dim] = slice(c * w, c * w + w)
            out = out[tuple(index)]
        return out

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block (collective over each
        axis of the spec; every rank gets it)."""
        out = local.contiguous()
        for dim, ax in enumerate(self.spec):
            for a in reversed(_names(ax)):   # the minor axis first
                n = mesh_shape(self.mesh)[a]
                if n == 1:
                    continue
                parts = [torch.empty_like(out) for _ in range(n)]
                dist.all_gather(parts, out, group=self.mesh.get_group(a))
                out = torch.cat(parts, dim)
        return out


def logical_shardings(mesh, meta_tree, rules: Dict):
    """``NamedSharding`` tree for a ``ParamMeta`` tree
    (divisibility-sanitized)."""
    specs = pspec_tree(meta_tree, rules)

    def build(meta: ParamMeta, spec: Spec) -> NamedSharding:
        return NamedSharding(mesh, sanitize_spec(spec, meta.shape, mesh))

    return _zip_map(build, meta_tree, specs, is_meta)


def sanitized_shardings(mesh, abstract_tree, spec_tree):
    """``NamedSharding`` tree for a tree of tensors (``abstract_tree``'s
    ``meta`` tensors, or any with a shape) and a spec tree."""
    def build(abs_, spec):
        return NamedSharding(mesh, sanitize_spec(spec, abs_.shape, mesh))
    return _zip_map(build, abstract_tree, spec_tree,
                    lambda x: hasattr(x, "shape"))


def _zip_map(fn, tree, other, is_leaf):
    if is_leaf(tree):
        return fn(tree, other)
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k], is_leaf)
                for k, v in tree.items()}
    return [_zip_map(fn, v, o, is_leaf) for v, o in zip(tree, other)]
