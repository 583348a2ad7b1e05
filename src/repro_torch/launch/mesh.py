"""Mesh construction, ported from ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
process group. Each makes a ``DeviceMesh`` over the ranks of the default
process group (``torch.distributed.init_process_group``, e.g. under
``torchrun``) with ``core.comm.make_mesh``: NCCL meshes live on the GPU,
gloo meshes on the CPU.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from ..core.comm import make_mesh


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) = 256 ranks (data, model), or (2, 16, 16) = 512 ranks
    (pod, data, model) for the two-pod configuration. Raises where the
    process group has another number of ranks, as ``jax.make_mesh``
    does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, "
                         f"got {world}")
    return make_mesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh over every rank of the process group (tests,
    CPU examples)."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: start the ranks "
                           "with torchrun or init_process_group")
    return make_mesh((data, model), ("data", "model"))
