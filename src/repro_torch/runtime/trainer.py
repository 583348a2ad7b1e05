"""Fault-tolerant training driver, ported from ``repro.runtime.trainer``.

* one step: ``loss_fn`` and its backward (``grad_accum`` microbatches
  summed and scaled as the reference does), then ``adamw_update``;
* checkpoint every ``ckpt_every`` steps and at the end (async, atomic,
  keep-N): the LM's parameters by name and the AdamW state;
* restart: resume from the latest checkpoint (parameters, Adam moments,
  the data iterator's step), bit for bit where the arithmetic is
  deterministic (the CPU);
* straggler watchdog: per-step wall-time EWMA; steps slower than
  ``straggler_factor`` x the EWMA are recorded as straggler events;
* preemption hook: ``REPRO_PREEMPT_AT=<step>`` raises ``SystemExit`` after
  the checkpoint at that step, a simulated SIGTERM for the restart tests.

The model is an ``LM`` on one device (``device=None``: the GPU, which
raises without one), or on a ``DeviceMesh`` with axes ``data`` and
``model`` (and ``pod``), every rank of it running the trainer:

* ``rules = make_rules(mesh)``; the MoE's groups are the ``dp`` ranks;
* tensor parallelism first: the LM keeps each rank's block of the weights
  the sanitized rules shard over ``model`` (``LM.place``);
* then each layer and the root go under FSDP2's ``fully_shard`` over the
  ``dp`` ranks: ZeRO-3, what the reference's ``fsdp`` rule does. FSDP2
  cuts each parameter along its first dim (the reference's rule names a
  dim per parameter; either way every parameter, gradient and moment is
  1/dp a rank). Gradients are summed over the data ranks (each rank's
  loss is its share of the global one, ``lm.loss_fn``);
* the AdamW moments are each rank's blocks (``opt_meta``: sharded like
  their parameters), updated in place on the local blocks;
* each step reads this rank's rows (``sharded_batch_at``);
* checkpoints gather every tensor whole and one rank writes them in the
  one-device format; a restore cuts them for the current mesh, whatever
  mesh (or device) wrote them.

Parameters stay float32 and are cast at each use.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..core.comm import mesh_device
from ..core.plan import Planner, resolve_device
from ..data import SyntheticDataset
from ..models.blocks import Runs, TensorParallel
from ..models.config import ArchConfig, ShapeConfig
from ..models.lm import LM, loss_fn, model_meta
from ..models.params import axes_size
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..optim.adamw import NormShare, local
from ..parallel import make_rules, mesh_shape


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep_n: int = 3
    straggler_factor: float = 3.0
    seed: int = 0
    # gradient accumulation: split the global batch into this many
    # microbatches and sum their gradients: the numerics of one big batch
    # at 1/n the activation memory
    grad_accum: int = 1


class MeshLayout:
    """Where a parameter (or its moment) lives on the trainer's mesh: a
    block over ``model`` (``tp`` and the LM's ``blocks.Runs`` layout, or
    None) cut further by FSDP2 over the data ranks (``ref``: the
    parameter's DTensor). ``gather`` and ``shard`` are the checkpoint's
    (``CheckpointManager.save``/``restore``)."""

    def __init__(self, ref: torch.Tensor, tp: Optional[TensorParallel],
                 layout: Optional[Runs]):
        self.ref, self.tp, self.layout = ref, tp, layout

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        if hasattr(self.ref, "device_mesh"):
            t = _gather_rows(local(t), self.ref)
        if self.layout is not None:
            t = self.tp.gather(t, self.layout)
        return t

    def shard(self, whole: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import distribute_tensor
        t = whole.to(local(self.ref).device)
        if self.layout is not None:
            t = self.tp.block(t, self.layout)
        if not hasattr(self.ref, "device_mesh"):
            return t
        return distribute_tensor(t.contiguous(), self.ref.device_mesh,
                                 self.ref.placements,
                                 src_data_rank=None).to_local()

    def norm_weight(self) -> Optional[torch.Tensor]:
        """Where whole runs stand inside a block cut over ``model``: the
        weight of each element of this rank's local block in the gradient
        norm (``Runs.weight``, broadcast along its dim and cut to FSDP2's
        rows), else None."""
        if self.layout is None or not self.layout.mixed:
            return None
        block = local(self.ref)
        w = self.layout.weight(self.tp.size)
        if hasattr(self.ref, "device_mesh") and self.layout.dim == 0:
            rows = -(-self.ref.shape[0] // self.ref.device_mesh.size())
            first = self.ref.device_mesh.get_local_rank() * rows
            w = w[first:first + block.shape[0]]
        shape = [1] * block.dim()
        shape[self.layout.dim] = -1
        return w.view(shape).to(block.device)


def _gather_rows(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's FSDP2 block
    (``ref``: a DTensor laid out the same, sharded by rows over a 1-D mesh
    in ``torch.chunk``'s blocks), by the c10d all-gather: DTensor's
    ``full_tensor`` crashes on gloo with CUDA tensors (torch 2.11)."""
    from torch.distributed.tensor import Shard
    if tuple(ref.placements) != (Shard(0),):
        raise ValueError(f"FSDP2 blocks laid out as {ref.placements}")
    group = ref.device_mesh.get_group()
    ranks, n = torch.distributed.get_world_size(group), ref.shape[0]
    rows = -(-n // ranks)
    block = t.new_zeros((rows,) + tuple(t.shape[1:]))
    block[:t.shape[0]] = t.detach()
    parts = [torch.empty_like(block) for _ in range(ranks)]
    torch.distributed.all_gather(parts, block, group=group)
    return torch.cat(parts)[:n]


def _dp_mesh(mesh, rules: Dict[str, Any]):
    """The sub-mesh of the ``dp`` axes (one dim; two flattened)."""
    dp = rules.get("dp")
    if dp is None:
        return None
    if isinstance(dp, str):
        return mesh[dp]
    return mesh[dp]._flatten("_".join(dp))


def shard_lm(model: LM, mesh, rules: Dict[str, Any],
             meta: Optional[Dict[str, Any]] = None):
    """Lay ``model`` out on ``mesh`` by ``rules``, in place: tensor
    parallelism (``LM.place``, unless the LM is placed already), then,
    where the rules keep ``fsdp`` (and it is not sharded already, nor a
    frozen LM on a data axis of one rank: nothing to shard, and FSDP2's
    per-layer hooks cost a serving step host time), FSDP2 over the dp
    ranks, every layer and then the root (the shared block of
    zamba2 with the root: it runs at several places), the LM's and the
    layers' ``prefill`` and the LM's ``decode_step`` and ``call`` gathering
    their parameters as ``forward`` does. Returns ({name: MeshLayout}, {name:
    the process groups its gradient's blocks span, or, for a block that
    holds whole runs, an ``optim.adamw.NormShare`` of them}), the second
    ``global_norm``'s ``shard_groups``."""
    from torch.distributed.fsdp import (FSDPModule, fully_shard,
                                        register_fsdp_forward_method)
    if model.mesh is None:
        model.place(mesh, rules, meta)
    layouts = model.tp_layouts(meta)
    dp_mesh = _dp_mesh(mesh, rules) if "fsdp" in rules else None
    if dp_mesh is not None and dp_mesh.size() == 1 and not any(
            p.requires_grad for p in model.parameters()):
        dp_mesh = None              # a frozen LM on one data rank: no FSDP
    if dp_mesh is not None and not isinstance(model, FSDPModule):
        layers = [layer for layer in dict.fromkeys(model.layers)
                  if layer is not model.shared]
        for module in layers + [model]:
            fully_shard(module, mesh=dp_mesh)
        for module in layers + [model]:
            # each rank's loss is its share: sum, do not average
            module.set_gradient_divide_factor(1.0)
            module.set_force_sum_reduction_for_comms(True)
        for layer in layers:
            register_fsdp_forward_method(layer, "prefill")
        for method in ("prefill", "decode_step", "call"):
            register_fsdp_forward_method(model, method)
    dp_groups = [g for g in model.dp_groups
                 if torch.distributed.get_world_size(g) > 1]
    shardings, groups = {}, {}
    for name, p in model.named_parameters():
        shardings[name] = MeshLayout(p, model.tp, layouts[name])
        groups[name] = ((dp_groups if dp_mesh is not None else [])
                        + ([model.tp.group] if layouts[name] is not None
                           else []))
        weight = shardings[name].norm_weight()
        if weight is not None:
            groups[name] = NormShare(tuple(groups[name]), weight)
    return shardings, groups


def _copy_into(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for key, value in dst.items():
        if isinstance(value, dict):
            _copy_into(value, src[key])
        else:
            value.copy_(src[key])


class Trainer:
    """Trains an LM of ``arch`` on ``SyntheticDataset(arch, shape,
    tcfg.seed)`` with AdamW (``ocfg``) on ``device`` (None: the GPU).
    ``model`` and ``opt_state`` are the state to start from where no
    checkpoint exists (tests start from the reference's weights), and are
    trained in place; without them the LM is drawn from
    ``torch.Generator().manual_seed(tcfg.seed)`` and the moments are zero.
    ``planner`` is handed to the FFT-conv layers.

    ``mesh``: None (one device), or a ``DeviceMesh`` (``launch.mesh``) on
    which every rank of it builds a trainer; the device is then the
    mesh's. A ``model`` given is whole (the same on every rank) and is
    laid out on the mesh, and so is ``opt_state``."""

    def __init__(self, arch: ArchConfig, shape: ShapeConfig, mesh,
                 tcfg: TrainerConfig, ocfg: Optional[AdamWConfig] = None,
                 device=None, planner: Optional[Planner] = None,
                 model: Optional[LM] = None,
                 opt_state: Optional[Dict[str, Any]] = None):
        from torch.distributed.device_mesh import DeviceMesh
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"a mesh is a DeviceMesh (launch.mesh), not "
                            f"{type(mesh).__name__}")
        self.arch = arch
        self.shape = shape
        self.mesh = mesh
        self.tcfg = tcfg
        self.ocfg = ocfg or AdamWConfig()
        self.rules = make_rules(mesh) if mesh is not None else {}
        if mesh is not None and device is None:
            device = mesh_device(mesh)
        self.device = resolve_device(device)
        self.planner = planner
        self.meta = model_meta(arch)
        # the MoE's groups: the data ranks
        self.num_groups = axes_size(mesh_shape(mesh), self.rules.get(
            "dp")) if mesh is not None else 1
        self.data = SyntheticDataset(arch, shape, seed=tcfg.seed)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep_n=tcfg.keep_n,
                                      mesh=mesh)
        self.shardings = self.shard_groups = None
        self.straggler_events = []
        self._ewma = None
        self._model, self._opt_state = model, opt_state

    # -- state init / restore ------------------------------------------------

    def init_state(self):
        """(model, AdamW state, 0): the starting state given, else a new
        LM from the seed and zero moments, on the trainer's device."""
        model = self._model
        if model is None:
            model = LM(self.arch, planner=self.planner, device=self.device,
                       generator=torch.Generator().manual_seed(
                           self.tcfg.seed))
        model.to(self.device)
        if self.planner is not None:
            model.planner = self.planner
        if self.mesh is not None:
            self._shard(model)
        params = dict(model.named_parameters())
        if self._opt_state is None:
            return model, adamw_init(params), 0
        given = self._opt_state
        opt_state = {m: {n: self._block(given[m][n], m, n).to(self.device)
                         for n in params}
                     for m in ("mu", "nu")}
        opt_state["step"] = given["step"].to(self.device)
        return model, opt_state, 0

    def _block(self, whole: torch.Tensor, part: str, name: str):
        if self.shardings is None:
            return whole
        return self.shardings["opt"][part][name].shard(whole)

    def _shard(self, model: LM) -> None:
        """Lay ``model`` out on the mesh (``shard_lm``)."""
        sh, self.shard_groups = shard_lm(model, self.mesh, self.rules,
                                         self.meta)
        self.shardings = {"params": sh, "opt": {"mu": sh, "nu": sh}}

    def restore_or_init(self):
        """(model, AdamW state, the data step to go on from): the latest
        checkpoint's, else ``init_state()``'s."""
        model, opt_state, _ = self.init_state()
        step = self.ckpt.latest_step()
        if step is None:
            return model, opt_state, 0
        tree = {"params": {n: local(p) for n, p in model.named_parameters()},
                "opt": opt_state}
        if self.shardings is None:
            restored, extra = self.ckpt.restore(step, tree, device="cpu")
        else:
            restored, extra = self.ckpt.restore(step, tree, self.shardings)
        with torch.no_grad():
            _copy_into(tree, restored)
        return model, opt_state, extra.get("data_step", step)

    def save(self, step: int, model: LM, opt_state: Dict[str, Any]) -> None:
        self.ckpt.save(step, {"params": dict(model.named_parameters()),
                              "opt": opt_state},
                       extra={"data_step": step}, shardings=self.shardings)

    # -- one step -----------------------------------------------------------

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The dataset's batch of ``step`` (this rank's rows on a mesh) as
        tensors on the device (token ids and labels as int64)."""
        out = {}
        batch = (self.data.batch_at(step) if self.mesh is None else
                 self.data.sharded_batch_at(step, self.mesh, self.rules))
        for name, a in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(a))
            if name in ("tokens", "labels"):
                t = t.long()
            out[name] = t.to(self.device)
        return out

    def _microbatches(self, batch: Dict[str, torch.Tensor]
                      ) -> Iterator[Dict[str, torch.Tensor]]:
        accum = self.tcfg.grad_accum
        rows = batch["labels"].shape[0]
        if rows % accum:
            raise ValueError(f"a batch of {rows} does not split into "
                             f"{accum} microbatches")
        parts = {k: v.chunk(accum, dim=1 if k == "positions" else 0)
                 for k, v in batch.items()}
        for i in range(accum):
            yield {k: v[i] for k, v in parts.items()}

    def train_step(self, model: LM, opt_state: Dict[str, Any],
                   batch: Dict[str, torch.Tensor]):
        """(model, AdamW state, metrics): one optimizer step on ``batch``,
        the model's parameters and the moments updated in place. Metrics
        are 0-d tensors: loss, nll, aux, grad_norm, lr."""
        accum = max(self.tcfg.grad_accum, 1)
        params = dict(model.named_parameters())
        model.zero_grad(set_to_none=True)
        if accum == 1:
            loss, metrics = loss_fn(model, batch, self.num_groups)
            loss.backward()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for micro in self._microbatches(batch):
                micro_loss, _ = loss_fn(model, micro, self.num_groups)
                micro_loss.backward()           # sums into .grad
                loss = loss + micro_loss.detach()
            scale = 1.0 / accum
            with torch.no_grad():
                for p in params.values():
                    if p.grad is not None:
                        p.grad.mul_(scale)
            loss = loss * scale
            metrics = {"nll": loss, "aux": torch.zeros_like(loss)}
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        _, opt_state, opt_metrics = adamw_update(
            self.ocfg, grads, params, opt_state,
            self.shard_groups)
        model.zero_grad(set_to_none=True)
        metrics = {k: v.detach() for k, v in
                   dict(metrics, loss=loss, **opt_metrics).items()}
        return model, opt_state, metrics

    # -- loop ---------------------------------------------------------------

    def run(self, num_steps: int):
        """Train up to step ``num_steps`` from the latest checkpoint (or the
        start); returns (model, AdamW state, per-step float metrics)."""
        model, opt_state, start = self.restore_or_init()
        preempt_at = int(os.environ.get("REPRO_PREEMPT_AT", "-1"))
        history = []
        for step in range(start, num_steps):
            t0 = time.perf_counter()
            batch = self.batch_at(step)
            model, opt_state, metrics = self.train_step(model, opt_state,
                                                        batch)
            row = {k: float(v) for k, v in metrics.items()}  # waits for it
            dt = time.perf_counter() - t0
            self._watchdog(step, dt)
            history.append(row)
            if (step + 1) % self.tcfg.ckpt_every == 0 or step + 1 == num_steps:
                self.save(step + 1, model, opt_state)
            if preempt_at >= 0 and step + 1 >= preempt_at:
                self.ckpt.wait()
                raise SystemExit(f"simulated preemption at step {step + 1}")
        self.ckpt.wait()
        return model, opt_state, history

    def _watchdog(self, step: int, dt: float):
        if self._ewma is None:
            self._ewma = dt
        if dt > self.tcfg.straggler_factor * self._ewma and step > 2:
            self.straggler_events.append((step, dt, self._ewma))
        self._ewma = 0.9 * self._ewma + 0.1 * dt
