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
raises without one); its parameters stay float32 and are cast at each use.
The reference's meshes, sharding rules and elastic restore wait for the
port of ``parallel/`` (ROADMAP.md, Queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..core.plan import Planner, resolve_device
from ..data import SyntheticDataset
from ..models.config import ArchConfig, ShapeConfig
from ..models.lm import LM, loss_fn
from ..optim import AdamWConfig, adamw_init, adamw_update


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
    ``planner`` is handed to the FFT-conv layers. ``mesh`` must be None."""

    def __init__(self, arch: ArchConfig, shape: ShapeConfig, mesh,
                 tcfg: TrainerConfig, ocfg: Optional[AdamWConfig] = None,
                 device=None, planner: Optional[Planner] = None,
                 model: Optional[LM] = None,
                 opt_state: Optional[Dict[str, Any]] = None):
        if mesh is not None:
            raise NotImplementedError(
                "training on a mesh waits for the port of parallel/ "
                "(ROADMAP.md, Queue 1 item 7)")
        self.arch = arch
        self.shape = shape
        self.tcfg = tcfg
        self.ocfg = ocfg or AdamWConfig()
        self.device = resolve_device(device)
        self.planner = planner
        self.data = SyntheticDataset(arch, shape, seed=tcfg.seed)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep_n=tcfg.keep_n)
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
        if self._opt_state is None:
            return model, adamw_init(dict(model.named_parameters())), 0
        given = self._opt_state
        opt_state = {m: {n: t.to(self.device) for n, t in given[m].items()}
                     for m in ("mu", "nu")}
        opt_state["step"] = given["step"].to(self.device)
        return model, opt_state, 0

    def restore_or_init(self):
        """(model, AdamW state, the data step to go on from): the latest
        checkpoint's, else ``init_state()``'s."""
        model, opt_state, _ = self.init_state()
        step = self.ckpt.latest_step()
        if step is None:
            return model, opt_state, 0
        tree = {"params": dict(model.named_parameters()), "opt": opt_state}
        restored, extra = self.ckpt.restore(step, tree, device="cpu")
        with torch.no_grad():
            _copy_into(tree, restored)
        return model, opt_state, extra.get("data_step", step)

    def save(self, step: int, model: LM, opt_state: Dict[str, Any]) -> None:
        self.ckpt.save(step, {"params": dict(model.named_parameters()),
                              "opt": opt_state},
                       extra={"data_step": step})

    # -- one step -----------------------------------------------------------

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The dataset's batch of ``step`` as tensors on the device (token
        ids and labels as int64)."""
        out = {}
        for name, a in self.data.batch_at(step).items():
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
            loss, metrics = loss_fn(model, batch)
            loss.backward()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for micro in self._microbatches(batch):
                micro_loss, _ = loss_fn(model, micro)
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
        _, opt_state, opt_metrics = adamw_update(self.ocfg, grads, params,
                                                 opt_state)
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
