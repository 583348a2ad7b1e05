"""Training steps of the port's LM through ``Trainer.train_step``.

Traffic parameters: ``batch`` x ``seq`` tokens a step; ``pool`` batches
drawn from the seed at set-up, step i training on batch i mod pool;
``checked_steps`` (3) steps at set-up that the reference follows;
``trace_steps`` profiled in a ``--trace 1`` window; ``optimizer``: the
AdamW settings (``optim.adamw.AdamWConfig``).

Configuration: ``arch`` (the fields of the port's ``ArchConfig``), the
planner's ``backends``, ``limits``.

Set-up builds one trainer over an LM whose weights the benchmark drew
(``lib.weights``), drives it through the first ``checked_steps`` steps
by the window's own call on batches whose rows all differ, and reads
there what the reference is held against: each step's loss, each
parameter's first gradient as AdamW took it (its first moment over
1 - b1) and each parameter's change after the last of them. The same
trainer then runs the window. Once the window has closed and the port's
state is freed, the plain reference (``reference.fftconv_lm``) runs the
same steps from the same weights, and three numbers are compared:

* ``loss_gap``: the worst step's |loss - reference| / |reference|;
* ``grad_norm_gap``: over the parameters, the worst gap between the
  norms of the port's and the reference's first gradient, over the
  larger of the reference's norm and the median parameter's;
* ``update_norm_gap``: the same of the parameters' change.

A parameter whose reference gradient is under a thousandth of the median
parameter's moves under AdamW by round-off alone and is left out of the
change (none is at this configuration's widths).
"""

from __future__ import annotations

import contextlib
import gc
import os
import statistics
import tempfile
import time

import torch
from torch import nn

from ..lib import common, counts, trace, weights, window
from ..reference import fftconv_lm as ref


def _arch(cfg):
    from repro_torch.models.config import ArchConfig
    a = dict(cfg["arch"])
    a["segments"] = tuple(tuple(s) for s in a["segments"])
    return ArchConfig(**a)


def build(ctx, planner, ckpt_dir):
    """(trainer, model, AdamW state): the port's LM built empty and given
    the benchmark's weights, parameter by parameter."""
    from repro_torch.models import LM
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    cfg, tr = ctx.config, ctx.traffic
    arch = _arch(cfg)
    model = LM(arch, planner=planner, device="meta")
    drawn = weights.draw(cfg["arch"], ctx.seed, ctx.device)
    names = {n for n, _ in model.named_parameters()}
    if names != set(drawn):
        raise RuntimeError(f"parameters differ from the drawn weights: "
                           f"{sorted(names ^ set(drawn))}")
    for name, t in drawn.items():
        path, _, leaf = name.rpartition(".")
        model.get_submodule(path)._parameters[leaf] = nn.Parameter(t)
    trainer = Trainer(arch, ShapeConfig("train", tr["seq"], tr["batch"],
                                        "train"), None,
                      TrainerConfig(ckpt_dir=ckpt_dir),
                      AdamWConfig(**tr["optimizer"]), device=ctx.device,
                      planner=planner, model=model)
    model, opt_state, _ = trainer.init_state()
    return trainer, model, opt_state


def change_norms(model, arch, seed, device):
    """Each parameter's norm of change from the drawn weights, drawing
    them again one group at a time."""
    params = dict(model.named_parameters())
    out = {}
    for i, leaves in enumerate(weights.groups(arch)):
        start = weights.draw_group(leaves, seed, i, device)
        out.update({n: float((params[n].detach() - t).norm())
                    for n, t in start.items()})
    return out


def run(ctx, patch=contextlib.nullcontext) -> dict:
    from repro_torch.core.plan import Planner
    common.mark("import the port")
    cfg, tr = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    common.device_context(dev)
    planner = Planner(backends=tuple(cfg["backends"]))
    ckpt_dir = tempfile.mkdtemp(prefix="bench_ckpt_")
    batches = weights.batches(cfg["arch"], tr["batch"], tr["seq"],
                              tr["pool"], ctx.seed, dev)
    b1 = tr["optimizer"]["b1"]
    with patch():
        trainer, model, opt_state = build(ctx, planner, ckpt_dir)
        window.sync(dev)
        common.mark("batches, weights, trainer")
        port = {"losses": []}
        for i in range(tr["checked_steps"]):
            model, opt_state, m = trainer.train_step(model, opt_state,
                                                     batches[i])
            port["losses"].append(float(m["loss"]))
            if i == 0:
                port["grads"] = {n: float(t.norm()) / (1 - b1)
                                 for n, t in opt_state["mu"].items()}
            common.mark(f"checked step {i}")
        port["change"] = change_norms(model, cfg["arch"], ctx.seed, dev)
        window.sync(dev)
        common.mark("change norms")
        setup_s = time.perf_counter() - ctx.t_start

        def step(i, over):
            nonlocal model, opt_state
            k = tr["checked_steps"] + i
            model, opt_state, _ = trainer.train_step(
                model, opt_state, batches[k % len(batches)])
            return over

        tracer = trace.Tracer(ctx.trace, tr["trace_steps"])
        got = window.run_window(step, ctx.seconds, window.Pacer(dev, 1),
                                tracer)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    tokens = tr["batch"] * tr["seq"]
    out = {"e2e": {"train_tokens_per_s": got["steps"] * tokens
                   / got["seconds"], "setup_s": setup_s},
           "memory_peak_bytes": peak,
           "attempted": tr["checked_steps"] + got["steps"]}
    traced = tracer.result
    if traced is not None:
        traced["model_flops_per_step"] = counts.lm_step_flops(
            cfg["arch"], tr["batch"], tr["seq"])
        out["traces"] = [traced]
        out["breakdown"] = trace.breakdown(traced)
    if dev.type == "cuda":
        out.update(common.card_info())
    del trainer, model, opt_state, tracer, traced
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    os.rmdir(ckpt_dir)
    want = reference(ctx, batches[:tr["checked_steps"]])
    out["checks"] = compare(port, want, ctx.limits)
    out["failed"] = int(any(v > lim for _, v, lim in out["checks"]))
    return out


def reference(ctx, batches, precision="float32") -> dict:
    """The plain reference's readings over the checked steps, from the
    same drawn weights: as ``run`` reads the port's."""
    arch = ctx.config["arch"]
    p = weights.draw(arch, ctx.seed, ctx.device)
    got = ref.train(p, batches, arch["num_layers"], arch["vocab_size"],
                    ctx.traffic["optimizer"], precision)
    got["change"] = {}
    for i, leaves in enumerate(weights.groups(arch)):
        start = weights.draw_group(leaves, ctx.seed, i, ctx.device)
        got["change"].update({n: float((p[n] - t).norm())
                              for n, t in start.items()})
    return got


def control(ctx) -> list:
    """The control's numbers: the reference put in the port's place, its
    products in fp8 (``reference.fftconv_lm``), judged as the port is."""
    tr = ctx.traffic
    batches = weights.batches(ctx.config["arch"], tr["batch"], tr["seq"],
                              tr["checked_steps"], ctx.seed, ctx.device)
    low = reference(ctx, batches, precision="fp8")
    return compare(low, reference(ctx, batches), ctx.limits)


@contextlib.contextmanager
def planted(name: str):
    """The timed path broken underneath (``Trainer.train_step``'s own
    calls replaced): ``state_unchanged``, AdamW leaves every parameter
    and moment as it was; ``half_batch``, the loss of the first half of
    the rows alone; ``answer_altered``, the loss 1% off where it is
    produced."""
    from repro_torch.runtime import trainer as mod
    orig_loss, orig_update = mod.loss_fn, mod.adamw_update

    def unchanged(cfg, grads, params, state, shard_groups=None):
        return params, dict(state, step=state["step"] + 1), {
            "grad_norm": torch.zeros(()), "lr": torch.zeros(())}

    def half(model, batch, num_groups=1):
        rows = batch["labels"].shape[0] // 2
        return orig_loss(model, {k: v[:rows] for k, v in batch.items()},
                         num_groups)

    def altered(model, batch, num_groups=1):
        value, metrics = orig_loss(model, batch, num_groups)
        return value * 1.01, metrics

    swap = {"state_unchanged": ("adamw_update", unchanged),
            "half_batch": ("loss_fn", half),
            "answer_altered": ("loss_fn", altered)}[name]
    setattr(mod, *swap)
    try:
        yield
    finally:
        mod.loss_fn, mod.adamw_update = orig_loss, orig_update


FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def fault(ctx, name: str) -> list:
    """The numbers of a run whose timed path carries fault ``name``."""
    return run(ctx, patch=lambda: planted(name))["checks"]


def gap(port: dict, want: dict, keep) -> float:
    """The worst gap of norms over the parameters in ``keep``, each over
    the larger of the reference's norm and the median parameter's."""
    med = statistics.median(want[n] for n in keep)
    return max(abs(port[n] - want[n]) / max(want[n], med) for n in keep)


def compare(port: dict, want: dict, limits: dict) -> list:
    raw = want["raw"]
    med = statistics.median(raw.values())
    moving = [n for n in raw if raw[n] >= 1e-3 * med]
    loss = max(abs(a - b) / abs(b) for a, b in zip(port["losses"],
                                                  want["losses"]))
    return [("loss_gap", loss, limits["loss_gap"]),
            ("grad_norm_gap", gap(port["grads"], want["grads"], list(raw)),
             limits["grad_norm_gap"]),
            ("update_norm_gap", gap(port["change"], want["change"], moving),
             limits["update_norm_gap"])]
