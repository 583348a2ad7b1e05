"""Carry the reference's plans across to the port.

The FFT library's state is the plan. ``plan_from_reference`` and
``nd_plan_from_reference`` take ``dataclasses.asdict`` of a reference
``repro.core.plan.Plan`` or ``repro.core.api.NdPlan`` and return the port's
plan with the very same factorization, so both packages can run one
recipe. Backend names map jnp -> torch, pallas -> hopper, xla_native ->
torch_native. The FFT-conv mixer has weights: ``fftconv_mixer_from_reference``
carries the reference's parameters across, ``lm_from_reference`` those of
a whole LM, ``adamw_state_from_reference`` its optimizer state and
``cache_from_reference`` its decode cache.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .core.api import NdPlan
from .core.plan import Plan, Planner, resolve_device
from .models.blocks import FFTConvMixer
from .models.config import ArchConfig
from .models.lm import LM
from .models.ssm import SLSTM_STATE

BACKEND_NAMES = {
    "jnp": "torch",
    "jnp_karatsuba": "torch_karatsuba",
    "pallas": "hopper",
    "pallas_karatsuba": "hopper_karatsuba",
    "xla_native": "torch_native",
}


def plan_from_reference(d: dict) -> Plan:
    """A reference ``Plan`` (as a dict) as the port's ``Plan``."""
    if d["backend"] not in BACKEND_NAMES:
        raise ValueError(f"unknown reference backend {d['backend']!r}")
    return Plan(n=int(d["n"]), kind=d["kind"],
                factors=tuple(int(f) for f in d["factors"]),
                backend=BACKEND_NAMES[d["backend"]],
                permuted=bool(d.get("permuted", False)),
                est_cost=float(d.get("est_cost", 0.0)),
                measured_cost=float(d.get("measured_cost", -1.0)))


def nd_plan_from_reference(d: dict) -> NdPlan:
    """A reference ``NdPlan`` (as a dict) as the port's ``NdPlan``."""
    return NdPlan(shape=tuple(int(n) for n in d["shape"]), kind=d["kind"],
                  decomp=d["decomp"],
                  mesh_axes=tuple(d.get("mesh_axes", ())),
                  mesh_shape=tuple(int(p) for p in d.get("mesh_shape", ())),
                  comm=tuple(d.get("comm", ())),
                  mode=d.get("mode", "estimate"),
                  est_cost=float(d.get("est_cost", 0.0)),
                  measured_cost=float(d.get("measured_cost", -1.0)),
                  output_layout=d.get("output_layout", "natural"),
                  factors=tuple(int(f) for f in d.get("factors", ())))


def fftconv_mixer_from_reference(p: Mapping[str, np.ndarray],
                                 planner: Optional[Planner] = None,
                                 device=None, **sharding) -> FFTConvMixer:
    """The reference's FFT-conv mixer parameters (``fftconv_meta`` as
    ``init_tree`` makes them, as numpy arrays: ``w_in`` (d, 2d), ``filt``
    (d, rank), ``skip`` (d,), ``w_out`` (d, d)) as an ``FFTConvMixer`` on
    ``device`` (None: the GPU). ``sharding``: the mixer's ``mesh``,
    ``axis`` and ``comm``."""
    d, rank = np.shape(p["filt"])
    mixer = FFTConvMixer(d, rank, planner=planner, device=device, **sharding)
    with torch.no_grad():
        for name, param in mixer.named_parameters():
            value = torch.from_numpy(np.array(p[name], np.float32))
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)}, the "
                                 f"mixer needs {tuple(param.shape)}")
            param.copy_(value)
    return mixer


def _tensor(a) -> torch.Tensor:
    """A numpy array as a tensor; bfloat16 (which numpy lacks) through
    float32, which holds it exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def flatten_reference(tree: Mapping[str, Any],
                      cfg: ArchConfig) -> Dict[str, np.ndarray]:
    """A tree shaped as ``repro.models.lm.init_params``' (the parameters,
    or AdamW's ``mu``/``nu`` or gradients that mirror them), as numpy
    arrays by the port's parameter names: each segment's leading layer
    axis unstacked into ``layers.<i>``, the shared block (``tree["shared"]``,
    whose segments are empty) under ``shared``."""
    flat: Dict[str, np.ndarray] = {"embed": np.asarray(tree["embed"])}
    if "lm_head" in tree:
        flat["lm_head"] = np.asarray(tree["lm_head"])
    for name, a in tree["final_norm"].items():
        flat[f"final_norm.{name}"] = np.asarray(a)
    for part, sub in tree.get("shared", {}).items():
        for name, a in sub.items():
            flat[f"shared.{part}.{name}"] = np.asarray(a)
    i = 0
    for seg, (_, count) in zip(tree["segments"], cfg.resolved_segments()):
        for j in range(count):
            for part, sub in seg.get("layers", {}).items():
                for name, a in sub.items():
                    flat[f"layers.{i + j}.{part}.{name}"] = np.asarray(a)[j]
        i += count
    return flat


def _by_name(tree: Mapping[str, Any], cfg: ArchConfig, model: LM,
             what: str) -> Dict[str, torch.Tensor]:
    """``flatten_reference(tree)`` as tensors, checked name for name and
    shape for shape against ``model``'s parameters."""
    flat = flatten_reference(tree, cfg)
    ours = dict(model.named_parameters())
    if set(ours) != set(flat):
        raise ValueError(f"{what} the reference lacks: "
                         f"{sorted(set(ours) - set(flat))}; the port lacks: "
                         f"{sorted(set(flat) - set(ours))}")
    out = {}
    for name, param in ours.items():
        value = _tensor(flat[name])
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)}, the "
                             f"LM needs {tuple(param.shape)}")
        out[name] = value
    return out


def lm_from_reference(params: Mapping[str, Any], cfg: ArchConfig,
                      planner: Optional[Planner] = None,
                      device=None) -> LM:
    """The reference's LM parameters (``repro.models.lm.init_params``' tree,
    as numpy arrays) as an ``LM`` of ``cfg`` on ``device`` (None: the GPU).
    Each segment's leading layer axis is unstacked into the port's layers
    (``flatten_reference``). A parameter missing on either side or of
    another shape raises."""
    model = LM(cfg, planner=planner, device=device)
    values = _by_name(params, cfg, model, "parameters")
    with torch.no_grad():
        for name, param in model.named_parameters():
            param.copy_(values[name])
    return model


def adamw_state_from_reference(opt_state: Mapping[str, Any],
                               cfg: ArchConfig, model: LM) -> Dict[str, Any]:
    """The reference's AdamW state (``repro.optim.adamw_init``'s or
    ``adamw_update``'s, as numpy arrays: ``mu`` and ``nu`` mirror
    ``init_params``' tree, ``step`` a scalar) as the port's ``{"mu", "nu",
    "step"}``: float32 moments by ``model``'s parameter names on its
    device, ``step`` a 0-d int32 tensor."""
    dev = model.device
    state = {m: {n: t.to(device=dev, dtype=torch.float32)
                 for n, t in _by_name(opt_state[m], cfg, model,
                                      f"{m} entries").items()}
             for m in ("mu", "nu")}
    state["step"] = torch.tensor(int(np.asarray(opt_state["step"])),
                                 dtype=torch.int32, device=dev)
    return state


CACHE_NAMES = ("k", "v", "v_hist", "conv", "ssd", "mlstm") + SLSTM_STATE


def cache_from_reference(cache: Mapping[str, Any],
                         device=None) -> Dict[str, Any]:
    """The reference's decode cache (``prefill``'s or ``init_cache``'s, as
    numpy arrays: ``len`` and per segment its tensors stacked over the
    segment's layers: attention ``k``/``v``, FFT-conv ``v_hist``, Mamba2
    ``conv``/``ssd``, mLSTM ``mlstm``, sLSTM ``slstm`` as a ``(c, n, h,
    m)`` tuple) as the port's, one entry per layer, the sLSTM tuple as
    named tensors, on ``device`` (None: the GPU)."""
    dev = resolve_device(device)
    layers = []
    for seg in cache["segments"]:
        seg = dict(seg)
        if "slstm" in seg:
            seg.update(zip(SLSTM_STATE, seg.pop("slstm")))
        if not seg or set(seg) - set(CACHE_NAMES):
            raise ValueError(f"a segment cache with {sorted(seg)}: the port "
                             f"holds {', '.join(CACHE_NAMES)} and the sLSTM "
                             "tuple")
        count = len(next(iter(seg.values())))
        layers += [{name: _tensor(np.asarray(a)[j]).to(dev)
                    for name, a in seg.items()} for j in range(count)]
    return {"len": _tensor(cache["len"]).to(dev), "layers": layers}
