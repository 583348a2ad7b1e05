"""Carry the reference's plans across to the port.

The FFT library's state is the plan. ``plan_from_reference`` and
``nd_plan_from_reference`` take ``dataclasses.asdict`` of a reference
``repro.core.plan.Plan`` or ``repro.core.api.NdPlan`` and return the port's
plan with the very same factorization, so both packages can run one
recipe. Backend names map jnp -> torch, pallas -> hopper, xla_native ->
torch_native. The FFT-conv mixer has weights: ``fftconv_mixer_from_reference``
carries the reference's parameters across.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .core.api import NdPlan
from .core.plan import Plan, Planner
from .models.blocks import FFTConvMixer

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
                                 device=None) -> FFTConvMixer:
    """The reference's FFT-conv mixer parameters (``fftconv_meta`` as
    ``init_tree`` makes them, as numpy arrays: ``w_in`` (d, 2d), ``filt``
    (d, rank), ``skip`` (d,), ``w_out`` (d, d)) as an ``FFTConvMixer`` on
    ``device`` (None: the GPU)."""
    d, rank = np.shape(p["filt"])
    mixer = FFTConvMixer(d, rank, planner=planner, device=device)
    with torch.no_grad():
        for name, param in mixer.named_parameters():
            value = torch.from_numpy(np.array(p[name], np.float32))
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)}, the "
                                 f"mixer needs {tuple(param.shape)}")
            param.copy_(value)
    return mixer
