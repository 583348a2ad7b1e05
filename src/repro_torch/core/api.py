"""One planned N-D transform front-end: ``plan_nd`` + the ``fftn`` family.

Port of ``repro.core.api`` for one device. ``plan_nd`` scores the
decompositions the device layout supports with the roofline of
:mod:`repro_torch.core.plan` and returns a pure-data :class:`NdPlan`; the
``fftn``/``ifftn``/``rfftn``/``irfftn`` conveniences execute it. On one card
the only decomposition is ``local``: the 1D stages run axis by axis through
``plan.execute`` (the four-step kernel under the ``hopper`` backends), with
the tiled transpose kernel moving each axis to the end and back.

A mesh, or a decomposition other than ``local``, raises
``NotImplementedError``: the slab, pencil and factor1d executors need
several ranks and come with the distributed layer. Verdicts are cached
under the ``dfft/v2/*`` wisdom keys of the reference (pre-bump ``dfft/*``
entries are migrated on first lookup).

Device policy: ``device=None`` means the GPU and raises without one; pass
``device="cpu"`` to run the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence, Tuple

import torch

from . import algo, dfft
from .comm import fac_sum, pad_to
from .plan import Planner, execute, execute_inverse, resolve_device

Complex = algo.Complex

__all__ = ["NdPlan", "plan_nd", "execute_nd", "execute_nd_inverse",
           "fftn", "ifftn", "rfftn", "irfftn", "COLLECTIVE_LAT"]

DECOMPS = ("local", "slab", "pencil", "factor1d")
OUTPUT_LAYOUTS = ("natural", "transposed")

#: per-collective latency charge in the decomposition roofline (seconds).
COLLECTIVE_LAT = 2e-5

_LATER = "distributed decompositions: later slice"


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NdPlan:
    """A pure-data recipe for one N-D (possibly distributed) transform.

    ``shape`` is the transform shape (the trailing axes of the input; any
    leading axes are batch).  ``mesh_axes``/``mesh_shape`` name the mesh
    axes the decomposition uses, in decomposition order; ``comm`` holds one
    resolved exchange spec per mesh axis.  ``output_layout="transposed"``
    leaves the spectrum sharded over the LAST transform axis.  ``factors``
    is the (n1, n2) split of the ``factor1d`` decomposition.
    """

    shape: Tuple[int, ...]
    kind: str                            # "c2c" | "r2c"
    decomp: str                          # one of DECOMPS
    mesh_axes: Tuple[str, ...] = ()
    mesh_shape: Tuple[int, ...] = ()
    comm: Tuple = ()
    mode: str = "estimate"
    est_cost: float = 0.0
    measured_cost: float = -1.0
    output_layout: str = "natural"       # "natural" | "transposed"
    factors: Tuple[int, ...] = ()        # factor1d: the (n1, n2) split

    # -- padded layout (the shared pad-and-crop convention) -----------------

    @property
    def spectrum_shape(self) -> Tuple[int, ...]:
        """Exact transform output shape (``numpy.fft.fftn``/``rfftn``)."""
        if self.kind == "r2c":
            return self.shape[:-1] + (self.shape[-1] // 2 + 1,)
        return self.shape

    @property
    def padded_spectrum_shape(self) -> Tuple[int, ...]:
        """Spectrum shape with the collective-divisibility padding the
        executors produce (equal to ``spectrum_shape`` for local plans)."""
        s, sp = self.shape, self.spectrum_shape
        if self.decomp == "slab":
            (p,) = self.mesh_shape
            return (pad_to(s[0], p),) + s[1:-1] + (pad_to(sp[-1], p),)
        if self.decomp == "pencil":
            ps, k = self.mesh_shape, len(self.mesh_shape)
            # axis j (0 < j < k) is input-sharded over p_j and
            # exchange-split over p_{j-1}, so its padding must divide both
            # communicators; unsharded middle axes stay unpadded
            return ((pad_to(s[0], ps[0]),)
                    + tuple(pad_to(s[j], math.lcm(ps[j - 1], ps[j]))
                            for j in range(1, k))
                    + s[k:-1] + (pad_to(sp[-1], ps[-1]),))
        return sp

    @property
    def padded_input_shape(self) -> Tuple[int, ...]:
        """Input transform-shape after the executors' zero-padding of the
        sharded axes (the last axis is always fully local going in)."""
        return self.padded_spectrum_shape[:-1] + (self.shape[-1],)

    @property
    def crop(self) -> Tuple[slice, ...]:
        """Slices recovering the exact spectrum from the padded layout."""
        return tuple(slice(0, n) for n in self.spectrum_shape)

    def crop_pair(self, c: Complex) -> Complex:
        """Apply :attr:`crop` to an (re, im) pair (batch dims untouched)."""
        idx = (Ellipsis,) + self.crop
        return c[0][idx], c[1][idx]


# ---------------------------------------------------------------------------
# the decomposition roofline (ESTIMATE mode)
# ---------------------------------------------------------------------------


def _estimate_nd(plan: NdPlan, hw, on_mesh: bool) -> float:
    """Roofline seconds for one execution of ``plan`` on ``hw``: per-device
    compute is max(flops, HBM passes), each redistribution charges its wire
    bytes through one link plus ``COLLECTIVE_LAT``, and a local plan on a
    mesh charges one gather of the whole array."""
    d = len(plan.shape)
    padded = plan.padded_spectrum_shape
    elems = float(math.prod(padded))
    bytes_pair = elems * 8.0                       # (re, im) f32
    if plan.decomp == "factor1d":                  # two planned 1D stages
        stage_macs = fac_sum(plan.factors[0]) + fac_sum(plan.factors[1])
    else:
        stage_macs = sum(fac_sum(n) for n in plan.shape)
    flops = 8.0 * elems * stage_macs
    devices = max(int(math.prod(plan.mesh_shape or (1,))), 1)
    t_comp = max(flops / hw.flops,
                 (d + 1) * bytes_pair / hw.hbm_bw) / devices
    t_comm = 0.0
    if plan.decomp == "local":
        if on_mesh:
            t_comm = bytes_pair / hw.link_bw + COLLECTIVE_LAT
    elif plan.decomp == "slab":
        (p,) = plan.mesh_shape
        wire = (p - 1) / p * (bytes_pair / p)
        # a transposed output layout skips the restore exchange entirely
        n_exchanges = 1.0 if plan.output_layout == "transposed" else 2.0
        t_comm = n_exchanges * (wire / hw.link_bw + COLLECTIVE_LAT)
    elif plan.decomp == "factor1d":
        (p,) = plan.mesh_shape
        wire = (p - 1) / p * (bytes_pair / p)
        # stage A + stage B + the natural-order unpermute
        t_comm = 3.0 * (wire / hw.link_bw + COLLECTIVE_LAT)
    else:                                          # pencil
        for p in plan.mesh_shape:
            if p <= 1:
                continue
            wire = (p - 1) / p * (bytes_pair / devices)
            t_comm += wire / hw.link_bw + COLLECTIVE_LAT
    return t_comp + t_comm


def _candidates(shape, kind, sizes,
                output_layout: str = "natural"
                ) -> Sequence[Tuple[str, Tuple[str, ...]]]:
    """(decomp, mesh_axes) candidates for a ``{mesh axis: size}`` layout.
    The factor1d candidates come with the distributed layer's factor
    split."""
    d = len(shape)
    live = [a for a, p in sizes.items() if p > 1]
    cands = [("local", ())]
    if d >= 2:
        cands += [("slab", (a,)) for a in live]
    if d >= 3:
        # multi-axis pencil: every ordered tuple of 2..ndim-1 mesh axes
        for k in range(2, min(d - 1, len(live)) + 1):
            cands += [("pencil", axes)
                      for axes in itertools.permutations(live, k)]
    return cands


# ---------------------------------------------------------------------------
# plan_nd (the guru interface)
# ---------------------------------------------------------------------------


def _check_local(mesh, decomp) -> None:
    if mesh is not None or decomp not in (None, "local"):
        raise NotImplementedError(_LATER)


def plan_nd(shape: Sequence[int], kind: str = "c2c", mesh=None,
            axes: Optional[Sequence[str]] = None, mode: str = "estimate",
            comm="auto", planner: Optional[Planner] = None,
            decomp: Optional[str] = None,
            output_layout: str = "natural", device=None) -> NdPlan:
    """Plan one N-D transform and return the :class:`NdPlan`.

    ``shape``: transform shape (trailing axes; leading input axes are
    batch).  ``kind``: ``"c2c"`` or ``"r2c"`` (the plan serves the inverse
    too).  ``mesh`` must be None in this package so far (one device).
    ``mode="measured"`` times the finalists on ``device`` (None: the GPU,
    which must exist); with one device ``local`` is the only candidate, so
    nothing needs timing.  The verdict is cached under a ``dfft/v2/*``
    wisdom key (pre-bump ``dfft/*`` entries are migrated on first lookup).
    """
    shape = tuple(int(n) for n in shape)
    if kind not in ("c2c", "r2c"):
        raise ValueError(f"kind must be c2c or r2c: {kind!r}")
    if mode not in ("estimate", "measured"):
        raise ValueError(f"mode must be estimate or measured: {mode!r}")
    if output_layout not in OUTPUT_LAYOUTS:
        raise ValueError(f"output_layout must be one of {OUTPUT_LAYOUTS}")
    _check_local(mesh, decomp)
    if mode == "measured":
        resolve_device(device)
    planner = planner or Planner(backends=("torch",))
    sizes: dict = {}

    if decomp is not None:              # forced
        nd = NdPlan(shape, kind, "local", mode=mode,
                    output_layout=output_layout)
        return dataclasses.replace(
            nd, est_cost=_estimate_nd(nd, planner.hw, on_mesh=False))

    key = None
    tag = _comm_tag(comm)
    if tag is not None:
        mesh_tag = "none"               # one device: no mesh axes
        key = (f"dfft/v2/{'x'.join(str(n) for n in shape)}/{kind}/"
               f"{mesh_tag}/{mode}/{tag}/{output_layout}")
        hit = planner.wisdom.get(key)
        if hit is not None and not _valid_verdict(hit):
            hit = None                  # corrupt v2 record: re-plan
        if hit is None and output_layout == "natural":
            hit = _migrate_v1_verdict(planner, shape, kind, mesh_tag, mode,
                                      tag, key)
        if hit is not None:
            return NdPlan(shape, kind, hit["decomp"],
                          tuple(hit["mesh_axes"]), tuple(hit["mesh_shape"]),
                          tuple(hit["comm"]), mode, hit.get("est", 0.0),
                          hit.get("measured", -1.0),
                          hit.get("output_layout", "natural"),
                          tuple(hit.get("factors", ())))

    scored = []
    for dec, mesh_axes in _candidates(shape, kind, sizes, output_layout):
        nd = NdPlan(shape, kind, dec, mesh_axes,
                    tuple(sizes[a] for a in mesh_axes), (), mode,
                    output_layout=output_layout)
        scored.append((_estimate_nd(nd, planner.hw, on_mesh=False), nd))
    scored.sort(key=lambda t: t[0])
    est, nd = scored[0]
    best = dataclasses.replace(nd, est_cost=est)

    if key is not None:
        planner.wisdom.put(key, {
            "decomp": best.decomp, "mesh_axes": list(best.mesh_axes),
            "mesh_shape": list(best.mesh_shape), "comm": list(best.comm),
            "est": best.est_cost, "measured": best.measured_cost,
            "output_layout": best.output_layout,
            "factors": list(best.factors)})
    return best


def _comm_tag(comm) -> Optional[str]:
    """Stable wisdom-key tag for a comm argument, or None if uncacheable."""
    if isinstance(comm, str):
        return comm
    if isinstance(comm, (list, tuple)) and all(isinstance(s, str)
                                               for s in comm):
        return ",".join(comm)
    if isinstance(comm, dict) and all(isinstance(s, str)
                                      for s in comm.values()):
        return ",".join(f"{k}={v}" for k, v in sorted(comm.items()))
    return None


def _valid_verdict(rec) -> bool:
    """A ``dfft/*`` wisdom record trustworthy enough to reconstruct a plan
    from (truncated/hand-edited records fall through to re-planning)."""
    return (isinstance(rec, dict)
            and rec.get("decomp") in DECOMPS
            and all(isinstance(rec.get(f), list)
                    for f in ("mesh_axes", "mesh_shape", "comm"))
            and (rec["decomp"] != "factor1d"
                 or len(rec.get("factors") or ()) == 2))


def _migrate_v1_verdict(planner, shape, kind, mesh_tag, mode, tag,
                        v2_key) -> Optional[dict]:
    """Adopt a pre-bump ``dfft/*`` (v1) wisdom verdict for a natural-layout
    lookup (a v1 record is a v2 natural-layout record with the new fields
    defaulted) and re-write it under the v2 key."""
    v1_key = (f"dfft/{'x'.join(str(n) for n in shape)}/{kind}/"
              f"{mesh_tag}/{mode}/{tag}")
    old = planner.wisdom.get(v1_key)
    # the v1 schema predates factor1d, so a factor1d decomp marks the
    # record as garbage rather than a migratable verdict
    if (not _valid_verdict(old)
            or old["decomp"] not in ("local", "slab", "pencil")):
        return None
    rec = dict(old)
    rec.setdefault("output_layout", "natural")
    rec.setdefault("factors", [])
    planner.wisdom.put(v2_key, rec)
    return rec


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------


def execute_nd(plan: NdPlan, x, mesh=None, planner: Optional[Planner] = None):
    """Run ``plan`` forward.  ``x``: real tensor for r2c, (re, im) pair for
    c2c (leading batch dims welcome).  Returns the spectrum pair."""
    _check_local(mesh, plan.decomp)
    return _execute_local(plan, x, planner or Planner(backends=("torch",)))


def execute_nd_inverse(plan: NdPlan, c: Complex, mesh=None,
                       planner: Optional[Planner] = None):
    """Run ``plan`` backward from the spectrum pair.  Returns a pair for
    c2c, a real tensor for r2c."""
    _check_local(mesh, plan.decomp)
    return _execute_local_inverse(plan, c,
                                  planner or Planner(backends=("torch",)))


def _execute_local(plan: NdPlan, x, planner: Planner):
    """Single-device N-D transform: planned 1D stages, axis by axis."""
    d = len(plan.shape)
    if plan.kind == "r2c":
        y = dfft.rows_rfft(planner, x, plan.shape[-1])
    else:
        y = execute(planner.plan(plan.shape[-1], kind="c2c"), x)
    for k in range(d - 2, -1, -1):
        y = dfft._fft_axis(planner.plan(plan.shape[k], kind="c2c"), y,
                           y[0].dim() - d + k)
    return y


def _execute_local_inverse(plan: NdPlan, c: Complex, planner: Planner):
    d = len(plan.shape)
    y = c
    for k in range(d - 1):
        y = dfft._fft_axis(planner.plan(plan.shape[k], kind="c2c"), y,
                           y[0].dim() - d + k, inverse=True)
    if plan.kind == "r2c":
        return dfft.rows_irfft(planner, y, plan.shape[-1])
    return execute_inverse(planner.plan(plan.shape[-1], kind="c2c"), y)


# ---------------------------------------------------------------------------
# the fftn family (numpy-shaped conveniences over plan_nd)
# ---------------------------------------------------------------------------


def _as_real(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


def _as_pair(x, device: torch.device) -> Complex:
    if isinstance(x, (tuple, list)):
        return _as_real(x[0], device), _as_real(x[1], device)
    x = torch.as_tensor(x)
    if x.is_complex():
        return algo.to_pair(x.to(device))
    x = _as_real(x, device)
    return x, torch.zeros_like(x)


def _transform_ndim(x, ndim, plan) -> int:
    if plan is not None:
        return len(plan.shape)
    arr = x[0] if isinstance(x, (tuple, list)) else x
    return arr.dim() if ndim is None else ndim


def _pad_spectrum(c: Complex, plan: NdPlan) -> Complex:
    """Zero-pad an exact spectrum pair back to the executor's padded layout
    (the padded bands are zero by construction, so this is lossless)."""
    d = len(plan.shape)
    for ax_off, (true, padded) in enumerate(zip(plan.spectrum_shape,
                                                plan.padded_spectrum_shape)):
        if true != padded:
            c = dfft._pad_axis(c, c[0].dim() - d + ax_off, padded)
    return c


def _crop_spatial(y, plan: NdPlan, pair: bool):
    """Crop the inverse executors' output back to ``plan.shape``."""
    d = len(plan.shape)
    for ax_off, (true, padded) in enumerate(zip(plan.shape,
                                                plan.padded_input_shape)):
        if true != padded:
            if pair:
                y = dfft._crop_axis(y, y[0].dim() - d + ax_off, true)
            else:
                y = y.narrow(y.dim() - d + ax_off, 0, true)
    return y


def fftn(x, mesh=None, axes=None, planner: Optional[Planner] = None,
         comm="auto", mode: str = "estimate", ndim: Optional[int] = None,
         plan: Optional[NdPlan] = None, output_layout: str = "natural",
         device=None) -> Complex:
    """N-D c2c FFT matching ``numpy.fft.fftn`` over the trailing ``ndim``
    axes (default: all).  ``x``: complex array/tensor or (re, im) pair;
    leading axes beyond ``ndim`` are batch.  Runs on ``device`` (None: the
    GPU).  Returns an (re, im) float32 pair with the exact numpy shape."""
    dev = resolve_device(device)
    c = _as_pair(x, dev)
    d = _transform_ndim(c, ndim, plan)
    plan = plan or plan_nd(c[0].shape[c[0].dim() - d:], "c2c", mesh=mesh,
                           axes=axes, mode=mode, comm=comm, planner=planner,
                           output_layout=output_layout, device=dev)
    out = execute_nd(plan, c, mesh=mesh, planner=planner)
    return plan.crop_pair(out)


def ifftn(x, mesh=None, axes=None, planner: Optional[Planner] = None,
          comm="auto", mode: str = "estimate", ndim: Optional[int] = None,
          plan: Optional[NdPlan] = None, output_layout: str = "natural",
          device=None) -> Complex:
    """Inverse of :func:`fftn` (matches ``numpy.fft.ifftn``)."""
    dev = resolve_device(device)
    c = _as_pair(x, dev)
    d = _transform_ndim(c, ndim, plan)
    plan = plan or plan_nd(c[0].shape[c[0].dim() - d:], "c2c", mesh=mesh,
                           axes=axes, mode=mode, comm=comm, planner=planner,
                           output_layout=output_layout, device=dev)
    c = _pad_spectrum(c, plan)
    y = execute_nd_inverse(plan, c, mesh=mesh, planner=planner)
    return _crop_spatial(y, plan, pair=True)


def rfftn(x, mesh=None, axes=None, planner: Optional[Planner] = None,
          comm="auto", mode: str = "estimate", ndim: Optional[int] = None,
          plan: Optional[NdPlan] = None, output_layout: str = "natural",
          device=None) -> Complex:
    """N-D r2c FFT matching ``numpy.fft.rfftn`` over the trailing ``ndim``
    axes of a real array (odd last-axis lengths included).  Returns the
    exact half-spectrum pair."""
    dev = resolve_device(device)
    x = _as_real(x, dev)
    d = _transform_ndim(x, ndim, plan)
    plan = plan or plan_nd(x.shape[x.dim() - d:], "r2c", mesh=mesh,
                           axes=axes, mode=mode, comm=comm, planner=planner,
                           output_layout=output_layout, device=dev)
    out = execute_nd(plan, x, mesh=mesh, planner=planner)
    return plan.crop_pair(out)


def irfftn(x, shape: Optional[Sequence[int]] = None, mesh=None, axes=None,
           planner: Optional[Planner] = None, comm="auto",
           mode: str = "estimate", plan: Optional[NdPlan] = None,
           output_layout: str = "natural", device=None) -> torch.Tensor:
    """Inverse of :func:`rfftn` back to a real tensor (matches
    ``numpy.fft.irfftn``).  ``shape`` is the spatial transform shape; when
    omitted the last axis is assumed even (``2 * (mh - 1)``), exactly
    numpy's convention."""
    dev = resolve_device(device)
    c = _as_pair(x, dev)
    if plan is None:
        if shape is None:       # no batch dims: every input axis transforms
            shape = tuple(c[0].shape[:-1]) + (2 * (c[0].shape[-1] - 1),)
        shape = tuple(int(n) for n in shape)
        plan = plan_nd(shape, "r2c", mesh=mesh, axes=axes, mode=mode,
                       comm=comm, planner=planner,
                       output_layout=output_layout, device=dev)
    c = _pad_spectrum(c, plan)
    y = execute_nd_inverse(plan, c, mesh=mesh, planner=planner)
    return _crop_spatial(y, plan, pair=False)
