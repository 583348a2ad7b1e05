"""One planned N-D transform front-end: ``plan_nd`` + the ``fftn`` family.

Port of ``repro.core.api``. ``plan_nd`` scores every decomposition the
mesh supports — ``local``, ``slab`` over one mesh axis, ``pencil`` over an
ordered chain of 2..ndim-1 mesh axes, ``factor1d`` for one long c2c axis —
with the roofline of :mod:`repro_torch.core.plan` and
:mod:`repro_torch.core.comm`, and returns a pure-data :class:`NdPlan`; the
``fftn``/``ifftn``/``rfftn``/``irfftn`` conveniences execute it. The 1D
stages run through ``plan.execute`` (the four-step kernel under the
``hopper`` backends), the tiled transpose kernel moves each axis to the end
and back, and the executors of :mod:`repro_torch.core.dfft` exchange data
over the mesh.

A mesh is a ``torch.distributed`` ``DeviceMesh`` (``comm.make_mesh``; one
rank per process) or, for planning only, an abstract ``{axis: size}``
dict. On a mesh every rank passes and gets back its own block (the layout
convention of :mod:`repro_torch.core.dfft`): the ``fftn`` family then
needs ``plan=`` or the global ``shape=``, returns the padded block
uncropped, and ``dfft.collect`` gathers and crops it. ``mode="measured"``
times the finalists on the live mesh; every rank times the same
candidates, reduces each time with MAX over the mesh and takes the same
argmin. Verdicts are cached under the reference's ``dfft/v2/*`` wisdom keys
(pre-bump ``dfft/*`` entries are migrated on first lookup).

Device policy: ``device=None`` means the GPU and raises without one; pass
``device="cpu"`` to run the plain PyTorch versions on the CPU. On a live
mesh the device is the mesh's (CUDA under NCCL, the CPU under gloo).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import algo, dfft
from .comm import (_normalize_axis_specs, fac_sum, is_mesh_leader,
                   measure_comm_factor1d, measure_comm_pencil_nd,
                   measure_comm_slab_nd, mesh_device, mesh_sizes, pad_to,
                   plan_comm_factor1d, plan_comm_pencil_nd, plan_comm_slab_nd,
                   time_on_mesh)
from .fftconv import factor_split
from .plan import Planner, execute, execute_inverse, resolve_device

Complex = algo.Complex

__all__ = ["NdPlan", "plan_nd", "execute_nd", "execute_nd_inverse",
           "fftn", "ifftn", "rfftn", "irfftn", "PLAN_ND_STATS"]

DECOMPS = ("local", "slab", "pencil", "factor1d")
OUTPUT_LAYOUTS = ("natural", "transposed")

#: whole-transform timing probes actually executed by ``mode="measured"``;
#: tests snapshot this to prove wisdom hits re-measure nothing.
PLAN_ND_STATS = {"timed": 0}


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


def _estimate_nd(plan: NdPlan, hw, on_mesh: bool,
                 planner: Optional[Planner] = None) -> float:
    """Roofline seconds for one execution of ``plan`` on ``hw``: per-device
    compute is max(the DFT stages, HBM passes), each redistribution charges
    its wire bytes through one link plus ``hw.collective_lat``, and a local
    plan on a mesh charges one gather of the whole array. The stages cost
    the reference's dense four-step flops, or, for a profile with
    ``fft_share`` and a planner, the planner's own 1D price of each."""
    d = len(plan.shape)
    padded = plan.padded_spectrum_shape
    elems = float(math.prod(padded))
    bytes_pair = elems * 8.0                       # (re, im) f32
    # (length, kind, rows) of each planned 1D stage
    if plan.decomp == "factor1d":
        stages = [(n, "c2c", elems / n) for n in plan.factors]
    else:
        stages = [(n, "c2c", elems / w) for n, w in zip(plan.shape, padded)]
        if plan.kind == "r2c" and plan.shape[-1] % 2 == 0:
            stages[-1] = (plan.shape[-1], "r2c", stages[-1][2])
    if planner is not None and hw.fft_share:
        t_stages = sum(planner.stage_seconds(n, kind, rows)
                       for n, kind, rows in stages)
    else:
        t_stages = 8.0 * elems * sum(fac_sum(n) for n, _, _ in stages) \
            / hw.flops
    devices = max(int(math.prod(plan.mesh_shape or (1,))), 1)
    t_comp = max(t_stages, (d + 1) * bytes_pair / hw.hbm_bw) / devices
    t_comm = 0.0
    lat = hw.collective_lat
    if plan.decomp == "local":
        if on_mesh:
            t_comm = bytes_pair / hw.link_bw + lat
    elif plan.decomp == "slab":
        (p,) = plan.mesh_shape
        wire = (p - 1) / p * (bytes_pair / p)
        # a transposed output layout skips the restore exchange entirely
        n_exchanges = 1.0 if plan.output_layout == "transposed" else 2.0
        t_comm = n_exchanges * (wire / hw.link_bw + lat)
    elif plan.decomp == "factor1d":
        (p,) = plan.mesh_shape
        wire = (p - 1) / p * (bytes_pair / p)
        # stage A + stage B + the natural-order unpermute
        t_comm = 3.0 * (wire / hw.link_bw + lat)
    else:                                          # pencil
        for p in plan.mesh_shape:
            if p <= 1:
                continue
            wire = (p - 1) / p * (bytes_pair / devices)
            t_comm += wire / hw.link_bw + lat
    return t_comp + t_comm


def _candidates(shape, kind, sizes,
                output_layout: str = "natural"
                ) -> Sequence[Tuple[str, Tuple[str, ...]]]:
    """(decomp, mesh_axes) candidates for a ``{mesh axis: size}`` layout."""
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
    if d == 1 and kind == "c2c" and output_layout == "natural":
        # distributed 1D through the fft_conv factor split (three
        # exchanges; output is natural-order, so no transposed layout)
        cands += [("factor1d", (a,)) for a in live
                  if factor_split(shape[0], sizes[a]) is not None]
    return cands


def _mesh_axis_sizes(mesh, axes) -> "dict[str, int]":
    """Accepts a live ``DeviceMesh`` OR an abstract ``{name: size}``
    mapping (estimate-only planning without ranks)."""
    if mesh is None:
        return {}
    sizes = dict(mesh) if isinstance(mesh, dict) else mesh_sizes(mesh)
    if axes is not None:
        sizes = {a: sizes[a] for a in axes}
    return sizes


def _plan_factors(decomp: str, shape, mesh_axes, sizes) -> Tuple[int, ...]:
    """The (n1, n2) split a ``factor1d`` candidate executes; () otherwise."""
    if decomp != "factor1d":
        return ()
    split = factor_split(shape[0], sizes[mesh_axes[0]])
    if split is None:
        raise ValueError(
            f"no factor split of n={shape[0]} over p={sizes[mesh_axes[0]]} "
            "(need n divisible by p**2 with factorizable factors)")
    return split


def _resolve_comm(decomp, mesh_axes, shape, kind, comm, mesh, sizes,
                  planner, factors=()) -> Tuple:
    """Turn the user's ``comm`` argument into one concrete spec per mesh
    axis. ``"auto"`` entries go through the roofline planners,
    ``"measure"`` entries through the on-mesh autotuners (live mesh only);
    explicit names / CommBackend instances / per-axis collections pass
    through."""
    if decomp == "local":
        return ()
    live = mesh is not None and not isinstance(mesh, dict)
    specs = list(_normalize_axis_specs(comm, mesh_axes))
    hw = planner.hw
    if decomp in ("slab", "factor1d"):
        (a,) = mesh_axes
        if specs[0] == "auto":
            if decomp == "factor1d":
                specs[0] = plan_comm_factor1d(shape[0], factors[0],
                                              factors[1], sizes[a], hw=hw,
                                              planner=planner)
            else:
                specs[0] = plan_comm_slab_nd(shape, sizes[a], hw=hw,
                                             kind=kind, planner=planner)
        elif specs[0] == "measure":
            if not live:
                raise ValueError('comm="measure" needs a live mesh')
            if decomp == "factor1d":
                specs[0] = measure_comm_factor1d(shape[0], tuple(factors),
                                                 mesh, a,
                                                 wisdom=planner.wisdom, hw=hw)
            else:
                specs[0] = measure_comm_slab_nd(shape, mesh, a, kind=kind,
                                                wisdom=planner.wisdom, hw=hw)
        return tuple(specs)
    # pencil: plan/measure per mesh axis, only the axes that ask
    if "auto" in specs:
        ps = tuple(sizes[a] for a in mesh_axes)
        planned = plan_comm_pencil_nd(shape, ps, hw=hw, kind=kind,
                                      planner=planner)
        specs = [planned[i] if s == "auto" else s for i, s in enumerate(specs)]
    if "measure" in specs:
        if not live:
            raise ValueError('comm="measure" needs a live mesh')
        measured = measure_comm_pencil_nd(
            tuple(shape), mesh, mesh_axes, kind=kind, wisdom=planner.wisdom,
            which=tuple(s == "measure" for s in specs), hw=hw)
        specs = [measured[i] if s == "measure" else s
                 for i, s in enumerate(specs)]
    return tuple(specs)


# ---------------------------------------------------------------------------
# plan_nd (the guru interface)
# ---------------------------------------------------------------------------


def plan_nd(shape: Sequence[int], kind: str = "c2c", mesh=None,
            axes: Optional[Sequence[str]] = None, mode: str = "estimate",
            comm="auto", planner: Optional[Planner] = None,
            decomp: Optional[str] = None,
            output_layout: str = "natural", device=None) -> NdPlan:
    """Plan one N-D transform: pick the decomposition, the mesh-axis
    assignment, and the exchange backends; return the :class:`NdPlan`.

    ``shape``: transform shape (trailing axes; leading input axes are
    batch).  ``kind``: ``"c2c"`` or ``"r2c"`` (the plan serves the inverse
    too).  ``mesh``: a live ``DeviceMesh``, an abstract ``{axis: size}``
    mapping (estimate-only), or None for one device.  ``axes`` restricts
    which mesh axes the planner may use.

    ``mode="estimate"`` scores candidates with the roofline model;
    ``mode="measured"`` also times the finalists on the live mesh (every
    rank must call it). Without a live mesh ``local`` is the only
    candidate and nothing is timed, but ``device`` (None: the GPU) must
    exist.  ``comm`` is a backend name/instance, ``"auto"``,
    ``"measure"``, or a per-mesh-axis collection for pencil.

    ``output_layout="transposed"`` plans for a spectrum sharded over the
    last transform axis (slab saves its restore exchange).  ``decomp``
    forces a decomposition; the verdict of a free choice is cached under a
    ``dfft/v2/*`` wisdom key (pre-bump ``dfft/*`` entries are migrated on
    first lookup), which only the mesh's rank 0 writes to the file.
    """
    shape = tuple(int(n) for n in shape)
    if kind not in ("c2c", "r2c"):
        raise ValueError(f"kind must be c2c or r2c: {kind!r}")
    if mode not in ("estimate", "measured"):
        raise ValueError(f"mode must be estimate or measured: {mode!r}")
    if output_layout not in OUTPUT_LAYOUTS:
        raise ValueError(f"output_layout must be one of {OUTPUT_LAYOUTS}")
    live = mesh is not None and not isinstance(mesh, dict)
    if mode == "measured" and not live:
        resolve_device(device)
    planner = planner or Planner(backends=("torch",))
    sizes = _mesh_axis_sizes(mesh, axes)
    persist = not live or is_mesh_leader(mesh)

    def build(dec, mesh_axes, est=0.0, measured=-1.0, comm_arg=None):
        factors = _plan_factors(dec, shape, mesh_axes, sizes)
        return NdPlan(
            shape, kind, dec, tuple(mesh_axes),
            tuple(sizes[a] for a in mesh_axes),
            _resolve_comm(dec, tuple(mesh_axes), shape, kind,
                          comm if comm_arg is None else comm_arg, mesh,
                          sizes, planner, factors=factors),
            mode, est, measured, output_layout, factors)

    if decomp is not None:              # forced
        if decomp not in DECOMPS:
            raise ValueError(f"decomp must be one of {DECOMPS}: {decomp!r}")
        if decomp == "factor1d" and output_layout == "transposed":
            raise ValueError("factor1d output is natural-order only")
        if decomp == "slab" and len(shape) < 2:
            raise ValueError("slab decomposition needs ndim >= 2")
        if decomp == "factor1d" and (len(shape) != 1 or kind != "c2c"):
            raise ValueError("factor1d is the 1D c2c decomposition")
        if decomp == "local":
            mesh_axes = ()
        elif axes is not None:
            mesh_axes = tuple(axes)
        else:
            width = 1 if decomp in ("slab", "factor1d") else \
                min(len(sizes), len(shape) - 1)
            mesh_axes = tuple(list(sizes)[:width])
        if decomp in ("slab", "factor1d") and len(mesh_axes) != 1:
            raise ValueError(f"{decomp} needs one mesh axis, got "
                             f"{mesh_axes}")
        if decomp == "pencil" and not 2 <= len(mesh_axes) <= len(shape) - 1:
            raise ValueError(
                f"pencil needs 2..ndim-1 mesh axes, got {mesh_axes} for "
                f"ndim={len(shape)}")
        nd = build(decomp, mesh_axes)
        return dataclasses.replace(
            nd, est_cost=_estimate_nd(nd, planner.hw, on_mesh=bool(sizes),
                                      planner=planner))

    key = None
    tag = _comm_tag(comm)
    if tag is not None:
        mesh_tag = ".".join(f"{a}{p}" for a, p in sizes.items()) or "none"
        key = (f"dfft/v2/{'x'.join(str(n) for n in shape)}/{kind}/"
               f"{mesh_tag}/{mode}/{tag}/{output_layout}")
        hit = planner.wisdom.get(key)
        if hit is not None and not _valid_verdict(hit):
            hit = None                  # corrupt v2 record: re-plan
        if hit is None and output_layout == "natural":
            hit = _migrate_v1_verdict(planner, shape, kind, mesh_tag, mode,
                                      tag, key, persist)
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
                    output_layout=output_layout,
                    factors=_plan_factors(dec, shape, mesh_axes, sizes))
        scored.append((_estimate_nd(nd, planner.hw, on_mesh=bool(sizes),
                                    planner=planner), nd))
    scored.sort(key=lambda t: t[0])

    if mode == "measured" and live and len(scored) > 1:
        # measured mode prices every finalist with its best exchange:
        # "auto" comm upgrades to the on-mesh measure_comm_* autotuners
        m_comm = "measure" if comm == "auto" else comm
        best = _measure_finalists(scored, mesh, planner,
                                  lambda dec, axes_, est: build(
                                      dec, axes_, est=est, comm_arg=m_comm))
    else:
        est, nd = scored[0]
        best = build(nd.decomp, nd.mesh_axes, est=est)

    if key is not None and _comm_tag(best.comm) is not None:
        planner.wisdom.put(key, {
            "decomp": best.decomp, "mesh_axes": list(best.mesh_axes),
            "mesh_shape": list(best.mesh_shape), "comm": list(best.comm),
            "est": best.est_cost, "measured": best.measured_cost,
            "output_layout": best.output_layout,
            "factors": list(best.factors)}, persist=persist)
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
                        v2_key, persist: bool = True) -> Optional[dict]:
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
    planner.wisdom.put(v2_key, rec, persist=persist)
    return rec


def _probe(nd, dev: torch.device):
    """Seeded input for timing ``nd``: this rank's block of the padded
    input (a real tensor for r2c, a pair for c2c), the same on every
    rank."""
    rng = np.random.default_rng(0)
    shape = dfft.block_shape(nd, spectrum=False)
    parts = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             .to(dev) for _ in range(1 if nd.kind == "r2c" else 2)]
    return parts[0] if nd.kind == "r2c" else tuple(parts)


def _measure_finalists(scored, mesh, planner, build) -> NdPlan:
    """FFTW MEASURE over decompositions: run the forward transform of each
    of the roofline's top three finalists on the live mesh and keep the
    fastest. Each finalist's exchanges resolve through the comm autotuners
    first. Every rank times the same finalists in the same order and the
    times are the mesh's MAX, so every rank keeps the same plan; a finalist
    that fails raises. A candidate priced at infinity has a stage no 1D
    plan covers (``Planner.stage_seconds``) and is not a finalist."""
    dev = mesh_device(mesh)
    best, best_t = None, float("inf")
    for est, cand in [t for t in scored if math.isfinite(t[0])][:3]:
        nd = build(cand.decomp, cand.mesh_axes, est)
        probe = _probe(nd, dev)
        dt = time_on_mesh(lambda: execute_nd(nd, probe, mesh=mesh,
                                             planner=planner), mesh, reps=3)
        PLAN_ND_STATS["timed"] += 1
        if dt < best_t:
            best, best_t = nd, dt
    return dataclasses.replace(best, measured_cost=best_t)


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------


def execute_nd(plan: NdPlan, x, mesh=None, planner: Optional[Planner] = None,
               chunks: int = 4):
    """Run ``plan`` forward.  ``x``: real tensor for r2c, (re, im) pair for
    c2c (leading batch dims welcome); on a mesh, this rank's block of the
    padded input.  Returns the PADDED spectrum pair (on a mesh, this rank's
    block of it): crop with ``plan.crop_pair``, or gather and crop with
    ``dfft.collect``, for the exact transform."""
    planner = planner or Planner(backends=("torch",))
    if plan.decomp == "local":
        dfft._check_block(plan, x if plan.kind == "r2c" else x[0],
                          spectrum=False)
        return _execute_local(plan, x, planner)
    if mesh is None or isinstance(mesh, dict):
        raise ValueError(f"a {plan.decomp} plan runs on a live DeviceMesh")
    if plan.decomp == "slab":
        return dfft.execute_slab(plan, x, mesh, planner, chunks=chunks)
    if plan.decomp == "factor1d":
        return dfft.execute_factor1d(plan, x, mesh, planner, chunks=chunks)
    return dfft.execute_pencil(plan, x, mesh, planner, chunks=chunks)


def execute_nd_inverse(plan: NdPlan, c: Complex, mesh=None,
                       planner: Optional[Planner] = None, chunks: int = 4):
    """Run ``plan`` backward from the PADDED spectrum pair (on a mesh, this
    rank's block of it).  Returns a pair for c2c, a real tensor for r2c;
    sharded axes keep their divisibility padding."""
    planner = planner or Planner(backends=("torch",))
    if plan.decomp == "local":
        dfft._check_block(plan, c[0], spectrum=True)
        return _execute_local_inverse(plan, c, planner)
    if mesh is None or isinstance(mesh, dict):
        raise ValueError(f"a {plan.decomp} plan runs on a live DeviceMesh")
    if plan.decomp == "slab":
        return dfft.execute_slab_inverse(plan, c, mesh, planner,
                                         chunks=chunks)
    if plan.decomp == "factor1d":
        return dfft.execute_factor1d_inverse(plan, c, mesh, planner,
                                             chunks=chunks)
    return dfft.execute_pencil_inverse(plan, c, mesh, planner, chunks=chunks)


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


def _placement(mesh, device) -> Tuple[torch.device, bool]:
    """(device, whether ``mesh`` is live). On a live mesh the tensors live
    on the mesh's device, and a ``device`` of another type raises."""
    if mesh is None or isinstance(mesh, dict):
        return resolve_device(device), False
    dev = mesh_device(mesh)
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"the mesh runs on {dev.type}, not {device}")
    return dev, True


def _plan_shape(arr: torch.Tensor, ndim, shape, live: bool):
    """The transform shape to plan: ``shape``, or the trailing ``ndim``
    axes of a whole array. A rank's block does not carry the padding, so
    on a live mesh ``shape`` (or ``plan=``) is required."""
    if shape is not None:
        return tuple(int(n) for n in shape)
    if live:
        raise ValueError("on a mesh each rank holds a block, which does not "
                         "carry the padding: pass plan= or the global "
                         "transform shape=")
    d = arr.dim() if ndim is None else ndim
    return tuple(arr.shape[arr.dim() - d:])


def fftn(x, mesh=None, axes=None, planner: Optional[Planner] = None,
         comm="auto", mode: str = "estimate", ndim: Optional[int] = None,
         plan: Optional[NdPlan] = None, output_layout: str = "natural",
         device=None, shape: Optional[Sequence[int]] = None,
         chunks: int = 4) -> Complex:
    """N-D c2c FFT matching ``numpy.fft.fftn`` over the trailing ``ndim``
    axes (default: all).  ``x``: complex array/tensor or (re, im) pair;
    leading axes beyond ``ndim`` are batch.  Runs on ``device`` (None: the
    GPU).  Returns an (re, im) float32 pair with the exact numpy shape.

    On a live mesh ``x`` is this rank's block of the padded input, the
    plan comes from ``plan=`` or the global transform ``shape=``, and the
    result is this rank's block of the padded spectrum
    (``dfft.collect`` gathers and crops it)."""
    dev, live = _placement(mesh, device)
    c = _as_pair(x, dev)
    plan = plan or plan_nd(_plan_shape(c[0], ndim, shape, live), "c2c",
                           mesh=mesh, axes=axes, mode=mode, comm=comm,
                           planner=planner, output_layout=output_layout,
                           device=dev)
    out = execute_nd(plan, c, mesh=mesh, planner=planner, chunks=chunks)
    return out if live else plan.crop_pair(out)


def ifftn(x, mesh=None, axes=None, planner: Optional[Planner] = None,
          comm="auto", mode: str = "estimate", ndim: Optional[int] = None,
          plan: Optional[NdPlan] = None, output_layout: str = "natural",
          device=None, shape: Optional[Sequence[int]] = None,
          chunks: int = 4) -> Complex:
    """Inverse of :func:`fftn` (matches ``numpy.fft.ifftn``). On a live
    mesh ``x`` is this rank's block of the padded spectrum and the result
    its block of the padded input."""
    dev, live = _placement(mesh, device)
    c = _as_pair(x, dev)
    plan = plan or plan_nd(_plan_shape(c[0], ndim, shape, live), "c2c",
                           mesh=mesh, axes=axes, mode=mode, comm=comm,
                           planner=planner, output_layout=output_layout,
                           device=dev)
    if live:
        return execute_nd_inverse(plan, c, mesh=mesh, planner=planner,
                                  chunks=chunks)
    c = _pad_spectrum(c, plan)
    y = execute_nd_inverse(plan, c, mesh=mesh, planner=planner,
                           chunks=chunks)
    return _crop_spatial(y, plan, pair=True)


def rfftn(x, mesh=None, axes=None, planner: Optional[Planner] = None,
          comm="auto", mode: str = "estimate", ndim: Optional[int] = None,
          plan: Optional[NdPlan] = None, output_layout: str = "natural",
          device=None, shape: Optional[Sequence[int]] = None,
          chunks: int = 4) -> Complex:
    """N-D r2c FFT matching ``numpy.fft.rfftn`` over the trailing ``ndim``
    axes of a real array (odd last-axis lengths included).  Returns the
    exact half-spectrum pair; on a live mesh, as :func:`fftn`, this rank's
    block of the padded half spectrum."""
    dev, live = _placement(mesh, device)
    x = _as_real(x, dev)
    plan = plan or plan_nd(_plan_shape(x, ndim, shape, live), "r2c",
                           mesh=mesh, axes=axes, mode=mode, comm=comm,
                           planner=planner, output_layout=output_layout,
                           device=dev)
    out = execute_nd(plan, x, mesh=mesh, planner=planner, chunks=chunks)
    return out if live else plan.crop_pair(out)


def irfftn(x, shape: Optional[Sequence[int]] = None, mesh=None, axes=None,
           planner: Optional[Planner] = None, comm="auto",
           mode: str = "estimate", plan: Optional[NdPlan] = None,
           output_layout: str = "natural", device=None,
           chunks: int = 4) -> torch.Tensor:
    """Inverse of :func:`rfftn` back to a real tensor (matches
    ``numpy.fft.irfftn``).  ``shape`` is the spatial transform shape; when
    omitted the last axis is assumed even (``2 * (mh - 1)``), exactly
    numpy's convention. On a live mesh ``x`` is this rank's block of the
    padded half spectrum, ``shape`` (or ``plan=``) is required, and the
    result is this rank's block of the padded input."""
    dev, live = _placement(mesh, device)
    c = _as_pair(x, dev)
    if plan is None:
        if shape is None and not live:  # no batch dims: every axis transforms
            shape = tuple(c[0].shape[:-1]) + (2 * (c[0].shape[-1] - 1),)
        plan = plan_nd(_plan_shape(c[0], None, shape, live), "r2c",
                       mesh=mesh, axes=axes, mode=mode, comm=comm,
                       planner=planner, output_layout=output_layout,
                       device=dev)
    if live:
        return execute_nd_inverse(plan, c, mesh=mesh, planner=planner,
                                  chunks=chunks)
    c = _pad_spectrum(c, plan)
    y = execute_nd_inverse(plan, c, mesh=mesh, planner=planner,
                           chunks=chunks)
    return _crop_spatial(y, plan, pair=False)
