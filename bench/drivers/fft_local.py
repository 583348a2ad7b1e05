"""One card's planned N-D FFT through the port's entry points.

Traffic parameters (``bench/traffic/<name>.json``):

* ``ops``: the transforms of one step, in order: ``["rfftn", "irfftn"]``
  (a real field to its half spectrum and back) or ``["fftn"]`` (a complex
  field forward);
* ``pool``: fields made from the seed at set-up; step i transforms field
  i mod pool;
* ``ahead``: steps dispatched ahead of the card;
* ``warm``: untimed steps of the same shapes at set-up;
* ``sample``: [first, end, count]: window steps drawn from the seed in
  [first, end) whose outputs are kept and judged too;
* ``trace_steps``: steps profiled at the start of a ``--trace 1`` window.

Configuration (``bench/configs/<name>.json``): ``shape``, the planner's
``backends``, ``gen_chunk`` (planes a generator call draws) and the
``limits`` of the numbers compared.

The window drives ``repro_torch.core.api`` (``rfftn``/``irfftn``,
``fftn``) on a plan of ``plan_nd`` in estimate mode. Each field's last outputs
and those of the sampled steps are kept and, after the window, compared
with the float64 transform of the same field (``reference.fft``): the
worst spectrum's relative L2 error and, for a round trip, the worst real
field's.
"""

from __future__ import annotations

import time

import torch

from ..lib import common, counts, fields, trace, window
from ..reference import fft as ref

KIND = {("rfftn", "irfftn"): "r2c", ("fftn",): "c2c"}


def transforms(ops, shape):
    """(FFTW operations, least bytes) of one step's transforms."""
    flops = nbytes = 0.0
    for op in ops:
        kind = {"rfftn": "r2c", "irfftn": "c2r", "fftn": "c2c",
                "ifftn": "c2c"}[op]
        flops += counts.fftw_flops(shape, kind)
        nbytes += counts.fft_bytes(shape, kind)
    return flops, nbytes


def run(ctx) -> dict:
    from repro_torch.core import api
    from repro_torch.core.plan import Planner

    common.mark("import the port")
    cfg, tr = ctx.config, ctx.traffic
    shape, ops = tuple(cfg["shape"]), tuple(tr["ops"])
    kind = KIND[ops]
    dev = torch.device(ctx.device)
    common.device_context(dev)
    planner = Planner(backends=tuple(cfg["backends"]))
    plan = api.plan_nd(shape, kind, planner=planner, device=dev)
    common.mark("plan")
    pool = [fields.field(shape, cfg["gen_chunk"], ctx.seed, i,
                         pair=kind == "c2c", device=dev)
            for i in range(tr["pool"])]
    window.sync(dev)
    common.mark("inputs")
    kept = [None] * len(pool)
    sample = common.sampled_steps(ctx.seed, *tr["sample"])
    judged = {}

    def step(i, over=False, record=True):
        f = i % len(pool)
        if kind == "r2c":
            y = api.rfftn(pool[f], plan=plan, planner=planner, device=dev)
            outs = (y, api.irfftn(y, shape=shape, plan=plan,
                                  planner=planner, device=dev))
        else:
            outs = (api.fftn(pool[f], plan=plan, planner=planner,
                             device=dev),)
        kept[f] = outs
        if record and i in sample:
            judged[i] = (f, outs)
        return over

    for i in range(tr["warm"]):
        step(i, record=False)
        window.sync(dev)
        common.mark(f"warm step {i}")
    kept[:] = [None] * len(pool)        # judge the window's outputs alone
    setup_s = time.perf_counter() - ctx.t_start

    tracer = trace.Tracer(ctx.trace, tr["trace_steps"])
    got = window.run_window(step, ctx.seconds,
                            window.Pacer(dev, tr["ahead"]), tracer)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    flops, nbytes = transforms(ops, shape)
    out = {"e2e": {"fft_gflops": got["steps"] * flops / got["seconds"] / 1e9,
                   "setup_s": setup_s},
           "memory_peak_bytes": peak, "attempted": got["steps"]}
    traced = tracer.result
    if traced is not None:
        traced.update(fft_flops_per_step=flops, fft_bytes_per_step=nbytes)
        out["traces"] = [traced]
        out["breakdown"] = trace.breakdown(traced)
    if dev.type == "cuda":
        out.update(common.card_info())
    del plan, planner
    # the answers due: of the steps that the window reached
    answers = list(enumerate(kept))[:got["steps"]] + [
        judged.get(i, (0, None)) for i in sample if i < got["steps"]]
    out["checks"] = compare(kind, shape, pool, answers, ctx.limits)
    out["failed"] = sum(v > lim for _, v, lim in out["checks"])
    return out


def compare(kind, shape, pool, answers, limits):
    """The worst relative L2 error over the answers, (field, outputs)
    pairs (outputs None: never produced in the window): of the spectrum
    and, for a round trip, of the field."""
    spec = trip = 0.0
    for f in sorted({f for f, _ in answers}):
        outs = [o for g, o in answers if g == f]
        if any(o is None for o in outs):
            spec = trip = float("inf")
            continue
        want = ref.spectrum(pool[f], kind)
        for o in outs:
            diff, norm = ref.rel_l2_parts(o[0], want)
            spec = max(spec, (diff / norm) ** 0.5)
            if kind == "r2c":
                trip = max(trip, ref.rel_l2_real(o[1], pool[f]))
        del want
    checks = [("spectrum_rel_l2", spec, limits["spectrum_rel_l2"])]
    if kind == "r2c":
        checks.append(("roundtrip_rel_l2", trip, limits["roundtrip_rel_l2"]))
    return checks


def control(ctx) -> list:
    """The control's numbers on the cell's fields: the reference put in
    the port's place, its transforms a plain DFT by TF32 products
    (``reference.fft.dft_tf32``), judged as the port is."""
    cfg, tr = ctx.config, ctx.traffic
    shape = tuple(cfg["shape"])
    kind = KIND[tuple(tr["ops"])]
    dev = torch.device(ctx.device)
    pool, answers = [], []
    for i in range(tr["pool"]):
        x = fields.field(shape, cfg["gen_chunk"], ctx.seed, i,
                         pair=kind == "c2c", device=dev)
        y = ref.dft_tf32(x, kind)
        back = (ref.inverse_r2c_tf32(y, shape),) if kind == "r2c" else ()
        pool.append(x)
        answers.append((i, (y,) + back))
    return compare(kind, shape, pool, answers, ctx.limits)
