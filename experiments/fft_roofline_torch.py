"""Roofline of the paper's own application on the PyTorch/H100 port: the
distributed 2D r2c FFT (2^14 x 2^14, the paper's production problem size)
slab-decomposed over 256 ranks, each named configuration priced at the
H100 profile's constants (``repro_torch.core.plan.H100``).

The port of ``experiments/fft_roofline.py``. Where the reference lowers
and compiles each case for 256 TPU chips and reads XLA's cost analysis
and HLO, this script opens the ``fake`` c10d backend at 256 ranks in one
process (``launch.dryrun._fake_group``; rank 0's view, every collective
a no-op), pushes rank 0's (N/256, N) float32 block through
``core.dfft.fft2_slab`` on the CPU and counts what the dry run counts
(``launch.dryrun.StepCounter``): matmul-class FLOPs, the bytes every op
reads and writes (unfused, so ``t_memory`` is an upper bound), and each
c10d collective, bucketed by the reference's formulas
(``bucket_collectives``: operand and wire bytes). The hand-written
kernels are not torch ops and would count nothing, so the cases run the
matmul planners (``torch``, ``torch_karatsuba``), as the reference prices
its ``jnp`` path.

``t_collective`` prices every byte on the wire at NVLink's published 450
GB/s (``H100.link_bw``). Over 256 H100s, 32 nodes of 8, only 7 of a
rank's 255 peers are on NVLink and the rest are reached over the slower
network between nodes, which no constant here holds (none has been
measured): at p = 256 ``t_collective`` is a lower bound.

  PYTHONPATH=src python experiments/fft_roofline_torch.py --out dryrun_out/fft
  PYTHONPATH=src python experiments/fft_roofline_torch.py --pencil --out dryrun_out/fft

Runs on the CPU in seconds; no card, no cluster.
"""

import argparse
import json
import os
import time
import warnings

import torch

from repro_torch.core import dfft, plan
from repro_torch.core.comm import make_mesh
from repro_torch.core.plan import H100, H100_CARD
from repro_torch.launch.dryrun import (StepCounter, _fake_group,
                                       bucket_collectives)

N = 1 << 14           # paper problem: 2^14 x 2^14
RANKS = 256           # one pod of the reference: 16 x 16 chips


def _traced(world, fn):
    """(``StepCounter`` of ``fn()``, seconds): ``fn`` runs once on a fake
    group of ``world`` ranks, under the counter."""
    counter = StepCounter()
    with _fake_group(world), warnings.catch_warnings():
        # the shims are deprecated in favour of plan_nd, and c10d's
        # all_gather_into_tensor (agas) in favour of a newer name; the
        # reference's script calls the shims, so this one does
        warnings.simplefilter("ignore", DeprecationWarning)
        warnings.simplefilter("ignore", FutureWarning)
        t0 = time.perf_counter()
        with counter:
            fn()
        seconds = time.perf_counter() - t0
    return counter, seconds


def roofline(name, counter, seconds, chunks=None):
    """The record of one traced case at the H100 profile's constants.
    ``chunks``: the pipelined exchange's chunk count (None: monolithic),
    for the reference's exposed-communication model."""
    flops = float(counter.flops)
    bytes_ = float(counter.bytes)
    coll, counts, wire = bucket_collectives(counter.events)
    wire_b = sum(wire.values())
    # exposed-communication model: the pipelined schedule overlaps each
    # chunk's exchange with the next chunk's row FFTs; with c chunks,
    # exposed time ~ max(per-chunk comm, per-chunk compute) summed, lower-
    # bounded by 1/c of the monolithic exchange staying exposed.
    t_coll = wire_b / H100.link_bw
    exposed = t_coll if chunks is None else (
        t_coll / chunks + (chunks - 1) / chunks * max(
            0.0, t_coll / chunks - flops / H100.flops / chunks))
    rec = {
        "name": name, "card": H100_CARD,
        "constants": {"flops": H100.flops, "hbm_bw": H100.hbm_bw,
                      "link_bw": H100.link_bw},
        "trace_seconds": round(seconds, 2),
        "flops_per_device": flops,
        "flops_counted": "matmul-class ops (FlopCounterMode's rules); no "
                         "elementwise op",
        "bytes_per_device_unfused": bytes_,
        "collective_operand_bytes": sum(coll.values()),
        "collective_wire_bytes": wire_b,
        "collective_counts": counts,
        "t_compute": flops / H100.flops,
        "t_memory": bytes_ / H100.hbm_bw,
        "t_collective": t_coll,
        "t_collective_exposed": exposed,
    }
    terms = {k: rec[k] for k in ("t_compute", "t_memory")}
    terms["t_collective"] = exposed
    rec["bottleneck"] = max(terms, key=terms.get)
    rec["t_total_max"] = max(terms.values())
    return rec


def lower_case(name, planner, comm, keep_transposed, chunks=4,
               permuted_cols=False):
    """One case: rank 0's (N/RANKS, N) block through ``fft2_slab`` on a
    (RANKS,) mesh, priced by ``roofline``."""
    x = torch.randn(N // RANKS, N, generator=torch.Generator().manual_seed(0))

    def run():
        mesh = make_mesh((RANKS,), ("fft",))
        dfft.fft2_slab(x, mesh, "fft", planner, comm=comm, chunks=chunks,
                       keep_transposed=keep_transposed,
                       permuted_cols=permuted_cols)
    counter, seconds = _traced(RANKS, run)
    return roofline(name, counter, seconds,
                    chunks if comm == "pipelined" else None)


def lower_pencil(n3: int = 1024):
    """3D c2c FFT (n3^3) pencil-decomposed over a 16 x 16 mesh — the
    P3DFFT-style decomposition the paper cites: exchanges stay within
    row/column communicators (16 ranks) instead of the global 256."""
    planner = plan.Planner(backends=("torch",))
    gen = torch.Generator().manual_seed(0)
    pair = tuple(torch.randn(n3 // 16, n3 // 16, n3, generator=gen)
                 for _ in "ri")

    def run():
        mesh = make_mesh((16, 16), ("mx", "my"))
        dfft.fft3_pencil(pair, mesh, ("mx", "my"), planner)
    counter, seconds = _traced(RANKS, run)
    return roofline(f"pencil3d_{n3}", counter, seconds)


def cases():
    """(name, ``lower_case`` keywords) of the seven configurations."""
    est = plan.Planner(mode="estimate", backends=("torch",))
    kar = plan.Planner(mode="estimate", backends=("torch_karatsuba",))
    return [
        # paper-faithful baseline: monolithic all_to_all, ordered
        # transforms, 4-matmul complex products, full layout restore
        ("baseline_paper", dict(planner=est, comm="collective",
                                keep_transposed=False)),
        # the paper's own AGAS overhead measurement
        ("agas", dict(planner=est, comm="agas", keep_transposed=False)),
        # beyond-paper #1: skip the second exchange (consumer accepts the
        # transposed spectrum — valid for conv/filter pipelines)
        ("keep_transposed", dict(planner=est, comm="collective",
                                 keep_transposed=True)),
        # beyond-paper #2: Karatsuba 3-matmul complex products
        ("karatsuba", dict(planner=kar, comm="collective",
                           keep_transposed=True)),
        # beyond-paper #3: chunked pipelined exchange (LCI analogue)
        ("pipelined_c4", dict(planner=kar, comm="pipelined",
                              keep_transposed=True, chunks=4)),
        ("pipelined_c8", dict(planner=kar, comm="pipelined",
                              keep_transposed=True, chunks=8)),
        # beyond-paper #4: permuted-order column FFTs (skip digit transpose
        # — one fewer memory pass per column transform)
        ("permuted_cols", dict(planner=est, comm="collective",
                               keep_transposed=True, permuted_cols=True)),
    ]


def _line(rec) -> str:
    colls = {k: v for k, v in rec["collective_counts"].items() if v}
    return (f"{rec['name']:18s} trace={rec['trace_seconds']:6.2f}s "
            f"t_comp={rec['t_compute'] * 1e3:7.3f}ms "
            f"t_mem={rec['t_memory'] * 1e3:7.3f}ms "
            f"t_coll={rec['t_collective'] * 1e3:7.3f}ms "
            f"exposed={rec['t_collective_exposed'] * 1e3:7.3f}ms "
            f"bneck={rec['bottleneck']} "
            f"max={rec['t_total_max'] * 1e3:7.3f}ms "
            f"colls={colls} "
            f"[{rec['card']}]")


def _write(out, name, obj):
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, name), "w") as f:
            json.dump(obj, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default=None)
    ap.add_argument("--pencil", action="store_true")
    args = ap.parse_args(argv)

    if args.pencil:
        rec = lower_pencil()
        print(_line(rec), flush=True)
        _write(args.out, "fft_pencil3d.json", rec)
        return

    results = []
    for name, kw in cases():
        if args.only and args.only != name:
            continue
        rec = lower_case(name, **kw)
        results.append(rec)
        print(_line(rec), flush=True)
    _write(args.out, "fft_roofline.json", results)


if __name__ == "__main__":
    main()
