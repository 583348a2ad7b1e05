"""The dry-run summary, roofline and collective-traffic tables of the
PyTorch/H100 port, from the per-cell JSON records that
``repro_torch.launch.dryrun`` writes: the port of
``experiments/make_tables.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
        --out dryrun_out
    PYTHONPATH=src python experiments/make_tables_torch.py dryrun_out > tables.md

The tables are the reference's, in its order, with what the port's
records hold in place of XLA's: the trace's seconds for the compile's,
FLOPs counted on matmul-class ops (``flops_per_device``) and an eager
step's unfused bytes (``t_memory`` an upper bound), priced at the H100
profile's constants (``repro_torch.core.plan.H100``). Runs on the CPU.
"""

from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.configs import ARCH_IDS
from repro_torch.core.plan import H100, H100_CARD
from repro_torch.models.config import SHAPES

ARCH_ORDER = list(ARCH_IDS)
SHAPE_ORDER = [s.name for s in SHAPES]


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def fmt_b(x):
    if x is None:
        return "-"
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x / div:.2f}{unit}"
    return f"{x:.0f}B"


def improvement_hint(r):
    b = r["bottleneck"]
    kind = r["kind"]
    ar = (r.get("collective_bytes_per_device") or {}).get("all-reduce", 0)
    if kind == "train" and ar > 1e10:
        return ("f32 TP activation all-reduces dominate the wire (2/layer "
                "x fwd+remat+bwd); bf16 reductions + sequence-parallel "
                "reduce-scatter halve it; remat policy trims HBM bytes")
    if b == "memory" and kind == "decode":
        return ("weight+cache streaming bound (classic decode); bf16/int8 "
                "weights, bf16-kept attention (no f32 cache copies), more "
                "batch per card raise arithmetic intensity")
    if b == "memory":
        return ("activation streaming bound (eager ops' unfused bytes, an "
                "upper bound); fused elementwise kernels, bf16 reductions")
    if b == "collective":
        return ("collective-dominated; bf16 partial-sum reductions, "
                "replicated MoE combine buffer, chunked overlap "
                "(LCI-analogue) cut exposed time")
    return "compute-bound; near roofline if the GEMMs hold the matmul rate"


def load(dir_):
    """{(arch, shape, "single" | "multi", "flat" | "pipeline"): record} of
    the records in ``dir_`` (the mesh from the record, the pipeline from
    the file's name)."""
    recs = {}
    for f in glob.glob(os.path.join(dir_, "*.json")):
        with open(f) as fh:
            r = json.load(fh)
        if not isinstance(r, dict) or "arch" not in r:
            continue                      # other files
        key = (r["arch"], r["shape"],
               "multi" if r["mesh"].startswith("2x") else "single",
               "pipeline" if "pipeline" in os.path.basename(f) else "flat")
        recs[key] = r
    return recs


def main(dir_):
    recs = load(dir_)

    print("### Dry-run summary (single pod 16x16 = 256 chips; "
          "multi-pod 2x16x16 = 512 chips)\n")
    print("| arch | shape | 16x16 | 2x16x16 | trace(s/m) | "
          "args bytes/dev | temp bytes/dev |")
    print("|---|---|---|---|---|---|---|")
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r1 = recs.get((a, s, "single", "flat"))
            r2 = recs.get((a, s, "multi", "flat"))
            if r1 is None and r2 is None:
                continue

            def st(r):
                if r is None:
                    return "(pending)"
                return {"ok": "ok", "skip": "skip*", "error": "ERROR"}[r["status"]]
            mem = (r1 or {}).get("memory") or {}
            arg_b = mem.get("argument_bytes")
            tmp_b = mem.get("temp_bytes")
            trace = (f"{(r1 or {}).get('trace_seconds', '-')}/"
                     f"{(r2 or {}).get('trace_seconds', '-')}")
            print(f"| {a} | {s} | {st(r1)} | {st(r2)} | {trace} | "
                  f"{fmt_b(arg_b)} | {fmt_b(tmp_b)} |")
    print("\n`skip*` = documented long_500k skip for pure full-attention "
          "archs (the record's `reason`).\n")

    print(f"### Roofline (single-pod 16x16, per rank: "
          f"{H100.flops / 1e12:g} TF float32 matmul, "
          f"{H100.hbm_bw / 1e9:g} GB/s HBM, {H100.link_bw / 1e9:g} GB/s "
          f"link; {H100_CARD})\n")
    print("| arch | shape | t_compute | t_memory | t_collective | "
          "bottleneck | MODEL/counted flops | note |")
    print("|---|---|---|---|---|---|---|---|")
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s, "single", "flat"))
            if r is None or r["status"] != "ok":
                continue
            print(f"| {a} | {s} | {fmt_s(r['t_compute'])} | "
                  f"{fmt_s(r['t_memory'])} | {fmt_s(r['t_collective'])} | "
                  f"{r['bottleneck']} | {r['useful_flops_ratio']:.2f} | "
                  f"{improvement_hint(r)} |")

    print("\n### Collective traffic detail (per device, single-pod)\n")
    print("| arch | shape | all-gather | all-reduce | reduce-scatter | "
          "all-to-all | permute | wire total |")
    print("|---|---|---|---|---|---|---|---|")
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s, "single", "flat"))
            if r is None or r["status"] != "ok":
                continue
            c = r["collective_bytes_per_device"]
            w = r.get("collective_wire_bytes_per_device", {})
            print(f"| {a} | {s} | {fmt_b(c['all-gather'])} | "
                  f"{fmt_b(c['all-reduce'])} | {fmt_b(c['reduce-scatter'])} | "
                  f"{fmt_b(c['all-to-all'])} | "
                  f"{fmt_b(c['collective-permute'])} | "
                  f"{fmt_b(sum(w.values()) if w else None)} |")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "dryrun_out")
