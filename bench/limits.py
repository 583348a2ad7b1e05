#!/usr/bin/env python3
"""Read the numbers that decide a cell's ``correct`` on many seeds, for
setting its limits: the port's own over ``--seeds`` seeds (each a short
window of the cell's timed path), and the control's (the reference in the
precision below the configuration's) over ``--control-seeds``.

    python3 bench/limits.py --workload <cell> --seeds 12 \\
        --control-seeds 3 --seconds 2 --first-seed N

One process reads them all, one JSON line a reading; the benchmark's own
runs never run it. Needs the cards the cell asks for.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import run  # noqa: E402
from bench.lib import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--faults", default="",
                    help="comma-separated faults of the driver to read")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    common.cache_env()
    common.use_src()
    man = common.manifest()
    spec = common.cell(args.workload, man)
    if args.device != "cpu":
        # the control runs on one card; the port and its faults on the
        # cards the cell asks for
        ranks = args.seeds or args.faults
        common.require_cuda(spec["entry"]["chips"] if ranks else 1)
    driver = importlib.import_module(
        f"bench.drivers.{spec['traffic']['driver']}")
    jobs = [("port", args.first_seed + i, None) for i in range(args.seeds)]
    jobs += [("control", args.first_seed + 1000 + i, None)
             for i in range(args.control_seeds)]
    jobs += [(f"fault:{f}", args.first_seed + 2000 + i, f)
             for f in filter(None, args.faults.split(","))
             for i in range(args.control_seeds)]
    if hasattr(driver, "run_seeds") and args.seeds:
        ctx = run.Context(args.workload, spec, 0, args.seconds, 0,
                          device=args.device, t_start=time.perf_counter())
        seeds = [s for what, s, _ in jobs if what == "port"]
        t0 = time.perf_counter()
        for seed, got in zip(seeds, driver.run_seeds(ctx, seeds)):
            print(json.dumps({"what": "port", "seed": seed,
                              "seconds": (time.perf_counter() - t0)
                              / len(seeds),
                              "numbers": {n: v for n, v, _ in got["checks"]},
                              "e2e": got["e2e"]}), flush=True)
        jobs = [j for j in jobs if j[0] != "port"]
    for what, seed, fault in jobs:
        ctx = run.Context(args.workload, spec, seed, args.seconds, 0,
                          device=args.device, t_start=time.perf_counter())
        t0 = time.perf_counter()
        if what == "port":
            checks = driver.run(ctx)["checks"]
        elif what == "control":
            checks = driver.control(ctx)
        else:
            checks = driver.fault(ctx, fault)
        print(json.dumps({"what": what, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "numbers": {n: v for n, v, _ in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
