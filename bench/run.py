#!/usr/bin/env python3
"""Run one cell of the benchmark and print its result line.

    python3 bench/run.py --workload <config>.<traffic> --seed N \\
        --seconds S --trace 0|1

from the root of a checkout with the cards the cell asks for. The cell's
configuration and traffic files, found by the names in BENCHMARK.json,
say what runs: the traffic's ``driver`` (a module of ``bench/drivers``)
makes the inputs from the seed, sets up the port (``src/repro_torch``),
warms up, measures for ``--seconds``, and compares what the timed path
produced with the plain reference of ``bench/reference``.

With ``--trace 0`` the result's metrics are the cell's end-to-end ones;
with ``--trace 1`` the per-layer ones, each read from the profiler's
trace by its reader (``bench/metrics/<name>.py``). The numbers compared
are printed beside their limits as the last lines of standard error and
under ``checks``, the last key of the result line, which is the last line
of standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.lib import common  # noqa: E402


class Context:
    """What a driver is given: the cell's files, the run's arguments, and
    the device it runs on (the card; the CPU only in the tests)."""

    def __init__(self, name, spec, seed, seconds, trace, device="cuda",
                 t_start=None):
        self.name = name
        self.entry, self.config = spec["entry"], spec["config"]
        self.traffic = spec["traffic"]
        self.chips = self.entry["chips"]
        self.seed, self.seconds, self.trace = seed, seconds, bool(trace)
        self.device = device
        self.t_start = T_START if t_start is None else t_start
        self.limits = self.config["limits"]


def reader(name: str):
    """The per-layer metric reader of ``bench/metrics/<name>.py``."""
    path = common.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def layer_metrics(name: str, man: dict, out: dict) -> dict:
    """The cell's per-layer metrics that their readers find; a reader that
    finds nothing returns None and its metric is left out."""
    found = {}
    for m in common.metrics_of(name, man, "per_layer"):
        value = reader(m["name"])(out)
        if value is not None:
            found[m["name"]] = {"value": value, "unit": m["unit"]}
    return found


def execute(ctx: Context, man: dict):
    """Run the cell's driver: (the result line as a dict, the JAX modules
    that the cell's other processes found loaded)."""
    driver = importlib.import_module(f"bench.drivers.{ctx.traffic['driver']}")
    common.mark("import the driver")
    out = driver.run(ctx)
    checks = out["checks"]
    correct = all(value <= limit for _, value, limit in checks)
    if ctx.trace:
        metrics = layer_metrics(ctx.name, man, out)
    else:
        units = {m["name"]: m["unit"]
                 for m in common.metrics_of(ctx.name, man, "end_to_end")}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out["e2e"].items() if k in units}
    device = {"platform": "gpu" if ctx.device != "cpu" else "cpu",
              "kind": out.get("kind"), "count": ctx.chips,
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power_limit": out.get("power_limit")}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if ctx.trace and out.get("traces"):
        traces = out["traces"]
        device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        device["window_s"] = sum(t["window_s"] for t in traces) / len(traces)
        line["breakdown"] = out["breakdown"]
    mine = [m for m in common.SETUP if m[1] >= ctx.t_start]
    line["setup_parts"] = {"main": common.setup_parts(ctx.t_start, mine)}
    for r, marks in enumerate(out.get("rank_marks", [])):
        line["setup_parts"][f"rank{r}"] = common.setup_parts(ctx.t_start,
                                                             marks)
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for note in out.get("notes", []):
        common.say(note)
    return line, out.get("loaded", [])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.cache_env()
    common.use_src()
    man = common.manifest()
    spec = common.cell(args.workload, man)
    if not (common.SRC / "repro_torch").is_dir():
        raise SystemExit(f"no program under {common.SRC}: the benchmark "
                         "measures src/repro_torch")
    common.cache_bytecode()
    common.require_cuda(spec["entry"]["chips"])
    common.mark("import torch, count the cards")
    ctx = Context(args.workload, spec, args.seed, args.seconds, args.trace)
    line, elsewhere = execute(ctx, man)
    loaded = common.forbidden_modules(sys.modules) + elsewhere
    if loaded:
        common.say(f"JAX or the JAX package was loaded: {loaded}")
        return 3
    for who, parts in line["setup_parts"].items():
        common.say(f"set-up of {who} (s): " + ", ".join(
            f"{k} {v}" for k, v in parts.items()))
    for n, c in line["checks"].items():
        common.say(f"check {n}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
