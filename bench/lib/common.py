"""What every cell of the benchmark shares: the manifest, the files a cell
is made of, seeds, devices, the caches, and the check that no JAX module
was loaded.

A cell is ``<config>.<traffic>``. Its configuration is the JSON file that
``BENCHMARK.json`` names; its traffic is ``bench/traffic/<traffic>.json``,
whose ``driver`` names the module under ``bench/drivers/`` that runs it.
Nothing here is specific to one cell.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Sequence, Tuple

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SRC = ROOT / "src"

#: top-level module names that must not be loaded in a run: JAX and the JAX
#: package the port was made from (``repro``; the port is ``repro_torch``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


#: set-up's parts in this process as each ended: (part, the host's clock)
SETUP: List[Tuple[str, float]] = []


def mark(part: str) -> None:
    """Note that set-up's part ``part`` ends now: a run prints how long
    each part took, so that it shows where its set-up went."""
    SETUP.append((part, time.perf_counter()))


def setup_parts(t_start: float,
                marks: Sequence[Tuple[str, float]]) -> Dict[str, float]:
    """Seconds of each marked part, each from the end of the one before,
    the first from ``t_start``."""
    out, prev = {}, t_start
    for part, t in marks:
        out[part] = round(t - prev, 4)
        prev = t
    return out


def manifest(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, man: Dict[str, Any]) -> Dict[str, Any]:
    """The workload entry of ``name`` with its configuration and traffic
    files read: {"entry", "config", "traffic"}."""
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{entry['traffic']}.json")
                         .read_text())
    return {"entry": entry, "config": config, "traffic": traffic}


def metrics_of(name: str, man: Dict[str, Any], section: str) -> List[dict]:
    """The metrics of ``section`` that workload ``name`` reports: those
    whose ``workloads`` list it, or that have no such list."""
    return [m for m in man[section]
            if name in m.get("workloads", [name])]


def derive_seed(seed: int, *parts: int) -> int:
    """A generator seed for one part of the inputs (a field, a chunk of
    planes, a batch), the same for the same ``seed`` and parts."""
    h = int(seed) % (1 << 62)
    for p in parts:
        h = (h * 1_000_003 + int(p) + 1) % (1 << 62)
    return h


def sampled_steps(seed: int, first: int, end: int, count: int) -> List[int]:
    """``count`` step indices in [first, end) drawn from the seed: the
    window's answers kept beside each field's last one and judged."""
    return sorted(random.Random(derive_seed(seed, 13)).sample(
        range(first, end), count))


def cache_env(root: Path = ROOT) -> None:
    """Point every build and kernel cache into the checkout, at fixed
    paths: only the first run of a cell in a checkout builds. The port's
    own kernels build into ``<checkout>/build/torch_kernels`` by code."""
    cache = root / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def cache_bytecode(root: Path = ROOT) -> None:
    """Keep the bytecode of every module a run imports in the checkout, at
    a fixed path, and load it from there: where the install keeps none of
    torch's, or Python is told to write none, every run would compile
    torch's modules again (seconds of set-up). Only the first run in a
    checkout compiles; the ranks a run starts find the prefix in their
    environment."""
    prefix = str(root / "build" / "bench_cache" / "pycache")
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = prefix


def use_src() -> None:
    """Make the port importable from the checkout's ``src``."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))


def require_cuda(chips: int) -> None:
    """Exit with an error, and print no result, without ``chips`` cards.
    The cards are counted by NVML, so that this process does not
    initialise CUDA and may fork ranks that do."""
    os.environ.setdefault("PYTORCH_NVML_BASED_CUDA_CHECK", "1")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, found "
                         f"{torch.cuda.device_count()}")


def device_context(device) -> None:
    """Make the device's context now, apart from the parts that follow
    (a no-op on the CPU)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
        mark("device context")


def card_info() -> Dict[str, Any]:
    """The card's name as torch gives it, and its power limit as
    nvidia-smi reads it (None where it cannot)."""
    import torch
    info = {"kind": torch.cuda.get_device_name(0), "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        info["power_limit"] = out[0].strip() if out else None
    except (OSError, subprocess.SubprocessError):
        pass
    return info


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The module names among ``names`` whose top-level name (before the
    first dot) is one of FORBIDDEN, compared whole."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def say(*parts: Any) -> None:
    print(*parts, file=sys.stderr, flush=True)
