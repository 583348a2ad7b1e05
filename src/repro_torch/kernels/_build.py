"""Build the package's CUDA kernels at first use and load them with ctypes.

Every ``*.cu`` under ``repro_torch/kernels/`` is compiled by ``nvcc`` into a
shared library with a plain C interface (``extern "C"`` launchers that
return a ``cudaError_t`` code). The libraries go to ``build/torch_kernels/``
at the root of the checkout (listed in ``.gitignore``), named by a hash of
the source, the headers under ``kernels/`` (``common/*.cuh``) and the
flags, so an edited source or header is rebuilt and an unchanged one is
not. The first call builds all sources at once, one ``nvcc`` process
each, in parallel. Nothing here runs at import time: the CPU tests import
every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> Dict[str, Path]:
    """Kernel name (the source's stem) -> its ``.cu`` file."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source on the machine with the GPU")


def _target(src: Path) -> Path:
    """The library of ``src``, named by a hash of the source, every header
    of the kernels' directory (by path and content, sorted) and the flags."""
    kernels_dir = src.resolve().parents[1]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(kernels_dir.rglob("*.cuh")):
        h.update(header.relative_to(kernels_dir).as_posix().encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale kernel source, all in parallel; return the
    library of each kernel. Raises with the compiler's output on failure."""
    srcs = sources()
    targets = {name: _target(src) for name, src in srcs.items()}
    stale = [name for name, t in targets.items() if not t.exists()]
    if stale:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in stale:
            tmp = targets[name].with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            targets[name].with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{srcs[name]} (nvcc exit {proc.returncode}):\n"
                              f"{log}")
                continue
            os.replace(tmp, targets[name])      # atomic against racing builds
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def build_log(name: str) -> str:
    """``nvcc``'s output for one kernel (``-Xptxas -v``: registers, shared
    memory, spills) from the build of the current source, or "" if none."""
    log = _target(sources()[name]).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """Load the library of one kernel, building all kernels if needed."""
    return ctypes.CDLL(str(build_all()[name]))
