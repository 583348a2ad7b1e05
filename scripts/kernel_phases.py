#!/usr/bin/env python3
"""Where the FFT kernels spend their time, stage by stage, on the GPU.

    python3 scripts/kernel_phases.py

run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds instrumented copies of ``dft_matmul.cu`` and ``fftconv.cu`` under
``build/kernel_phases/`` (the sources in the package are not touched), runs
each kernel at its main-path shape three times, and prints the SM clock
cycles (``clock64`` of thread 0) of each stage of one unit of work in the
last run, for a unit early, in the middle and late in the launch.

- The four-step kernel (natural and permuted, at (8193, 16384), (128, 128)
  and (262144, 512), (32, 16)) marks its stages with ``FOUR_STEP_MARK``:
  the unit is a row (BIG) or a batch of rows, and its persistent CTA's
  stages are, for a BIG row, per group of columns: the wait on the tile
  ring, DFT_n1's first pass from the ring and the barrier after it (which
  also starts the next group's copies), DFT_n1's later passes; then the
  barrier closing DFT_n1, DFT_n2 but its last pass, and the last pass with
  the store (or the permuted copy-out). For a batch of short rows: starting
  the next batch's copies and waiting on this one's, DFT_n1, DFT_n2 but
  its last pass, the last pass with the store.
- The fused convolution (at (8192, 16384), (128, 128) and (262144, 512),
  (32, 16)) marks its stages with ``FFTCONV_MARK``: the unit is a pair of
  rows (BIG) or a batch of pairs. A BIG pair's stages are, per group of
  columns, the wait on the tile ring, the forward DFT_n1's first pass from
  the ring and the barrier after it (which also starts the next copies),
  its later passes; then the barrier closing DFT_n1, the middle (DFT_n2,
  H, inverse DFT_n2 and the barrier after them), the inverse DFT_n1 but
  its last pass, and the last pass with the store. A batch: starting the
  next batch's copies and waiting on this one's, the forward DFT_n1, the
  middle, the inverse DFT_n1 but its last pass, the last pass with the
  store.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.calibrate import card_label  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.dft_matmul import ops as dft_ops  # noqa: E402
from repro_torch.kernels.fftconv import ops as conv_ops  # noqa: E402

OUT = ROOT / "build" / "kernel_phases"
RUNS = 3
GLOBALS = ("__device__ long long g_clock[64];\n__device__ int g_marks;\n"
           "__device__ long long g_unit;\n")
# one row, pair or batch, whichever CTA takes it
MARK_BODY = ("(unit) do { if (threadIdx.x == 0 && (long long)(unit) == g_unit "
             "&& g_marks < 64) g_clock[g_marks++] = clock64(); } while (0)\n")
READ = """
extern "C" void read_marks(long long* out, long long next_unit) {
  cudaMemcpyFromSymbol(out, g_clock, sizeof(long long) * 64);
  const long long none[64] = {};
  cudaMemcpyToSymbol(g_clock, none, sizeof(none));
  const int zero = 0;
  cudaMemcpyToSymbol(g_marks, &zero, sizeof(int));
  cudaMemcpyToSymbol(g_unit, &next_unit, sizeof(long long));
}
"""


def _replace_once(text: str, old: str, new: str) -> str:
    if text.count(old) < 1:
        raise RuntimeError(f"kernel_phases: source no longer has {old!r}")
    return text.replace(old, new, 1)


def build() -> dict:
    """Instrumented copies of the two kernels, compiled; name -> CDLL."""
    shutil.rmtree(OUT, ignore_errors=True)
    kernels = _build.KERNELS_DIR
    procs = {}
    for name, hook in (("dft_matmul", "FOUR_STEP_MARK"),
                       ("fftconv", "FFTCONV_MARK")):
        # the kernel's own marks, the headers as they are
        shutil.copytree(kernels / "common", OUT / name / "common")
        (OUT / name / name).mkdir(parents=True)
        src = (kernels / name / f"{name}.cu").read_text()
        src = _replace_once(src, f"#ifndef {hook}",
                            GLOBALS + f"#define {hook}" + MARK_BODY
                            + f"#ifndef {hook}")
        path = OUT / name / name / f"{name}.cu"
        path.write_text(src + READ)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"kernel_phases: nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
        libs[name].read_marks.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    return libs


def phases(lib, unit: int, launch) -> list:
    """Cycles of each stage of `unit` in the last of RUNS launches."""
    marks = (ctypes.c_longlong * 64)()
    lib.read_marks(ctypes.addressof(marks), unit)
    for _ in range(RUNS):
        rc = launch()
        if rc:
            raise RuntimeError(f"kernel_phases: launch failed with code {rc}")
    torch.cuda.synchronize()
    lib.read_marks(ctypes.addressof(marks), -1)
    got = [m for m in marks if m]
    per = len(got) // RUNS
    last = got[(RUNS - 1) * per:RUNS * per]
    return [b - a for a, b in zip(last, last[1:])]


def four_step_stages(n2: int, big: bool) -> list:
    """The names of the four-step kernel's stages of one unit."""
    if not big:
        return ["start next + wait", "DFT_n1", "DFT_n2 but last pass",
                "last pass + store"]
    names = []
    for g in range((n2 + 63) // 64):
        names += [f"wait ring g{g}", f"DFT_n1 pass 0 g{g} + barrier",
                  f"DFT_n1 later passes g{g}"]
    return names + ["barrier", "DFT_n2 but last pass", "last pass + store"]


def fftconv_stages(n2: int, big: bool) -> list:
    """The names of the fused kernel's stages of one pair or batch."""
    tail = ["middle", "inverse DFT_n1 but last pass", "last pass + store"]
    if not big:
        return ["start next + wait", "DFT_n1"] + tail
    names = []
    for g in range((n2 + 63) // 64):
        names += [f"wait ring g{g}", f"DFT_n1 pass 0 g{g} + barrier",
                  f"DFT_n1 later passes g{g}"]
    return names + ["barrier"] + tail


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    print(card_label())
    libs = build()
    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    gen = torch.Generator(device="cuda").manual_seed(0)
    four = libs["dft_matmul"]
    four.four_step_fft.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    four.four_step_fft.restype = ctypes.c_int
    for shape, f, rows_per_unit in (((8193, 16384), (128, 128), 1),
                                    ((262144, 512), (32, 16), 16)):
        x = [torch.randn(shape, device="cuda", generator=gen) for _ in "ri"]
        y = [torch.empty_like(t) for t in x]
        r1, tw, r2 = dft_ops.tables(*f, x[0].device)
        units = shape[0] // rows_per_unit
        names = four_step_stages(f[1], rows_per_unit == 1)
        for permuted in (0, 1):
            for unit in (0, units // 2, units - 2):
                cycles = phases(four, unit, lambda: four.four_step_fft(
                    ptr(x[0]), ptr(x[1]), ptr(r1), ptr(tw), ptr(r2), ptr(y[0]),
                    ptr(y[1]), shape[0], f[0], f[1], 0, permuted, stream()))
                named = ", ".join(f"{k} {c}" for k, c in zip(names, cycles))
                print(f"four_step_fft {shape} {f} permuted={permuted} "
                      f"{'row' if rows_per_unit == 1 else 'batch'} {unit}: "
                      f"{named}; total {sum(cycles)}")
        del x, y
    conv = libs["fftconv"]
    conv.fftconv_fused.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    conv.fftconv_fused.restype = ctypes.c_int
    # rows a unit: a pair (BIG), or a batch of kPoints / n pairs
    for shape, f, rows_per_unit in (((8192, 16384), (128, 128), 2),
                                    ((262144, 512), (32, 16), 32)):
        x = torch.randn(shape, device="cuda", generator=gen)
        y = torch.empty_like(x)
        h = torch.randn(shape[1], device="cuda", generator=gen)
        spec = dft_ops.interleaved(conv_ops.filter_spectrum_permuted(h, f))
        r1, tw, r2 = dft_ops.tables(*f, x.device)
        units = shape[0] // rows_per_unit
        names = fftconv_stages(f[1], rows_per_unit == 2)
        for unit in (0, units // 2, units - 2):
            cycles = phases(conv, unit, lambda: conv.fftconv_fused(
                ptr(x), ptr(spec), ptr(r1), ptr(tw), ptr(r2), ptr(y),
                shape[0], f[0], f[1], 8, stream()))
            named = ", ".join(f"{k} {c}" for k, c in zip(names, cycles))
            print(f"fftconv_fused {shape} {f} "
                  f"{'pair' if rows_per_unit == 2 else 'batch'} {unit}: "
                  f"{named}; total {sum(cycles)}")
        del x, y
    return 0


if __name__ == "__main__":
    sys.exit(main())
