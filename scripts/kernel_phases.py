#!/usr/bin/env python3
"""Where a CTA of the FFT kernels spends its time, pass by pass, on the GPU.

    python3 scripts/kernel_phases.py

run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds copies of ``dft_matmul.cu`` and ``fftconv.cu`` under
``build/kernel_phases/`` in which thread 0 of one chosen CTA records the SM
clock (``clock64``) when the kernel starts and after the barrier that ends
every radix pass, runs each kernel at its main-path shape (the four-step
at (8193, 16384) and (262144, 512), natural and permuted; the fused
convolution at (8192, 16384)) three times for a CTA early, in the middle
and late in the grid, and prints the cycles of each phase of the last run.
Phase 0 runs from the kernel's start to the end of its first pass (the
tables and the loads from device memory); the four-step's permuted
copy-out after its last pass is not a phase. The sources in the package
are not touched.
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
MARK = ("do { if (threadIdx.x == 0 && blockIdx.x == fft_radix::g_block) "
        "fft_radix::g_clock[fft_radix::g_marks++] = clock64(); } while (0)")
READ = """
extern "C" void read_marks(long long* out, int next_block) {
  cudaMemcpyFromSymbol(out, fft_radix::g_clock, sizeof(long long) * 64);
  const int zero = 0;
  cudaMemcpyToSymbol(fft_radix::g_marks, &zero, sizeof(int));
  cudaMemcpyToSymbol(fft_radix::g_block, &next_block, sizeof(int));
}
"""


def _replace_once(text: str, old: str, new: str) -> str:
    if text.count(old) < 1:
        raise RuntimeError(f"kernel_phases: source no longer has {old!r}")
    return text.replace(old, new, 1)


def build() -> dict:
    """Instrumented copies of the two kernels, compiled; name -> CDLL."""
    shutil.rmtree(OUT, ignore_errors=True)
    (OUT / "common").mkdir(parents=True)
    header = (_build.KERNELS_DIR / "common" / "fft_radix.cuh").read_text()
    header = _replace_once(
        header, "namespace fft_radix {",
        "namespace fft_radix {\n__device__ long long g_clock[64];\n"
        "__device__ int g_marks;\n__device__ int g_block;\n"
        f"#define FFT_PHASE_MARK() {MARK}\n")
    # after the barrier that ends each pass of transform()
    header = _replace_once(
        header, "        [&](int r, int l, int p, float2 v) { store(i, r, l, p, v); });\n"
        "    __syncthreads();\n",
        "        [&](int r, int l, int p, float2 v) { store(i, r, l, p, v); });\n"
        "    __syncthreads();\n    FFT_PHASE_MARK();\n")
    (OUT / "common" / "fft_radix.cuh").write_text(header)
    procs = {}
    for name in ("dft_matmul", "fftconv"):
        src = (_build.KERNELS_DIR / name / f"{name}.cu").read_text()
        src = _replace_once(src, "  const int n1 = a1.m, n2 = a2.m, n = n1 * n2;\n",
                            "  FFT_PHASE_MARK();\n"
                            "  const int n1 = a1.m, n2 = a2.m, n = n1 * n2;\n")
        if name == "fftconv":      # the merged pass ends outside transform()
            src = _replace_once(src, "    __syncthreads();\n  }\n  fft_radix::transform<BIG, true, true, false>(",
                                "    __syncthreads();\n    FFT_PHASE_MARK();\n  }\n"
                                "  fft_radix::transform<BIG, true, true, false>(")
        (OUT / name).mkdir()
        (OUT / name / f"{name}.cu").write_text(src + READ)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(OUT / name / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"kernel_phases: nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
        libs[name].read_marks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return libs


def phases(lib, block: int, launch) -> list:
    """Cycles of each phase of CTA `block` in the last of RUNS launches."""
    marks = (ctypes.c_longlong * 64)()
    lib.read_marks(ctypes.addressof(marks), block)
    for _ in range(RUNS):
        launch()
    torch.cuda.synchronize()
    lib.read_marks(ctypes.addressof(marks), 0)
    got = [m for m in marks if m]
    per = len(got) // RUNS
    last = got[(RUNS - 1) * per:RUNS * per]
    return [b - a for a, b in zip(last, last[1:])]


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
    for shape, f, rows_per_cta in (((8193, 16384), (128, 128), 1),
                                   ((262144, 512), (32, 16), 16)):
        x = [torch.randn(shape, device="cuda", generator=gen) for _ in "ri"]
        y = [torch.empty_like(t) for t in x]
        r1, tw, r2 = dft_ops.tables(*f, x[0].device)
        ctas = shape[0] // rows_per_cta
        for permuted in (0, 1):
            for block in (0, ctas // 2, ctas - 2):
                cycles = phases(four, block, lambda: four.four_step_fft(
                    ptr(x[0]), ptr(x[1]), ptr(r1), ptr(tw), ptr(r2), ptr(y[0]),
                    ptr(y[1]), shape[0], f[0], f[1], 0, permuted, stream()))
                print(f"four_step_fft {shape} {f} permuted={permuted} CTA "
                      f"{block}: cycles per phase {cycles}, total {sum(cycles)}")
        del x, y
    conv = libs["fftconv"]
    conv.fftconv_fused.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    x = torch.randn((8192, 16384), device="cuda", generator=gen)
    y = torch.empty_like(x)
    h = torch.randn(16384, device="cuda", generator=gen)
    spec = dft_ops.interleaved(conv_ops.filter_spectrum_permuted(h, (128, 128)))
    r1, tw, r2 = dft_ops.tables(128, 128, x.device)
    for block in (0, 2048, 4094):
        cycles = phases(conv, block, lambda: conv.fftconv_fused(
            ptr(x), ptr(spec), ptr(r1), ptr(tw), ptr(r2), ptr(y), 8192, 128,
            128, 8, stream()))
        print(f"fftconv_fused (8192, 16384) (128, 128) CTA {block}: cycles per "
              f"phase {cycles}, total {sum(cycles)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
