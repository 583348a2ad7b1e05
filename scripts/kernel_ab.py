#!/usr/bin/env python3
"""The FFT kernels of two checkouts, side by side on one card, in turns.

    python3 scripts/kernel_ab.py --parent DIR [--rounds 2] [--steps]
        [--tree LABEL=DIR ...]

run from the root of a checkout on a machine with a CUDA card and nvcc;
DIR is the root of another checkout (for example a ``git archive`` of the
parent commit unpacked under ``build/``). It compiles ``dft_matmul.cu`` and
``fftconv.cu`` of both trees (each with its own ``kernels/common``
headers) under ``build/kernel_ab/``, all at once, and prints each kernel's
registers, shared memory and spills as ``nvcc -Xptxas -v`` gives them.
Then at the main path's shapes (the four-step at (8193, 16384),
(128, 128) and (262144, 512), (32, 16); the fused convolution at
(8192, 16384), (128, 128) and (262144, 512), (32, 16)) it checks the
trees' kernels against this checkout's plain version (the four-step,
1e-4 * scale) or float64 ``torch.fft`` (the convolution, 2e-4 * max) and
times them in the order parent, change, change, parent (``--rounds`` such
rounds), each time the median of 10 CUDA-event runs, with
``torch.fft.fft`` (the four-step) and the composition rfft, multiply,
irfft (the convolution) timed in the same rounds. The tables and the
inputs are this checkout's.

More fused-convolution builds join the turns (parent, change, the others,
then the same in reverse): ``--tree LABEL=DIR`` another checkout's, and
``--steps`` this checkout's fused kernel with steps of its design undone,
derived by fixed edits of the sources (``STEPS``): ``step-1`` keeps only
the persistent CTAs and their staged input (T from its table, the middle
in shared-memory passes), ``steps-1-2`` adds T from the roots,
``no-step-2`` is the whole design but T from its table, and
``one-unit-ctas`` the whole design with one CTA a pair or batch.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.calibrate import card_label, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.dft_matmul import ops as dft_ops  # noqa: E402
from repro_torch.kernels.dft_matmul.ref import fft_four_step_ref  # noqa: E402
from repro_torch.kernels.fftconv import ops as conv_ops  # noqa: E402

OUT = ROOT / "build" / "kernel_ab"
HBM_PEAK = 3.35e12     # H100 SXM HBM3 bytes/s (published)
FOUR_STEP = (((8193, 16384), (128, 128)), ((262144, 512), (32, 16)))
CONV = (((8192, 16384), (128, 128)), ((262144, 512), (32, 16)))
TREES = ("parent", "change")
# The design's steps undone, each by fixed edits (file under the kernels
# directory, old text, new text; each old text found once):
# - the middle in shared-memory passes instead of registers (step 3);
_SMEM_MIDDLE = [("fftconv/fftconv.cu", "  if (middle_in_registers(",
                 "  if (false && middle_in_registers(")]
# - T read from its table in device memory at every point, instead of
#   from the roots in shared memory (step 2);
_T_TABLE = [
    ("common/persistent.cuh", "namespace persistent {\n",
     "namespace persistent {\n__device__ const float2* t_table;\n"),
    ("common/persistent.cuh",
     "    const int n1 = a1.m, n2 = a2.m;\n"
     "    for (int i = threadIdx.x; i < n1; i += blockDim.x) w1[i]",
     "    const int n1 = a1.m, n2 = a2.m;\n    t_table = tw;\n"
     "    for (int i = threadIdx.x; i < n1; i += blockDim.x) w1[i]"),
    ("common/persistent.cuh",
     "    const int e = k1 * c, q = by_n2(e);\n"
     "    return fft_radix::cmul(w1[q], wn[e - q * n2]);",
     "    return __ldg(t_table + k1 * n2 + c);"),
    ("fftconv/fftconv.cu",
     "      float2 tw_t = fft_radix::conj(tab.twiddle(k1, j, N, by_n2));\n"
     "      const float2 tw_step = fft_radix::conj(tab.twiddle(k1, R1, N, "
     "by_n2));\n"
     "#pragma unroll\n"
     "      for (int t = 0; t < R0; ++t) {\n"
     "        line[Smem::col(j + t * R1)] = fft_radix::cmul(v[t], tw_t);\n"
     "        tw_t = fft_radix::cmul(tw_t, tw_step);\n"
     "      }\n",
     "#pragma unroll\n"
     "      for (int t = 0; t < R0; ++t)\n"
     "        line[Smem::col(j + t * R1)] = fft_radix::cmul(\n"
     "            v[t], fft_radix::conj(tab.twiddle(k1, j + t * R1, N, "
     "by_n2)));\n")]
# - one CTA a pair or batch instead of persistent CTAs (step 1's walk).
_ONE_UNIT_CTAS = [
    ("common/persistent.cuh",
     "  const long long ctas =\n"
     "      units < (long long)sms * per_sm ? units : (long long)sms * per_sm;",
     "  const long long ctas = units;")]
STEPS = (
    ("step-1", _T_TABLE + _SMEM_MIDDLE),   # staged CTAs alone
    ("steps-1-2", _SMEM_MIDDLE),           # and T from the roots
    ("no-step-2", _T_TABLE),
    ("one-unit-ctas", _ONE_UNIT_CTAS),
)


def derive_steps() -> dict:
    """{label: kernels directory} of this checkout's design steps, under
    OUT."""
    dirs = {}
    for label, edits in STEPS:
        kdir = OUT / "steps" / label / "kernels"
        shutil.rmtree(kdir, ignore_errors=True)
        shutil.copytree(_build.KERNELS_DIR, kdir,
                        ignore=shutil.ignore_patterns("*.py", "__pycache__"))
        for rel, old, new in edits:
            text = (kdir / rel).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"kernel_ab: {rel} no longer has {old!r} "
                                   f"once")
            (kdir / rel).write_text(text.replace(old, new))
        dirs[label] = kdir
    return dirs


def build(roots: dict) -> dict:
    """{tree: {kernel: CDLL}} of the kernels directories in `roots`
    (parent and change build both kernels, the others the fused one),
    compiled in parallel; prints ptxas's lines."""
    procs = {}
    for tree, kdir in roots.items():
        (OUT / tree).mkdir(parents=True, exist_ok=True)
        names = (("dft_matmul", "fftconv") if tree in TREES
                 else ("fftconv",))
        for name in names:
            so = OUT / tree / f"{name}.so"
            procs[tree, name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                 str(kdir / name / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {tree: {} for tree in roots}
    for (tree, name), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"kernel_ab: nvcc failed on {tree} {name}:\n"
                               f"{log}")
        for line in log.splitlines():
            if re.search(r"entry function|registers|spill", line):
                print(f"  {tree} {name}: {line.strip()}")
        lib = ctypes.CDLL(str(so))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        if name == "dft_matmul":
            lib.four_step_fft.argtypes = [ptr] * 7 + [i64] + [i32] * 4 + [ptr]
            lib.four_step_fft.restype = i32
        else:
            lib.fftconv_fused.argtypes = [ptr] * 6 + [i64] + [i32] * 3 + [ptr]
            lib.fftconv_fused.restype = i32
        libs[tree][name] = lib
    return libs


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def time_conv(libs, trees, shape, f, gen, rounds) -> bool:
    """Checks each tree's fused kernel at `shape` against float64 torch.fft
    and times them in turns; whether every check passed."""
    x = torch.randn(shape, device="cuda", generator=gen)
    h = torch.randn(shape[1], device="cuda", generator=gen) * torch.exp(
        -torch.arange(shape[1], device="cuda") / 64.0)
    y = torch.empty_like(x)
    spec = dft_ops.interleaved(conv_ops.filter_spectrum_permuted(h, f))
    r1, tw, r2 = dft_ops.tables(*f, x.device)
    ref = torch.fft.irfft(torch.fft.rfft(x.double()) * torch.fft.rfft(
        h.double()), n=shape[1])

    def conv(tree):
        rc = libs[tree]["fftconv"].fftconv_fused(
            x.data_ptr(), spec.data_ptr(), r1.data_ptr(), tw.data_ptr(),
            r2.data_ptr(), y.data_ptr(), shape[0], f[0], f[1], 8, stream())
        if rc:
            raise RuntimeError(f"kernel_ab: {tree} fftconv_fused rc {rc}")

    ok = True
    limit = 2e-4 * ref.abs().max().item()
    for tree in trees:
        y.fill_(float("nan"))
        conv(tree)
        torch.cuda.synchronize()
        err = (y.double() - ref).abs().max().item()
        ok &= err <= limit
        print(f"check fftconv_fused {shape} {f} {tree}: err {err:.3e} "
              f"(limit {limit:.3e})")
    del ref
    hf = torch.fft.rfft(h)
    bound = 8.0 * shape[0] * shape[1] / HBM_PEAK * 1e3
    order = list(trees) + list(reversed(trees))
    for rnd in range(rounds):
        ms = {}
        for tree in order:
            ms.setdefault(tree, []).append(time_ms(lambda: conv(tree)))
        lib = time_ms(lambda: torch.fft.irfft(torch.fft.rfft(x) * hf,
                                              n=shape[1]))
        print(f"time fftconv_fused {shape} {f} round {rnd}: " + ", ".join(
            f"{tree} {t[0]:.3f} / {t[1]:.3f} ms "
            f"({bound / (sum(t) / 2):.1%} of bound)"
            for tree, t in ms.items())
            + f", torch.fft composition {lib:.3f} ms, bound {bound:.3f} ms "
            f"(bytes)")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--tree", action="append", default=[],
                    metavar="LABEL=DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    print(card_label())
    kernels = Path("src") / "repro_torch" / "kernels"
    roots = {"parent": args.parent.resolve() / kernels,
             "change": _build.KERNELS_DIR}
    for spec in args.tree:
        label, _, root = spec.partition("=")
        roots[label] = Path(root).resolve() / kernels
    if args.steps:
        roots.update(derive_steps())
    libs = build(roots)
    conv_trees = tuple(roots)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True

    for shape, f in FOUR_STEP:
        x = [torch.randn(shape, device="cuda", generator=gen) for _ in "ri"]
        y = [torch.empty_like(t) for t in x]
        xc = torch.complex(x[0], x[1])
        r1, tw, r2 = dft_ops.tables(*f, x[0].device)
        ref = fft_four_step_ref(tuple(x), f)
        scale = ref[0].abs().max().item() + 1e-6

        def run(tree):
            rc = libs[tree]["dft_matmul"].four_step_fft(
                x[0].data_ptr(), x[1].data_ptr(), r1.data_ptr(),
                tw.data_ptr(), r2.data_ptr(), y[0].data_ptr(),
                y[1].data_ptr(), shape[0], f[0], f[1], 0, 0, stream())
            if rc:
                raise RuntimeError(f"kernel_ab: {tree} four_step_fft rc {rc}")

        for tree in TREES:
            run(tree)
            torch.cuda.synchronize()
            err = max((y[i] - ref[i]).abs().max().item() for i in (0, 1))
            ok &= err <= 1e-4 * scale
            print(f"check four_step_fft {shape} {f} {tree}: err {err:.3e} "
                  f"(limit {1e-4 * scale:.3e})")
        del ref
        bound = 16.0 * shape[0] * shape[1] / HBM_PEAK * 1e3
        for rnd in range(args.rounds):
            ms = {}
            for tree in ("parent", "change", "change", "parent"):
                ms.setdefault(tree, []).append(time_ms(lambda: run(tree)))
            lib = time_ms(lambda: torch.fft.fft(xc))
            print(f"time four_step_fft {shape} {f} round {rnd}: parent "
                  f"{ms['parent'][0]:.3f} / {ms['parent'][1]:.3f} ms, change "
                  f"{ms['change'][0]:.3f} / {ms['change'][1]:.3f} ms, "
                  f"torch.fft.fft {lib:.3f} ms, bound {bound:.3f} ms (bytes);"
                  f" share of bound parent "
                  f"{bound / (sum(ms['parent']) / 2):.1%}, change "
                  f"{bound / (sum(ms['change']) / 2):.1%}")
        del x, y, xc

    for shape, f in CONV:
        ok &= time_conv(libs, conv_trees, shape, f, gen, args.rounds)
    print("kernel_ab: " + ("every check passed" if ok else "a check FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
