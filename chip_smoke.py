#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

run from the root of a checkout. Phases, each of which raises on failure:

1. print the card's name and power limit, build every CUDA kernel of the
   port from the checkout's sources (all in parallel), turn TF32 off, and
   measure the constants of the H100 hardware profile
   (repro_torch.calibrate);
2. hold each kernel against its plain PyTorch version on the card: the
   four-step FFT over the reference's kernel sweep (with every radix
   path: 16, 8, 4, 2, 3, 5, 7, a copy and primes above 7), a Karatsuba
   permuted 128 x 128 case and the main path's shapes, at
   atol = 1e-4*scale; the tiled transpose over several dtypes and shapes and every block the main path's moves give it, exactly; the
   complex multiply over a block sweep, a suffix broadcast and the FFT
   convolution's shape, at atol = 1e-5 (the reference's); the four-step
   (permuted, at 1e-4*scale) and the transpose (exactly) at the blocks
   fft_conv hands them on the mixer's path; the fused FFT convolution over
   a factor x batch (odd and even) x block_rows sweep and its own path's
   shape, at atol = 2e-4*max|plain|;
3. run the N-D FFT path at real size through the public entry points with
   the kernel backend (Planner(backends=("hopper",))): rfftn of a 16384^2
   real array and irfftn back, fftn of a 512^3 complex pair and ifftn back,
   held against float64 torch.fft at atol = 2e-4*max|ref|, with the launch
   counts of the kernels read around this phase alone;
4. time the transforms (hopper planner, torch planner, torch.fft) and the
   four-step and transpose kernels alone at their main-path shapes, as
   medians of 10 CUDA-event timed runs after warm-up, then trace one call
   of each transform with torch.profiler (device time by kernel, device
   busy share);
5. free those arrays and run the FFT-convolution paths at real size:
   FFTConvMixer at olmo-1b's width (d_model 2048, rank 16) on a
   (4, 8192, 2048) input through the hopper planner, held against a
   float64 torch.fft convolution and float64 gate and projections, and the
   fused kernel's own entry causally (2x padding) on 8192 rows of 8192,
   held against float64 torch.fft, each with the launch counts of its run;
6. time the mixer and fft_conv (hopper planner, torch planner, a torch.fft
   composition) and the complex-multiply and fused kernels alone at their
   path shapes, then trace one mixer call with torch.profiler;
7. free those arrays and run the paper's shared-memory variants
   (repro_torch.core.variants: every name in VARIANTS, strided, and the
   composed staged_for_loop stages) on a 16384^2 f32 array through the
   hopper planner, each held against float64 torch.fft.rfft2 at
   atol = 2e-4*max|ref| with its kernel launches read around it alone
   (four-step 1; transpose 4 for for_loop, future_sync and the stages, 2
   for future_naive and future_opt, 0 for future_agas and strided), and
   for_loop against repro_torch.rfftn within 1e-6*max|ref|;
8. time them, the card's Fig. 1 and Fig. 2: every variant at 4096^2,
   8192^2 and 16384^2 with its ratio to for_loop, future_naive at 4096^2
   over the reference's task sizes, the four stages at 16384^2 alone
   against for_loop, as medians of CUDA-event timed runs (10, or 3 for the
   chunked variants) after one warm-up run with the wall time beside
   them, then trace for_loop and future_naive (task_size 8) at 4096^2.

The last two lines are the kernel table as one JSON object, then the card
label, then {"ok": true, "device": {...}}. It needs one GPU and exits
non-zero, printing no result, without one.
"""

from __future__ import annotations

import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
FP32_PEAK = 67e12    # H100 SXM float32 FLOP/s outside the tensor cores (published)
HBM_PEAK = 3.35e12   # H100 SXM HBM3 bytes/s (published)
# every radix path of the kernels: 16 (128 x 128), 8, 4, 2 (6 x 10), 3, 5,
# 7, a copy (1) and the generic pass of a prime above 7 (11, 13, 127)
FOUR_STEP_SWEEP = [(8, 8), (16, 16), (16, 32), (32, 64), (128, 128), (8, 128),
                   (128, 8), (25, 40), (125, 8), (7, 3), (4, 9), (128, 1),
                   (11, 13), (127, 1), (1, 127), (6, 10)]
# the arrays whose axes the main path moves: the rfftn 16384^2 spectrum
# before its column pass, and the fftn 512^3 cube
MAIN_SPECTRA = ((16384, 8193), (512, 512, 512))
# complex_multiply (a, b) shapes: same shape, the reference's broadcast, a
# suffix broadcast, an odd one, a small b repeated many times; and elements
# per CTA, some not a multiple of 4
CMUL_CASES = [((3, 40, 56), (3, 40, 56)), ((4, 300), (300,)),
              ((2, 3, 64), (3, 64)), ((5, 1001), (1001,)),
              ((4096, 64), (64,))]
CMUL_BLOCKS = (1, 3, 256, 1024, 4096)
FUSED_FACTORS = [(8, 8), (16, 32), (64, 64), (128, 8), (128, 128), (11, 13),
                 (127, 1), (6, 10)]
FUSED_BLOCK_ROWS = (1, 4, 8)
FUSED_BATCHES = (5, 6)     # the kernel pairs rows: an odd batch pads one
# the FFT-conv mixer at olmo-1b's width (src/repro/configs/olmo_1b.py:
# d_model 2048; fftconv_rank 16 is the ArchConfig default) on 4 x 8192
# tokens: nf = 16384, factors (128, 128)
MIXER_D, MIXER_RANK, MIXER_B, MIXER_S = 2048, 16, 4, 8192
CONV_ROWS, CONV_L = 8192, 8192     # the fused kernel's causal path
# the variants: the 2D size class of the paper's shared-memory study (and
# rfftn's shape above), the card's Fig. 1 sizes, the variants in the
# reference's Fig. 1 order, and its task-size sweep (benchmarks/fig1_variants.py)
VARIANT_N = 16384
VARIANT_SIZES = (4096, 8192, 16384)
VARIANT_ORDER = ("for_loop", "future_sync", "future_opt", "future_naive",
                 "future_agas", "strided")
CHUNKED = ("future_naive", "future_opt")    # host-bound: 3 timed runs
TASK_SIZES, TASK_SWEEP_N = (1, 2, 4, 8, 16, 64, 256), 4096
# transpose kernel launches of one call; the four-step's is 1 for each
# (future_naive and future_opt scatter their rows with torch's copy, agas
# gathers, strided copies its view inside the four-step op)
VARIANT_TRANSPOSES = {"for_loop": 4, "future_sync": 4, "staged": 4,
                      "future_naive": 2, "future_opt": 2, "future_agas": 0,
                      "strided": 0}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def bound(ops, nbytes):
    """(ms, what bounds it): the larger of operations over the FP32 peak and
    bytes over the HBM peak."""
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_PEAK
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def randn(shape, gen, dtype=torch.float32):
    return torch.randn(shape, device="cuda", generator=gen, dtype=dtype)


def four_step_error(x, factors, **modes):
    """(max |kernel - plain|, scale) for one four-step call on the card."""
    from repro_torch.kernels.dft_matmul import fft_four_step, fft_four_step_ref
    k = fft_four_step(x, factors, **modes)
    r = fft_four_step_ref(x, factors, **modes)
    torch.cuda.synchronize()
    scale = r[0].abs().max().item() + 1e-6
    err = max((k[0] - r[0]).abs().max().item(),
              (k[1] - r[1]).abs().max().item())
    return err, scale


def main_move_blocks() -> list:
    """Every (B, n, M) block the main path's moves hand the transpose: each
    axis but the last of MAIN_SPECTRA, moved last and moved back."""
    from repro_torch.core.dfft import move_blocks
    out = []
    for shape in MAIN_SPECTRA:
        for axis in range(len(shape) - 1):
            for block in move_blocks(shape, axis):
                if block not in out:
                    out.append(block)
    return out


def transpose_error(x) -> float:
    """max |kernel - plain| of one transpose on the card; raises unless the
    two are equal."""
    from repro_torch.kernels.transpose import transpose, transpose_ref
    k, r = transpose(x), transpose_ref(x)
    torch.cuda.synchronize()
    check(k.shape == r.shape, f"batched_transpose {tuple(x.shape)} shape")
    err = (k.double() - r.double()).abs().max().item()
    check(err == 0.0 and torch.equal(k, r), f"batched_transpose "
          f"{tuple(x.shape)} {x.dtype} differs from plain by {err}")
    return err


def phase_kernels(gen, main_shapes) -> dict:
    """Every kernel against its plain version; returns the max errors."""
    worst = 0.0           # max err / scale over the sweep (limit 1e-4)
    cases = [((b, f[0] * f[1]), f, {}) for f in FOUR_STEP_SWEEP
             for b in (1, 5, 16)]
    cases += [((4, 1024), (32, 32), dict(karatsuba=k, permuted=p))
              for k in (False, True) for p in (False, True)]
    cases += [((2, 16384), (128, 128), dict(karatsuba=True, permuted=True))]
    cases += [((2, 3, 256), (16, 16), {})]
    cases += [(shape, f, {}) for shape, f in main_shapes.values()]
    main_err = {}
    for shape, factors, modes in cases:
        x = (randn(shape, gen), randn(shape, gen))
        err, scale = four_step_error(x, factors, **modes)
        check(err <= 1e-4 * scale,
              f"four_step_fft {shape} {factors} {modes}: err {err} > "
              f"1e-4 * {scale}")
        worst = max(worst, err / scale)
        for name, (s, f) in main_shapes.items():
            if (shape, factors) == (s, f):
                main_err[name] = err
        del x
    transposed = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.int8,
                  torch.float64):
        for shape in ((3, 40, 56), (96, 160), (8193, 16384)):
            if dtype.is_floating_point:
                x = randn(shape, gen, dtype)
            else:
                x = torch.randint(-100, 100, shape, device="cuda",
                                  generator=gen, dtype=dtype)
            transpose_error(x)
            transposed += 1
            del x
    moves = {}
    for block in main_move_blocks():
        moves[str(block)] = transpose_error(randn(block, gen))
    print(f"checked four_step_fft on {len(cases)} cases (worst err/scale "
          f"{worst:.3e}, limit 1e-4) and batched_transpose on {transposed} "
          f"dtype x shape cases and the main path's f32 blocks {list(moves)} "
          "(exact)")
    return {"four_step_fft": main_err, "four_step_worst_rel": worst,
            "batched_transpose": moves}


def check_two_factor_hopper(planner, n: int) -> None:
    """planner.plan(n, "c2c") must be a two-factor hopper plan, the only
    kind that reaches the kernel."""
    p = planner.plan(n, "c2c")
    check(p.backend == "hopper" and len(p.factors) == 2,
          f"c2c n={n} plan {p} does not reach the four-step kernel")
    print(f"plan c2c n={n}: {p.backend} {p.factors} (estimate, no wisdom)")


def max_err(pair, ref) -> float:
    return max((pair[0].double() - ref.real).abs().max().item(),
               (pair[1].double() - ref.imag).abs().max().item())


def phase_main_path(planner, x, z) -> dict:
    """The public entry points at real size, checked; returns the launch
    counts of this phase alone."""
    import repro_torch
    from repro_torch import kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    spec = repro_torch.rfftn(x, planner=planner)
    back = repro_torch.irfftn(spec, shape=x.shape, planner=planner)
    zf = repro_torch.fftn(z, planner=planner)
    zb = repro_torch.ifftn(zf, planner=planner)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name in ("four_step_fft", "batched_transpose"):
        check(launches[name] > 0, f"the main path never launched {name}")

    ref = torch.fft.rfftn(x.double())
    tol = 2e-4 * ref.abs().max().item()
    err_r = max_err(spec, ref)
    check(err_r <= tol, f"rfftn 16384^2 err {err_r} > {tol}")
    del ref
    x_tol = 2e-4 * x.abs().max().item()
    rt_r = (back - x).abs().max().item()
    check(rt_r <= x_tol, f"irfftn(rfftn) round trip err {rt_r} > {x_tol}")
    ref = torch.fft.fftn(torch.complex(z[0].double(), z[1].double()))
    tol_c = 2e-4 * ref.abs().max().item()
    err_c = max_err(zf, ref)
    check(err_c <= tol_c, f"fftn 512^3 err {err_c} > {tol_c}")
    del ref
    z_tol = 2e-4 * max(z[0].abs().max().item(), z[1].abs().max().item())
    rt_c = max((zb[0] - z[0]).abs().max().item(),
               (zb[1] - z[1]).abs().max().item())
    check(rt_c <= z_tol, f"ifftn(fftn) round trip err {rt_c} > {z_tol}")
    check(tuple(spec[0].shape) == (16384, 8193) and back.shape == x.shape
          and tuple(zf[0].shape) == (512,) * 3, "output shapes")
    check(all(torch.isfinite(t).all().item()
              for t in (*spec, back, *zf, *zb)), "non-finite output")
    print(f"main path: rfftn 16384^2 err {err_r:.4e} (tol {tol:.4e}), "
          f"round trip {rt_r:.3e} (tol {x_tol:.3e}); fftn 512^3 err "
          f"{err_c:.4e} (tol {tol_c:.4e}), round trip {rt_c:.3e} (tol "
          f"{z_tol:.3e}); launches {launches}; {seconds:.3f} s incl. first "
          f"calls; peak {peak / 2 ** 30:.2f} GiB")
    return launches


def phase_times(label, planners, x, z, main_shapes, gen) -> dict:
    import repro_torch
    from repro_torch.calibrate import time_ms
    from repro_torch.kernels.dft_matmul import fft_four_step, fft_four_step_ref
    from repro_torch.kernels.transpose import transpose, transpose_ref
    zc = torch.complex(z[0], z[1])
    rows = [("rfftn 16384^2", lambda p: repro_torch.rfftn(x, planner=p),
             lambda: torch.fft.rfftn(x)),
            ("fftn 512^3", lambda p: repro_torch.fftn(z, planner=p),
             lambda: torch.fft.fftn(zc))]
    for name, run, lib in rows:
        ms = {k: time_ms(lambda p=p: run(p)) for k, p in planners.items()}
        ms["torch.fft"] = time_ms(lib)
        print(f"time {name}: " + ", ".join(f"{k} {v:.3f} ms"
                                           for k, v in ms.items())
              + f" [{label}]")
    del zc

    out = {}
    for name, (shape, f) in main_shapes.items():
        b, n = shape
        xs = (randn(shape, gen), randn(shape, gen))
        xc = torch.complex(xs[0], xs[1])
        ms = time_ms(lambda: fft_four_step(xs, f))
        plain = time_ms(lambda: fft_four_step_ref(xs, f))
        lib = time_ms(lambda: torch.fft.fft(xc))
        # the function is a length-n DFT of each row: 5 n log2(n) float
        # operations and one complex f32 read and write per point
        fft_flops, nbytes = 5.0 * b * n * math.log2(n), 16.0 * b * n
        bound_ms, by = bound(fft_flops, nbytes)
        print(f"time four_step_fft {name} {shape} {f}: kernel {ms:.3f} ms, "
              f"plain {plain:.3f} ms, torch.fft.fft {lib:.3f} ms, bound "
              f"{bound_ms:.3f} ms ({by}, {bound_ms / ms:.1%} of it); "
              f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s, "
              f"{fft_flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s of the FFT's "
              f"operations [{label}]")
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=bound_ms, bound_by=by)
        del xs, xc
    for block in main_move_blocks():
        xt = randn(block, gen)
        ms = time_ms(lambda: transpose(xt))
        plain = time_ms(lambda: transpose_ref(xt))
        nbytes = 2.0 * xt.numel() * xt.element_size()
        bound_ms, by = bound(0.0, nbytes)
        print(f"time batched_transpose {block} f32: kernel {ms:.3f} ms, "
              f"plain = library (x.transpose(-1,-2).contiguous()) "
              f"{plain:.3f} ms, bound {bound_ms:.3f} ms "
              f"({nbytes / (ms * 1e-3) / 1e12:.2f} TB/s) [{label}]")
        if block == (1,) + MAIN_SPECTRA[0]:     # the rfftn column pass's move
            out["transpose"] = dict(ms=ms, plain_ms=plain, library_ms=plain,
                                    bound_ms=bound_ms, bound_by=by)
        del xt
    return out


def phase_profile(label, calls) -> None:
    """One traced run of each (name, call): device time by kernel, and the
    device's busy share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for name, run in calls:
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
        ops = sum(e.count for e in rows)
        print(f"profile {name}: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}), {ops} device "
              f"ops [{label}]")
        for e in rows[:10]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<3d} "
                  f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# the FFT convolution: complex multiply, fused kernel, mixer
# ---------------------------------------------------------------------------


def cmul_error(a, b, block: int = 1024) -> float:
    """max |kernel - plain| of one complex multiply on the card."""
    from repro_torch.kernels.twiddle import (complex_multiply,
                                             complex_multiply_ref)
    k = complex_multiply(a, b, block=block)
    r = complex_multiply_ref(a, b)
    torch.cuda.synchronize()
    check(k[0].shape == r[0].shape == a[0].shape,
          f"complex_multiply {tuple(a[0].shape)} shape")
    return max((k[0] - r[0]).abs().max().item(),
               (k[1] - r[1]).abs().max().item())


def fused_error(x, h, factors, block_rows: int = 8):
    """(max |kernel - plain|, max |plain|) of one fused FFT convolution on
    the card; the plain version runs the kernel's schedule on torch.matmul."""
    from repro_torch.kernels.fftconv import fftconv_fused
    from repro_torch.kernels.fftconv.ref import (fftconv_fused_plain,
                                                 filter_spectrum_plain)
    k = fftconv_fused(x, h, factors, block_rows=block_rows)
    r = fftconv_fused_plain(x, filter_spectrum_plain(h, factors), factors)
    torch.cuda.synchronize()
    check(k.shape == r.shape == x.shape, f"fftconv_fused {factors} shape")
    return (k - r).abs().max().item(), r.abs().max().item()


def decaying_filter(n: int, gen) -> torch.Tensor:
    return randn((n,), gen) * torch.exp(
        -torch.arange(n, device="cuda", dtype=torch.float32) / 64)


def mixer_blocks(nf: int):
    """What fft_conv hands the kernels on the mixer's path: the four-step
    (permuted) gets the padded activations (B, D, nf) and filters (D, nf);
    the transpose gets two views, v (B, L, D), the first half of
    x @ w_in (B, L, 2D), and the cropped output (B, D, L) of (B, D, nf),
    given here as (array shape, cropped shape)."""
    return (((MIXER_B, MIXER_D, nf), (MIXER_D, nf)),
            (((MIXER_B, MIXER_S, 2 * MIXER_D), (MIXER_B, MIXER_S, MIXER_D)),
             ((MIXER_B, MIXER_D, nf), (MIXER_B, MIXER_D, MIXER_S))))


def phase_conv_kernels(gen, factors, errs) -> dict:
    """The complex-multiply and fused kernels against their plain versions,
    and the four-step and transpose at the mixer path's blocks (added to
    ``errs``' entries for them); returns the max errors at the paths'
    shapes."""
    nf = factors[0] * factors[1]
    four_step_blocks, move_sources = mixer_blocks(nf)
    for shape in four_step_blocks:
        x = (randn(shape, gen), randn(shape, gen))
        err, scale = four_step_error(x, factors, permuted=True)
        check(err <= 1e-4 * scale, f"four_step_fft {shape} {factors} "
              f"permuted (fft_conv): err {err} > 1e-4 * {scale}")
        errs["four_step_fft"][f"fft_conv {shape} permuted"] = err
        errs["four_step_worst_rel"] = max(errs["four_step_worst_rel"],
                                          err / scale)
        del x
    for full, crop in move_sources:
        x = randn(full, gen)[tuple(slice(0, c) for c in crop)]
        errs["batched_transpose"][f"fft_conv {crop} view of {full}"] = \
            transpose_error(x)
        del x
    print(f"checked four_step_fft permuted at fft_conv's {four_step_blocks} "
          f"{factors} and batched_transpose (exact) at its moves of "
          f"{[crop for _, crop in move_sources]} (views)")
    cmul_cases = 0
    for a_shape, b_shape in CMUL_CASES:
        a = (randn(a_shape, gen), randn(a_shape, gen))
        b = (randn(b_shape, gen), randn(b_shape, gen))
        for block in CMUL_BLOCKS:
            err = cmul_error(a, b, block)
            check(err <= 1e-5, f"complex_multiply {a_shape} x {b_shape} "
                  f"block {block}: err {err} > 1e-5")
            cmul_cases += 1
    # views 4 bytes past a 16-byte boundary take the kernel's scalar path
    bufs = [randn((4 * 1024 + 1,), gen) for _ in range(4)]
    a = (bufs[0][1:].view(4, 1024), bufs[1][1:].view(4, 1024))
    b = (bufs[2][1:1025], bufs[3][1:1025])
    unaligned = cmul_error(a, b)
    check(unaligned <= 1e-5, f"complex_multiply unaligned: err {unaligned}")
    a = tuple(randn((MIXER_B, MIXER_D, nf), gen) for _ in "ri")
    b = tuple(randn((MIXER_D, nf), gen) for _ in "ri")
    cmul_path = cmul_error(a, b)
    check(cmul_path <= 1e-5, f"complex_multiply at the path's shape: err "
          f"{cmul_path} > 1e-5")
    del a, b

    worst = 0.0
    for f in FUSED_FACTORS:
        n = f[0] * f[1]
        for batch in FUSED_BATCHES:
            x, h = randn((batch, n), gen), decaying_filter(n, gen)
            for block_rows in FUSED_BLOCK_ROWS:
                err, scale = fused_error(x, h, f, block_rows)
                check(err <= 2e-4 * scale, f"fftconv_fused {f} batch {batch} "
                      f"block_rows {block_rows}: err {err} > 2e-4 * {scale}")
                worst = max(worst, err / scale)
    x, h = randn((CONV_ROWS, nf), gen), decaying_filter(nf, gen)
    fused_path, scale = fused_error(x, h, factors)
    check(fused_path <= 2e-4 * scale, f"fftconv_fused ({CONV_ROWS}, {nf}): "
          f"err {fused_path} > 2e-4 * {scale}")
    del x, h
    print(f"checked complex_multiply on {cmul_cases} shape x block cases, "
          f"an unaligned case (err {unaligned:.3e}) and ({MIXER_B}, "
          f"{MIXER_D}, {nf}) x ({MIXER_D}, {nf}) (err {cmul_path:.3e}, "
          f"limit 1e-5); fftconv_fused on {FUSED_FACTORS} x batch "
          f"{FUSED_BATCHES} x block_rows {FUSED_BLOCK_ROWS} (worst "
          f"err/scale {worst:.3e}, limit 2e-4) and "
          f"({CONV_ROWS}, {nf}) {factors} (err {fused_path:.3e}, scale "
          f"{scale:.3e})")
    return {"complex_multiply": cmul_path, "fftconv_fused": fused_path,
            "fftconv_fused_worst_rel": worst}


def causal_conv(u, k) -> torch.Tensor:
    """torch.fft causal convolution of u (B, L, D) with k (D, L): rfft,
    multiply, irfft, in the inputs' precision."""
    length = u.shape[1]
    uf = torch.fft.rfft(u, n=2 * length, dim=1)
    kf = torch.fft.rfft(k, n=2 * length, dim=1).T
    return torch.fft.irfft(uf * kf, n=2 * length, dim=1)[:, :length]


def mixer_parts(mixer, x):
    """v, gate and the filters of one mixer call, as the mixer makes them."""
    from repro_torch.core.fftconv import materialize_filter
    v, gate = (x @ mixer.w_in).chunk(2, dim=-1)
    return v, gate, materialize_filter(mixer.filt, x.shape[1])


def phase_mixer(planner, gen):
    """FFTConvMixer at olmo-1b's width through the hopper planner, checked
    against float64; returns (launch counts of the call, mixer, input)."""
    from repro_torch import kernels
    from repro_torch.core.fftconv import fft_conv, next_fft_len
    from repro_torch.models import FFTConvMixer
    nf = next_fft_len(2 * MIXER_S)
    p = planner.plan(nf, "c2c", permuted=True)
    check(p.backend == "hopper" and p.factors == (128, 128),
          f"fft_conv's plan for nf={nf} is {p}, not hopper (128, 128)")
    print(f"plan c2c permuted n={nf}: {p.backend} {p.factors} (estimate, "
          "no wisdom)")
    mixer = FFTConvMixer(MIXER_D, MIXER_RANK, planner=planner,
                         generator=torch.Generator(
                             device="cuda").manual_seed(SEED))
    x = randn((MIXER_B, MIXER_S, MIXER_D), gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    y = mixer(x)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"four_step_fft": 2, "batched_transpose": 2,
            "complex_multiply": 1, "fftconv_fused": 0}
    check(launches == want, f"mixer launches {launches}, expected {want}")
    check(y.shape == x.shape and torch.isfinite(y).all().item(),
          "mixer output shape or non-finite values")

    v, gate, filt = mixer_parts(mixer, x)
    conv = causal_conv(v.double(), filt.double())
    conv_ours = fft_conv(v, filt, planner=planner)
    conv_tol = 2e-4 * conv.abs().max().item()
    conv_err = (conv_ours.double() - conv).abs().max().item()
    check(conv_err <= conv_tol, f"fft_conv err {conv_err} > {conv_tol}")
    del conv_ours
    ref = ((conv + v.double() * mixer.skip.double())
           * torch.nn.functional.silu(gate.double())) @ mixer.w_out.double()
    del conv, v, gate
    tol = 2e-4 * ref.abs().max().item()
    err = (y.double() - ref).abs().max().item()
    check(err <= tol, f"mixer err {err} > {tol}")
    del ref, y
    print(f"mixer path: FFTConvMixer({MIXER_D}, {MIXER_RANK}) on "
          f"{tuple(x.shape)}: err {err:.4e} (tol {tol:.4e}); fft_conv err "
          f"{conv_err:.4e} (tol {conv_tol:.4e}); launches {launches}; "
          f"{seconds:.3f} s incl. first call; peak {peak / 2 ** 30:.2f} GiB")
    return launches, mixer, x


def phase_fused_path(gen, mixer, factors) -> dict:
    """The fused kernel's own entry, causal through 2x padding, on CONV_ROWS
    rows of CONV_L with one of the mixer's filters; returns its launches."""
    from repro_torch import kernels
    from repro_torch.core.fftconv import materialize_filter
    from repro_torch.kernels.fftconv import fftconv_fused
    h = materialize_filter(mixer.filt[:1], CONV_L)[0]
    x = randn((CONV_ROWS, CONV_L), gen)
    xp = torch.nn.functional.pad(x, (0, CONV_L))
    hp = torch.nn.functional.pad(h, (0, CONV_L))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    y = fftconv_fused(xp, hp, factors)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {"four_step_fft": 1, "batched_transpose": 0,
            "complex_multiply": 0, "fftconv_fused": 1}
    check(launches == want, f"fftconv_fused launches {launches}, "
          f"expected {want}")
    ref = torch.fft.irfft(torch.fft.rfft(x.double(), n=2 * CONV_L)
                          * torch.fft.rfft(h.double(), n=2 * CONV_L),
                          n=2 * CONV_L)[:, :CONV_L]
    tol = 2e-4 * ref.abs().max().item()
    err = (y[:, :CONV_L].double() - ref).abs().max().item()
    check(err <= tol and torch.isfinite(y).all().item(),
          f"causal fftconv_fused err {err} > {tol}")
    print(f"fused path: fftconv_fused causal on ({CONV_ROWS}, {CONV_L}) "
          f"padded to {2 * CONV_L}, factors {factors}: err {err:.4e} (tol "
          f"{tol:.4e}); launches {launches} (the four-step one is the "
          "filter's spectrum)")
    return launches


def phase_conv_times(label, planners, mixer, x, factors, gen) -> dict:
    from repro_torch.calibrate import time_ms
    from repro_torch.core.fftconv import fft_conv
    from repro_torch.kernels.fftconv import fftconv_fused
    from repro_torch.kernels.fftconv.ref import (fftconv_fused_plain,
                                                 filter_spectrum_plain)
    from repro_torch.kernels.twiddle import (complex_multiply,
                                             complex_multiply_ref)
    v, gate, filt = mixer_parts(mixer, x)

    def mixer_lib():
        vv, gg, ff = mixer_parts(mixer, x)
        y = causal_conv(vv, ff) + vv * mixer.skip
        return (y * torch.nn.functional.silu(gg)) @ mixer.w_out

    ms = {}
    for name, p in planners.items():
        mixer.planner = p
        ms[f"mixer {name}"] = time_ms(lambda: mixer(x))
        ms[f"fft_conv {name}"] = time_ms(lambda p=p: fft_conv(v, filt,
                                                              planner=p))
    mixer.planner = planners["hopper"]
    ms["mixer with torch.fft conv"] = time_ms(mixer_lib)
    ms["fft_conv torch.fft (rfft, multiply, irfft)"] = time_ms(
        lambda: causal_conv(v, filt))
    print("time FFT conv at " + str(tuple(x.shape)) + ": " + ", ".join(
        f"{k} {t:.3f} ms" for k, t in ms.items()) + f" [{label}]")
    del v, gate, filt

    out = {}
    b_, d_, nf = MIXER_B, MIXER_D, factors[0] * factors[1]
    a = (randn((b_, d_, nf), gen), randn((b_, d_, nf), gen))
    b = (randn((d_, nf), gen), randn((d_, nf), gen))
    kt = time_ms(lambda: complex_multiply(a, b))
    plain = time_ms(lambda: complex_multiply_ref(a, b))
    ac, bc = torch.complex(*a), torch.complex(*b)
    lib = time_ms(lambda: ac * bc)
    # each input read once, the output written once: a, b and o pairs
    nbytes = 4.0 * (2 * a[0].numel() + 2 * b[0].numel() + 2 * a[0].numel())
    bound_ms, by = bound(6.0 * a[0].numel(), nbytes)
    print(f"time complex_multiply {tuple(a[0].shape)} x {tuple(b[0].shape)}: "
          f"kernel {kt:.3f} ms ({nbytes / (kt * 1e-3) / 1e12:.2f} TB/s), "
          f"plain {plain:.3f} ms, library (complex64 a * b) {lib:.3f} ms, "
          f"bound {bound_ms:.3f} ms ({by}) [{label}]")
    out["complex_multiply"] = dict(ms=kt, plain_ms=plain, library_ms=lib,
                                   bound_ms=bound_ms, bound_by=by)
    del a, b, ac, bc

    xs, h = randn((CONV_ROWS, nf), gen), decaying_filter(nf, gen)
    kt = time_ms(lambda: fftconv_fused(xs, h, factors))
    plain = time_ms(lambda: fftconv_fused_plain(
        xs, filter_spectrum_plain(h, factors), factors))
    comp = time_ms(lambda: torch.fft.irfft(
        torch.fft.rfft(xs) * torch.fft.rfft(h), n=nf))
    # the function: a length-nf FFT and inverse per row and the product,
    # one f32 read and write per point
    fft_flops = (2 * 5.0 * nf * math.log2(nf) + 6.0 * nf) * CONV_ROWS
    nbytes = 8.0 * CONV_ROWS * nf
    bound_ms, by = bound(fft_flops, nbytes)
    print(f"time fftconv_fused ({CONV_ROWS}, {nf}) {factors}: kernel "
          f"{kt:.3f} ms (with the filter spectrum's one-row four-step "
          f"launch), plain {plain:.3f} ms, torch.fft composition (rfft, "
          f"multiply, irfft; no single library call) {comp:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({by}, {bound_ms / kt:.1%} of it); "
          f"{nbytes / (kt * 1e-3) / 1e12:.2f} TB/s, "
          f"{fft_flops / (kt * 1e-3) / 1e12:.2f} TFLOP/s of the FFT's "
          f"operations [{label}]")
    out["fftconv_fused"] = dict(ms=kt, plain_ms=plain, library_ms=None,
                                bound_ms=bound_ms, bound_by=by)
    del xs, h
    return out


# ---------------------------------------------------------------------------
# the paper's shared-memory variants (Figs. 1 and 2)
# ---------------------------------------------------------------------------


def variant_runs(planner) -> list:
    """(name, call on x) of every variant, and of the composed stages."""
    from repro_torch.core import variants

    def staged(x):
        val = x
        for _, stage in variants.staged_for_loop(x, planner):
            val = stage(val)
        return val

    return [(name, lambda x, name=name: variants.run_variant(name, x,
                                                             planner))
            for name in VARIANT_ORDER] + [("staged", staged)]


def phase_variants(planner, gen) -> dict:
    """Every variant at VARIANT_N^2 against float64 torch.fft.rfft2, with
    the launches of each call alone; returns them by name."""
    import repro_torch
    from repro_torch import kernels
    from repro_torch.core.variants import shrink_task_size
    n = VARIANT_N
    mh = n // 2 + 1
    rows, cols = shrink_task_size(n, 8), shrink_task_size(mh, 8)
    print(f"variants at {n}^2, task_size 8: {n // rows} row tasks of {rows} "
          f"rows (future_naive, future_opt), {mh // cols} column tasks of "
          f"{cols} columns (future_opt)")
    x = randn((n, n), gen)
    ref = torch.fft.rfft2(x.double())
    scale = ref.abs().max().item()
    tol = 2e-4 * scale
    spec = repro_torch.rfftn(x, planner=planner)
    out = {}
    for name, run in variant_runs(planner):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        y = run(x)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        want = {"four_step_fft": 1,
                "batched_transpose": VARIANT_TRANSPOSES[name],
                "complex_multiply": 0, "fftconv_fused": 0}
        check(launches == want, f"variant {name} launches {launches}, "
              f"expected {want}")
        check(all(tuple(t.shape) == (n, mh) and t.is_contiguous()
                  and torch.isfinite(t).all().item() for t in y),
              f"variant {name}: output shape, layout or non-finite values")
        err = max_err(y, ref)
        check(err <= tol, f"variant {name} {n}^2 err {err} > {tol}")
        line = f"variant {name} {n}^2: err {err:.4e} (tol {tol:.4e})"
        if name == "for_loop":
            agree = max((y[0] - spec[0]).abs().max().item(),
                        (y[1] - spec[1]).abs().max().item())
            check(agree <= 1e-6 * scale, f"for_loop differs from rfftn by "
                  f"{agree} > 1e-6 * {scale}")
            line += f", from rfftn {agree:.3e} (limit {1e-6 * scale:.3e})"
        print(f"{line}; {seconds:.3f} s, first call")
        out[name] = {k: launches[k] for k in ("four_step_fft",
                                               "batched_transpose")}
        del y
    print("variant launches " + json.dumps(out))
    return out


def time_variant(fn, reps: int):
    """(median CUDA-event ms, median wall ms) of ``reps`` runs of ``fn``
    after one warm-up run; the host waits for each run to end."""
    fn()
    torch.cuda.synchronize()
    device_ms, wall_ms = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
    return statistics.median(device_ms), statistics.median(wall_ms)


def phase_variant_times(label, planner, gen) -> None:
    """The card's Fig. 1 (sizes, task sizes) and Fig. 2 (stages), and the
    profiles of for_loop and future_naive at TASK_SWEEP_N^2."""
    from repro_torch.core import variants
    fig1 = {}
    for n in VARIANT_SIZES:
        x = randn((n, n), gen)
        for name in VARIANT_ORDER:
            reps = 3 if name in CHUNKED else 10
            ms, wall = time_variant(
                lambda: variants.run_variant(name, x, planner), reps)
            fig1[name, n] = ms
            print(f"time variant {name} {n}^2: {ms:.3f} ms (wall {wall:.3f} "
                  f"ms; median of {reps}), {ms / fig1['for_loop', n]:.2f}x "
                  f"for_loop [{label}]")
        del x
    n = TASK_SWEEP_N
    x = randn((n, n), gen)
    for ts in TASK_SIZES:
        ms, wall = time_variant(lambda: variants.run_variant(
            "future_naive", x, planner, task_size=ts), 3)
        tasks = n // variants.shrink_task_size(n, ts)
        print(f"time future_naive {n}^2 task_size {ts} ({tasks} tasks): "
              f"{ms:.3f} ms (wall {wall:.3f} ms), "
              f"{ms / fig1['for_loop', n]:.2f}x for_loop [{label}]")
    phase_profile(label, [
        (f"variant for_loop {n}^2",
         lambda: variants.run_variant("for_loop", x, planner)),
        (f"variant future_naive {n}^2 task_size 8",
         lambda: variants.run_variant("future_naive", x, planner))])
    del x
    n = VARIANT_N
    x = randn((n, n), gen)
    val, total = x, 0.0
    for name, stage in variants.staged_for_loop(x, planner):
        ms, wall = time_variant(lambda: stage(val), 10)
        print(f"time stage {name} {n}^2: {ms:.3f} ms (wall {wall:.3f} ms) "
              f"[{label}]")
        total += ms
        val = stage(val)
    del val
    fused, wall = time_variant(
        lambda: variants.run_variant("for_loop", x, planner), 10)
    print(f"time stages {n}^2: sum {total:.3f} ms, for_loop {fused:.3f} ms "
          f"(wall {wall:.3f} ms), stage_sum_over_fused "
          f"{total / fused:.3f} [{label}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch import Planner
    from repro_torch.calibrate import card_label, measure
    from repro_torch.core.plan import H100
    from repro_torch.kernels import _build

    # phase 1: card, build, TF32 off, calibration
    label = card_label()
    print(label)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in sorted(libs):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cal = measure()
    print(f"calibration: matmul f32 {cal['matmul_f32_flops'] / 1e12:.2f} "
          f"TFLOP/s, copy {cal['copy_bytes_per_s'] / 1e12:.3f} TB/s "
          f"(H100 profile: {H100.flops / 1e12:.2f} TFLOP/s, "
          f"{H100.hbm_bw / 1e12:.3f} TB/s) [{label}]")

    planner = Planner(backends=("hopper",))
    for n in (16384, 512):
        check_two_factor_hopper(planner, n)
    main_shapes = {"rfftn column pass": ((8193, 16384),
                                         planner.plan(16384, "c2c").factors),
                   "fftn 512^3 pass": ((512 * 512, 512),
                                       planner.plan(512, "c2c").factors)}

    # phase 2: kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = phase_kernels(gen, main_shapes)
    conv_factors = planner.plan(2 * MIXER_S, "c2c", permuted=True).factors
    errs.update(phase_conv_kernels(gen, conv_factors, errs))
    print("kernels " + json.dumps(errs))

    # phase 3: the N-D FFT path at real size
    x = randn((16384, 16384), gen)
    z = (randn((512,) * 3, gen), randn((512,) * 3, gen))
    launches = phase_main_path(planner, x, z)

    # phase 4: its times
    planners = {"hopper": planner, "torch": Planner(backends=("torch",))}
    times = phase_times(label, planners, x, z, main_shapes, gen)
    phase_profile(label, [
        ("rfftn 16384^2 hopper",
         lambda: repro_torch.rfftn(x, planner=planner)),
        ("fftn 512^3 hopper", lambda: repro_torch.fftn(z, planner=planner))])
    del x, z
    torch.cuda.empty_cache()

    # phase 5: the FFT-convolution paths at real size, then 6: their times
    with torch.no_grad():
        mixer_launches, mixer, xm = phase_mixer(planner, gen)
        fused_launches = phase_fused_path(gen, mixer, conv_factors)
        times.update(phase_conv_times(label, planners, mixer, xm,
                                      conv_factors, gen))
        phase_profile(label, [(f"FFTConvMixer({MIXER_D}, {MIXER_RANK}) "
                               f"{tuple(xm.shape)} hopper",
                               lambda: mixer(xm))])
    del mixer, xm
    torch.cuda.empty_cache()

    # phase 7: the paper's shared-memory variants at real size, then 8:
    # their times
    t0 = time.perf_counter()
    phase_variants(planner, gen)
    torch.cuda.empty_cache()
    t7 = time.perf_counter()
    phase_variant_times(label, planner, gen)
    torch.cuda.empty_cache()
    print(f"variant phases: 7 took {t7 - t0:.1f} s, 8 took "
          f"{time.perf_counter() - t7:.1f} s")

    head = times["rfftn column pass"]
    table = {"kernels": [
        dict(name="four_step_fft", route="cuda",
             source="src/repro_torch/kernels/dft_matmul/dft_matmul.cu",
             replaces="src/repro/kernels/dft_matmul/dft_matmul.py:76",
             launches=launches["four_step_fft"],
             max_abs_err=max(errs["four_step_fft"].values()),
             **head),
        dict(name="batched_transpose", route="cuda",
             source="src/repro_torch/kernels/transpose/transpose.cu",
             replaces="src/repro/kernels/transpose/transpose.py:27",
             launches=launches["batched_transpose"],
             max_abs_err=max(errs["batched_transpose"].values()),
             **times["transpose"]),
        dict(name="complex_multiply", route="cuda",
             source="src/repro_torch/kernels/twiddle/twiddle.cu",
             replaces="src/repro/kernels/twiddle/twiddle.py:23",
             launches=mixer_launches["complex_multiply"],
             max_abs_err=errs["complex_multiply"],
             **times["complex_multiply"]),
        dict(name="fftconv_fused", route="cuda",
             source="src/repro_torch/kernels/fftconv/fftconv.cu",
             replaces="src/repro/kernels/fftconv/fftconv.py:80",
             launches=fused_launches["fftconv_fused"],
             max_abs_err=errs["fftconv_fused"],
             **times["fftconv_fused"]),
    ]}
    for k in table["kernels"]:
        check(all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms")),
              f"non-finite time for {k['name']}")
    print(json.dumps(table))
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
