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
   them, then trace for_loop and future_naive (task_size 8) at 4096^2;
9. start NCCL at world size 1 on a loopback TCPStore with a (1,) "fft" and
   a (1, 1) ("mx", "my") mesh (repro_torch.make_mesh) and run the
   distributed layer through the hopper planner with forced
   decompositions, each rank's block in and out (distribute, then collect):
   slab r2c 16384^2 (rfftn/irfftn) with comm collective, pipelined:4, agas
   and measure and with the transposed layout, pencil c2c 512^3
   (fftn/ifftn) and factor1d c2c 2^26, each held against float64
   torch.fft at atol = 2e-4*max|ref| and its round trip at 2e-4*max|x|,
   with the launch counts of each run alone (four-step and transpose in
   every run, complex_multiply in factor1d);
10. time each forward (medians of 10 CUDA-event timed runs) beside the
   local plan of the same shape (rfftn 16384^2, fftn 512^3; for 2^26,
   which no local plan takes, torch.fft.fft), timed before and after, the
   NCCL all_to_all_single call of 1 KiB at world size 1, and trace one
   slab call; then destroy the process group;
12. (still at world size 1 on NCCL) run FFTConvMixer(2048, 16) on
   (4, 8192, 2048) with the sequence sharded over the (1,) mesh
   (seq_axis_sharded=True, fft_conv_seq_sharded) with every comm
   (collective, pipelined:4, agas, auto, measure), each call's launches
   read alone (four-step 4, transpose 14, complex multiply 4), held within
   2e-4*max|ref| of the unsharded mixer on the same weights and of a
   float64 torch.fft mixer, and timed (medians of 10) beside the unsharded
   mixer;
13. the deprecated shims: fft2_slab/ifft2_slab r2c 16384^2 with no legacy
   flag, keep_transposed/from_transposed and permuted_cols, and
   fft3_pencil/ifft3_pencil/rfft3_pencil/irfft3_pencil 512^3 on the (1,)
   and (1, 1) meshes, each forward equal to the plan_nd path on the same
   block (its legacy layout undone), within 2e-4*max|ref| of float64
   torch.fft, its round trip within 2e-4*max|x|, with the launches of
   shim forward and back equal to those of the plan_nd path's;
14. compressed_psum on a payload of the mixer's parameters at olmo-1b
   width (12,617,728 f32) with every gather backend, auto and measure:
   at world size 1 the sum is exactly this rank's dequantized payload and
   the residual what quantization lost; timed (medians of 10); then the
   process group is destroyed;
11. spawn 4 ranks on the one card over gloo (which takes CUDA tensors;
   NCCL refuses two ranks on one GPU) and hold slab r2c 16384^2 on a (4,)
   mesh and pencil c2c 512^3 on a (2, 2) mesh, forward and back, against
   float64 torch.fft in the same way; then, on the same ranks, phases 12-14
   over them: the sharded mixer on (4,) against the unsharded mixer and
   float64 on rank 0, the shims on (4,) and (2, 2) against the gathered
   plan_nd path and float64, and compressed_psum (each rank its own
   payload) against the sum of the dequantized payloads and the exact
   sum; every rank ends and is joined.

Phase 2 also holds the four-step, transpose and complex-multiply kernels
at the blocks the sharded convolution hands them; phase 4 prints the
H100 profile's estimate of the four-step pass beside its time and fails
beyond 1.5x; phase 10 prints plan_nd's estimate-mode and measured-mode
verdicts at the chip shapes. The last lines are the kernel table as one
JSON object, then the card label, then {"ok": true, "device": {...}}. It
needs one GPU and exits non-zero, printing no result, without one.
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
# the distributed layer at world size 1: slab r2c 16384^2 (rfftn's shape)
# over each exchange setting and the transposed layout, pencil c2c 512^3
# (fftn's), factor1d c2c 2^26 (a length no local plan takes)
DIST_SLAB_N, DIST_PENCIL_N, DIST_FACTOR1D_LOG2 = 16384, 512, 26
DIST_SLAB_COMMS = ("collective", "pipelined:4", "agas", "measure")
GLOO_RANKS = 4       # phase 11: ranks on the one card, over gloo
# kernel launches of one forward and inverse of each decomposition, on every
# rank at any p: slab and pencil those of the local rfftn + irfftn and fftn +
# ifftn (no exchange move runs a kernel), factor1d two four-step passes
# forward, six moves each way and one twiddle product each way
DIST_LAUNCHES = {
    "slab": {"four_step_fft": 1, "batched_transpose": 8,
             "complex_multiply": 0, "fftconv_fused": 0},
    "pencil": {"four_step_fft": 3, "batched_transpose": 16,
               "complex_multiply": 0, "fftconv_fused": 0},
    "factor1d": {"four_step_fft": 2, "batched_transpose": 12,
                 "complex_multiply": 2, "fftconv_fused": 0}}
# phase 12: the mixer with its sequence sharded, each exchange setting,
# and the kernel launches of one call at any p: the c2c passes along n1
# and n2 of the activations and of the filters on the four-step kernel;
# the (B, L, D) -> (B, D, L) move and back and, for each n1 pass (the two
# forward ones and the inverse, on torch.matmul), two moves a pair member
# on the transpose kernel; the twiddle of each forward and of the inverse
# and the spectrum product on the complex multiply
SHARDED_COMMS = ("collective", "pipelined:4", "agas", "auto", "measure")
SHARDED_LAUNCHES = {"four_step_fft": 4, "batched_transpose": 14,
                    "complex_multiply": 4, "fftconv_fused": 0}
# phase 14: a payload the size of the mixer's parameters at olmo-1b width
# (w_in, w_out, filt, skip)
PSUM_N = MIXER_D * 2 * MIXER_D + MIXER_D * MIXER_D + MIXER_D * MIXER_RANK \
    + MIXER_D
PSUM_COMMS = ("collective", "pipelined:4", "agas", "auto", "measure")
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
        # the H100 profile prices the pass as its radix bound over fft_share
        est = planners["hopper"].stage_seconds(n, "c2c", b) * 1e3
        print(f"estimate four_step_fft {name} {shape}: {est:.3f} ms, "
              f"{est / ms:.2f}x the kernel's time [{label}]")
        if name == "rfftn column pass":
            check(1 / 1.5 <= est / ms <= 1.5, f"the estimate of the "
                  f"{name}, {est:.3f} ms, is not within 1.5x of {ms:.3f} ms")
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


def sharded_conv_blocks(planner):
    """What fft_conv_seq_sharded hands the kernels on the mixer's path at
    world size 1 (nf = 16384 split n1 x n2): the four-step gets the n1
    pass (moved last) and the n2 pass of the activations, (B, D, n2, n1)
    and (B, D, n1, n2), and of the filters, (D, n2, n1) and (D, n1, n2),
    with the planner's factors of n1 and of n2; the complex multiply gets
    the (n1, n2) twiddle against each (the spectrum product is
    fft_conv's); the transpose the n1 moves of each and back."""
    from repro_torch.core.fftconv import factor_split, next_fft_len
    n1, n2 = factor_split(next_fft_len(2 * MIXER_S), 1)
    f1 = planner.plan(n1, "c2c").factors
    f2 = planner.plan(n2, "c2c").factors
    leads = ((MIXER_B, MIXER_D), (MIXER_D,))
    four = [(lead + (n2, n1), f1) for lead in leads] \
        + [(lead + (n1, n2), f2) for lead in leads]
    cmul = [(lead + (n1, n2), (n1, n2)) for lead in leads]
    moves = [(math.prod(lead), a, b) for lead in leads
             for a, b in ((n1, n2), (n2, n1))]
    return four, cmul, moves


def phase_sharded_conv_kernels(gen, planner, errs) -> None:
    """The four-step, complex-multiply and transpose kernels against their
    plain versions at the blocks of the sharded mixer's path, added to
    ``errs``' entries for them."""
    four, cmul, moves = sharded_conv_blocks(planner)
    for shape, f in four:
        x = (randn(shape, gen), randn(shape, gen))
        err, scale = four_step_error(x, f)
        check(err <= 1e-4 * scale, f"four_step_fft {shape} {f} (sharded "
              f"conv): err {err} > 1e-4 * {scale}")
        errs["four_step_fft"][f"sharded conv {shape} {f}"] = err
        errs["four_step_worst_rel"] = max(errs["four_step_worst_rel"],
                                          err / scale)
        del x
    for a_shape, b_shape in cmul:
        a = (randn(a_shape, gen), randn(a_shape, gen))
        b = (randn(b_shape, gen), randn(b_shape, gen))
        err = cmul_error(a, b)
        check(err <= 1e-5, f"complex_multiply {a_shape} x {b_shape} "
              f"(sharded conv): err {err} > 1e-5")
        errs["complex_multiply"] = max(errs["complex_multiply"], err)
        del a, b
    for block in moves:
        errs["batched_transpose"][f"sharded conv {block}"] = \
            transpose_error(randn(block, gen))
    print(f"checked four_step_fft at the sharded conv's {four}, "
          f"complex_multiply at its twiddles {cmul} (limit 1e-5) and "
          f"batched_transpose (exact) at its moves {moves}")


def mixer_reference(mixer, x) -> torch.Tensor:
    """The mixer's output in float64, its convolution by torch.fft."""
    v, gate, filt = mixer_parts(mixer, x)
    conv = causal_conv(v.double(), filt.double())
    return ((conv + v.double() * mixer.skip.double())
            * torch.nn.functional.silu(gate.double())) @ mixer.w_out.double()


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


# ---------------------------------------------------------------------------
# the distributed layer on NCCL at world size 1 (phases 9 and 10)
# ---------------------------------------------------------------------------


def start_nccl():
    """NCCL at world size 1 on a loopback TCPStore (an OS-chosen port), and
    the port's (1,) "fft" and (1, 1) ("mx", "my") meshes on the card."""
    import datetime
    import torch.distributed as dist
    from repro_torch import make_mesh
    timeout = datetime.timedelta(seconds=120)
    store = dist.TCPStore("127.0.0.1", 0, 1, True, timeout=timeout)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=timeout)
    return (make_mesh((1,), ("fft",), timeout=timeout),
            make_mesh((1, 1), ("mx", "my"), timeout=timeout), store)


def dist_runs(planner, m1, m11) -> list:
    """(name, plan, mesh) of every run of phases 9 and 10: forced
    decompositions through the hopper planner."""
    from repro_torch import plan_nd
    s = (DIST_SLAB_N,) * 2
    runs = [(f"slab r2c {DIST_SLAB_N}^2 comm={c}",
             plan_nd(s, "r2c", mesh=m1, decomp="slab", comm=c,
                     planner=planner), m1) for c in DIST_SLAB_COMMS]
    runs.append((f"slab r2c {DIST_SLAB_N}^2 transposed",
                 plan_nd(s, "r2c", mesh=m1, decomp="slab",
                         output_layout="transposed", planner=planner), m1))
    runs.append((f"pencil c2c {DIST_PENCIL_N}^3",
                 plan_nd((DIST_PENCIL_N,) * 3, "c2c", mesh=m11,
                         decomp="pencil", planner=planner), m11))
    runs.append((f"factor1d c2c 2^{DIST_FACTOR1D_LOG2}",
                 plan_nd((1 << DIST_FACTOR1D_LOG2,), "c2c", mesh=m1,
                         decomp="factor1d", planner=planner), m1))
    return runs


def dist_input(decomp: str, gen):
    """The full input of a decomposition's run (the same on every rank)."""
    if decomp == "slab":
        return randn((DIST_SLAB_N,) * 2, gen)
    shape = (DIST_PENCIL_N,) * 3 if decomp == "pencil" \
        else (1 << DIST_FACTOR1D_LOG2,)
    return randn(shape, gen), randn(shape, gen)


def dist_reference(nd, data):
    """float64 torch.fft of the whole input."""
    if nd.kind == "r2c":
        return torch.fft.rfftn(data.double())
    zc = torch.complex(data[0].double(), data[1].double())
    return torch.fft.fftn(zc)


def phase_distributed(planner, gen, m1, m11) -> dict:
    """Every distributed run forward and back through the public entry
    points on this rank's block, collected and held against float64
    torch.fft; returns the launch counts of each run alone."""
    from repro_torch import (collect, distribute, fftn, ifftn, irfftn,
                             kernels, rfftn)
    out, inputs, refs = {}, {}, {}
    for name, nd, mesh in dist_runs(planner, m1, m11):
        if nd.decomp not in inputs:
            inputs.clear()
            refs.clear()
            torch.cuda.empty_cache()
            inputs[nd.decomp] = dist_input(nd.decomp, gen)
            refs[nd.decomp] = dist_reference(nd, inputs[nd.decomp])
        data, ref = inputs[nd.decomp], refs[nd.decomp]
        local = distribute(data, nd, mesh)
        forward, inverse = (rfftn, irfftn) if nd.kind == "r2c" \
            else (fftn, ifftn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        spec = forward(local, mesh=mesh, plan=nd, planner=planner)
        back = inverse(spec, mesh=mesh, plan=nd, planner=planner)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        want = DIST_LAUNCHES[nd.decomp]
        check(launches == want, f"{name}: launches {launches}, expected "
              f"{want}")
        full = collect(spec, nd, mesh)
        check(tuple(full[0].shape) == tuple(ref.shape), f"{name}: shape "
              f"{tuple(full[0].shape)}, want {tuple(ref.shape)}")
        tol = 2e-4 * ref.abs().max().item()
        err = max_err(full, ref)
        check(err <= tol, f"{name}: err {err} > {tol}")
        back = collect(back, nd, mesh, spatial=True)
        if nd.kind == "r2c":
            scale = data.abs().max().item()
            rt = (back - data).abs().max().item()
        else:
            scale = max(d.abs().max().item() for d in data)
            rt = max((b - d).abs().max().item() for b, d in zip(back, data))
        check(rt <= 2e-4 * scale, f"{name}: round trip err {rt} > "
              f"{2e-4 * scale}")
        check(all(torch.isfinite(t).all().item() for t in full),
              f"{name}: non-finite output")
        print(f"dist {name}: comm {nd.comm}, err {err:.4e} (tol {tol:.4e}), "
              f"round trip {rt:.3e} (tol {2e-4 * scale:.3e}); launches "
              f"{launches}; {seconds:.3f} s incl. first calls; peak "
              f"{peak / 2 ** 30:.2f} GiB")
        out[name] = launches
        del local, spec, back, full
    del refs, inputs
    torch.cuda.empty_cache()
    print("dist launches " + json.dumps(out))
    return out


def phase_distributed_times(label, planner, gen, m1, m11) -> dict:
    """Medians of 10 CUDA-event timed forward calls of every distributed
    run beside the local plan of the same shape (before and after them),
    the NCCL call cost at world size 1, and one traced slab call."""
    import repro_torch
    from repro_torch import distribute, fftn, rfftn
    from repro_torch.calibrate import collective_latency
    from repro_torch.core import dfft
    inputs = {d: dist_input(d, gen) for d in ("slab", "pencil", "factor1d")}
    x, z = inputs["slab"], inputs["pencil"]
    zc = torch.complex(*inputs["factor1d"])
    local_runs = {
        "slab": ("local rfftn", lambda: rfftn(x, planner=planner)),
        "pencil": ("local fftn", lambda: fftn(z, planner=planner)),
        "factor1d": ("torch.fft.fft (no local plan: the planner splits n "
                     "into at most three factors of at most 128)",
                     lambda: torch.fft.fft(zc))}
    times, base = {}, {}
    runs = dist_runs(planner, m1, m11)
    for name, nd, mesh in runs:
        if nd.decomp not in base:
            what, fn = local_runs[nd.decomp]
            base[nd.decomp] = [time_variant(fn, 10)[0]]
            print(f"time dist baseline {nd.decomp} {what}: "
                  f"{base[nd.decomp][0]:.3f} ms [{label}]")
        local = distribute(inputs[nd.decomp], nd, mesh)
        forward = rfftn if nd.kind == "r2c" else fftn
        ms, wall = time_variant(lambda: forward(local, mesh=mesh, plan=nd,
                                                planner=planner), 10)
        times[name] = ms
        print(f"time dist {name}: {ms:.3f} ms (wall {wall:.3f} ms), "
              f"{ms - base[nd.decomp][0]:+.3f} ms over the baseline "
              f"[{label}]")
        del local
    for decomp, (what, fn) in local_runs.items():
        again = time_variant(fn, 10)[0]
        base[decomp].append(again)
        print(f"time dist baseline {decomp} again: {again:.3f} ms [{label}]")
    dev = torch.device("cuda", torch.cuda.current_device())
    lat_runs = [collective_latency(dev) for _ in range(5)]
    lat = statistics.median(lat_runs)
    print(f"time nccl all_to_all_single 1 KiB world size 1: "
          f"{lat * 1e6:.2f} us a call (median of 5 runs of 200: "
          f"{', '.join(f'{r * 1e6:.2f}' for r in lat_runs)} us) [{label}]")
    # the factor1d twiddle: one block built alone, and the forward call with
    # both built anew in every call (as before they were cached)
    twiddle = dfft._factor1d_twiddle_block
    f_name, f_nd, f_mesh = runs[-1]
    n1, n2 = f_nd.factors
    tw_ms = time_variant(lambda: twiddle.__wrapped__(
        n1, n2, 0, 1, -1, chunk_axis=1, device=dev), 10)[0]
    f_local = distribute(inputs["factor1d"], f_nd, f_mesh)

    def factor1d_uncached():
        twiddle.cache_clear()
        fftn(f_local, mesh=f_mesh, plan=f_nd, planner=planner)

    uncached = time_variant(factor1d_uncached, 10)[0]
    print(f"time dist factor1d twiddle block ({n1}, {n2}) alone: "
          f"{tw_ms:.3f} ms; {f_name} with the twiddle built in every call: "
          f"{uncached:.3f} ms, cached {times[f_name]:.3f} ms [{label}]")
    name, nd, mesh = runs[0]
    local = distribute(x, nd, mesh)
    phase_profile(label, [
        (f"dist {name}", lambda: repro_torch.rfftn(
            local, mesh=mesh, plan=nd, planner=planner)),
        (f"dist {f_name}", lambda: fftn(f_local, mesh=f_mesh, plan=f_nd,
                                        planner=planner))])
    del inputs, x, z, zc, local, f_local
    twiddle.cache_clear()
    torch.cuda.empty_cache()
    return {"times": times, "baselines": base, "nccl_call_s": lat,
            "twiddle_ms": tw_ms, "factor1d_uncached_ms": uncached}


def plan_verdicts(planner, m1, m11) -> None:
    """plan_nd's free verdicts at the chip shapes on the one card, in
    estimate and in measured mode; raises where they differ."""
    from repro_torch import plan_nd
    for shape, kind, mesh in (((DIST_SLAB_N,) * 2, "r2c", m1),
                              ((DIST_PENCIL_N,) * 3, "c2c", m11),
                              ((1 << DIST_FACTOR1D_LOG2,), "c2c", m1)):
        got = {mode: plan_nd(shape, kind, mesh=mesh, mode=mode,
                             planner=planner)
               for mode in ("estimate", "measured")}
        verdicts = {mode: (nd.decomp, nd.mesh_axes, nd.comm)
                    for mode, nd in got.items()}
        check(verdicts["estimate"] == verdicts["measured"],
              f"plan_nd {shape} {kind}: {verdicts}")
        print(f"plan_nd {shape} {kind} on {mesh.mesh_dim_names}: estimate "
              f"{verdicts['estimate']} ({got['estimate'].est_cost * 1e3:.3f}"
              f" ms est), measured {verdicts['measured']}")


def counted(fn):
    """(fn's value, kernel launches of the call alone, its seconds)."""
    from repro_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    val = fn()
    torch.cuda.synchronize()
    return val, kernels.launch_counts(), time.perf_counter() - t0


def phase_sharded_mixer(label, planner, gen, m1) -> dict:
    """FFTConvMixer at olmo-1b's width with the sequence sharded over the
    (1,) mesh, every exchange setting, against the unsharded mixer and
    float64, then timed beside the unsharded mixer."""
    from repro_torch.models import FFTConvMixer
    mixer = FFTConvMixer(MIXER_D, MIXER_RANK, planner=planner,
                         generator=torch.Generator(
                             device="cuda").manual_seed(SEED),
                         mesh=m1, axis="fft")
    x = randn((MIXER_B, MIXER_S, MIXER_D), gen)
    out = {}
    with torch.no_grad():
        local = mixer(x)
        ref = mixer_reference(mixer, x)
        tol_l = 2e-4 * local.abs().max().item()
        tol_r = 2e-4 * ref.abs().max().item()
        for comm in SHARDED_COMMS:
            mixer.comm = comm
            torch.cuda.reset_peak_memory_stats()
            y, launches, seconds = counted(
                lambda: mixer(x, seq_axis_sharded=True))
            peak = torch.cuda.max_memory_allocated()
            check(launches == SHARDED_LAUNCHES, f"sharded mixer {comm}: "
                  f"launches {launches}, expected {SHARDED_LAUNCHES}")
            err_l = (y - local).abs().max().item()
            err_r = (y.double() - ref).abs().max().item()
            check(err_l <= tol_l and err_r <= tol_r
                  and torch.isfinite(y).all().item(),
                  f"sharded mixer {comm}: err {err_l} (tol {tol_l}) against "
                  f"the unsharded mixer, {err_r} (tol {tol_r}) against "
                  "float64")
            print(f"sharded mixer FFTConvMixer({MIXER_D}, {MIXER_RANK}) "
                  f"{tuple(x.shape)} on (1,) comm={comm}: err {err_l:.4e} "
                  f"against the unsharded mixer (tol {tol_l:.4e}), "
                  f"{err_r:.4e} against float64 (tol {tol_r:.4e}); "
                  f"launches {launches}; {seconds:.3f} s incl. first call; "
                  f"peak {peak / 2 ** 30:.2f} GiB")
            out[comm] = launches
            del y
        del ref
        times = {"unsharded": time_variant(lambda: mixer(x), 10)[0]}
        for comm in SHARDED_COMMS:
            mixer.comm = comm
            times[comm] = time_variant(
                lambda: mixer(x, seq_axis_sharded=True), 10)[0]
        times["unsharded again"] = time_variant(lambda: mixer(x), 10)[0]
        print(f"time sharded mixer {tuple(x.shape)} on (1,): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in times.items()) + f" [{label}]")
        mixer.comm = "collective"
        phase_profile(label, [("sharded mixer on (1,) collective",
                               lambda: mixer(x, seq_axis_sharded=True))])
    del mixer, x, local
    torch.cuda.empty_cache()
    return {"launches": out, "times": times}


def fwd_back(forward, inverse):
    spec = forward()
    return spec, inverse(spec)


def phase_shims(label, planner, gen, m1, m11) -> dict:
    """The six deprecated shims at the chip shapes on the one card: each
    forward equal to the plan_nd path on the same block, within
    2e-4*max|ref| of float64 torch.fft, its round trip within 2e-4*max|x|,
    and the launches of shim forward and back those of the plan_nd
    path's."""
    import warnings
    from repro_torch import fftn, ifftn, irfftn, plan_nd, rfftn
    from repro_torch.core import dfft
    out = {}

    def report(name, same, err, tol, rt, x_tol, launches, base, seconds,
               exact=True):
        check(launches == base, f"{name}: launches {launches}, the plan_nd "
              f"path's {base}")
        check(same == 0.0 if exact else same <= tol, f"{name}: differs "
              f"from the plan_nd path by {same}")
        check(err <= tol, f"{name}: err {err} > {tol}")
        check(rt <= x_tol, f"{name}: round trip err {rt} > {x_tol}")
        print(f"shim {name}: err {err:.4e} (tol {tol:.4e}), from the "
              f"plan_nd path {same:.3e}, round trip {rt:.3e} (tol "
              f"{x_tol:.3e}); launches {launches}; {seconds:.3f} s forward "
              f"and back [{label}]")
        out[name] = launches

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        n = DIST_SLAB_N
        x = randn((n, n), gen)
        nd = plan_nd(x.shape, "r2c", mesh=m1, decomp="slab",
                     comm="collective", planner=planner)
        (want, _), base, _ = counted(lambda: fwd_back(
            lambda: rfftn(x, mesh=m1, plan=nd, planner=planner),
            lambda c: irfftn(c, mesh=m1, plan=nd, planner=planner)))
        ref = torch.fft.rfft2(x.double())
        tol, x_tol = 2e-4 * ref.abs().max().item(), \
            2e-4 * x.abs().max().item()
        # row k1*n2 + k2 of permuted columns holds frequency k2*n1 + k1
        n1, n2 = planner.plan(n, "c2c", permuted=True).factors
        perm = torch.arange(n, device="cuda").view(n2, n1).T.reshape(-1)
        for flags in ({}, {"keep_transposed": True},
                      {"permuted_cols": True}):
            kt = flags.get("keep_transposed", False)
            pc = flags.get("permuted_cols", False)
            (spec, back), launches, seconds = counted(lambda: fwd_back(
                lambda: dfft.fft2_slab(x, m1, "fft", planner, **flags),
                lambda c: dfft.ifft2_slab(c, m1, "fft", n, planner,
                                          from_transposed=kt,
                                          permuted_cols=pc)))
            got = tuple(t.T for t in spec) if kt else spec
            expect = tuple(t[perm] for t in want) if pc else want
            same = max((a - b).abs().max().item()
                       for a, b in zip(got, expect))
            err = max_err(got, ref[perm] if pc else ref)
            rt = (back - x).abs().max().item()
            report(f"fft2_slab/ifft2_slab r2c {n}^2 on (1,) "
                   f"{','.join(flags) or 'no flag'}", same, err, tol, rt,
                   x_tol, launches, base, seconds, exact=not pc)
            del spec, back, got, expect
        del x, want, ref
        torch.cuda.empty_cache()

        shape, axes = (DIST_PENCIL_N,) * 3, ("mx", "my")
        z = dist_input("pencil", gen)
        ndc = plan_nd(shape, "c2c", mesh=m11, decomp="pencil",
                      comm="collective", planner=planner)
        (want, _), base, _ = counted(lambda: fwd_back(
            lambda: fftn(z, mesh=m11, plan=ndc, planner=planner),
            lambda c: ifftn(c, mesh=m11, plan=ndc, planner=planner)))
        (spec, back), launches, seconds = counted(lambda: fwd_back(
            lambda: dfft.fft3_pencil(z, m11, axes, planner),
            lambda c: dfft.ifft3_pencil(c, m11, axes, planner)))
        ref = torch.fft.fftn(torch.complex(z[0].double(), z[1].double()))
        report(f"fft3_pencil/ifft3_pencil c2c {DIST_PENCIL_N}^3 on (1, 1)",
               max((a - b).abs().max().item() for a, b in zip(spec, want)),
               max_err(spec, ref), 2e-4 * ref.abs().max().item(),
               max((b - a).abs().max().item() for a, b in zip(z, back)),
               2e-4 * max(a.abs().max().item() for a in z), launches, base,
               seconds)
        del z, want, spec, back, ref
        xr = randn(shape, gen)
        ndr = plan_nd(shape, "r2c", mesh=m11, decomp="pencil",
                      comm="collective", planner=planner)
        (want, _), base, _ = counted(lambda: fwd_back(
            lambda: rfftn(xr, mesh=m11, plan=ndr, planner=planner),
            lambda c: irfftn(c, mesh=m11, plan=ndr, planner=planner)))
        (spec, back), launches, seconds = counted(lambda: fwd_back(
            lambda: dfft.rfft3_pencil(xr, m11, axes, planner),
            lambda c: dfft.irfft3_pencil(c, m11, axes, DIST_PENCIL_N,
                                         planner)))
        ref = torch.fft.rfftn(xr.double())
        report(f"rfft3_pencil/irfft3_pencil r2c {DIST_PENCIL_N}^3 on (1, 1)",
               max((a - b).abs().max().item() for a, b in zip(spec, want)),
               max_err(spec, ref), 2e-4 * ref.abs().max().item(),
               (back - xr).abs().max().item(), 2e-4 * xr.abs().max().item(),
               launches, base, seconds)
        del xr, want, spec, back, ref
    torch.cuda.empty_cache()
    return out


def phase_psum(label, gen, m1) -> dict:
    """compressed_psum of a PSUM_N payload on the (1,) mesh, every gather
    backend, auto and measure: the sum is this rank's dequantized payload
    and the residual what quantization lost, exactly; then timed."""
    from repro_torch.optim import (choose_psum_comm, compressed_psum,
                                   dequantize_int8, quantize_int8)
    group = m1.get_group("fft")
    x = randn((PSUM_N,), gen)
    q, scale, pad = quantize_int8(x)
    deq = dequantize_int8(q, scale, pad, x.shape)
    out = {}
    for comm in PSUM_COMMS:
        spec = choose_psum_comm(m1, "fft", x.shape, mode=comm)
        total, err = compressed_psum(x, group, comm=spec)
        check(torch.equal(total, deq) and torch.equal(err, x - deq),
              f"compressed_psum {comm}: not the dequantized payload")
        ms = time_variant(lambda: compressed_psum(x, group, comm=spec),
                          10)[0]
        out[comm] = dict(spec=spec, ms=ms)
        print(f"psum compressed_psum {PSUM_N} f32 on (1,) comm={comm} -> "
              f"{spec}: the dequantized payload exactly (quantization "
              f"error {err.abs().max().item():.4e}, half step "
              f"{scale.float().max().item() / 2:.4e}); {ms:.3f} ms (median "
              f"of 10) [{label}]")
    del x, q, scale, deq
    return out


def gather_blocks(t, mesh, axes):
    """Every rank's block of ``t`` concatenated along each (tensor axis,
    mesh axis name) of ``axes`` in turn; every rank of the mesh calls it."""
    from repro_torch.core import comm
    for axis, name in axes:
        work, buf = comm._gather_start(t, mesh.get_group(name),
                                       comm.mesh_sizes(mesh)[name])
        work.wait()
        t = comm._unlead(buf, axis)
    return t


def gloo_sharded_mixer(rank, mesh, planner, gen) -> list:
    """Phase 12 over the gloo ranks: the mixer with its sequence sharded
    over (4,), each rank its block; rank 0 holds the gathered output
    against the unsharded mixer and float64. Returns rank 0's lines."""
    from repro_torch.models import FFTConvMixer
    mixer = FFTConvMixer(MIXER_D, MIXER_RANK, planner=planner,
                         generator=torch.Generator(
                             device="cuda").manual_seed(SEED),
                         mesh=mesh, axis="fft")
    x = randn((MIXER_B, MIXER_S, MIXER_D), gen)     # the same on every rank
    w = MIXER_S // GLOO_RANKS
    block = x[:, rank * w:(rank + 1) * w].contiguous()
    with torch.no_grad():
        y, launches, seconds = counted(
            lambda: mixer(block, seq_axis_sharded=True))
        check(launches == SHARDED_LAUNCHES, f"gloo rank {rank} sharded "
              f"mixer: launches {launches}, expected {SHARDED_LAUNCHES}")
        ms = time_variant(lambda: mixer(block, seq_axis_sharded=True), 3)[0]
        full = gather_blocks(y, mesh, [(1, "fft")])
        if rank != 0:
            return []
        local = mixer(x)
        ref = mixer_reference(mixer, x)
    tol_l = 2e-4 * local.abs().max().item()
    tol_r = 2e-4 * ref.abs().max().item()
    err_l = (full - local).abs().max().item()
    err_r = (full.double() - ref).abs().max().item()
    check(err_l <= tol_l and err_r <= tol_r, f"gloo sharded mixer: err "
          f"{err_l} (tol {tol_l}) against the unsharded mixer, {err_r} (tol "
          f"{tol_r}) against float64")
    return [f"gloo{GLOO_RANKS} sharded mixer FFTConvMixer({MIXER_D}, "
            f"{MIXER_RANK}) {tuple(x.shape)} on (4,) (block "
            f"{tuple(block.shape)} a rank): err {err_l:.4e} against the "
            f"unsharded mixer (tol {tol_l:.4e}), {err_r:.4e} against float64 "
            f"(tol {tol_r:.4e}); rank 0 launches {launches}; {seconds:.3f} s "
            f"first call, {ms:.3f} ms (median of 3)"]


def gloo_shims(rank, meshes, planner, gen) -> list:
    """Phase 13 over the gloo ranks: fft2_slab/ifft2_slab r2c 16384^2 on
    (4,) with each legacy flag and the pencil shims 512^3 on (2, 2), each
    rank its block; rank 0 holds the gathered forward against the gathered
    plan_nd path and float64, and the gathered round trip against the
    input. Returns rank 0's lines."""
    import warnings
    from repro_torch import collect, distribute, fftn, plan_nd, rfftn
    from repro_torch.core import dfft
    m4, m22 = meshes["(4,)"], meshes["(2, 2)"]
    lines = []

    def report(name, got, want, ref, back, data):
        tol = 2e-4 * ref.abs().max().item()
        pair = isinstance(data, tuple)
        x_tol = 2e-4 * (max(a.abs().max().item() for a in data) if pair
                        else data.abs().max().item())
        same = max((a - b).abs().max().item() for a, b in zip(got, want))
        err = max_err(got, ref)
        rt = (max((a - b).abs().max().item() for a, b in zip(back, data))
              if pair else (back - data).abs().max().item())
        check(same <= tol and err <= tol and rt <= x_tol, f"gloo shim "
              f"{name}: from the plan_nd path {same}, err {err} (tol {tol}),"
              f" round trip {rt} (tol {x_tol})")
        lines.append(f"gloo{GLOO_RANKS} shim {name}: err {err:.4e} (tol "
                     f"{tol:.4e}), from the plan_nd path {same:.3e}, round "
                     f"trip {rt:.3e} (tol {x_tol:.3e})")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        n = DIST_SLAB_N
        x = randn((n, n), gen)                      # the same on every rank
        nd = plan_nd(x.shape, "r2c", mesh=m4, decomp="slab",
                     comm="collective", planner=planner)
        local = distribute(x, nd, m4)
        want = collect(rfftn(local, mesh=m4, plan=nd, planner=planner), nd,
                       m4)
        n1, n2 = planner.plan(n, "c2c", permuted=True).factors
        perm = torch.arange(n, device="cuda").view(n2, n1).T.reshape(-1)
        ref = torch.fft.rfft2(x.double()) if rank == 0 else None
        for flags in ({}, {"keep_transposed": True},
                      {"permuted_cols": True}):
            kt = flags.get("keep_transposed", False)
            pc = flags.get("permuted_cols", False)
            spec = dfft.fft2_slab(local, m4, "fft", planner, **flags)
            back = dfft.ifft2_slab(spec, m4, "fft", n, planner,
                                   from_transposed=kt, permuted_cols=pc)
            got = tuple(gather_blocks(t, m4, [(1 if kt else 0, "fft")])
                        for t in spec)
            back = gather_blocks(back, m4, [(0, "fft")])
            if rank == 0:
                if kt:      # the folded (w, 4 n) layout back to (n, 4 w)
                    w = got[0].shape[0]
                    got = tuple(t.view(w, GLOO_RANKS, n).permute(2, 1, 0)
                                .reshape(n, GLOO_RANKS * w) for t in got)
                got = tuple(t[:, :n // 2 + 1] for t in got)
                report(f"fft2_slab/ifft2_slab r2c {n}^2 on (4,) "
                       f"{','.join(flags) or 'no flag'}", got,
                       tuple(t[perm] for t in want) if pc else want,
                       ref[perm] if pc else ref, back, x)
            del spec, back, got
        del x, local, want, ref
        torch.cuda.empty_cache()

        shape, axes = (DIST_PENCIL_N,) * 3, ("mx", "my")
        z = dist_input("pencil", gen)
        xr = randn(shape, gen)
        for kind, data in (("c2c", z), ("r2c", xr)):
            nd = plan_nd(shape, kind, mesh=m22, decomp="pencil",
                         comm="collective", planner=planner)
            local = distribute(data, nd, m22)
            run = fftn if kind == "c2c" else rfftn
            want = collect(run(local, mesh=m22, plan=nd, planner=planner),
                           nd, m22)
            if kind == "c2c":
                spec = dfft.fft3_pencil(local, m22, axes, planner)
                back = dfft.ifft3_pencil(spec, m22, axes, planner)
                name = f"fft3_pencil/ifft3_pencil c2c {DIST_PENCIL_N}^3"
            else:
                spec = dfft.rfft3_pencil(local, m22, axes, planner)
                back = dfft.irfft3_pencil(spec, m22, axes, DIST_PENCIL_N,
                                          planner)
                name = f"rfft3_pencil/irfft3_pencil r2c {DIST_PENCIL_N}^3"
            got = collect(spec, nd, m22)
            back = collect(back, nd, m22, spatial=True)
            if rank == 0:
                report(name + " on (2, 2)", got, want,
                       dist_reference(nd, data), back, data)
            del local, want, spec, back, got
        del z, xr
    torch.cuda.empty_cache()
    return lines


def gloo_psum(rank, mesh) -> list:
    """Phase 14 over the gloo ranks: compressed_psum of a PSUM_N payload,
    each rank its own, every gather backend, auto and measure; rank 0
    holds the sum against the sum of the dequantized payloads (1e-6 of
    its max: the float32 order of the sum) and the exact sum (the
    reference's bounds). Returns rank 0's lines."""
    from repro_torch.optim import (choose_psum_comm, compressed_psum,
                                   dequantize_int8, quantize_int8)
    group = mesh.get_group("fft")
    xs = [torch.randn(PSUM_N, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED + 10 + r)) for r in range(GLOO_RANKS)]
    deq = sum(dequantize_int8(*quantize_int8(x), x.shape).double()
              for x in xs)
    exact = sum(x.double() for x in xs)
    lines = []
    for comm in PSUM_COMMS:
        spec = choose_psum_comm(mesh, "fft", (PSUM_N,), mode=comm)
        total, err = compressed_psum(xs[rank], group, comm=spec)
        ms = time_variant(lambda: compressed_psum(xs[rank], group,
                                                  comm=spec), 3)[0]
        if rank != 0:
            continue
        off = (total.double() - deq).abs().max().item()
        rel = ((total.double() - exact).abs() / (exact.abs() + 1e-3))
        med = rel.median().item()
        worst = err.abs().max().item()
        check(off <= 1e-6 * deq.abs().max().item() and med < 0.02
              and worst < 0.05, f"gloo compressed_psum {comm}: {off} from "
              f"the dequantized sum, median rel {med}, residual {worst}")
        lines.append(f"gloo{GLOO_RANKS} psum compressed_psum {PSUM_N} f32 a "
                     f"rank on (4,) comm={comm} -> {spec}: {off:.3e} from the "
                     f"sum of the dequantized payloads, median rel err "
                     f"{med:.3e} against the exact sum, residual "
                     f"{worst:.3e}; {ms:.3f} ms (median of 3)")
    return lines


def gloo_rank(rank: int, store_path: str, out_path: str) -> None:
    """gloo_rank_body, with any failure's traceback (an exit included)
    written to ``out_path.rank<r>.err`` for phase_gloo_ranks to print."""
    import traceback
    try:
        gloo_rank_body(rank, store_path, out_path)
    except BaseException:
        Path(f"{out_path}.rank{rank}.err").write_text(traceback.format_exc())
        raise


def gloo_rank_body(rank: int, store_path: str, out_path: str) -> None:
    """One of GLOO_RANKS ranks on the one card, gloo carrying CUDA tensors:
    slab r2c DIST_SLAB_N^2 over (4,) and pencil c2c DIST_PENCIL_N^3 over
    (2, 2), forward and back, collected on every rank and held against
    float64 torch.fft on rank 0, which writes the results to out_path."""
    import datetime
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import (Planner, collect, distribute, fftn, ifftn,
                             irfftn, kernels, make_mesh, plan_nd, rfftn)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    timeout = datetime.timedelta(seconds=300)
    dist.init_process_group("gloo", rank=rank, world_size=GLOO_RANKS,
                            store=dist.FileStore(store_path, GLOO_RANKS),
                            timeout=timeout)
    try:
        meshes = {"(4,)": make_mesh((4,), ("fft",), timeout=timeout,
                                    device_type="cuda"),
                  "(2, 2)": make_mesh((2, 2), ("mx", "my"), timeout=timeout,
                                      device_type="cuda")}
        planner = Planner(backends=("hopper",))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        runs = [(f"slab r2c {DIST_SLAB_N}^2", "(4,)", "slab", "r2c",
                 (DIST_SLAB_N,) * 2),
                (f"pencil c2c {DIST_PENCIL_N}^3", "(2, 2)", "pencil", "c2c",
                 (DIST_PENCIL_N,) * 3)]
        out = {}
        for name, mesh_name, decomp, kind, shape in runs:
            mesh = meshes[mesh_name]
            data = dist_input(decomp, gen)          # the same on every rank
            nd = plan_nd(shape, kind, mesh=mesh, decomp=decomp,
                         comm="collective", planner=planner)
            local = distribute(data, nd, mesh)
            forward, inverse = (rfftn, irfftn) if kind == "r2c" \
                else (fftn, ifftn)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            spec = forward(local, mesh=mesh, plan=nd, planner=planner)
            back = inverse(spec, mesh=mesh, plan=nd, planner=planner)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            want = DIST_LAUNCHES[decomp]
            check(launches == want, f"gloo rank {rank} {name}: launches "
                  f"{launches}, expected {want}")
            full = collect(spec, nd, mesh)
            back = collect(back, nd, mesh, spatial=True)
            if rank == 0:
                ref = dist_reference(nd, data)
                tol = 2e-4 * ref.abs().max().item()
                err = max_err(full, ref)
                check(err <= tol, f"gloo {name} on {mesh_name}: err {err} "
                      f"> {tol}")
                del ref
                if kind == "r2c":
                    scale = data.abs().max().item()
                    rt = (back - data).abs().max().item()
                else:
                    scale = max(d.abs().max().item() for d in data)
                    rt = max((b - d).abs().max().item()
                             for b, d in zip(back, data))
                check(rt <= 2e-4 * scale, f"gloo {name} on {mesh_name}: "
                      f"round trip err {rt} > {2e-4 * scale}")
                out[name] = dict(mesh=mesh_name, block=list(local.shape if
                                 kind == "r2c" else local[0].shape),
                                 err=err, tol=tol, round_trip=rt,
                                 round_trip_tol=2e-4 * scale,
                                 seconds=seconds, launches=launches,
                                 peak_gib=peak / 2 ** 30)
            del data, local, spec, back, full
            torch.cuda.empty_cache()
        # phases 12-14 on the same ranks
        t0 = time.perf_counter()
        extra = gloo_sharded_mixer(rank, meshes["(4,)"], planner, gen)
        torch.cuda.empty_cache()
        extra += gloo_shims(rank, meshes, planner, gen)
        extra += gloo_psum(rank, meshes["(4,)"])
        if rank == 0:
            extra.append(f"gloo{GLOO_RANKS} phases 12-14 took "
                         f"{time.perf_counter() - t0:.1f} s")
            Path(out_path).write_text(json.dumps({"runs": out,
                                                  "extra": extra}))
    finally:
        dist.destroy_process_group()


def phase_gloo_ranks() -> dict:
    """GLOO_RANKS processes on the one card over gloo (NCCL refuses two
    ranks on one GPU), started and joined here."""
    import tempfile
    import torch.multiprocessing as mp
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out_path = str(Path(tmp) / "gloo.json")
        try:
            mp.start_processes(gloo_rank, args=(str(Path(tmp) / "store"),
                                                out_path),
                               nprocs=GLOO_RANKS, start_method="spawn")
        except Exception:
            for err in sorted(Path(tmp).glob("gloo.json.rank*.err")):
                print(f"phase 11 {err.name}:\n{err.read_text()}",
                      file=sys.stderr)
            raise
        out = json.loads(Path(out_path).read_text())
    for name, r in out["runs"].items():
        print(f"gloo{GLOO_RANKS} {name} on {r['mesh']} (block "
              f"{tuple(r['block'])} a rank): err {r['err']:.4e} (tol "
              f"{r['tol']:.4e}), round trip {r['round_trip']:.3e} (tol "
              f"{r['round_trip_tol']:.3e}); rank 0 launches {r['launches']},"
              f" peak {r['peak_gib']:.2f} GiB; {r['seconds']:.3f} s forward "
              "and back, first call")
    for line in out["extra"]:
        print(line)
    return out


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
          f"TFLOP/s, copy {cal['copy_bytes_per_s'] / 1e12:.3f} TB/s, "
          f"four-step share of its bound {cal['four_step_share']:.4f} at "
          f"{cal['four_step_ms']:.3f} ms (H100 profile: "
          f"{H100.flops / 1e12:.2f} TFLOP/s, {H100.hbm_bw / 1e12:.3f} TB/s, "
          f"fft_share {H100.fft_share}) [{label}]")

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
    phase_sharded_conv_kernels(gen, planner, errs)
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

    # phase 9: the distributed layer at world size 1 on NCCL, then 10: its
    # times beside the local plans
    import torch.distributed as dist
    t0 = time.perf_counter()
    m1, m11, store = start_nccl()
    try:
        phase_distributed(planner, gen, m1, m11)
        t9 = time.perf_counter()
        phase_distributed_times(label, planner, gen, m1, m11)
        plan_verdicts(planner, m1, m11)
        t10 = time.perf_counter()
        # phases 12-14: the sharded mixer, the shims and the compressed
        # all-reduce, still at world size 1 on NCCL
        phase_sharded_mixer(label, planner, gen, m1)
        t12 = time.perf_counter()
        phase_shims(label, planner, gen, m1, m11)
        t13 = time.perf_counter()
        phase_psum(label, gen, m1)
    finally:
        dist.destroy_process_group()
        del store
    t14 = time.perf_counter()

    # phase 11: four ranks on the one card over gloo (with phases 12-14)
    phase_gloo_ranks()
    print(f"dist phases: 9 took {t9 - t0:.1f} s, 10 took {t10 - t9:.1f} s, "
          f"12 took {t12 - t10:.1f} s, 13 took {t13 - t12:.1f} s, 14 took "
          f"{t14 - t13:.1f} s, 11 took {time.perf_counter() - t14:.1f} s")

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
