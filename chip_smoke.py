#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

run from the root of a checkout. Phases, each of which raises on failure:

1. print the card's name and power limit, build every CUDA kernel of the
   port from the checkout's sources, turn TF32 off, and measure the
   constants of the H100 hardware profile (repro_torch.calibrate);
2. hold each kernel against its plain PyTorch version on the card: the
   four-step FFT over the reference's kernel sweep and the main path's
   shapes, at atol = 1e-4*scale, and the tiled transpose over several
   dtypes and shapes and every block the main path's moves give it,
   exactly;
3. run the main path at real size through the public entry points with the
   kernel backend (Planner(backends=("hopper",))): rfftn of a 16384^2 real
   array and irfftn back, fftn of a 512^3 complex pair and ifftn back,
   held against float64 torch.fft at atol = 2e-4*max|ref|, with the launch
   counts of both kernels read around this phase alone;
4. time the transforms (hopper planner, torch planner, torch.fft) and each
   kernel alone at its main-path shape, as medians of 10 CUDA-event timed
   runs after warm-up, then trace one call of each transform with
   torch.profiler (device time by kernel, device busy share).

The last two lines are the kernel table as one JSON object, then the card
label, then {"ok": true, "device": {...}}. It needs one GPU and exits
non-zero, printing no result, without one.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
FP32_PEAK = 67e12    # H100 SXM float32 FLOP/s outside the tensor cores (published)
HBM_PEAK = 3.35e12   # H100 SXM HBM3 bytes/s (published)
FOUR_STEP_SWEEP = [(8, 8), (16, 16), (16, 32), (32, 64), (128, 128), (8, 128),
                   (128, 8), (25, 40), (125, 8), (7, 3), (4, 9), (128, 1)]
# the arrays whose axes the main path moves: the rfftn 16384^2 spectrum
# before its column pass, and the fftn 512^3 cube
MAIN_SPECTRA = ((16384, 8193), (512, 512, 512))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


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
    for name, n in launches.items():
        check(n > 0, f"the main path never launched {name}")

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
    def bound(ops, nbytes):
        """(ms, what bounds it): the larger of operations over the FP32 peak
        and bytes over the HBM peak."""
        t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_PEAK
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops > t_bytes else "bytes")

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
        # operations and one complex f32 read and write per point; the
        # four-step's own 8 n (n1 + n2) operations are reported as its rate
        bound_ms, by = bound(5.0 * b * n * math.log2(n), 16.0 * b * n)
        four_step_flops = 8.0 * b * n * (f[0] + f[1])
        print(f"time four_step_fft {name} {shape} {f}: kernel {ms:.3f} ms, "
              f"plain {plain:.3f} ms, torch.fft.fft {lib:.3f} ms, bound "
              f"{bound_ms:.3f} ms ({by}); four-step rate "
              f"{four_step_flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s [{label}]")
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


def phase_profile(label, planner, x, z) -> None:
    """One traced call of each transform: device time by kernel, and the
    device's busy share of the call's wall time."""
    import repro_torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for name, run in (("rfftn 16384^2", lambda: repro_torch.rfftn(
            x, planner=planner)), ("fftn 512^3", lambda: repro_torch.fftn(
                z, planner=planner))):
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
        print(f"profile {name} hopper: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}) [{label}]")
        for e in rows[:8]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<3d} "
                  f"{e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
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
    print("kernels " + json.dumps(errs))

    # phase 3: the main path at real size
    x = randn((16384, 16384), gen)
    z = (randn((512,) * 3, gen), randn((512,) * 3, gen))
    launches = phase_main_path(planner, x, z)

    # phase 4: times
    planners = {"hopper": planner, "torch": Planner(backends=("torch",))}
    times = phase_times(label, planners, x, z, main_shapes, gen)
    phase_profile(label, planner, x, z)

    head = times["rfftn column pass"]
    table = {"kernels": [
        dict(name="four_step_fft", route="cuda",
             source="src/repro_torch/kernels/dft_matmul/dft_matmul.cu",
             replaces="src/repro/kernels/dft_matmul/dft_matmul.py:76",
             launches=launches["four_step_fft"],
             max_abs_err=errs["four_step_fft"]["rfftn column pass"],
             **head),
        dict(name="batched_transpose", route="cuda",
             source="src/repro_torch/kernels/transpose/transpose.cu",
             replaces="src/repro/kernels/transpose/transpose.py:27",
             launches=launches["batched_transpose"],
             max_abs_err=max(errs["batched_transpose"].values()),
             **times["transpose"]),
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
