"""A rank's share of its roofline in a step: its block read and written
once by each transform at 3.35 TB/s, or its quarter of the transforms'
FFTW-convention operations at 67 TFLOP/s FP32, whichever is longer, over
the step's time on the slowest rank (its traced window over its steps)."""

from bench.lib import counts, kernels


def read(out):
    ts = kernels.traces(out)
    if not ts:
        return None
    t0 = ts[0]
    least = counts.least_seconds(t0["fft_flops_per_step"] / len(ts),
                                 t0["fft_bytes_per_step_rank"],
                                 counts.PEAKS["fp32_flops"])
    step = max(t["window_s"] / t["steps"] for t in ts)
    return 100.0 * least / step
