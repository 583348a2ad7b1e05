"""The transforms' share of their roofline on one card: the least time of
a step's transforms at the published peaks (each transform's input read
once and output written once at 3.35 TB/s, or its FFTW-convention
operations at 67 TFLOP/s FP32, whichever is longer) over the device's
busy time a step. It counts the transforms' work, not any kernel's, so
it reads the same work whatever implements the transform."""

from bench.lib import counts, kernels


def read(out):
    ts = kernels.traces(out)
    if not ts or ts[0]["busy_s"] <= 0:
        return None
    t = ts[0]
    least = counts.least_seconds(t["fft_flops_per_step"],
                                 t["fft_bytes_per_step"],
                                 counts.PEAKS["fp32_flops"])
    return 100.0 * least * t["steps"] / t["busy_s"]
