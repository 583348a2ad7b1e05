"""The training step's model operations over its time, against the bf16
dense peak of 989 TFLOP/s: 6 x the parameters in matrix products x the
tokens, plus the mixers' FFT convolutions by FFTW's convention, forward
and backward (``lib.counts.lm_step_flops``), per step of the traced
window."""

from bench.lib import counts, kernels


def read(out):
    ts = kernels.traces(out)
    if not ts:
        return None
    t = ts[0]
    rate = t["model_flops_per_step"] * t["steps"] / t["window_s"]
    return 100.0 * rate / counts.PEAKS["bf16_flops"]
