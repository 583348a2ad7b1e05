"""The port's four hand-written kernels' share of the card's kernel time
in a training step (four-step FFT, transpose, complex multiply, fused
FFT convolution)."""

from bench.lib import kernels


def read(out):
    ts = kernels.traces(out)
    return kernels.share(ts[0], kernels.PORT) if ts else None
