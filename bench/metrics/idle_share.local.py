"""The share of the traced window in which no operation ran on the card."""

from bench.lib import kernels


def read(out):
    ts = kernels.traces(out)
    return kernels.idle(ts[0]) if ts else None
