"""NCCL's kernels' share of a card's kernel time, on the rank where it is
largest (the rank that waits most in the exchanges)."""

from bench.lib import kernels


def read(out):
    got = [kernels.share(t, kernels.NCCL) for t in kernels.traces(out)]
    got = [g for g in got if g]
    return max(got) if got else None
