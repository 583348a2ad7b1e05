"""The share of the traced window in which no operation ran on a card,
the mean over the cards."""

from bench.lib import kernels


def read(out):
    got = [kernels.idle(t) for t in kernels.traces(out)]
    got = [g for g in got if g is not None]
    return sum(got) / len(got) if got else None
