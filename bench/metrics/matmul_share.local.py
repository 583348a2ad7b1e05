"""The GEMM kernels' share of the card's kernel time: the DFTs that the
plan layer (core/algo.py) runs on torch.matmul."""

from bench.lib import kernels


def read(out):
    ts = kernels.traces(out)
    return kernels.share(ts[0], kernels.GEMM) if ts else None
