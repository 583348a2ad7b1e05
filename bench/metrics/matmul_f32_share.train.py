"""The float32 GEMMs' share of the card's kernel time in a training step:
the mixers' DFTs that the plan layer runs on torch.matmul (the model's
own products run in bf16)."""

from bench.lib import kernels


def read(out):
    ts = kernels.traces(out)
    return kernels.share(ts[0], kernels.GEMM_F32) if ts else None
