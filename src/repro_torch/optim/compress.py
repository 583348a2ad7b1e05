"""Int8 error-feedback gradient compression for a reduction over a slow
link, ported from ``repro.optim.compress``.

Where plain data parallelism runs over a slow axis (between hosts), the
gradient all-reduce can run in int8 with per-block scales and an
error-feedback accumulator: the quantization error is re-injected next
step (Karimireddy et al., EF-SGD). For p ranks the wire cost is
p * (n + n/block * 2) bytes against 2 * 4n * (p-1)/p for a float32 ring.

``compressed_psum`` takes this rank's tensor and a ``torch.distributed``
process group (the reference runs inside ``shard_map`` over an axis name):
quantize locally, all-gather the int8 payload and its bfloat16 scales
through the pair collectives of :mod:`repro_torch.core.comm`, dequantize
and sum locally. ``comm="collective"`` is one all-gather per pair member,
``"pipelined[:c]"`` cuts the payload into chunks all in flight at once;
:func:`choose_psum_comm` resolves ``"auto"`` (the gather roofline) and
``"measure"`` (timed on the live mesh, cached under a ``comm/gather/*``
wisdom key) first.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..core.comm import (CommSpec, get_backend, measure_comm_gather,
                         mesh_sizes, plan_comm_gather)

BLOCK = 256


def quantize_int8(x: torch.Tensor, block: int = BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Per-block symmetric int8 quantization. Returns (q, scales, pad): q
    (nb, block) int8, scales (nb, 1) bfloat16, and the zeros appended to
    fill the last block."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % block
    blocks = torch.nn.functional.pad(flat, (0, pad)).view(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16), pad


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, pad: int,
                    shape) -> torch.Tensor:
    deq = (q.float() * scale.float()).reshape(-1)
    if pad:
        deq = deq[:-pad]
    return deq.reshape(shape)


def choose_psum_comm(mesh, axis_name: str, shape, mode: str = "auto",
                     wisdom=None, hw=None, planner=None) -> str:
    """Resolve a ``comm`` spec for :func:`compressed_psum`.

    ``mode="auto"`` applies the gather roofline
    (:func:`repro_torch.core.comm.plan_comm_gather`) for the ``hw`` profile
    (default ``H100``); ``mode="measure"`` times the monolithic and
    chunked gathers on the live mesh for this payload size (every rank of
    the axis must call it), caching the verdict under a ``comm/gather/*``
    wisdom key. Any other mode is passed through verbatim. ``planner=``
    resolves against the FFT planner's hardware profile and wisdom store.
    """
    if planner is not None:
        hw = hw or planner.hw
        wisdom = wisdom if wisdom is not None else planner.wisdom
    n = math.prod(shape)
    if mode == "auto":
        return plan_comm_gather(n, mesh_sizes(mesh)[axis_name], block=BLOCK,
                                hw=hw)
    if mode == "measure":
        return measure_comm_gather(mesh, axis_name, n, block=BLOCK,
                                   wisdom=wisdom, hw=hw)
    return mode


def compressed_psum(x: torch.Tensor, group,
                    error: Optional[torch.Tensor] = None,
                    comm: CommSpec = "collective", chunks: int = 4
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce of this rank's ``x`` over ``group``
    (every rank of it calls this). ``comm`` selects the gather backend
    (resolve ``"auto"``/``"measure"`` with :func:`choose_psum_comm`
    first). Returns (the float32 sum, this rank's new error-feedback
    residual)."""
    backend = get_backend(comm, chunks=chunks)
    xf = x.float()
    if error is not None:
        xf = xf + error
    q, scale, pad = quantize_int8(xf)
    new_error = xf - dequantize_int8(q, scale, pad, xf.shape)

    qg, sg = backend.gather((q, scale), group, dist.get_world_size(group))
    # (P, nb, block) int8 and (P, nb, 1) bfloat16
    total = (qg.float() * sg.float()).sum(0).reshape(-1)
    if pad:
        total = total[:-pad]
    return total.reshape(x.shape), new_error
