"""Pod-axis pipeline parallelism (GPipe microbatching by point-to-point
sends), ported from ``repro.parallel.pipeline``.

Multi-pod meshes pay the slow inter-pod links for every cross-pod
collective. FSDP over (pod, data) all-gathers weights across pods every
layer; pipelining instead confines cross-pod traffic to *stage
boundaries*: one (mb, S, d) activation per microbatch tick.

SPMD schedule: every rank of the ``axis`` group runs the same program; at
tick t, the rank holding stage s computes microbatch (t - s) and sends its
output to stage s+1 (a ring shift over the group). Ticks = M + S - 1;
every stage computes at every tick, so (S-1)/M of its compute is the
classic GPipe bubble. The ring shift is an autograd ``Function`` whose
backward is the reverse shift (the reference's "autodiff transposes
ppermute to the reverse ring"), so one forward definition trains: every
rank builds the same autograd graph, whose shifts' backwards then pair up
across the ranks in the same (reverse tick) order.

``axis`` names a dim of a ``DeviceMesh``; this rank's stage is
``mesh.get_local_rank(axis)``. The reference's ``me=`` argument, its
stage index passed as data, exists only for JAX 0.4.x's partial-manual
``shard_map``, where ``axis_index`` cannot lower; the port has no such
limit and reads the stage off the mesh. Every send and receive is a c10d
point-to-point op (``batch_isend_irecv``: a send and a receive on every
rank at once, so no rank blocks on a partner that is itself sending);
gloo's are staged through host memory where the tensors live on a card.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
import torch.distributed as dist

__all__ = ["pipeline_forward", "pipeline_stages"]


def _exchange(t: torch.Tensor, group, send_to: int, recv_from: int
              ) -> torch.Tensor:
    """``t`` sent to the group's rank ``send_to`` while a tensor like it
    is received from ``recv_from`` (group ranks), and returned."""
    staged = dist.get_backend(group) == "gloo" and t.device.type != "cpu"
    src = (t.cpu() if staged else t).contiguous()
    out = torch.empty_like(src)
    dst = dist.get_global_rank(group, send_to)
    peer = dist.get_global_rank(group, recv_from)
    if src.is_meta:
        # a step traced on the meta device (``launch.dryrun``), which
        # ``batch_isend_irecv`` refuses: the ops alone, nothing moves
        reqs = [dist.isend(src, dst, group), dist.irecv(out, peer, group)]
    else:
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, dst, group),
            dist.P2POp(dist.irecv, out, peer, group)])
    for req in reqs:
        req.wait()
    return out.to(t.device) if staged else out


class RingShift(torch.autograd.Function):
    """Stage s's ``x`` to stage s+1 (mod S) over ``group``: every rank
    sends its tensor and receives its predecessor's. The backward shifts
    the gradient back, s+1 to s."""

    @staticmethod
    def forward(ctx, x, group, me: int, stages: int):
        ctx.group, ctx.me, ctx.stages = group, me, stages
        if stages == 1:
            return x.clone()
        return _exchange(x, group, (me + 1) % stages, (me - 1) % stages)

    @staticmethod
    def backward(ctx, g):
        me, stages = ctx.me, ctx.stages
        if stages == 1:
            return g, None, None, None
        return (_exchange(g, ctx.group, (me - 1) % stages, (me + 1) % stages),
                None, None, None)


class FromLastStage(torch.autograd.Function):
    """The last stage's ``x`` on every rank of ``group`` (a broadcast):
    one value replicated over the group, as the reference's output of
    ``pipeline_forward`` is. Every rank computes the same thing of it, so
    the backward takes the last stage's own gradient (zeros on the
    others, whose ``x`` did not reach the output), as ``blocks.AllReduce``
    does for a loss that every rank holds."""

    @staticmethod
    def forward(ctx, x, group, me: int, stages: int):
        ctx.last = me == stages - 1
        out = x.detach().clone().contiguous()
        dist.broadcast(out, src=dist.get_global_rank(group, stages - 1),
                       group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None, None, None


def _stage(mesh, axis: str) -> Tuple[Any, int, int]:
    """(the ``axis`` group, this rank's stage, the number of stages)."""
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.size(mesh.mesh_dim_names.index(axis)))


def pipeline_stages(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                    stage_params: Any, x_mb: torch.Tensor, mesh, axis: str):
    """Like :func:`pipeline_forward` but WITHOUT the final broadcast:
    returns (outs, my_stage_index, num_stages) where ``outs`` (M, mb, ...)
    holds valid microbatch outputs only on the last stage (zeros
    elsewhere). Callers that reduce to a scalar (the LM loss) mask by stage
    and sum over ``axis``: no activation crosses ``axis`` outside the ring.

    ``stage_fn(stage_params, x)`` applies THIS rank's stage to ``x``
    with ``stage_params`` (this stage's parameters: any object, say its
    layers); ``x_mb`` (M, mb, ...) is the microbatched input, the same on
    every stage (only stage 0 reads it).
    """
    group, me, stages = _stage(mesh, axis)
    m = x_mb.shape[0]
    ticks = m + stages - 1
    first = torch.tensor(me == 0, device=x_mb.device)
    buf = torch.zeros_like(x_mb[0])
    outs = []
    for t in range(ticks):
        # stage 0 injects microbatch t (clipped: the last again during the
        # drain); the others take what their predecessor sent. ``where``
        # keeps ``buf`` in every rank's graph, so that every shift's
        # backward runs on every rank.
        inp = torch.where(first, x_mb[min(t, m - 1)], buf)
        out = stage_fn(stage_params, inp)
        # tick t completes microbatch t - (S-1) on the last stage
        if t >= stages - 1:
            outs.append(out)
        if t + 1 < ticks:
            buf = RingShift.apply(out, group, me, stages)
    # zeros off the last stage, still in the graph (as the reference's
    # ``where``): a caller's scalar of them starts every rank's backward
    outs = torch.stack(outs)
    outs = torch.where(torch.tensor(me == stages - 1, device=outs.device),
                       outs, torch.zeros((), dtype=outs.dtype,
                                         device=outs.device))
    return outs, me, stages


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stage_params: Any, x_mb: torch.Tensor, mesh,
                     axis: str) -> torch.Tensor:
    """Run microbatches through pipeline stages along mesh axis ``axis``.

    stage_fn(stage_params, x) applies THIS rank's stage.
    x_mb: (M, mb, ...) microbatched inputs (the same on every stage).
    Returns (M, mb, ...) outputs of the LAST stage, on every stage (a
    broadcast from the last stage: one value, whose gradient is the last
    stage's).
    """
    outs, me, stages = pipeline_stages(stage_fn, stage_params, x_mb, mesh,
                                       axis)
    group = mesh.get_group(axis)
    return FromLastStage.apply(outs, group, me, stages)
