"""Multi-pod dry run, ported from ``repro.launch.dryrun``: build every
(arch x shape x mesh) cell at the production mesh's size and read the
roofline terms off one traced step, with no card and no cluster.

The reference lowers and compiles each cell for 512 TPU chips in one
process (``--xla_force_host_platform_device_count=512``) and reads XLA's
cost analysis and HLO. The port does the same with what PyTorch offers:

* the mesh: one process starts the ``fake`` c10d backend at 256 or 512
  ranks (rank 0's view; every collective a no-op: ``_fake_group``), and
  ``launch.mesh.make_production_mesh`` lays the (16, 16) or (2, 16, 16)
  mesh over it as on a real cluster;
* the step: ``build_cell``'s, traced once on the ``meta`` device (shapes
  and dtypes, nothing allocated) with rank 0's blocks: its LM placed by
  ``Cell.place`` (this rank's pipeline stage, tensor parallelism) and its
  rows of the batch;
* FLOPs: ``torch.utils.flop_counter``'s rules (``FlopCounterMode``'s
  ``flop_registry``), applied to each op of the step as it runs (forward,
  the remat recompute and the backward) by the dispatch mode below, which
  spares ``FlopCounterMode``'s attempt to decompose every other op;
* collectives: a ``TorchDispatchMode`` sees each c10d op (all-reduce,
  all-gather, reduce-scatter, all-to-all, the pipeline's send) with its
  tensors and group, bucketed by the reference's own formulas
  (``parse_collectives`` with ``with_wire``: operand and wire bytes);
  the pipeline's point-to-point sends go in ``collective-permute``;
* FSDP2 refuses parameters on the ``meta`` device, so the step runs
  without it and its collectives are counted from the placed parameters
  per FSDP unit (each layer, and the root): an all-gather at each use of
  a layer in the forward and again in the backward (the re-gather of
  parameters resharded after the forward; with remat the recompute runs
  on that gather), one for the root, and one reduce-scatter per unit in
  the backward of a train step (``fsdp_collectives``; the reference's x3
  rule, and what a gloo run of the pipelined step counts, at a layer's
  ``M + S - 1`` uses a step there).

Which of the reference's roofline terms carry over:

* ``model_flops`` and ``inner_scan_flops_correction`` are its arithmetic,
  unchanged;
* ``flops_per_device`` (the reference's ``hlo_flops_per_device``) counts
  what ``FlopCounterMode`` counts: matrix products and attention (mm,
  bmm, addmm, baddbmm, convolutions, fused attention), not the
  elementwise ops that XLA's cost analysis adds. An eager trace runs
  every layer and every inner loop (flash-attention blocks, chunks,
  sLSTM steps), so there is no rolled loop to correct: ``_fwd_calibration`` and ``REPRO_SCAN_UNROLL``
  have no counterpart (``--unroll-mode fwd`` changes nothing), and
  ``inner_scan_flops_correction_per_device`` is reported beside the
  count, not added to it (that would count those FLOPs twice);
* ``bytes_per_device_unfused`` (for ``hlo_bytes_per_device``) sums the
  bytes every op of the step reads and writes, as eager PyTorch runs it:
  XLA's fusion would keep many of them in registers, so ``t_memory`` is
  an upper bound, not XLA's figure;
* collective bytes, counts and wire bytes carry over by the same
  formulas; ``t_collective``, ``t_collective_wire`` over one link;
* hardware constants are ``core.plan.H100``'s (float32 matmul FLOP/s and
  HBM bytes/s measured on the card, NVLink's published 450 GB/s), never
  the reference's TPU v5e constants, so ``t_compute`` prices the count at
  the card's float32 matmul rate;
* ``compile_seconds`` becomes ``trace_seconds``;
* ``memory``: ``argument_bytes`` are rank 0's placed parameters (cut over
  ``model``, over ``data`` by FSDP2's blocks along each parameter's
  ``runtime.trainer.fsdp_dims``, a pipeline stage's layers alone), their
  gradients and AdamW moments on a train cell, and its block of the
  decode cache. ``temp_bytes`` (XLA's ``temp_size_in_bytes``) is the peak
  of the bytes of activations and temporaries during the traced step
  (``TempBytes``: every storage an op creates, from that op until it is
  freed, but a parameter's gradient once accumulated). Against XLA's
  figure it has no fusion, so every eager temporary counts, and no buffer
  reuse beyond PyTorch's own freeing; the step's outputs (a prefill's
  cache, the logits, the metrics) count in it while they live, and
  FSDP2's gathered parameters do not (the trace runs without FSDP2: its
  all-gathers are counted, not run). ``output_bytes`` and ``alias_bytes``
  stay null: an eager step has no compiled program whose outputs and
  donated buffers XLA sizes apart (the decode cache and the AdamW state
  are updated in place, the reference's aliasing without a count).

Usage (any machine, no card):
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --mesh multi --pipeline
  python -m repro_torch.launch.dryrun --all --mesh both --out dryrun_out
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref
from typing import List, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import ARCH_IDS, get_config
from ..core.plan import H100
from ..models.config import SHAPES, SHAPES_BY_NAME
from ..runtime.trainer import fsdp_dims
from .mesh import make_production_mesh
from .specs import build_cell

BUCKETS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
           "collective-permute")
# the serve profile's budget of weights a rank holds without FSDP: half
# the 80 GB of an H100's memory (launch.specs.weight_budget on the card)
SERVE_BUDGET = 40e9

# c10d ops -> (bucket, the index of the tensors whose bytes the reference
# reads off the HLO: the result, or for an all-reduce, all-to-all and a
# send the operand)
_C10D = {"allreduce_": ("all-reduce", 0), "allreduce_coalesced_":
         ("all-reduce", 0), "allgather_": ("all-gather", 0),
         "_allgather_base_": ("all-gather", 0),
         "allgather_into_tensor_coalesced_": ("all-gather", 0),
         "reduce_scatter_": ("reduce-scatter", 0),
         "_reduce_scatter_base_": ("reduce-scatter", 0),
         "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
         "alltoall_base_": ("all-to-all", 1), "alltoall_": ("all-to-all", 1),
         "send": ("collective-permute", 0)}
# the receiving side of a send, and ops that move no payload
_C10D_SKIP = ("recv_", "recv_any_source_", "barrier", "monitored_barrier_")


@contextlib.contextmanager
def _fake_group(world: int):
    """The default process group on the ``fake`` backend at ``world``
    ranks, this process rank 0 (its collectives no-ops), destroyed on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tensors(x) -> List[torch.Tensor]:
    """The tensors of ``x``: a tensor, or lists, tuples and dicts of
    them."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group_size(args) -> int:
    """The size of the process group among a c10d op's arguments."""
    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:        # another bound class (a ReduceOp)
                continue
    raise ValueError("a c10d op without a process group")


class StepCounter(TorchDispatchMode):
    """Every op of a traced step: ``events``, (bucket, result bytes, group
    size) of each collective (the reference's ``parse_collectives``
    reads the same off HLO), ``bytes``, what every other op reads and
    writes, and ``flops``, ``FlopCounterMode``'s count of the matmul-class
    ops."""

    def __init__(self):
        super().__init__()
        self.events: List[Tuple[str, float, int]] = []
        self.ops: List[str] = []        # each event's c10d op
        self.bytes = 0
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if func.namespace == "c10d":
            name = func._opname
            if name in _C10D:
                bucket, i = _C10D[name]
                self.events.append((bucket, float(_nbytes(args[i])),
                                    _group_size(args)))
                self.ops.append(name)
            elif name not in _C10D_SKIP:
                raise ValueError(f"c10d.{name}: a collective with no bucket")
        else:
            self.bytes += _nbytes(list(args) + list(kwargs.values())) \
                + _nbytes(out)
        return out


class TempBytes(TorchDispatchMode):
    """The peak bytes of activations and temporaries of a traced step
    (``peak``): every storage an op creates (an output whose storage none
    of its inputs holds) counts from that op until it is freed, but for
    the storages ``keep`` takes out (a parameter's gradient, once
    accumulated: it stands beside the parameters, as XLA's arguments
    do)."""

    def __init__(self):
        super().__init__()
        self.live = {}                  # storage -> (bytes, weak reference)
        self.now = self.peak = 0

    def _free(self, key, _ref) -> None:
        self.now -= self.live.pop(key, (0, None))[0]

    def keep(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage no longer."""
        self._free(t.untyped_storage()._cdata, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        given = {t.untyped_storage()._cdata
                 for t in _tensors(list(args) + list(kwargs.values()))}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in given or key in self.live:
                continue
            self.live[key] = (st.nbytes(), weakref.ref(
                st, lambda ref, key=key: self._free(key, ref)))
            self.now += st.nbytes()
        self.peak = max(self.peak, self.now)
        return out


def bucket_collectives(events):
    """(operand bytes, counts, wire bytes) by bucket: the reference's
    ``parse_collectives(..., with_wire=True)`` of (bucket, result bytes,
    group size) events. Per device:

      all-gather:      operand = result / P, wire = result - operand
      all-reduce:      operand = result, wire = 2 * operand * (P-1)/P
      reduce-scatter:  operand = result * P, wire = operand * (P-1)/P
      all-to-all:      operand = result, wire = operand * (P-1)/P
      collective-permute: operand = result, wire = operand
    """
    out = dict.fromkeys(BUCKETS, 0.0)
    wire = dict.fromkeys(BUCKETS, 0.0)
    counts = dict.fromkeys(BUCKETS, 0)
    for op, result_bytes, g in events:
        g = max(int(g), 1)
        frac = (g - 1) / g
        if op == "all-gather":
            operand = result_bytes / g
            w = result_bytes - operand
        elif op == "reduce-scatter":
            operand = result_bytes * g
            w = operand * frac
        elif op == "all-reduce":
            operand = result_bytes
            w = 2 * operand * frac
        elif op == "all-to-all":
            operand = result_bytes
            w = operand * frac
        else:                       # collective-permute
            operand = result_bytes
            w = operand
        out[op] += operand
        wire[op] += w
        counts[op] += 1
    return out, counts, wire


def fsdp_block_bytes(p: torch.Tensor, dp: int, dim: int) -> int:
    """Bytes of FSDP2's block of ``p`` on one of ``dp`` ranks: its dim
    ``dim`` (``runtime.trainer.fsdp_dims``) cut into ceil(n / dp) (the
    last rank's padded)."""
    if not p.dim():
        return p.element_size()
    n = p.shape[dim]
    return -(-n // dp) * (p.numel() // max(n, 1)) * p.element_size()


def fsdp_units(model) -> List[Tuple[str, List[torch.Tensor]]]:
    """(unit, its parameters) of ``runtime.trainer.shard_lm``'s FSDP2
    units: each layer (not a shared block) and the root, which holds the
    rest."""
    units, seen = [], set()
    for i, layer in enumerate(model.layers):
        if layer is model.shared or id(layer) in seen:
            continue
        seen.add(id(layer))
        units.append((f"layers.{i}", list(layer.parameters())))
    in_layers = {id(p) for _, ps in units for p in ps}
    units.append(("root", [p for p in model.parameters()
                           if id(p) not in in_layers]))
    return units


def fsdp_collectives(model, dp: int, uses: int, train: bool, with_grad,
                     dims) -> List[Tuple[str, float, int]]:
    """The collectives FSDP2 runs in one step of ``model`` sharded over
    ``dp`` data ranks, as (bucket, result bytes, group size) events: each
    layer unit's flat all-gather at each of its ``uses`` in the forward
    and, in a train step, again at each in the backward (its parameters
    were resharded after the forward); the root's once; in a train step
    one reduce-scatter of each unit's gradients, of the parameters in
    ``with_grad`` (ids; None: all) alone (a pipeline stage's root holds
    no gradient of the head before the last stage). ``dims``: each
    parameter's FSDP2 dim by id (``placed_lm``'s)."""
    if dp <= 1:
        return []
    events = []
    for name, params in fsdp_units(model):
        block = sum(fsdp_block_bytes(p, dp, dims[id(p)]) for p in params)
        if not block:
            continue
        n = 1 if name == "root" else uses * (2 if train else 1)
        events += [("all-gather", float(block * dp), dp)] * n
        grads = sum(fsdp_block_bytes(p, dp, dims[id(p)]) for p in params
                    if with_grad is None or id(p) in with_grad)
        if train and grads:
            events.append(("reduce-scatter", float(grads), dp))
    return events


def inner_scan_flops_correction(cfg, shape) -> float:
    """Flops hidden from HloCostAnalysis by ROLLED inner scans (flash-attn KV
    blocks, chunked-GLA chunks, sLSTM time steps), added analytically.

    REPRO_SCAN_UNROLL only unrolls the LAYER loop; inner loops stay rolled so
    cost analysis sees 1/n_iters of their flops.  We add the missing
    (n-1)/n portion.  Train steps multiply by 4 (forward + remat-recompute +
    ~2x backward); prefill by 1.  Decode paths have no inner scans.
    Residual error after correction: <1% (chunk boundary terms).

    The port's eager trace runs every inner loop, so ``run_cell`` reports
    this beside its count and adds none of it.
    """
    if shape.kind == "decode":
        return 0.0
    b, s = shape.global_batch, shape.seq_len
    mult = 4.0 if shape.kind == "train" else 1.0
    total = 0.0
    for kind, count in cfg.resolved_segments():
        if kind in ("attn_mlp", "attn_moe", "shared_attn"):
            block_kv = min(1024, s)
            nkv = max(s // block_kv, 1)
            fwd = 4.0 * b * s * s * cfg.num_heads * cfg.hd   # qk + pv MACs*2
            total += count * fwd * (nkv - 1) / nkv
        elif kind in ("mamba2", "mlstm"):
            q = 128
            nc = max(s // q, 1)
            if kind == "mamba2":
                di = cfg.ssm_expand * cfg.d_model
                h = di // cfg.ssm_head_dim
                dk, dv = cfg.ssm_state, cfg.ssm_head_dim
            else:
                h = cfg.num_heads
                dk = 2 * cfg.d_model // h
                dv = dk + 1
            # intra-chunk scores+out (2 MACs->flops each) + state update/carry
            fwd = 2.0 * b * s * h * (q * (dk + dv) + 2.0 * dk * dv)
            total += count * fwd * (nc - 1) / nc
        elif kind == "slstm":
            dh = cfg.d_model // cfg.slstm_heads
            fwd = 2.0 * b * s * 4.0 * cfg.slstm_heads * dh * dh
            total += count * fwd * (s - 1) / s
    return total * mult


def model_flops(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode counts one token/seq."""
    from ..models.lm import model_meta
    from ..models.params import param_count
    total = param_count(model_meta(cfg))
    if cfg.num_experts:
        # non-active experts don't contribute: scale expert params by k/E
        active = total
        expert_fraction = (cfg.num_experts - cfg.top_k) / cfg.num_experts
        # expert params = 3 * d * ff * E per layer
        ep = 3 * cfg.d_model * cfg.d_ff * cfg.num_experts * cfg.num_layers
        active = total - ep * expert_fraction
        total = active
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * total * tokens


def _argument_bytes(cell, model, cache, dp: int, dims) -> int:
    """Rank 0's placed parameters (FSDP2's blocks, along each parameter's
    ``dims`` entry by id, where the rules keep fsdp), with their gradients
    and two float32 moments on a train cell, and its block of the decode
    cache."""
    fsdp = "fsdp" in cell.rules and dp > 1

    def numel(p):
        if not fsdp:
            return p.numel()
        return fsdp_block_bytes(p, dp, dims[id(p)]) // p.element_size()
    params = list(model.parameters())
    pbytes = sum(numel(p) * p.element_size() for p in params)
    if cell.kind == "train":
        return 2 * pbytes + 2 * sum(numel(p) * 4 for p in params)
    return pbytes + _nbytes(cache)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             pipeline: bool = False, unroll_mode: str = "env"):
    """The record of one cell: built and traced on a fake group of the
    production mesh's ranks (``_fake_group``)."""
    world = 512 if multi_pod else 256
    with _fake_group(world):
        return _run_cell(arch, shape_name, multi_pod, pipeline, unroll_mode)


def placed_lm(mesh, cell):
    """(rank 0's LM of ``cell`` on the ``meta`` device, placed on ``mesh``
    as the cell places it but for FSDP2, {id of each parameter: its FSDP2
    dim})."""
    from ..models.lm import LM
    model = LM(cell.arch, device="meta")
    cell.place(model, fsdp=False)
    names = fsdp_dims(mesh, model.meta(), cell.rules)
    return model, {id(p): names[n] for n, p in model.named_parameters()}


def _run_cell(arch, shape_name, multi_pod, pipeline, unroll_mode):
    from ..optim import adamw_init
    from ..parallel.pipelined_lm import NUM_MICROBATCHES, microbatches
    from ..parallel.rules import mesh_shape
    mesh = make_production_mesh(multi_pod=multi_pod)
    sizes = mesh_shape(mesh)
    chips = math.prod(sizes.values())
    cell = build_cell(arch, shape_name, mesh, pipeline=pipeline,
                      serve_budget=SERVE_BUDGET)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(s) for s in sizes.values()),
           "chips": chips, "kind": cell.kind, "pipelined": cell.pipelined,
           "unroll_mode": unroll_mode}
    if cell.skip_reason:
        rec["status"] = "skip"
        rec["reason"] = cell.skip_reason
        return rec

    t0 = time.perf_counter()
    model, dims = placed_lm(mesh, cell)
    batch_abs, batch_sh = cell.args[-1], cell.in_shardings[-1]
    batch = {k: batch_sh[k].shard(v) for k, v in batch_abs.items()}
    for k in ("tokens", "labels"):
        if k in batch:
            batch[k] = batch[k].long()
    dp = model.dp_size
    cache = None
    counter, temps = StepCounter(), TempBytes()
    with_grad = set()

    def accumulated(p):
        with_grad.add(id(p))
        temps.keep(p.grad)
    if cell.kind == "train":
        opt = adamw_init(dict(model.named_parameters()))
        hooks = [p.register_post_accumulate_grad_hook(accumulated)
                 for p in model.parameters()]
        with counter, temps:
            cell.fn(model, opt, batch)
        for hook in hooks:
            hook.remove()
    elif cell.kind == "prefill":
        with counter, temps:
            cell.fn(model, batch)
    else:
        cache = model.init_cache(cell.shape.global_batch,
                                 cell.shape.seq_len)
        with counter, temps:
            cell.fn(model, cache, batch)
    uses = 1
    if cell.pipelined:
        stages = sizes["pod"]
        rows = next(iter(batch.values())).shape[0]
        uses = microbatches(rows, NUM_MICROBATCHES) + stages - 1
    events = counter.events + (
        fsdp_collectives(model, dp, uses, cell.kind == "train", with_grad,
                         dims)
        if "fsdp" in cell.rules else [])
    rec["trace_seconds"] = round(time.perf_counter() - t0, 2)
    rec["memory"] = {
        "argument_bytes": _argument_bytes(cell, model, cache, dp, dims),
        "output_bytes": None, "temp_bytes": temps.peak, "alias_bytes": None}

    flops_dev = float(counter.flops)
    bytes_dev = float(counter.bytes)
    rec["flops_per_device"] = flops_dev
    rec["flops_counted"] = "matmul-class ops (FlopCounterMode's rules): " \
        "mm, bmm, addmm, baddbmm, convolutions, attention; no elementwise op"
    rec["bytes_per_device_unfused"] = bytes_dev
    coll, counts, wire = bucket_collectives(events)
    rec["collective_bytes_per_device"] = coll
    rec["collective_counts"] = counts
    rec["collective_wire_bytes_per_device"] = wire
    rec["t_collective_wire"] = sum(wire.values()) / H100.link_bw
    rec["inner_scan_flops_correction_per_device"] = \
        inner_scan_flops_correction(cell.arch, cell.shape) / chips

    # roofline terms (seconds), at the H100 profile's rates
    rec["t_compute"] = flops_dev / H100.flops
    rec["t_memory"] = bytes_dev / H100.hbm_bw
    rec["t_collective"] = sum(coll.values()) / H100.link_bw
    terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
             "collective": rec["t_collective"]}
    rec["bottleneck"] = max(terms, key=terms.get)

    mf = model_flops(cell.arch, cell.shape)
    rec["model_flops_total"] = mf
    rec["model_flops_per_device"] = mf / chips
    rec["useful_flops_ratio"] = (mf / chips) / flops_dev if flops_dev else 0.0
    rec["status"] = "ok"
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--pipeline", action="store_true",
                    help="pod-axis pipeline parallelism (multi-pod only)")
    ap.add_argument("--unroll-mode", choices=["env", "fwd"], default="env",
                    help="the reference's calibration of rolled loops; "
                         "the eager trace has none to correct (recorded, "
                         "changes nothing)")
    ap.add_argument("--out", default=None, help="JSON output directory")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.all or not args.arch else [args.arch]
    shapes = [s.name for s in SHAPES] if args.all or not args.shape \
        else [args.shape]
    for name in shapes:
        SHAPES_BY_NAME[name]        # an unknown shape fails here
    for arch in archs:
        get_config(arch)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                try:
                    rec = run_cell(arch, shape, mp, pipeline=args.pipeline,
                                   unroll_mode=args.unroll_mode)
                except Exception:
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "error",
                           "error": traceback.format_exc(limit=20)}
                results.append(rec)
                if rec["status"] == "ok":
                    print(f"[ok]   {tag}: trace={rec['trace_seconds']}s "
                          f"flops/dev={rec['flops_per_device']:.3e} "
                          f"coll/dev={sum(rec['collective_bytes_per_device'].values()):.3e}B "
                          f"bottleneck={rec['bottleneck']} "
                          f"args={rec['memory']['argument_bytes']}B "
                          f"temps={rec['memory']['temp_bytes']}B",
                          flush=True)
                elif rec["status"] == "skip":
                    print(f"[skip] {tag}: {rec['reason']}", flush=True)
                else:
                    print(f"[ERR]  {tag}:\n{rec['error']}", flush=True)
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    fn = f"{arch}_{shape}_{'multi' if mp else 'single'}"
                    fn += "_pipeline" if args.pipeline else ""
                    with open(os.path.join(args.out, fn + ".json"), "w") as f:
                        json.dump(rec, f, indent=1)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} documented skips, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
