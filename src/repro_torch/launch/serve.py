"""Serving launcher: batched prefill + decode loop with a request queue,
ported from ``repro.launch.serve``.

Continuous-batching-lite: a fixed decode batch; finished sequences (length
budget) are refilled from the pending queue between steps. One prefill per
admitted prompt, its cache merged into the batch cache at the slot, then
one ``decode_step`` for the whole batch.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --smoke \
      --device cpu --requests 16 --batch 4 --max-new 32

On a (data, model) mesh, one process a rank under ``torchrun`` (NCCL on
the GPU, gloo with ``--device cpu``; ``--data-axis`` ranks on ``data``,
the rest on ``model``; rank 0 alone prints):

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --arch olmo-1b \
      --smoke --device cpu --data-axis 1

Without ``--device`` it runs on the GPU, and raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get_config, get_smoke_config
from ..core.comm import mesh_device
from ..core.plan import Planner, resolve_device
from ..models.config import ShapeConfig
from ..models.lm import LM
from ..parallel import NamedSharding
from .specs import build_cell


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                   # (S,) int32
    max_new: int
    out: Optional[List[int]] = None


class ServeLoop:
    """Serves ``cfg`` with a decode batch of ``batch`` and caches of
    ``max_len`` positions. ``model`` is an already built ``LM`` of ``cfg``,
    served as it is (it is given ``planner`` when one is passed); without
    one the loop builds it from ``seed`` on ``device`` (None: the GPU) with
    ``planner`` and casts its matmul weights to the compute dtype once.
    ``next_token`` picks each request's next token (greedy).

    Every slot decodes at each step, an empty one token 0, as in the
    reference; a MoE layer's capacity counts the whole batch, so a
    request's tokens can depend on what the other slots hold.

    ``mesh``: a (data, model) ``DeviceMesh`` on which every rank of it
    runs the loop. The LM (a model given is whole) is placed by the rules
    of ``launch.specs.build_cell``'s decode cell of this batch and length
    on that mesh and profile, and decodes through its ``serve_step``
    (``num_groups`` = the data ranks); the batch cache is this rank's
    block. Every rank prefills every prompt (one MoE group) and keeps its
    block of the cache; each decode step's logits are gathered over the
    data ranks, so every rank picks every token. Where the data ranks
    split the batch, each prefill is thus run dp times, once on the row's
    owner and once on each rank that then drops the cache but picks the
    first token from it."""

    def __init__(self, cfg, batch: int, max_len: int, seed: int = 0,
                 prompt_bucket: int = 8, device=None,
                 planner: Optional[Planner] = None,
                 model: Optional[LM] = None, mesh=None):
        cell = None
        if mesh is not None:
            cell = build_cell(cfg, ShapeConfig("serve", max_len, batch,
                                               "decode"), mesh)
            cfg, device = cell.arch, mesh_device(mesh)
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        recurrent = any(k in ("mamba2", "mlstm", "slstm", "fftconv_mlp")
                        for k, _ in cfg.resolved_segments())
        # recurrent state would absorb pad tokens — exact lengths for those
        # (attention caches mask pads via "len", so buckets are safe there)
        self.prompt_bucket = 1 if recurrent else prompt_bucket
        if model is None:
            dev = resolve_device(device)
            # the reference casts each matmul weight to compute_dtype at
            # every use; casting once here gives the same values bit for bit
            model = LM(cfg, planner=planner, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(seed)
                       ).to_compute_dtype()
        elif planner is not None:
            model.planner = planner
        self.decode = lambda cache, tok: model.decode_step(cache, tok)
        if cell is not None:
            cell.place(model)
            self.decode = lambda cache, tok: cell.fn(model, cache, tok)
        self.mesh, self.rules = mesh, (cell.rules if cell else {})
        self.model = model
        self.device = model.device
        self.cache = model.init_cache(batch, max_len)
        # this rank's rows of the batch: [lo, lo + rows)
        self.rows = self.cache["len"].shape[0]
        self.lo = 0 if self.rows == batch else model.dp_rank * self.rows
        self.slots: List[Optional[Request]] = [None] * batch
        self.queue: List[Request] = []
        self.done: List[Request] = []

    def _merge(self, c1, i: int, true_len: int) -> None:
        """The one-sequence cache ``c1`` into slot ``i`` of the batch's:
        every layer's entry is a dict of tensors with the batch axis first
        (attention k/v and FFT-conv history in bf16, recurrent states in
        float32), each copied into row ``i``."""
        i -= self.lo
        if not 0 <= i < self.rows:
            return                           # another data rank's row
        for big, one in zip(self.cache["layers"], c1["layers"]):
            for name, t in one.items():
                big[name][i] = t[0]
        self.cache["len"][i] = true_len

    def next_token(self, req: Request, logits: torch.Tensor) -> int:
        """The token ``req`` takes from its logits row (V,): greedy."""
        return int(torch.argmax(logits))

    def submit(self, req: Request):
        req.out = []
        self.queue.append(req)

    def _admit(self):
        for i in range(self.batch):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                n = len(req.prompt)
                bucket = -(-n // self.prompt_bucket) * self.prompt_bucket
                prompt = np.zeros((1, bucket), np.int64)
                prompt[0, :n] = req.prompt
                # one prompt, one MoE group (on the data ranks' rows,
                # 1 / dp of each rank's share)
                split = self.model.seq_split(self.batch)
                groups = 1 if split else self.model.dp_size
                logits, c1 = self.model.prefill(
                    {"tokens": torch.from_numpy(prompt).to(self.device)},
                    self.max_len, groups, last_index=torch.tensor(
                        [n - 1], device=self.device),
                    global_batch=self.batch)
                # cache positions n..bucket-1 hold padding but "len"=n masks
                # them out of attention (recurrent archs use exact buckets)
                self._merge(c1, i, n)
                first = self.next_token(req, logits[0, 0])
                req.out.append(first)              # token #1 from prefill
                req._last = first
                if len(req.out) >= req.max_new:
                    self.done.append(req)
                    self.slots[i] = None

    def step(self):
        self._admit()
        tok = np.zeros((self.batch, 1), np.int64)
        for i, req in enumerate(self.slots):
            if req is not None:
                tok[i, 0] = req._last
        tok = tok[self.lo:self.lo + self.rows]
        logits, self.cache = self.decode(
            self.cache, {"tokens": torch.from_numpy(tok).to(self.device)})
        if self.rows < self.batch:
            logits = NamedSharding(self.mesh, (self.rules["dp"], None,
                                               None)).gather(logits)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            nxt = self.next_token(req, logits[i, 0])
            req.out.append(nxt)
            req._last = nxt
            if len(req.out) >= req.max_new:
                self.done.append(req)
                self.slots[i] = None

    def drain(self):
        while self.queue or any(s is not None for s in self.slots):
            self.step()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--data-axis", type=int, default=0,
                    help="under torchrun: the mesh's data-parallel size "
                         "(0 = all ranks)")
    args = ap.parse_args()

    from .mesh import make_local_mesh
    from .train import _start_ranks
    world, device = _start_ranks(args.device)
    mesh = None
    if world > 1:
        data = args.data_axis or world
        mesh = make_local_mesh(data=data, model=world // data)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rng = np.random.default_rng(0)
    loop = ServeLoop(cfg, args.batch, args.max_len, device=device, mesh=mesh)
    t0 = time.perf_counter()
    for r in range(args.requests):
        loop.submit(Request(r, rng.integers(
            0, cfg.vocab_size, args.prompt_len).astype(np.int32),
            args.max_new))
    loop.drain()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in loop.done)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps({"requests": len(loop.done),
                          "generated_tokens": toks,
                          "tok_per_s": round(toks / dt, 1),
                          "device": str(loop.device)}, indent=1))
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
