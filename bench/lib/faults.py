"""Faults planted in the port's FFT path underneath the timed call, for
the test that sees a cell's ``correct`` come out false, and for reading
the numbers a fault gives. Each replaces a function of the port for the
length of a ``with`` block; none runs in a benchmark run.

* ``state_unchanged``: the forward transform returns its input;
* ``half_batch``: the second half of the rows of each forward output is
  left out (zero);
* ``answer_altered``: one value of each forward output is changed where
  it is produced;
* ``exchange_left_out``: every exchange backend packs and unpacks as
  before but sends nothing: each rank keeps its own blocks.
"""

from __future__ import annotations

import contextlib

import torch

FFT_FAULTS = ("state_unchanged", "half_batch", "answer_altered")
DIST_FAULTS = FFT_FAULTS + ("exchange_left_out",)


@contextlib.contextmanager
def planted(name):
    """Plant fault ``name`` (None: nothing) in ``repro_torch``."""
    if name is None:
        yield
        return
    from repro_torch.core import api, comm
    orig_fwd = api.execute_nd
    backends = (comm.CollectiveBackend, comm.PipelinedBackend,
                comm.AgasBackend)
    orig_ex = [b.exchange for b in backends]

    def unchanged(plan, x, *args, **kwargs):
        out = orig_fwd(plan, x, *args, **kwargs)
        src = x if isinstance(x, tuple) else (x, torch.zeros_like(x))
        # the input's values in the output's place (a block's shape may
        # differ: the leading values, zeros past the input's end)
        got = []
        for s, o in zip(src, out):
            flat = torch.zeros(o.numel(), dtype=o.dtype, device=o.device)
            n = min(o.numel(), s.numel())
            flat[:n] = s.reshape(-1)[:n]
            got.append(flat.view(o.shape))
        return tuple(got)

    def half(plan, x, *args, **kwargs):
        out = orig_fwd(plan, x, *args, **kwargs)
        for t in out:
            t.narrow(-2, t.shape[-2] // 2, t.shape[-2] - t.shape[-2] // 2
                     ).zero_()
        return out

    def altered(plan, x, *args, **kwargs):
        out = orig_fwd(plan, x, *args, **kwargs)
        at = tuple(n // 3 for n in out[0].shape)
        out[0][at] += 1.0 + 10 * out[0].abs().max()
        return out

    def kept(self, c, group, *, split, concat, p):
        return tuple(comm._unlead(comm._lead(a, split, p), concat)
                     for a in c)

    if name == "exchange_left_out":
        for b in backends:
            b.exchange = kept
    else:
        api.execute_nd = {"state_unchanged": unchanged, "half_batch": half,
                          "answer_altered": altered}[name]
    try:
        yield
    finally:
        api.execute_nd = orig_fwd
        for b, ex in zip(backends, orig_ex):
            b.exchange = ex
