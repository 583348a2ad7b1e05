"""The paper's shared-memory 2D-FFT implementation variants (§3.3, Fig. 1).

Port of ``repro.core.variants``. Each variant computes the SAME transform,
the r2c 2D FFT of a real N x M matrix (r2c along the contiguous rows, c2c
along the columns), with a different task and synchronization structure.
The HPX concepts map to the card as:

  hpx::for_loop (bulk sync)   ->  whole-array passes: the planned 1D
                                  transforms and the tiled transpose kernel
  global sync barrier         ->  ``torch.cuda.current_stream().synchronize()``
                                  (eager PyTorch already materializes every
                                  step, so what a barrier costs is the host
                                  stall it forces)
  HPX fine-grained task       ->  one chunk of ``task_size`` rows: a Python
                                  loop of chunked launches on the current
                                  stream, each task tens of launches
  future dependency chain     ->  per-chunk compute, then a strided scatter
  AGAS implicit data movement ->  ``torch.take`` through int64 global index
                                  tables built on the device in every call

On the card the task overhead of the paper becomes host time per launch,
which shows as device idle time. Every function takes ``device=None``
(the GPU; raises without one) or ``device="cpu"``, moves ``x`` there as
float32, plans its row and column plans once per call, and returns a
contiguous ``(re, im)`` pair of shape ``(N, M//2 + 1)``.
"""

from __future__ import annotations

import torch

from ..kernels.transpose import transpose
from . import algo
from .plan import Plan, Planner, execute, resolve_device

Complex = algo.Complex

__all__ = ["VARIANTS", "fft2_for_loop", "fft2_future_sync",
           "fft2_future_naive", "fft2_future_opt", "fft2_future_agas",
           "fft2_strided", "run_variant", "staged_for_loop",
           "shrink_task_size"]

VARIANTS = ("future_naive", "future_opt", "future_sync", "future_agas",
            "for_loop")


def _row_plan(planner: Planner, m: int) -> Plan:
    return planner.plan(m, kind="r2c")


def _col_plan(planner: Planner, n: int) -> Plan:
    return planner.plan(n, kind="c2c")


def _input(x, device):
    dev = resolve_device(device)
    return torch.as_tensor(x).to(device=dev, dtype=torch.float32), dev


def _barrier(device: torch.device) -> None:
    """Global synchronization barrier (the 'join all futures' of the
    paper): the host waits for every launch queued so far."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _transpose_pair(c: Complex) -> Complex:
    return transpose(c[0]), transpose(c[1])


def shrink_task_size(n: int, task_size: int) -> int:
    """The reference's rule: the task size, capped at ``n``, shrunk to the
    largest divisor of ``n`` not above it."""
    ts = max(1, min(task_size, n))
    while n % ts:
        ts -= 1
    return ts


# ---------------------------------------------------------------------------
# variant: for_loop — the paper's winner (bulk-synchronous)
# ---------------------------------------------------------------------------


def fft2_for_loop(x, planner: Planner, device=None) -> Complex:
    """hpx::experimental::for_loop analogue: whole-array bulk passes, the
    same passes as ``api.rfftn``'s ``local`` path."""
    x, _ = _input(x, device)
    n, m = x.shape
    y = execute(_row_plan(planner, m), x)                       # r2c rows
    z = execute(_col_plan(planner, n), _transpose_pair(y))      # c2c rows
    return _transpose_pair(z)                                   # back


# ---------------------------------------------------------------------------
# variant: future_sync — barrier after EVERY algorithmic step
# ---------------------------------------------------------------------------


def fft2_future_sync(x, planner: Planner, device=None) -> Complex:
    """:func:`fft2_for_loop` with a barrier after the rows, the transpose
    and the columns: three host waits on the stream."""
    x, dev = _input(x, device)
    n, m = x.shape
    y = execute(_row_plan(planner, m), x)
    _barrier(dev)
    yt = _transpose_pair(y)
    _barrier(dev)
    z = execute(_col_plan(planner, n), yt)
    _barrier(dev)
    return _transpose_pair(z)


# ---------------------------------------------------------------------------
# chunked "futurized" variants — task_size rows per task
# ---------------------------------------------------------------------------


def _chunked_rfft(x: torch.Tensor, plan: Plan, task_size: int) -> Complex:
    """One task per chunk of rows, each written into a preallocated pair."""
    n, m = x.shape
    ts = shrink_task_size(n, task_size)
    re = x.new_empty((n, m // 2 + 1))
    im = torch.empty_like(re)
    for i in range(0, n, ts):
        fre, fim = execute(plan, x[i:i + ts])
        re[i:i + ts].copy_(fre)
        im[i:i + ts].copy_(fim)
    return re, im


def fft2_future_naive(x, planner: Planner, task_size: int = 8,
                      device=None) -> Complex:
    """Naive futurization (paper: 'postpone or remove synchronization').

    Each FFT task's dependent transpose task immediately scatters its rows
    into the *columns* of the transposed buffer: a strided, cache-hostile
    write by torch's copy, not the tiled transpose kernel (which takes
    contiguous blocks only, so a strided block would add a hidden gather).
    No barrier between FFT and transpose.
    """
    x, _ = _input(x, device)
    n, m = x.shape
    mh = m // 2 + 1
    ts = shrink_task_size(n, task_size)
    row_plan = _row_plan(planner, m)
    tre = x.new_empty((mh, n))
    tim = torch.empty_like(tre)
    for i in range(0, n, ts):
        fre, fim = execute(row_plan, x[i:i + ts])               # FFT task
        tre[:, i:i + ts].copy_(fre.T)                           # scatter task
        tim[:, i:i + ts].copy_(fim.T)
    z = execute(_col_plan(planner, n), (tre, tim))
    return _transpose_pair(z)


def fft2_future_opt(x, planner: Planner, task_size: int = 8,
                    device=None) -> Complex:
    """Optimized transpose (paper §3.2): the barrier is moved BEFORE the
    transpose, so transpose tasks WRITE contiguous memory (each task
    gathers strided reads but writes one contiguous row-block of the
    transposed buffer)."""
    x, dev = _input(x, device)
    n, m = x.shape
    mh = m // 2 + 1
    y = _chunked_rfft(x, _row_plan(planner, m), task_size)
    _barrier(dev)                                               # moved barrier
    ts = shrink_task_size(mh, task_size)
    tre = x.new_empty((mh, n))
    tim = torch.empty_like(tre)
    for j in range(0, mh, ts):
        # write-contiguous block (ts, n) of the transposed matrix
        tre[j:j + ts].copy_(y[0][:, j:j + ts].T)
        tim[j:j + ts].copy_(y[1][:, j:j + ts].T)
    z = execute(_col_plan(planner, n), (tre, tim))
    return _transpose_pair(z)


# ---------------------------------------------------------------------------
# variant: future_agas — implicit global-address-space data movement
# ---------------------------------------------------------------------------


def fft2_future_agas(x, planner: Planner, device=None) -> Complex:
    """AGAS analogue: data 'moves' by resolving global indices through an
    address table (gather), instead of a direct transpose copy. The index
    arithmetic, redone in every call as the reference's traced code does,
    plus the gathers are the measurable AGAS overhead of Fig. 1."""
    x, dev = _input(x, device)
    n, m = x.shape
    mh = m // 2 + 1
    y = execute(_row_plan(planner, m), x)
    k = torch.arange(mh * n, device=dev)
    # global address table: flat_transposed[i] lives at flat[src[i]]
    src = (k % n) * mh + k // n
    yt = (torch.take(y[0], src).view(mh, n),
          torch.take(y[1], src).view(mh, n))
    del src
    z = execute(_col_plan(planner, n), yt)
    dst = (k % mh) * n + k // mh
    return (torch.take(z[0], dst).view(n, mh),
            torch.take(z[1], dst).view(n, mh))


# ---------------------------------------------------------------------------
# strided (no-transpose) column FFT — the paper's §3.2 'strided access' option
# ---------------------------------------------------------------------------


def fft2_strided(x, planner: Planner, device=None) -> Complex:
    """Keep the row-major layout and run the column pass on a moved-axis
    view, with no explicit transpose. The four-step op makes that view
    contiguous (torch's generic strided copy, not the tiled kernel), and
    the result is made contiguous the same way."""
    x, _ = _input(x, device)
    n, m = x.shape
    y = execute(_row_plan(planner, m), x)                       # (n, mh)
    z = execute(_col_plan(planner, n),
                (y[0].movedim(0, -1), y[1].movedim(0, -1)))
    return (z[0].movedim(-1, 0).contiguous(),
            z[1].movedim(-1, 0).contiguous())


def run_variant(name: str, x, planner: Planner, task_size: int = 8,
                device=None) -> Complex:
    """Run the variant ``name`` (one of ``VARIANTS`` or ``"strided"``);
    ``task_size`` is the chunked variants' rows (columns) a task."""
    if name == "future_naive":
        return fft2_future_naive(x, planner, task_size, device=device)
    if name == "future_opt":
        return fft2_future_opt(x, planner, task_size, device=device)
    if name == "future_sync":
        return fft2_future_sync(x, planner, device=device)
    if name == "future_agas":
        return fft2_future_agas(x, planner, device=device)
    if name == "for_loop":
        return fft2_for_loop(x, planner, device=device)
    if name == "strided":
        return fft2_strided(x, planner, device=device)
    raise ValueError(f"unknown variant {name!r}; options: {VARIANTS + ('strided',)}")


# ---------------------------------------------------------------------------
# instrumented decomposition (paper Fig. 2): per-stage timings
# ---------------------------------------------------------------------------


def staged_for_loop(x, planner: Planner, device=None):
    """The four passes of :func:`fft2_for_loop` as separate callables, so
    fft1 / transpose / fft2 / transpose-back can be timed alone (Fig. 2).
    ``x`` gives the shape; the first stage takes the real input."""
    dev = resolve_device(device)
    n, m = torch.as_tensor(x).shape
    row_plan, col_plan = _row_plan(planner, m), _col_plan(planner, n)
    return [("fft_r2c_rows", lambda a: execute(row_plan, _input(a, dev)[0])),
            ("transpose", _transpose_pair),
            ("fft_c2c_cols", lambda c: execute(col_plan, c)),
            ("transpose_back", _transpose_pair)]
