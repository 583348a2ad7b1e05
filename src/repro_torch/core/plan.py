"""FFTW-style planning for the matmul FFT.

Port of ``repro.core.plan``:

* ``estimate`` — analytic roofline cost model over candidate (factorization,
  backend) tuples, using a ``HardwareSpec``; O(us) planning.
* ``measured`` — run and time every finalist on the device (FFTW MEASURE)
  and keep the fastest. A candidate that fails raises: a kernel that does
  not build or launch is a fault to see, not a candidate to skip.
* wisdom — plans are cached by (n, kind, batch bucket, mode, permuted,
  backends, hardware) in a :class:`~repro_torch.core.wisdom.WisdomStore`,
  optionally persisted to a JSON file, exactly like FFTW wisdom.

Backends: ``torch`` / ``torch_karatsuba`` run the four-step algorithm on
``torch.matmul``; ``hopper`` / ``hopper_karatsuba`` run the hand-written
four-step CUDA kernel for two-factor c2c plans (the r2c/c2r pack glue and
longer factorizations take the matmul path, as in the reference), and
their c2c candidates are the two-factor splits wherever ``n`` has one, so
the estimate cannot price the kernel out of its own backend;
``torch_native`` is ``torch.fft``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.dft_matmul import ops as dft_ops
from . import algo
from .wisdom import WisdomStore, batch_bucket

# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; without one this raises instead of quietly
    running on the CPU. Pass ``device="cpu"`` to run the plain versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU unless asked otherwise, and no "
                "CUDA device is available; pass device='cpu' to run on the "
                "CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# hardware profiles (roofline constants)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    flops: float          # peak FLOP/s (f32 matmul units)
    hbm_bw: float         # bytes/s main-memory bandwidth
    link_bw: float        # bytes/s per interconnect link
    matmul_dim: int       # native matmul tile
    vmem_bytes: int       # fast scratch (shared memory / L2)
    collective_lat: float  # seconds charged per collective call
    # Share of its radix-FFT bound, max(5*B*n*log2(n) / flops,
    # 16*B*n / hbm_bw), that the hand-written four-step kernel reaches. When
    # set, a kernel pass (a two-factor c2c plan of a hopper backend) is
    # priced as that bound over this share, and the N-D and comm rooflines
    # charge each stage the planner's own 1D price. 0 keeps the reference's
    # dense four-step pricing (2*muls*n*sum(factors) flops a row) throughout.
    fft_share: float = 0.0
    # True: the reference's rule, in which a chunked exchange hides behind
    # the DFT stages and pipelined wins once the wire passes 20% of their
    # compute. False: the port's PipelinedBackend, which overlaps a chunk's
    # wire only with the packing of the chunks after it, priced against the
    # calls and the concatenating copy it adds (comm._pipelined_saving).
    pipelined_hides_compute: bool = True


# flops and hbm_bw measured by `python -m repro_torch.calibrate` on an
# "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi name, power.limit): float32
# torch.matmul 8192^3 with TF32 off, and a 1 GiB device-to-device copy
# (bytes read + written). link_bw is NVLink's published 450 GB/s each way;
# matmul_dim is the register tile (8 columns) of the four-step kernel's
# dense first design, which still prices the torch.matmul plans; vmem_bytes
# is the 50 MB L2. fft_share is the four-step kernel's share of its bound
# at these flops and hbm_bw at (8193, 16384), (128, 128), for the kernel
# of persistent CTAs staging the next row by TMA: the median of 3 runs of
# `python -m repro_torch.calibrate` on one card of that kind,
# four_step_share 0.5957-0.6142 (1.176-1.212 ms; the design before it
# reached 0.4948-0.5323 on 5 cards). collective_lat
# is the cost of one NCCL all_to_all_single call of 1 KiB across 4
# NVLink-connected cards of that kind, where the verdicts at p > 1 are
# made: the median of 5 runs of 200 calls, 49.88-77.90 us
# (scripts/dist_times.py); at world size 1 single runs gave 38.87-144.40
# us. The host's dispatch, not the wire, sets it. The port's pipelined
# exchange overlaps no DFT pass.
H100 = HardwareSpec("h100", flops=51.33e12, hbm_bw=2.974e12, link_bw=450e9,
                    matmul_dim=8, vmem_bytes=50 * 2 ** 20,
                    collective_lat=5.240e-5, fft_share=0.6119,
                    pipelined_hides_compute=False)
# collective_lat: one gloo all_to_all_single call of 1 KiB at world size 1
# on an 8-core x86-64 CPU (`python -m repro_torch.calibrate --gloo`, the
# middle of three runs of 25.0-28.7 us); the other constants, its pricing
# and its pipelined rule are the reference's CPU profile.
CPU_LOCAL = HardwareSpec("cpu_local", flops=5e9, hbm_bw=20e9, link_bw=1e9,
                         matmul_dim=8, vmem_bytes=32 * 2 ** 20,
                         collective_lat=2.68e-5)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

BACKENDS = ("torch", "torch_karatsuba", "hopper", "hopper_karatsuba",
            "torch_native")


@dataclasses.dataclass(frozen=True)
class Plan:
    """A 1D FFT recipe (FFTW: one plan per transform length)."""
    n: int
    kind: str                       # "c2c" | "r2c" | "c2r"
    factors: Tuple[int, ...]
    backend: str                    # one of BACKENDS
    permuted: bool = False          # skip digit transpose (conv pipelines)
    est_cost: float = 0.0           # seconds, from the cost model
    measured_cost: float = -1.0     # seconds, if mode == "measured"

    @property
    def karatsuba(self) -> bool:
        return self.backend.endswith("karatsuba")

    def flops(self, batch: int) -> float:
        """Real-MAC flop count for one batched apply."""
        if self.backend == "torch_native":
            return 5.0 * batch * self.n * max(np.log2(self.n), 1)
        n_eff = self.n // 2 if self.kind in ("r2c", "c2r") else self.n
        muls = 3 if self.karatsuba else 4
        return 2.0 * muls * batch * n_eff * sum(self.factors)

    def bytes_moved(self, batch: int) -> float:
        """HBM traffic estimate: each four-step stage reads+writes the array."""
        n_eff = self.n // 2 if self.kind in ("r2c", "c2r") else self.n
        passes = max(len(self.factors), 1) + (0 if self.permuted else 1)
        return 2.0 * passes * batch * n_eff * 8.0  # (re, im) f32


def _candidate_factorizations(n: int, max_base: int) -> Sequence[Tuple[int, ...]]:
    """All 1/2/3-way splits with every factor <= max_base (dedup, sorted)."""
    cands = set()
    if n <= max_base:
        cands.add((n,))
    for f1 in range(2, max_base + 1):
        if n % f1:
            continue
        r1 = n // f1
        if r1 <= max_base:
            cands.add(tuple(sorted((f1, r1), reverse=True)))
        for f2 in range(2, max_base + 1):
            if r1 % f2:
                continue
            r2 = r1 // f2
            if r2 <= max_base:
                cands.add(tuple(sorted((f1, f2, r2), reverse=True)))
    return sorted(cands)


class Planner:
    """Creates and caches plans. ``mode``: "estimate" | "measured".
    ``device`` is where measured mode times its candidates (None: the GPU)."""

    def __init__(self, hardware: HardwareSpec = H100,
                 mode: str = "estimate", max_base: int = 128,
                 wisdom_path: Optional[str] = None,
                 backends: Sequence[str] = ("torch",),
                 wisdom: Optional[WisdomStore] = None, device=None):
        if mode not in ("estimate", "measured"):
            raise ValueError(f"mode must be estimate or measured: {mode!r}")
        unknown = set(backends) - set(BACKENDS)
        if unknown:
            raise ValueError(f"unknown backends {sorted(unknown)}; "
                             f"choose from {BACKENDS}")
        self.hw = hardware
        self.mode = mode
        self.max_base = max_base
        self.backends = tuple(backends)
        self.device = device
        # a shared store may be passed in; otherwise open/create our own
        self.wisdom = wisdom if wisdom is not None else WisdomStore(wisdom_path)
        self.wisdom_path = self.wisdom.path
        self.last_plan_seconds: float = 0.0

    # -- FFTW-style wisdom API -----------------------------------------------

    def export_wisdom(self) -> str:
        return self.wisdom.export_wisdom()

    def import_wisdom(self, text: str, replace: bool = False) -> int:
        return self.wisdom.import_wisdom(text, replace=replace)

    def forget_wisdom(self, prefix: str = "") -> int:
        return self.wisdom.forget_wisdom(prefix)

    def wisdom_key(self, n: int, kind: str = "c2c", batch: int = 1,
                   permuted: bool = False) -> str:
        """The ``plan/*`` wisdom key :meth:`plan` reads and writes."""
        return (f"plan/{n}/{kind}/b{batch_bucket(batch)}/{self.mode}/"
                f"{permuted}/{','.join(self.backends)}/{self.hw.name}")

    # -- cost model ---------------------------------------------------------

    def _estimate_seconds(self, plan: Plan, batch: float) -> float:
        hw = self.hw
        if hw.fft_share and runs_the_kernel(plan):
            n = plan.n
            bound = max(5.0 * batch * n * max(np.log2(n), 1) / hw.flops,
                        16.0 * batch * n / hw.hbm_bw)
            return bound / hw.fft_share
        t_compute = plan.flops(batch) / hw.flops
        t_mem = plan.bytes_moved(batch) / hw.hbm_bw
        # matmul efficiency penalty: factors far below the tile waste lanes
        if plan.backend != "torch_native" and plan.factors:
            util = min(min(plan.factors) / hw.matmul_dim, 1.0)
            t_compute = t_compute / max(util, 1 / hw.matmul_dim)
        return max(t_compute, t_mem)

    def stage_seconds(self, n: int, kind: str = "c2c",
                      batch: float = 1) -> float:
        """Estimated seconds of the cheapest 1D candidate of length ``n``
        over ``batch`` rows (inf where none exists): the price of one stage
        in the N-D and comm rooflines of a profile with ``fft_share``."""
        return min((self._estimate_seconds(p, batch)
                    for p in self._candidates(n, kind, False)),
                   default=float("inf"))

    # -- plan construction ---------------------------------------------------

    def _candidates(self, n: int, kind: str, permuted: bool):
        n_eff = n // 2 if kind in ("r2c", "c2r") else n
        facs = _candidate_factorizations(n_eff, self.max_base)
        two = [f for f in facs if len(f) == 2]
        for backend in self.backends:
            if backend == "torch_native":
                yield Plan(n, kind, (), backend)
                continue
            mine = facs
            if permuted:
                mine = two
            elif backend.startswith("hopper") and kind == "c2c" and two:
                # the kernel takes only two-factor c2c splits (see execute):
                # a cheaper-looking other split would leave it unused
                mine = two
            for fac in mine:
                yield Plan(n, kind, fac, backend, permuted=permuted)

    def plan(self, n: int, kind: str = "c2c", batch: int = 1,
             permuted: bool = False) -> Plan:
        key = self.wisdom_key(n, kind, batch, permuted)
        w = self.wisdom.get(key)
        if w is not None:
            self.last_plan_seconds = 0.0
            return Plan(n, kind, tuple(w["factors"]), w["backend"], permuted,
                        w.get("est", 0.0), w.get("measured", -1.0))
        t0 = time.perf_counter()
        cands = [dataclasses.replace(p, est_cost=self._estimate_seconds(p, batch))
                 for p in self._candidates(n, kind, permuted)]
        if not cands:
            raise ValueError(f"no plan candidates for n={n} ({kind})")
        cands.sort(key=lambda p: p.est_cost)
        if self.mode == "estimate":
            best = cands[0]
        else:
            best = self._measure(cands[: min(len(cands), 12)], n, kind, batch)
        self.last_plan_seconds = time.perf_counter() - t0
        self.wisdom.put(key, {"factors": list(best.factors),
                              "backend": best.backend,
                              "est": best.est_cost,
                              "measured": best.measured_cost})
        return best

    # -- measured planning (FFTW MEASURE) -------------------------------------

    def _measure(self, cands: Sequence[Plan], n: int, kind: str,
                 batch: int, reps: int = 3) -> Plan:
        dev = resolve_device(self.device)
        if kind == "c2c":
            probe = (torch.ones((batch, n), device=dev),
                     torch.zeros((batch, n), device=dev))
        elif kind == "r2c":
            probe = torch.ones((batch, n), device=dev)
        else:
            probe = (torch.ones((batch, n // 2 + 1), device=dev),
                     torch.zeros((batch, n // 2 + 1), device=dev))
        best, best_t = None, float("inf")
        for p in cands:
            execute(p, probe)                   # warm-up (and kernel build)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                execute(p, probe)
            _sync(dev)
            dt = (time.perf_counter() - t0) / reps
            if dt < best_t:
                best, best_t = p, dt
        return dataclasses.replace(best, measured_cost=best_t)


# ---------------------------------------------------------------------------
# plan execution
# ---------------------------------------------------------------------------


def runs_the_kernel(plan: Plan) -> bool:
    """Whether :func:`execute` runs ``plan`` on the four-step kernel."""
    return (plan.backend.startswith("hopper") and plan.kind == "c2c"
            and len(plan.factors) == 2)


def execute(plan: Plan, x):
    """Apply a plan along the last axis. c2c takes/returns an (re, im) pair;
    r2c takes a real tensor and returns a pair; c2r the reverse."""
    if plan.backend == "torch_native":
        if plan.kind == "c2c":
            return algo.to_pair(torch.fft.fft(algo.to_complex(x)))
        if plan.kind == "r2c":
            return algo.to_pair(torch.fft.rfft(x.float()))
        return torch.fft.irfft(algo.to_complex(x)).float()

    if runs_the_kernel(plan):
        # the kernel covers the two-factor c2c hot loop; the r2c pack/unpack
        # glue and longer factorizations take the matmul path below
        return dft_ops.fft_four_step(x, plan.factors,
                                     karatsuba=plan.karatsuba,
                                     permuted=plan.permuted)

    opts = dict(factors=plan.factors or None, karatsuba=plan.karatsuba)
    if plan.kind == "c2c":
        return algo.fft(x, permuted=plan.permuted, **opts)
    if plan.kind == "r2c":
        return algo.rfft(x, **opts)
    if plan.kind == "c2r":
        return algo.irfft(x, **opts)
    raise ValueError(plan.kind)


def execute_inverse(plan: Plan, x):
    """Inverse transform matching ``plan`` (c2c only)."""
    if plan.kind != "c2c":
        raise ValueError(f"execute_inverse takes c2c plans, got {plan.kind}")
    if plan.backend == "torch_native":
        return algo.to_pair(torch.fft.ifft(algo.to_complex(x)))
    if plan.permuted:
        return algo.ifft_from_permuted(x, factors=plan.factors,
                                       karatsuba=plan.karatsuba)
    return algo.ifft(x, factors=plan.factors or None, karatsuba=plan.karatsuba)
