"""The planned N-D FFT on one device, ported from ``repro.core``."""

from . import algo, api, comm, dfft, plan, wisdom
from .algo import fft, fft2, ifft, irfft, rfft, rfft2, to_complex, to_pair
from .api import (NdPlan, execute_nd, execute_nd_inverse, fftn, ifftn,
                  irfftn, plan_nd, rfftn)
from .comm import pad_to
from .plan import (CPU_LOCAL, H100, HardwareSpec, Plan, Planner, execute,
                   execute_inverse)
from .wisdom import WisdomStore

__all__ = [
    "algo", "api", "comm", "dfft", "plan", "wisdom",
    "fft", "ifft", "rfft", "irfft", "fft2", "rfft2",
    "to_pair", "to_complex",
    "NdPlan", "plan_nd", "execute_nd", "execute_nd_inverse",
    "fftn", "ifftn", "rfftn", "irfftn",
    "pad_to", "WisdomStore",
    "HardwareSpec", "Plan", "Planner", "execute", "execute_inverse",
    "H100", "CPU_LOCAL",
]
