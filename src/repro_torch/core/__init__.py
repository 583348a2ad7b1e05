"""The planned N-D FFT, the FFT convolution and the paper's shared-memory
variants on one device, ported from ``repro.core``."""

from . import algo, api, comm, dfft, fftconv, plan, variants, wisdom
from .algo import fft, fft2, ifft, irfft, rfft, rfft2, to_complex, to_pair
from .api import (NdPlan, execute_nd, execute_nd_inverse, fftn, ifftn,
                  irfftn, plan_nd, rfftn)
from .comm import pad_to
from .fftconv import factor_split, fft_conv, materialize_filter
from .plan import (CPU_LOCAL, H100, HardwareSpec, Plan, Planner, execute,
                   execute_inverse)
from .variants import VARIANTS, run_variant
from .wisdom import WisdomStore

__all__ = [
    "algo", "api", "comm", "dfft", "fftconv", "plan", "variants", "wisdom",
    "fft", "ifft", "rfft", "irfft", "fft2", "rfft2",
    "to_pair", "to_complex",
    "NdPlan", "plan_nd", "execute_nd", "execute_nd_inverse",
    "fftn", "ifftn", "rfftn", "irfftn",
    "pad_to", "WisdomStore",
    "fft_conv", "factor_split", "materialize_filter",
    "HardwareSpec", "Plan", "Planner", "execute", "execute_inverse",
    "H100", "CPU_LOCAL",
    "VARIANTS", "run_variant",
]
