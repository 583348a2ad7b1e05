"""The planned N-D FFT (on one device or distributed over a
``torch.distributed`` mesh), the FFT convolution (sharded over the
sequence too) and the paper's shared-memory variants, ported from
``repro.core``: every name it exports but ``compat`` (JAX version shims)
and ``TPU_V5E``."""

from . import algo, api, comm, dfft, fftconv, plan, variants, wisdom
from .algo import fft, fft2, ifft, irfft, rfft, rfft2, to_complex, to_pair
from .api import (PLAN_ND_STATS, NdPlan, execute_nd, execute_nd_inverse,
                  fftn, ifftn, irfftn, plan_nd, rfftn)
from .comm import (COMM_BACKENDS, MEASURE_STATS, AgasBackend,
                   CollectiveBackend, CommBackend, PipelinedBackend,
                   forget_measurements, get_backend, make_mesh, measure_comm,
                   measure_comm_conv, measure_comm_factor1d,
                   measure_comm_gather, measure_comm_pencil,
                   measure_comm_pencil_nd, measure_comm_slab,
                   measure_comm_slab_nd, pad_to, plan_comm, plan_comm_conv,
                   plan_comm_factor1d, plan_comm_gather, plan_comm_pencil,
                   plan_comm_pencil_nd, plan_comm_slab_nd,
                   resolve_axis_backends)
from .dfft import (collect, distribute, execute_factor1d,
                   execute_factor1d_inverse, execute_pencil,
                   execute_pencil_inverse, execute_slab, execute_slab_inverse,
                   fft2_slab, fft3_pencil, ifft2_slab, ifft3_pencil,
                   irfft3_pencil, rfft3_pencil)
from .fftconv import (factor_split, fft_conv, fft_conv_seq_sharded,
                      materialize_filter)
from .plan import (CPU_LOCAL, H100, HardwareSpec, Plan, Planner, execute,
                   execute_inverse)
from .variants import VARIANTS, run_variant
from .wisdom import WisdomStore

__all__ = [
    "algo", "api", "comm", "dfft", "fftconv", "plan", "variants", "wisdom",
    "fft", "ifft", "rfft", "irfft", "fft2", "rfft2",
    "to_pair", "to_complex",
    "NdPlan", "plan_nd", "execute_nd", "execute_nd_inverse",
    "fftn", "ifftn", "rfftn", "irfftn", "PLAN_ND_STATS",
    "COMM_BACKENDS", "CommBackend", "CollectiveBackend", "PipelinedBackend",
    "AgasBackend", "get_backend", "resolve_axis_backends", "pad_to",
    "make_mesh",
    "plan_comm", "plan_comm_slab_nd", "plan_comm_pencil",
    "plan_comm_pencil_nd", "plan_comm_conv", "plan_comm_factor1d",
    "plan_comm_gather",
    "measure_comm", "measure_comm_slab", "measure_comm_slab_nd",
    "measure_comm_pencil", "measure_comm_pencil_nd", "measure_comm_conv",
    "measure_comm_factor1d", "measure_comm_gather", "MEASURE_STATS",
    "forget_measurements",
    "execute_slab", "execute_slab_inverse",
    "execute_pencil", "execute_pencil_inverse",
    "execute_factor1d", "execute_factor1d_inverse",
    "fft2_slab", "ifft2_slab",
    "fft3_pencil", "ifft3_pencil", "rfft3_pencil", "irfft3_pencil",
    "distribute", "collect",
    "WisdomStore",
    "fft_conv", "fft_conv_seq_sharded", "factor_split", "materialize_filter",
    "HardwareSpec", "Plan", "Planner", "execute", "execute_inverse",
    "H100", "CPU_LOCAL",
    "VARIANTS", "run_variant",
]
