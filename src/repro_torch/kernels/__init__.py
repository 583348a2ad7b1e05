"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``), which the CPU path and the tests use:

  dft_matmul — fused four-step FFT (DFT_n1, twiddle, DFT_n2 in one kernel)
  transpose  — shared-memory tiled transpose, for the moves between the
               dimension passes of the N-D FFT

CUDA sources build at first use (``_build``); nothing builds at import.
"""

from .dft_matmul import fft_four_step, fft_four_step_ref
from .dft_matmul import ops as _dft_ops
from .transpose import transpose, transpose_ref
from .transpose import ops as _transpose_ops

__all__ = ["fft_four_step", "fft_four_step_ref", "transpose",
           "transpose_ref", "launch_counts", "reset_launch_counts"]


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    return {"four_step_fft": _dft_ops.LAUNCHES,
            "batched_transpose": _transpose_ops.LAUNCHES}


def reset_launch_counts() -> None:
    _dft_ops.LAUNCHES = 0
    _transpose_ops.LAUNCHES = 0
