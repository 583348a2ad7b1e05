"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``), which the CPU path and the tests use:

  dft_matmul — fused four-step FFT (DFT_n1, twiddle, DFT_n2 in one kernel)
  transpose  — shared-memory tiled transpose, for the moves between the
               dimension passes of the N-D FFT
  twiddle    — elementwise complex multiply, the spectral product of the
               FFT convolution
  fftconv    — fused FFT convolution (forward four-step, filter product,
               inverse from permuted order, in one kernel)

CUDA sources build at first use (``_build``); nothing builds at import.
The kernels record nothing for autograd, so a wrapper handed a CUDA tensor
that requires grad raises while autograd is on (``_grad``); ``fft_conv``
carries its own backward over them.
"""

from .dft_matmul import fft_four_step, fft_four_step_ref
from .dft_matmul import ops as _dft_ops
from .fftconv import fftconv_fused, fftconv_fused_ref
from .fftconv import ops as _fftconv_ops
from .transpose import transpose, transpose_ref
from .transpose import ops as _transpose_ops
from .twiddle import complex_multiply, complex_multiply_ref
from .twiddle import ops as _twiddle_ops

__all__ = ["fft_four_step", "fft_four_step_ref", "transpose",
           "transpose_ref", "complex_multiply", "complex_multiply_ref",
           "fftconv_fused", "fftconv_fused_ref", "launch_counts",
           "reset_launch_counts"]

_OPS = {"four_step_fft": _dft_ops, "batched_transpose": _transpose_ops,
        "complex_multiply": _twiddle_ops, "fftconv_fused": _fftconv_ops}


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    return {name: op.LAUNCHES for name, op in _OPS.items()}


def reset_launch_counts() -> None:
    for op in _OPS.values():
        op.LAUNCHES = 0
