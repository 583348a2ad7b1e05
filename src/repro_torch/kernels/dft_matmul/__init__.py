from .ops import fft_four_step
from .ref import fft_four_step_ref

__all__ = ["fft_four_step", "fft_four_step_ref"]
