"""PyTorch/CUDA port of the planned N-D FFT (``repro``'s JAX package is the
reference). Entry points run on the GPU unless given ``device="cpu"``."""

from .core import *  # noqa: F401,F403
from .core import __all__
