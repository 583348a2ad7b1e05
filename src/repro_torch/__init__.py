"""PyTorch/CUDA port of the planned N-D FFT and of the LM that serves and
trains with it (``repro``'s JAX package is the reference). Entry points run
on the GPU unless given ``device="cpu"``."""

from .core import *  # noqa: F401,F403
from .core import __all__ as _core_all
from .launch.serve import Request, ServeLoop
from .models import LM

__all__ = list(_core_all) + ["LM", "Request", "ServeLoop"]
