from .ops import transpose
from .ref import transpose_ref

__all__ = ["transpose", "transpose_ref"]
