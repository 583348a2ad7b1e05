from .ops import complex_multiply
from .ref import complex_multiply_ref

__all__ = ["complex_multiply", "complex_multiply_ref"]
