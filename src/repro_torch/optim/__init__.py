"""The optimizer-side collectives of the port, from ``repro.optim`` (so far
the int8 compressed all-reduce; AdamW comes with the model stack)."""

from .compress import (choose_psum_comm, compressed_psum, dequantize_int8,
                       quantize_int8)

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum",
           "choose_psum_comm"]
