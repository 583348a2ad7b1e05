"""The optimizer of the port, from ``repro.optim``: AdamW with its cosine
schedule and clipping, and the int8 compressed all-reduce."""

from .adamw import (AdamWConfig, adamw_init, adamw_update, cosine_schedule,
                    global_norm, opt_meta)
from .compress import (choose_psum_comm, compressed_psum, dequantize_int8,
                       quantize_int8)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "opt_meta", "quantize_int8", "dequantize_int8",
           "compressed_psum", "choose_psum_comm"]
