from .ops import fftconv_fused, filter_spectrum_permuted
from .ref import fftconv_fused_ref, fftconv_fused_plain

__all__ = ["fftconv_fused", "filter_spectrum_permuted", "fftconv_fused_ref",
           "fftconv_fused_plain"]
