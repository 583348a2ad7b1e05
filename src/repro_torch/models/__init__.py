"""The model blocks of the port that use the FFT, ported from
``repro.models`` (so far the FFT-convolution mixer on one device)."""

from .blocks import FFTConvMixer

__all__ = ["FFTConvMixer"]
