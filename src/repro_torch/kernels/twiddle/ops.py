"""Public wrapper of the complex-multiply kernel.

A CUDA tensor launches the hand-written kernel (``twiddle.cu``); a build or
launch failure raises. A CPU tensor runs the plain PyTorch version in
``ref.py``, which is what a caller asks for by putting data on the CPU.
"""

from __future__ import annotations

import torch

from ...core import algo
from .._grad import refuse_autograd
from . import binding
from .ref import complex_multiply_ref

#: kernel launches since the last reset (the CPU path does not count)
LAUNCHES = 0


def _suffix_of(b_shape, a_shape) -> bool:
    """Whether ``b_shape``, without its leading 1s, is a trailing block of
    ``a_shape``: the broadcast the kernel does by index (i mod b.numel())."""
    b_shape = list(b_shape)
    while b_shape and b_shape[0] == 1:
        b_shape.pop(0)
    k = len(b_shape)
    return k == 0 or tuple(a_shape[-k:]) == tuple(b_shape)


def complex_multiply(a: algo.Complex, b: algo.Complex, *,
                     block: int = 1024) -> algo.Complex:
    """Elementwise ``a * b`` of (re, im) float32 pairs, of ``a``'s shape.

    ``b`` broadcasts over the leading dims of ``a``. When ``b``'s shape
    (leading 1s dropped) is a trailing block of ``a``'s, as on the FFT
    convolution's path, the kernel indexes it modulo its size and nothing
    is materialised; any other broadcast is expanded here with
    ``expand(...).contiguous()`` first. ``block`` is elements of ``b`` per
    CTA, each taken over all of ``a``'s leading dims; the result does not
    depend on it (the kernel matches the plain version bit for bit)."""
    global LAUNCHES
    (ar, ai), (br, bi) = a, b
    if ar.shape != ai.shape or br.shape != bi.shape:
        raise ValueError(f"each pair needs equal shapes, got "
                         f"{tuple(ar.shape)}/{tuple(ai.shape)} and "
                         f"{tuple(br.shape)}/{tuple(bi.shape)}")
    try:
        full = torch.broadcast_shapes(ar.shape, br.shape)
    except RuntimeError as e:
        raise ValueError(f"b {tuple(br.shape)} does not broadcast to a "
                         f"{tuple(ar.shape)}") from e
    if full != ar.shape:
        raise ValueError(f"b {tuple(br.shape)} does not broadcast to a "
                         f"{tuple(ar.shape)}")
    tensors = (ar, ai, br, bi)
    if all(t.device.type == "cpu" for t in tensors):
        return complex_multiply_ref(a, b)
    if any(t.device.type != "cuda" or t.device != ar.device
           for t in tensors):
        raise ValueError(f"complex_multiply runs on one CUDA device or on "
                         f"the CPU, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"complex_multiply takes float32, got "
                        f"{[t.dtype for t in tensors]}")
    refuse_autograd("complex_multiply", *tensors)
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")
    if not _suffix_of(br.shape, ar.shape):
        br, bi = br.expand(ar.shape), bi.expand(ar.shape)
    srcs = [t.contiguous() for t in (ar, ai, br, bi)]
    out_r, out_i = torch.empty_like(srcs[0]), torch.empty_like(srcs[1])
    n, nb = out_r.numel(), srcs[2].numel()
    if n:
        lib = binding.lib()
        with torch.cuda.device(ar.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.complex_multiply(*(t.data_ptr() for t in srcs),
                                      out_r.data_ptr(), out_i.data_ptr(),
                                      n, nb, int(block), stream)
        if rc:
            raise RuntimeError(
                "complex_multiply launch failed: "
                + lib.complex_multiply_error_string(rc).decode())
        LAUNCHES += 1
    return out_r, out_i
