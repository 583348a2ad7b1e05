"""Inputs made from the seed, on the device, in a few large calls: the
benchmark's fields, which it hands both to the port and to the plain
reference.

A field is float32 standard normal (a real field, or an (re, im) pair).
It is drawn in chunks of planes along its first axis, each from its own
generator (``derive_seed(seed, field, chunk)``), so that one rank can
draw its own block of a field too large for one card, and the reference
the whole field, and both get the same values.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .common import derive_seed


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def planes(shape: Sequence[int], chunk: int, seed: int, index: int,
           first: int, count: int, pair: bool, device) -> Tuple:
    """Planes ``[first, first + count)`` along axis 0 of field ``index``
    (whole chunks of ``chunk`` planes): a tensor, or an (re, im) pair."""
    if first % chunk or count % chunk:
        raise ValueError(f"planes [{first}, {first + count}) are not whole "
                         f"chunks of {chunk}")
    rest = tuple(shape[1:])
    parts = 2 if pair else 1
    out = torch.empty((parts, count) + rest, dtype=torch.float32,
                      device=device)
    for c in range(first // chunk, (first + count) // chunk):
        i = c * chunk - first
        out[:, i:i + chunk] = torch.randn(
            (parts, chunk) + rest, generator=_gen(
                device, derive_seed(seed, index, c)), device=device)
    return (out[0], out[1]) if pair else (out[0],)


def field(shape: Sequence[int], chunk: int, seed: int, index: int,
          pair: bool, device):
    """The whole field ``index``: a real tensor, or an (re, im) pair."""
    got = planes(shape, chunk, seed, index, 0, shape[0], pair, device)
    return got if pair else got[0]
