"""The FFT-conv LM's weights and batches, made by the benchmark from the
seed on the device and handed to both the port and the reference.

The weights follow the port's initialisation rules (``models/params.py``:
a standard normal times 0.02 for every matrix, times 0.2 for the mixer's
``filt``, ones for its ``skip``), by the port's parameter names, but are
drawn here: one generator call for the embedding and one for each layer,
so that a layer can be drawn again alone.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .common import derive_seed

Leaf = Tuple[str, Tuple[int, ...], str, float]     # name, shape, init, scale


def padded_vocab(arch: Dict) -> int:
    return (arch["vocab_size"] + 255) // 256 * 256


def groups(arch: Dict) -> List[List[Leaf]]:
    """The leaves of each generator call: the embedding, then each layer."""
    d, f, r = arch["d_model"], arch["d_ff"], arch["fftconv_rank"]
    out = [[("embed", (padded_vocab(arch), d), "normal", 0.02)]]
    for i in range(arch["num_layers"]):
        p = f"layers.{i}."
        out.append([(p + "mix.w_in", (d, 2 * d), "normal", 0.02),
                    (p + "mix.filt", (d, r), "normal", 0.2),
                    (p + "mix.skip", (d,), "ones", 1.0),
                    (p + "mix.w_out", (d, d), "normal", 0.02),
                    (p + "mlp.w_up", (d, f), "normal", 0.02),
                    (p + "mlp.w_gate", (d, f), "normal", 0.02),
                    (p + "mlp.w_down", (f, d), "normal", 0.02)])
    return out


def draw_group(leaves: List[Leaf], seed: int, index: int,
               device) -> Dict[str, torch.Tensor]:
    """One group's leaves, float32: one standard normal draw for all its
    normal leaves, cut and scaled."""
    sizes = [torch.Size(s).numel() for _, s, init, _ in leaves
             if init == "normal"]
    gen = torch.Generator(device=device).manual_seed(
        derive_seed(seed, 7, index))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, init, scale in leaves:
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
            continue
        n = torch.Size(shape).numel()
        out[name] = flat[at:at + n].view(shape) * scale
        at += n
    return out


def draw(arch: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf by name."""
    out = {}
    for i, leaves in enumerate(groups(arch)):
        out.update(draw_group(leaves, seed, i, device))
    return out


def batches(arch: Dict, batch: int, seq: int, count: int, seed: int,
            device) -> List[Dict[str, torch.Tensor]]:
    """``count`` batches of token ids uniform over the vocabulary, in one
    draw: {"tokens" (batch, seq), "labels" (the next token; -1 at the
    end)}, int64, as the port's dataset lays them out."""
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 11))
    toks = torch.randint(0, arch["vocab_size"], (count, batch, seq),
                         generator=gen, device=device)
    end = torch.full((count, batch, 1), -1, dtype=toks.dtype, device=device)
    labels = torch.cat([toks[..., 1:], end], -1)
    return [{"tokens": toks[i], "labels": labels[i]} for i in range(count)]
