"""Each cell at a size the CPU tests can hold: the same files, drivers
and limits, the shapes cut down (never run by the benchmark)."""

from __future__ import annotations

import copy

from . import common

SMALL = {
    "fft2d_16384": {"shape": [32, 64], "gen_chunk": 32},
    "fft3d_1024": {"shape": [16, 16, 16], "gen_chunk": 4},
    "fftconv_lm_olmo1b": {"arch": {"num_layers": 2, "d_model": 256,
                                   "d_ff": 512, "vocab_size": 500,
                                   "num_heads": 4, "num_kv_heads": 4,
                                   "segments": [["fftconv_mlp", 2]]}},
}
SMALL_TRAFFIC = {"train": {"seq": 128, "pool": 4}}


def small_cell(name: str) -> dict:
    """The cell's spec (``common.cell``) with its sizes cut down."""
    spec = copy.deepcopy(common.cell(name, common.manifest()))
    for key, value in SMALL[spec["entry"]["config"]].items():
        if isinstance(value, dict):
            spec["config"][key].update(value)
        else:
            spec["config"][key] = value
    spec["traffic"].update(SMALL_TRAFFIC.get(spec["traffic"]["driver"], {}))
    return spec
