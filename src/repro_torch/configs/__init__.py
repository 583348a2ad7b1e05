"""Assigned-architecture registry: one module per architecture, exact pool
configs, plus reduced smoke variants and the FFT case-study configs; the
port's copy of ``repro.configs``. ``models.lm.LM`` builds every one."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "granite_8b", "olmo_1b", "command_r_plus_104b", "granite_3_2b",
    "phi35_moe_42b", "dbrx_132b", "xlstm_1_3b", "zamba2_7b",
    "qwen2_vl_7b", "musicgen_large",
]

# public --arch aliases (hyphenated pool names) -> module ids
ALIASES = {
    "granite-8b": "granite_8b",
    "olmo-1b": "olmo_1b",
    "command-r-plus-104b": "command_r_plus_104b",
    "granite-3-2b": "granite_3_2b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "dbrx-132b": "dbrx_132b",
    "xlstm-1.3b": "xlstm_1_3b",
    "zamba2-7b": "zamba2_7b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "musicgen-large": "musicgen_large",
}


def get_config(name: str) -> ArchConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
