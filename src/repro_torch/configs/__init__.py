"""Architecture registry: ``get_config(name)`` / ``--arch <id>``.

Each module defines CONFIG (the exact assigned full-size architecture, source
cited) — the reduced smoke variant comes from ``CONFIG.reduced()``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "seamless_m4t_large_v2",
    "phi3_vision_4p2b",
    "qwen2_moe_a2p7b",
    "qwen15_4b",
    "glm4_9b",
    "nemotron4_340b",
    "xlstm_125m",
    "deepseek_v2_236b",
    "qwen3_4b",
    "zamba2_1p2b",
]

# dashed aliases matching the assignment table
ALIASES = {
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "qwen1.5-4b": "qwen15_4b",
    "glm4-9b": "glm4_9b",
    "nemotron-4-340b": "nemotron4_340b",
    "xlstm-125m": "xlstm_125m",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen3-4b": "qwen3_4b",
    "zamba2-1.2b": "zamba2_1p2b",
}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{ARCH_IDS + sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
