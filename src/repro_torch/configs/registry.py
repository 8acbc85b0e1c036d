"""Architecture registry: an arch id (``qwen2.5-14b``) resolves to its
config file in this package."""
from __future__ import annotations

import importlib

from .base import ModelConfig

#: public arch ids (dashed, as assigned) -> module name
ARCH_IDS = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen2.5-14b": "qwen2_5_14b",
    "deepseek-7b": "deepseek_7b",
    "minitron-4b": "minitron_4b",
    "grok-1-314b": "grok1_314b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "hymba-1.5b": "hymba_1_5b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "musicgen-large": "musicgen_large",
}


def get_config(arch: str) -> ModelConfig:
    mod_name = ARCH_IDS.get(arch, arch.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS.values():
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"{__package__}.{mod_name}")
    return mod.CONFIG


def all_arch_ids() -> list[str]:
    return list(ARCH_IDS)
