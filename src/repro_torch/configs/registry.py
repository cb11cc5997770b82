"""``--arch`` id → ArchConfig registry."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.configs import (
    glm4_9b,
    smollm_360m,
    llama3_2_3b,
    llama3_405b,
    zamba2_2p7b,
    qwen2_vl_7b,
    musicgen_medium,
    mamba2_370m,
    mixtral_8x22b,
    mixtral_8x7b,
    nemotron3_nano_30b_a3b,
)

_MODULES = (
    glm4_9b,
    smollm_360m,
    llama3_2_3b,
    llama3_405b,
    zamba2_2p7b,
    qwen2_vl_7b,
    musicgen_medium,
    mamba2_370m,
    mixtral_8x22b,
    mixtral_8x7b,
    nemotron3_nano_30b_a3b,
)

ARCHS: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
