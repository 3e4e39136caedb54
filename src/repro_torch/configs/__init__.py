"""Architecture registry: ``get_config("<arch-id>")`` for the 10 assigned
architectures, plus the paper's own benchmark-network graph topologies
(``paper_networks``) used by the Table-1/2 benchmarks."""

from __future__ import annotations

from typing import Dict, List

from . import (
    granite_moe_3b_a800m,
    mistral_large_123b,
    paper_networks,
    phi4_mini_3_8b,
    phi_3_vision_4_2b,
    qwen2_5_14b,
    qwen3_moe_30b_a3b,
    stablelm_3b,
    whisper_small,
    xlstm_1_3b,
    zamba2_2_7b,
)
from .base import (
    SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    reduced,
    shape_applicable,
)

_MODULES = [
    xlstm_1_3b,
    stablelm_3b,
    qwen2_5_14b,
    phi4_mini_3_8b,
    mistral_large_123b,
    phi_3_vision_4_2b,
    qwen3_moe_30b_a3b,
    granite_moe_3b_a800m,
    zamba2_2_7b,
    whisper_small,
]

REGISTRY: Dict[str, ModelConfig] = {m.ARCH_ID: m.config() for m in _MODULES}
ARCH_IDS: List[str] = list(REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return REGISTRY[arch_id]


__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "ShapeConfig",
    "SHAPES",
    "REGISTRY",
    "ARCH_IDS",
    "get_config",
    "reduced",
    "shape_applicable",
    "paper_networks",
]
