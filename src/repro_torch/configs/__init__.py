"""Architecture registry: ``get_config("<arch-id>")`` for the 10 assigned
architectures (``ARCH_IDS``, the reference's list) and the architectures
only the port runs (``PORT_ARCH_IDS``), plus the paper's own
benchmark-network graph topologies (``paper_networks``) used by the
Table-1/2 benchmarks."""

from __future__ import annotations

from typing import Dict, List

from . import (
    granite_4_0_h_small,
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

#: architectures the reference package has no config of
_PORT_MODULES = [granite_4_0_h_small]

REGISTRY: Dict[str, ModelConfig] = {m.ARCH_ID: m.config() for m in _MODULES}
ARCH_IDS: List[str] = list(REGISTRY)
PORT_REGISTRY: Dict[str, ModelConfig] = {m.ARCH_ID: m.config() for m in _PORT_MODULES}
PORT_ARCH_IDS: List[str] = list(PORT_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    cfg = REGISTRY.get(arch_id) or PORT_REGISTRY.get(arch_id)
    if cfg is None:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS + PORT_ARCH_IDS}")
    return cfg


__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "ShapeConfig",
    "SHAPES",
    "REGISTRY",
    "ARCH_IDS",
    "PORT_ARCH_IDS",
    "get_config",
    "reduced",
    "shape_applicable",
    "paper_networks",
]
