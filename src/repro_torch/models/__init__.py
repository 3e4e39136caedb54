"""Model substrate of the port: layers, attention and the dense LM."""

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig

from .transformer import LM, default_segments, unit_pattern


def build_model(cfg: ModelConfig, device="cuda",
                generator: Optional[torch.Generator] = None) -> LM:
    """Factory: arch family → model.  Only the dense ``attn_mlp`` family is
    ported; the others raise."""
    kinds, _ = unit_pattern(cfg)
    if cfg.encoder_decoder or cfg.frontend != "none" or kinds != ["attn_mlp"]:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not ported yet: ROADMAP.md module "
            "queue, item 'Other model families'"
        )
    return LM(cfg, device=device, generator=generator)


__all__ = ["LM", "build_model", "default_segments", "unit_pattern"]
