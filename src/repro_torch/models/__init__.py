"""Model substrate of the port: layers, attention, MoE, Mamba2 and the LM."""

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig

from .transformer import LM, default_segments, unit_pattern


def build_model(cfg: ModelConfig, device="cuda",
                generator: Optional[torch.Generator] = None) -> LM:
    """Factory: arch family → model.  The dense, MoE and Mamba2-hybrid
    families are ported; xLSTM, whisper and the vision stub raise."""
    missing = None
    if cfg.ssm is not None and cfg.ssm.slstm_every:
        missing = "the xLSTM blocks (mlstm, slstm)"
    elif cfg.encoder_decoder:
        missing = "the encoder-decoder model (whisper)"
    elif cfg.frontend != "none":
        missing = f"the {cfg.frontend} frontend's extra_embeds"
    if missing:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) needs {missing}, which is not ported yet: "
            "ROADMAP.md module queue, item 'Other model families'"
        )
    return LM(cfg, device=device, generator=generator)


__all__ = ["LM", "build_model", "default_segments", "unit_pattern"]
