"""Model substrate of the port: layers, attention, MoE, SSM/xLSTM, the LM
and the whisper encoder-decoder."""

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig

from .transformer import LM, default_segments, unit_kinds, unit_pattern
from .whisper import WhisperModel


def build_model(cfg: ModelConfig, device="cuda",
                generator: Optional[torch.Generator] = None
                ) -> Union[LM, WhisperModel]:
    """Factory: arch family → model (every reference config builds)."""
    if cfg.encoder_decoder:
        return WhisperModel(cfg, device=device, generator=generator)
    return LM(cfg, device=device, generator=generator)


__all__ = ["LM", "WhisperModel", "build_model", "default_segments", "unit_kinds",
           "unit_pattern"]
