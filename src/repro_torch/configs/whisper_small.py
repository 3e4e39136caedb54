"""whisper-small — enc-dec audio backbone, conv frontend stub
[arXiv:2212.04356; unverified].

12L (each side) d_model=768 12H (GQA kv=12) d_ff=3072 vocab=51865.
input_specs() supplies 1500 precomputed frame embeddings (30 s of audio
after the conv frontend, which is a stub per the assignment).
"""

from .base import ModelConfig

ARCH_ID = "whisper-small"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        encoder_decoder=True,
        frontend="audio",
        frontend_seq=1500,
        rope_theta=0.0,
    )
