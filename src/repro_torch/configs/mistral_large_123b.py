"""mistral-large-123b — dense [hf:mistralai/Mistral-Large-Instruct-2407].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""

from .base import ModelConfig

ARCH_ID = "mistral-large-123b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=88,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=28672,
        vocab_size=32768,
        d_head=128,
    )
