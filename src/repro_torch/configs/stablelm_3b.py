"""stablelm-3b — dense [hf:stabilityai/stablelm-2-1_6b; unverified].

32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.
"""

from .base import ModelConfig

ARCH_ID = "stablelm-3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab_size=50304,
    )
