"""phi4-mini-3.8b — dense, RoPE SwiGLU GQA [arXiv:2412.08905; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""

from .base import ModelConfig

ARCH_ID = "phi4-mini-3.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=200064,
    )
