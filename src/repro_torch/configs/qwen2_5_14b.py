"""qwen2.5-14b — dense, GQA + QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""

from .base import ModelConfig

ARCH_ID = "qwen2.5-14b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=13824,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
