"""qwen3-moe-30b-a3b — MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

48L d_model=2048 32H (GQA kv=4) expert d_ff=768 vocab=151936.
"""

from .base import ModelConfig, MoEConfig

ARCH_ID = "qwen3-moe-30b-a3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=768,
        vocab_size=151936,
        d_head=128,
        moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
        rope_theta=1_000_000.0,
    )
