"""granite-moe-3b-a800m — MoE 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

32L d_model=1536 24H (GQA kv=8) expert d_ff=512 vocab=49155.
"""

from .base import ModelConfig, MoEConfig

ARCH_ID = "granite-moe-3b-a800m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512),
    )
