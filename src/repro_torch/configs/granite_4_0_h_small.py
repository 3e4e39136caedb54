"""granite-4.0-h-small — Mamba-2/attention hybrid with MoE in every layer
[hf:ibm-granite/granite-4.0-h-small, config.json].

40L d_model=4096 vocab=100352 (tied), a period of 10 layers repeated four
times: five Mamba-2 mixers, one attention, four Mamba-2 mixers.  Mamba-2:
128 heads of 64, d_state 128, one group, chunk 256, expand 2, a causal
conv of 4 with bias over x, B and C.  Attention: 32 q over 8 KV heads of
128, no positional encoding, scores × 1/128.  Every layer: 72 experts of
768, top-10, and a shared SwiGLU expert of 1536.  Multipliers: embedding
12, residual 0.22, logits 1/16.  Each layer is one unit of the plan's
chain, the units unlike.
"""

from .base import ModelConfig, MoEConfig, SSMConfig

ARCH_ID = "granite-4.0-h-small"

#: one period of the source's ``layer_types`` (attention 6th of 10)
PERIOD = ("mamba_moe",) * 5 + ("attn_moe",) + ("mamba_moe",) * 4


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=768,
        vocab_size=100352,
        tie_embeddings=True,
        rope_theta=0.0,
        moe=MoEConfig(num_experts=72, top_k=10, d_ff_expert=768, d_ff_shared=1536),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, chunk=256, conv_bc=True),
        layer_pattern=PERIOD,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        logits_scaling=16.0,
        attention_multiplier=1.0 / 128,
    )
