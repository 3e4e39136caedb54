"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf].

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
One shared-attention block (single param set) applied every 6 Mamba2 blocks;
its input is concat(h, h0) — the skip edges from the embedding make the
layer graph non-chain, the paper's target case.
"""

from .base import ModelConfig, SSMConfig

ARCH_ID = "zamba2-2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        ssm=SSMConfig(d_state=64, chunk=256),
        hybrid_shared_attn_every=6,
    )
