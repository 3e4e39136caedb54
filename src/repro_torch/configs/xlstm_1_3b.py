"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304.  Units of 8 blocks
(7 mLSTM + 1 sLSTM); d_ff=0 — no separate FFN, per the xLSTM design.
"""

from .base import ModelConfig, SSMConfig

ARCH_ID = "xlstm-1.3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        ssm=SSMConfig(d_state=64, chunk=256, slstm_every=8),
        rope_theta=0.0,
    )
