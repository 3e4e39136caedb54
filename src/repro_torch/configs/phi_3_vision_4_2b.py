"""phi-3-vision-4.2b — VLM: phi3-mini backbone + CLIP stub
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.  The CLIP frontend
is a STUB: input_specs() supplies 576 precomputed patch embeddings.
"""

from .base import ModelConfig

ARCH_ID = "phi-3-vision-4.2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        frontend="vision",
        frontend_seq=576,
    )
