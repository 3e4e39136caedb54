"""Config system: ModelConfig + the assigned input-shape registry.

The port's copy of ``repro/configs/base.py``: the same data, with
``activation_dtype`` a ``torch.dtype`` instead of a ``jnp.dtype``.

Every architecture in ``repro.configs`` returns a ``ModelConfig``; shapes are
global (``SHAPES``) and pair with any LM arch.  ``reduced()`` produces the
CPU-smoke-test variant of a config (same family, tiny dims).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256  # chunked-scan block length
    # xLSTM: index pattern of sLSTM blocks (others are mLSTM)
    slstm_every: int = 0  # 0 → none


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every k backbone blocks
    hybrid_shared_attn_every: int = 0
    # enc-dec (whisper): n_layers applies to each side
    encoder_decoder: bool = False
    # multimodal stub frontend: input_specs provides precomputed embeddings
    frontend: str = "none"  # none | vision | audio
    frontend_seq: int = 0  # patches / frames prepended to the text sequence
    # remat planning defaults (the paper's technique, first-class)
    remat_method: str = "approx_dp"  # approx_dp | exact_dp | chen | none | full
    remat_objective: str = "time_centric"
    remat_budget_frac: Optional[float] = None  # fraction of per-device HBM; None → min feasible

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def _attn_params(self) -> int:
        d, h, kv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        p = d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d
        if self.qkv_bias:
            p += h * dh + 2 * kv * dh
        return p

    def _mamba_params(self) -> int:
        d = self.d_model
        ssm = self.ssm or SSMConfig()
        d_inner = ssm.expand * d
        proj_out = 2 * d_inner + 2 * ssm.d_state + max(1, d_inner // 64)
        return d * proj_out + ssm.d_conv * d_inner + d_inner * d + d_inner + d

    def num_params(self) -> int:
        """Analytic parameter count, family-aware (feeds MODEL_FLOPS=6·N·D)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        emb = V * d
        head = 0 if self.tie_embeddings else V * d
        ffn = 3 * d * self.d_ff if self.d_ff > 0 else 0
        moe = (
            d * self.moe.num_experts * (3 * self.moe.d_ff_expert + 1)
            if self.moe is not None
            else 0
        )
        if self.family == "ssm" and self.ssm and self.ssm.slstm_every:
            # xLSTM: mLSTM (4d² + gates) and sLSTM (5d²) blocks
            k = self.ssm.slstm_every
            mlstm = 4 * d * d + 2 * d * self.n_heads + 2 * d
            slstm = 5 * d * d + 2 * d
            per = ((k - 1) * mlstm + slstm) / k
            total = emb + head + L * (per + ffn) + d
        elif self.family == "ssm":
            total = emb + head + L * (self._mamba_params() + ffn) + d
        elif self.family == "hybrid":
            k = max(1, self.hybrid_shared_attn_every)
            shared = self._attn_params() + (2 * d) * d + ffn + 4 * d
            total = (
                emb + head + L * self._mamba_params() + (L // k) * 0  # reuse!
                + shared  # ONE shared block, applied L/k times
                + d
            )
        else:
            per_layer = self._attn_params() + 2 * d + (moe or ffn)
            total = emb + head + L * per_layer + d
            if self.encoder_decoder:
                total += L * per_layer  # decoder side (self+cross approx)
        return int(total)

    def num_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.num_params()
        d, L = self.d_model, self.n_layers
        dense = self.num_params() - L * (
            d * self.moe.num_experts * 3 * self.moe.d_ff_expert
        )
        return int(dense + L * d * self.moe.top_k * 3 * self.moe.d_ff_expert)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: run only for SSM / hybrid archs
# (see DESIGN.md §Arch-applicability).
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True


def reduced(cfg: ModelConfig, n_layers: int = 2, d_model: int = 64) -> ModelConfig:
    """Smoke-test variant: same family/topology, tiny dims."""
    n_heads = max(2, min(4, cfg.n_heads))
    n_kv = max(1, min(n_heads, cfg.n_kv_heads * n_heads // max(cfg.n_heads, 1)))
    if n_heads % n_kv:
        n_kv = 1
    changes = dict(
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=d_model // n_heads,
        d_ff=0 if cfg.d_ff == 0 else d_model * 2,
        vocab_size=256,
        frontend_seq=8 if cfg.frontend != "none" else 0,
    )
    if cfg.moe is not None:
        changes["moe"] = MoEConfig(
            num_experts=4, top_k=2, d_ff_expert=d_model, capacity_factor=2.0
        )
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm,
            d_state=16,
            chunk=8,
            slstm_every=2 if cfg.ssm.slstm_every else 0,
        )
    if cfg.hybrid_shared_attn_every:
        changes["hybrid_shared_attn_every"] = 2
    return dataclasses.replace(cfg, **changes)
