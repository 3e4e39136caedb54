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
    # a SwiGLU expert every token passes through, beside the routed ones
    # (0: none); its width
    d_ff_shared: int = 0
    # the experts this device holds of the layer's ``num_experts`` (the
    # first ones; None: all): the router keeps its width and capacity its
    # formula over all of them, routes to the others add nothing here
    experts_held: Optional[int] = None

    @property
    def held(self) -> int:
        return self.num_experts if self.experts_held is None else self.experts_held


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256  # chunked-scan block length
    # Mamba-2's causal conv over x, B and C (with a bias) where zamba2's
    # runs over x alone without one
    conv_bc: bool = False
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
    # a chain of unlike units (granite-4.0-h): the block kind of each layer
    # of one period, repeated over n_layers; each layer is one unit
    layer_pattern: Tuple[str, ...] = ()
    # granite's multipliers (1.0: none): h = m_e·embed, h + m_r·f(h),
    # logits / logits_scaling; attention scores × attention_multiplier
    # (None: 1/sqrt(d_head))
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attention_multiplier: Optional[float] = None

    def __post_init__(self):
        # a pattern read from JSON arrives as a list; the config stays hashable
        object.__setattr__(self, "layer_pattern", tuple(self.layer_pattern))

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
        if ssm.conv_bc:  # conv weights and bias over x, B and C; A_log, D, dt_bias
            conv = d_inner + 2 * ssm.d_state
            return (d * proj_out + (ssm.d_conv + 1) * conv + d_inner * d + d_inner + d
                    + 3 * max(1, d_inner // 64))
        return d * proj_out + ssm.d_conv * d_inner + d_inner * d + d_inner + d

    def _moe_params(self, active: bool = False) -> int:
        """One layer's MoE: its pre-norm, the router over all experts, the
        held experts (``active``: the ``top_k`` a token takes, each held
        with probability held / num_experts) and the shared expert."""
        m, d = self.moe, self.d_model
        routed = 3 * d * m.d_ff_expert
        experts = (routed * m.top_k * m.held / m.num_experts) if active else routed * m.held
        return int(d + d * m.num_experts + experts + 3 * d * m.d_ff_shared)

    def _pattern_params(self, active: bool = False) -> int:
        """A ``layer_pattern`` model: embedding (tied or not), each layer's
        mixer (a Mamba-2 mixer with its norm, or pre-norm attention) and
        MoE, the final norm."""
        d, V = self.d_model, self.vocab_size
        mixers = {"mamba_moe": self._mamba_params(), "attn_moe": self._attn_params() + d}
        pat = self.layer_pattern
        layers = sum(mixers[pat[u % len(pat)]] for u in range(self.n_layers))
        head = 0 if self.tie_embeddings else V * d
        return V * d + head + layers + self.n_layers * self._moe_params(active) + d

    def num_params(self) -> int:
        """Analytic parameter count, family-aware (feeds MODEL_FLOPS=6·N·D)."""
        if self.layer_pattern:
            return self._pattern_params()
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
        if self.layer_pattern:
            return self._pattern_params(active=True)
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
            num_experts=4, top_k=2, d_ff_expert=d_model, capacity_factor=2.0,
            d_ff_shared=d_model if cfg.moe.d_ff_shared else 0,
            experts_held=2 if cfg.moe.experts_held is not None else None,
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
    if cfg.layer_pattern:  # each kind once, in the order they first appear
        changes["layer_pattern"] = tuple(dict.fromkeys(cfg.layer_pattern))
    return dataclasses.replace(cfg, **changes)
