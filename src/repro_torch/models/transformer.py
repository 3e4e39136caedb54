"""Language models from one ModelConfig (port of
``repro/models/transformer.py``): the dense ``attn_mlp``, MoE ``attn_moe``,
Mamba2-hybrid, xLSTM and vision-stub families.

The layer stack is a chain of repeated *units* (one block for dense and
MoE; "k Mamba2 blocks + the shared attention block" for the hybrid; "k-1
mLSTM blocks + 1 sLSTM block" for xLSTM).  A config with a
``layer_pattern`` (granite-4.0-h) is a chain of *unlike* units, one layer
each: a ``mamba_moe`` block (pre-norm Mamba-2 mixer, then the pre-norm MoE
with its shared expert) or an ``attn_moe`` one, in the pattern's order
(:func:`unit_kinds`); its multipliers scale the embedding, each block's
residual branches, the attention scores and the logits.  The reference
stacks the unit params along a leading axis and runs them
through ``lax.scan``; here each unit is its own ``nn.Module`` in a
``ModuleList`` (slicing one stacked leaf would make autograd build a
full-size gradient per unit), and ``weights.params_from_jax`` unstacks the
reference's ``"layers"`` tree.  The hybrid's shared block is one top-level
param set (``shared_attn``), applied once a unit to ``concat(h, h0)``,
where h0 is the embedding output: the skip edges from the embedding make
the layer graph non-chain.  A multimodal config's stub frontend hands
``forward`` precomputed ``extra_embeds`` (B, F, D), prepended to the token
embeddings; the loss drops those F positions.

The paper's recomputation plan enters as ``segment_sizes``/``segment_remat``:
units are partitioned into segments and ``scan_over_segments`` runs a
segment with remat under ``torch.utils.checkpoint`` (non-reentrant) — the
canonical strategy (§3) on the unit chain, whose cached boundaries ∂(L_i)
are exactly the segment inputs.  The reference groups runs of equal
segments into nested scans to keep its HLO small; eager mode needs no such
grouping.

Decode (``init_caches``/``decode_step``) keeps the reference's cache tree:
``{"b{i}_attn_mlp": {"k", "v"}}`` (or ``b{i}_attn_moe``) with each leaf
(n_units, B, S, KV, D) in the activation dtype; for the hybrid
``{"units": {"b{i}_mamba": {"ssm", "conv"}}, "shared": {"k", "v"}}``, the
Mamba2 ``ssm`` state in f32 and ``conv`` in the activation dtype; xLSTM's
``b{i}_mlstm: {"C", "n"}`` and ``b{i}_slstm: {"c", "n"}``, in f32.  Each
unit decodes on its own slices (views) and writes its new state there in
place.  On a mesh (DTensor parameters and caches, ``serving.Engine(mesh=)``)
the same code runs on DTensors: a unit's slice of a cache is a view of
each rank's shard, each recurrent state is written back in its cache's
layout, and an attention block writes and attends on its rank's shard
(``attention.decode_attention``).  Every family runs on a model axis:
the reference's constraints of the MoE, Mamba2, xLSTM and whisper blocks
come with their modules.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch import obs
from repro_torch.configs.base import ModelConfig, SSMConfig
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from repro_torch.parallel.sharding import like, shard
from .layers import (checkpointed, embed, gather_sequence, init_normal, rmsnorm, softmax_xent,
                     swiglu, unembed)


# ---------------------------------------------------------------------------
# Unit patterns
# ---------------------------------------------------------------------------


def unit_pattern(cfg: ModelConfig) -> Tuple[List[str], int]:
    """Return (block kinds inside one unit, number of units).  A chain of
    unlike units (``layer_pattern``) has no one unit: :func:`unit_kinds`."""
    L = cfg.n_layers
    if cfg.layer_pattern:
        raise ValueError(f"{cfg.name}'s units differ by layer; see unit_kinds")
    if cfg.family == "ssm" and cfg.ssm and cfg.ssm.slstm_every:
        k = cfg.ssm.slstm_every
        if L % k:
            raise ValueError(f"n_layers {L} is not a multiple of slstm_every {k}")
        return ["mlstm"] * (k - 1) + ["slstm"], L // k
    if cfg.family == "ssm":
        return ["mamba"], L
    if cfg.family == "hybrid":
        k = cfg.hybrid_shared_attn_every
        if not k or L % k:
            raise ValueError(f"n_layers {L} is not a multiple of {k}")
        return ["mamba"] * k + ["shared_attn"], L // k
    if cfg.moe is not None:
        return ["attn_moe"], L
    return ["attn_mlp"], L


def unit_kinds(cfg: ModelConfig) -> List[List[str]]:
    """The block kinds of each unit, in chain order: one layer a unit in
    ``layer_pattern``'s kind (the pattern repeated over ``n_layers``),
    else :func:`unit_pattern`'s kinds for every unit."""
    if cfg.layer_pattern:
        pat = cfg.layer_pattern
        return [[pat[u % len(pat)]] for u in range(cfg.n_layers)]
    kinds, n_units = unit_pattern(cfg)
    return [kinds] * n_units


def _scaled(t: torch.Tensor, m: float) -> torch.Tensor:
    """``t·m``, with no multiply where m is 1."""
    return t if m == 1.0 else t * m


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def _params(**tree) -> nn.Module:
    """A module that only holds the given tensors as parameters; a nested
    dict becomes a submodule of the same name."""
    m = nn.Module()
    for name, val in tree.items():
        if isinstance(val, dict):
            m.add_module(name, _params(**val))
        else:
            m.register_parameter(name, nn.Parameter(val))
    return m


def _tree(module: nn.Module) -> Dict:
    """The nested dict of a module's parameters (``_params``'s inverse),
    read anew each call so that ``functional_call`` shows through."""
    out: Dict = dict(module.named_parameters(recurse=False))
    for name, child in module.named_children():
        out[name] = _tree(child)
    return out


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.scale, x)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        self.wq = nn.Parameter(init_normal((d, h * dh), d**-0.5, **kw))
        self.wk = nn.Parameter(init_normal((d, kv * dh), d**-0.5, **kw))
        self.wv = nn.Parameter(init_normal((d, kv * dh), d**-0.5, **kw))
        self.wo = nn.Parameter(init_normal((h * dh, d), (h * dh) ** -0.5, **kw))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(h * dh, device=device))
            self.bk = nn.Parameter(torch.zeros(kv * dh, device=device))
            self.bv = nn.Parameter(torch.zeros(kv * dh, device=device))

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                causal: bool = True) -> torch.Tensor:
        c = self.cfg
        return attn.attention(
            dict(self.named_parameters(recurse=False)), x,
            n_heads=c.n_heads, n_kv_heads=c.n_kv_heads, d_head=c.head_dim,
            rope_theta=c.rope_theta, positions=positions, causal=causal,
            scale=c.attention_multiplier,
        )

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               position: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        out, _, _ = attn.decode_attention(
            dict(self.named_parameters(recurse=False)), x, cache["k"], cache["v"],
            position, n_heads=c.n_heads, n_kv_heads=c.n_kv_heads,
            d_head=c.head_dim, rope_theta=c.rope_theta,
        )
        return out


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.w_gate = nn.Parameter(init_normal((d_model, d_ff), d_model**-0.5, **kw))
        self.w_up = nn.Parameter(init_normal((d_model, d_ff), d_model**-0.5, **kw))
        self.w_down = nn.Parameter(init_normal((d_ff, d_model), d_ff**-0.5, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(self.w_gate, self.w_up, self.w_down, x)


class AttnMLP(nn.Module):
    """The dense ``attn_mlp`` block: pre-norm attention, then pre-norm SwiGLU."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.attn = Attention(cfg, device, generator)
        self.ln2 = RMSNorm(cfg.d_model, device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, device, generator)

    def forward(self, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        h = h + self.attn(self.ln1(h), positions)
        return h + self.mlp(self.ln2(h))

    def decode(self, h: torch.Tensor, cache: Dict[str, torch.Tensor],
               position: torch.Tensor) -> torch.Tensor:
        h = h + self.attn.decode(self.ln1(h), cache, position)
        return h + self.mlp(self.ln2(h))


def _moe_branch(block: nn.Module, h: torch.Tensor) -> torch.Tensor:
    """``h + r·moe(ln2(h))`` of a block holding ``ln2`` and ``moe`` (the
    MoE's shared expert, if any, inside ``moe``)."""
    c = block.cfg
    return h + _scaled(moe_mod.moe_apply(_tree(block.moe), block.ln2(h), c.moe),
                       c.residual_multiplier)


class AttnMoE(nn.Module):
    """The ``attn_moe`` block: pre-norm attention, then the pre-norm MoE."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.attn = Attention(cfg, device, generator)
        self.ln2 = RMSNorm(cfg.d_model, device)
        self.moe = _params(**moe_mod.moe_init(cfg.d_model, cfg.moe, device=device,
                                              generator=generator))

    def forward(self, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        r = self.cfg.residual_multiplier
        return _moe_branch(self, h + _scaled(self.attn(self.ln1(h), positions), r))

    def decode(self, h: torch.Tensor, cache: Dict[str, torch.Tensor],
               position: torch.Tensor) -> torch.Tensor:
        r = self.cfg.residual_multiplier
        return _moe_branch(self, h + _scaled(self.attn.decode(self.ln1(h), cache, position), r))


class MambaMoE(nn.Module):
    """The ``mamba_moe`` block (granite-4.0-h): the pre-norm Mamba-2 mixer
    (its norm in its tree, as zamba2's), then the pre-norm MoE with its
    shared expert, each added as ``h + r·f(h)``.  Training only."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.ssm_cfg = cfg.ssm or SSMConfig()
        self.mamba = _params(**ssm_mod.mamba2_init(cfg.d_model, self.ssm_cfg, device=device,
                                                   generator=generator))
        self.ln2 = RMSNorm(cfg.d_model, device)
        self.moe = _params(**moe_mod.moe_init(cfg.d_model, cfg.moe, device=device,
                                              generator=generator))

    def forward(self, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        h = ssm_mod.mamba2_apply(_tree(self.mamba), h, self.ssm_cfg,
                                 self.cfg.residual_multiplier)
        return _moe_branch(self, h)


class _Recurrent(nn.Module):
    """A recurrent block (``mamba``, ``mlstm``, ``slstm``): its param tree
    under the block's kind, as in the reference, a full-sequence ``run``
    and a decode ``step`` whose new state is copied into the cache in
    place."""

    kind = ""

    def __init__(self, params: Dict):
        super().__init__()
        self.add_module(self.kind, _params(**params))

    def run(self, p: Dict, h: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def step(self, p: Dict, h: torch.Tensor, cache: Dict[str, torch.Tensor]):
        raise NotImplementedError

    def forward(self, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return self.run(_tree(getattr(self, self.kind)), h)

    def decode(self, h: torch.Tensor, cache: Dict[str, torch.Tensor],
               position: torch.Tensor) -> torch.Tensor:
        h, new = self.step(_tree(getattr(self, self.kind)), h, cache)
        for key, t in new.items():
            cache[key].copy_(like(t, cache[key]))
        return h


class Mamba(_Recurrent):
    """The ``mamba`` block: one Mamba2 layer with its residual."""

    kind = "mamba"

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        ssm_cfg = cfg.ssm or SSMConfig()
        super().__init__(ssm_mod.mamba2_init(cfg.d_model, ssm_cfg, device=device,
                                             generator=generator))
        self.ssm_cfg = ssm_cfg

    def run(self, p, h):
        return ssm_mod.mamba2_apply(p, h, self.ssm_cfg)

    def step(self, p, h, cache):
        return ssm_mod.mamba2_step(p, h, cache, self.ssm_cfg)


class MLSTM(_Recurrent):
    """The ``mlstm`` block: one mLSTM layer with its residual."""

    kind = "mlstm"

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__(ssm_mod.mlstm_init(cfg.d_model, cfg.n_heads, device=device,
                                            generator=generator))
        self.n_heads, self.chunk = cfg.n_heads, (cfg.ssm or SSMConfig()).chunk

    def run(self, p, h):
        return ssm_mod.mlstm_apply(p, h, self.n_heads, self.chunk)

    def step(self, p, h, cache):
        return ssm_mod.mlstm_step(p, h, cache, self.n_heads)


class SLSTM(_Recurrent):
    """The ``slstm`` block: one sLSTM layer with its residual."""

    kind = "slstm"

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__(ssm_mod.slstm_init(cfg.d_model, device=device, generator=generator))

    def run(self, p, h):
        return ssm_mod.slstm_apply(p, h)

    def step(self, p, h, cache):
        return ssm_mod.slstm_step(p, h, cache)


class SharedAttn(nn.Module):
    """The hybrid's shared-attention block (zamba2): one param set applied
    once a unit; ``concat(h, h0)`` is projected back to d_model first."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        d = cfg.d_model
        self.ln = RMSNorm(2 * d, device)
        self.in_proj = _params(w=init_normal((2 * d, d), (2 * d) ** -0.5, device=device,
                                             generator=generator))
        self.attn = Attention(cfg, device, generator)
        self.ln2 = RMSNorm(d, device)
        self.mlp = SwiGLU(d, cfg.d_ff, device, generator)

    def _in(self, h: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
        x = torch.cat([gather_sequence(h), h0], dim=-1)
        return self.ln(x) @ self.in_proj.w.to(h.dtype)

    def forward(self, h: torch.Tensor, h0: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        x = self._in(h, h0)
        x = x + self.attn(x, positions)
        return h + self.mlp(self.ln2(x))

    def decode(self, h: torch.Tensor, h0: torch.Tensor, cache: Dict[str, torch.Tensor],
               position: torch.Tensor) -> torch.Tensor:
        x = self._in(h, h0)
        x = x + self.attn.decode(x, cache, position)
        return h + self.mlp(self.ln2(x))


BLOCKS = {"attn_mlp": AttnMLP, "attn_moe": AttnMoE, "mamba_moe": MambaMoE, "mamba": Mamba,
          "mlstm": MLSTM, "slstm": SLSTM}


class Unit(nn.Module):
    """One repeat of the unit pattern; blocks are named ``b{i}_{kind}`` as
    in the reference's param tree (the shared block takes no index: it
    lives on the LM)."""

    def __init__(self, kinds: Sequence[str], cfg: ModelConfig, device=None,
                 generator=None):
        super().__init__()
        self.steps: List[Optional[str]] = []  # block names; None = the shared block
        for kind in kinds:
            if kind == "shared_attn":
                self.steps.append(None)
                continue
            name = f"b{len(self.block_names)}_{kind}"
            self.add_module(name, BLOCKS[kind](cfg, device, generator))
            self.steps.append(name)

    @property
    def block_names(self) -> List[str]:
        return [name for name in self.steps if name is not None]

    def forward(self, h: torch.Tensor, positions: torch.Tensor,
                h0: Optional[torch.Tensor] = None,
                shared: Optional[SharedAttn] = None) -> torch.Tensor:
        for name in self.steps:
            h = shared(h, h0, positions) if name is None else getattr(self, name)(h, positions)
        # the unit boundary, the plan's cache candidate: sequence-parallel
        # (S/model per device), as Megatron's SP keeps the residual stream
        return shard(h, "batch", "seq_act", None)

    def decode(self, h: torch.Tensor, caches: Dict[str, Dict[str, torch.Tensor]],
               position: torch.Tensor, h0: Optional[torch.Tensor] = None,
               shared: Optional[SharedAttn] = None,
               shared_cache: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        for name in self.steps:
            if name is None:
                h = shared.decode(h, h0, shared_cache, position)
            else:
                h = getattr(self, name).decode(h, caches[name], position)
        return h


class LM(nn.Module):
    """The language model: embedding → unit chain → final norm → head.

    Parameters are f32 masters on ``device`` (CUDA unless the caller asks
    for the CPU), drawn from ``generator`` (default: seed 0 on ``device``).
    ``pattern`` is one unit's block kinds, or a chain of unlike units' one
    period of ``layer_pattern``.
    """

    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        kinds = unit_kinds(cfg)
        self.pattern = list(cfg.layer_pattern) if cfg.layer_pattern else kinds[0]
        self.n_units = len(kinds)
        device = torch.device(device)
        if generator is None and device.type != "meta":  # meta: shapes only
            generator = torch.Generator(device=device).manual_seed(0)
        kw = dict(device=device, generator=generator)
        self.embedding = _params(
            embed=init_normal((cfg.vocab_size, cfg.d_model), 1.0, **kw))
        self.layers = nn.ModuleList(Unit(k, cfg, device, generator) for k in kinds)
        self.final_norm = RMSNorm(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.head = _params(unembed=init_normal(
                (cfg.vocab_size, cfg.d_model), cfg.d_model**-0.5, **kw))
        self.has_shared = "shared_attn" in self.pattern
        self.shared_attn = SharedAttn(cfg, device, generator) if self.has_shared else None

    def forward(
        self,
        tokens: torch.Tensor,
        extra_embeds: Optional[torch.Tensor] = None,
        segment_sizes: Optional[Tuple[int, ...]] = None,
        segment_remat: Optional[Tuple[bool, ...]] = None,
    ) -> torch.Tensor:
        """tokens (B, S) → f32 logits (B, F + S, V).  extra_embeds (B, F, D)
        is the multimodal stub frontend's output, prepended to the token
        embeddings (F = 0 without it)."""
        return self._logits(self._trunk(tokens, extra_embeds, segment_sizes, segment_remat))

    def _trunk(self, tokens: torch.Tensor, extra_embeds: Optional[torch.Tensor],
               segment_sizes: Optional[Tuple[int, ...]],
               segment_remat: Optional[Tuple[bool, ...]]) -> torch.Tensor:
        """The embedding and the unit chain: the final hidden states."""
        dt = self.cfg.activation_dtype
        h = _scaled(embed(self.embedding.embed, tokens, dt), self.cfg.embedding_multiplier)
        if extra_embeds is not None:
            h = torch.cat([extra_embeds.to(dt), h], dim=1)
        h = shard(h, "batch", None, "model")
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        h0 = h  # the hybrid's skip input, read by every unit
        return scan_over_segments(
            h, self.layers, lambda unit, x: unit(x, positions, h0, self.shared_attn),
            segment_sizes, segment_remat,
        )

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """f32 logits; divided by ``logits_scaling`` through the head's input
        (B, S, d), not its (B, S, V) output: the same numbers where the
        divisor is a power of two, as granite's 16."""
        h = rmsnorm(self.final_norm.scale, h)
        if self.cfg.logits_scaling != 1.0:
            h = h / self.cfg.logits_scaling
        table = self.embedding.embed if self.cfg.tie_embeddings else self.head.unembed
        return unembed(table, h)

    def loss(
        self,
        batch: Dict[str, torch.Tensor],
        segment_sizes: Optional[Tuple[int, ...]] = None,
        segment_remat: Optional[Tuple[bool, ...]] = None,
    ) -> torch.Tensor:
        h = self._trunk(batch["tokens"], batch.get("extra_embeds"), segment_sizes,
                        segment_remat)
        with obs.span("lm.head"):
            logits = self._logits(h)
            labels = batch["labels"]
            F = logits.shape[1] - labels.shape[1]
            if F > 0:  # multimodal prefix positions carry no labels
                logits = logits[:, F:]
            return softmax_xent(logits[:, :-1], labels[:, 1:])

    # ------------------------------------------------------------------ decode

    def init_caches(self, batch: int, max_seq: int) -> Dict[str, Dict]:
        """Zero caches for ``batch`` sequences of up to ``max_seq`` tokens, on
        the model's device, in the reference's tree: each attention block's
        ``{"k", "v"}``, (n_units, batch, max_seq, KV, D) in the activation
        dtype; each recurrent block's state with the unit axis in front
        (Mamba2 ``{"ssm", "conv"}``, mLSTM ``{"C", "n"}``, sLSTM
        ``{"c", "n"}``); the hybrid's ``{"units": ..., "shared": {"k", "v"}}``."""
        cfg = self.cfg
        if cfg.layer_pattern:
            raise NotImplementedError(f"{cfg.name}: no decode caches for a chain of unlike "
                                      "units (its Mamba-2 blocks have no decode step)")
        n, dt = self.n_units, cfg.activation_dtype
        kw = dict(dtype=dt, device=self.embedding.embed.device)

        def kv() -> Dict[str, torch.Tensor]:
            shape = (n, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
            return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}

        states = {
            "mamba": lambda: ssm_mod.mamba2_init_state(batch, cfg.d_model,
                                                       cfg.ssm or SSMConfig(), dt),
            "mlstm": lambda: ssm_mod.mlstm_init_state(batch, cfg.d_model, cfg.n_heads),
            "slstm": lambda: ssm_mod.slstm_init_state(batch, cfg.d_model),
        }
        units: Dict[str, Dict[str, torch.Tensor]] = {}
        for name in self.layers[0].block_names:
            kind = name.split("_", 1)[1]
            if kind in states:
                units[name] = {k: torch.zeros((n, *t.shape), dtype=t.dtype,
                                              device=kw["device"])
                               for k, t in states[kind]().items()}
            else:
                units[name] = kv()
        return {"units": units, "shared": kv()} if self.has_shared else units

    @torch.no_grad()
    def decode_step(
        self,
        tokens: torch.Tensor,
        caches: Dict[str, Dict],
        position: torch.Tensor,
    ) -> Tuple[torch.Tensor, Dict[str, Dict]]:
        """tokens (B, 1), position (B,) → (f32 logits (B, 1, V), caches).

        Each row's new state (k and v at its position; the recurrent states)
        goes into the caches in place; the returned caches are the given
        ones.
        """
        h = shard(embed(self.embedding.embed, tokens, self.cfg.activation_dtype),
                  "batch", None, "model")
        h0 = h
        unit_caches = caches["units"] if self.has_shared else caches
        for u, unit in enumerate(self.layers):
            views = {name: {k: t[u] for k, t in c.items()}
                     for name, c in unit_caches.items()}
            shared = ({k: t[u] for k, t in caches["shared"].items()}
                      if self.has_shared else None)
            h = unit.decode(h, views, position, h0, self.shared_attn, shared)
        return self._logits(h), caches


def default_segments(n_units: int) -> Tuple[int, ...]:
    """√n segmentation fallback when no DP plan is supplied (Chen-style)."""
    k = max(1, int(math.isqrt(n_units)))
    sizes = [n_units // k] * k
    for i in range(n_units - sum(sizes)):
        sizes[i] += 1
    return tuple(sizes)


def scan_over_segments(
    h: torch.Tensor,
    units: Sequence[nn.Module],
    unit_body: Callable[[nn.Module, torch.Tensor], torch.Tensor],
    segment_sizes: Optional[Tuple[int, ...]] = None,
    segment_remat: Optional[Tuple[bool, ...]] = None,
) -> torch.Tensor:
    """Execute the unit chain under a (sizes, remat-flags) canonical plan.

    ``unit_body(unit, h) -> h``.  A segment with remat runs under a
    non-reentrant ``checkpoint``: only its input is kept, and its interior
    is recomputed in the backward pass.  Without a plan the chain is cut
    into √n segments, all rematerialized when there is more than one (the
    reference's default).
    """
    n_units = len(units)
    segs = tuple(segment_sizes or default_segments(n_units))
    if sum(segs) != n_units:
        raise ValueError(f"segment sizes {segs} do not cover {n_units} units")
    remat = tuple(
        segment_remat if segment_remat is not None
        else (len(segs) > 1 for _ in segs)
    )
    if len(remat) != len(segs):
        raise ValueError(f"{len(remat)} remat flags for {len(segs)} segments")

    offset = 0
    for index, (size, do_remat) in enumerate(zip(segs, remat)):
        seg_units = units[offset:offset + size]
        # the first call is the segment's forward; a checkpoint calls it
        # again for each recompute in the backward
        def seg_fn(x: torch.Tensor, seg_units=seg_units, calls=itertools.count(),
                   index=index, do_remat=do_remat) -> torch.Tensor:
            name = "remat.recompute" if next(calls) else "remat.segment"
            with obs.span(name, index=index, units=len(seg_units), remat=do_remat):
                for unit in seg_units:
                    x = unit_body(unit, x)
            return x

        h = checkpointed(seg_fn, h) if do_remat else seg_fn(h)
        offset += size
    return h
