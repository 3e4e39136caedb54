"""Dense LM from one ModelConfig (port of ``repro/models/transformer.py``,
the ``attn_mlp`` family).

The layer stack is a chain of repeated *units*.  The reference stacks the
unit params along a leading axis and runs them through ``lax.scan``; here
each unit is its own ``nn.Module`` in a ``ModuleList`` (slicing one stacked
leaf would make autograd build a full-size gradient per unit), and
``weights.params_from_jax`` unstacks the reference's ``"layers"`` tree.

The paper's recomputation plan enters as ``segment_sizes``/``segment_remat``:
units are partitioned into segments and ``scan_over_segments`` runs a
segment with remat under ``torch.utils.checkpoint`` (non-reentrant) — the
canonical strategy (§3) on the unit chain, whose cached boundaries ∂(L_i)
are exactly the segment inputs.  The reference groups runs of equal
segments into nested scans to keep its HLO small; eager mode needs no such
grouping.

Decode (``init_caches``/``decode_step``) keeps the reference's cache tree,
``{"b{i}_attn_mlp": {"k", "v"}}`` with each leaf (n_units, B, S, KV, D) in
the activation dtype; each unit decodes on its own slice (a view) and
writes its new k and v there in place.  The other families (MoE, SSM,
hybrid, whisper), their decode steps included, wait for ROADMAP.md module
queue, item 'Other model families': ``Unit`` raises for their blocks.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from . import attention as attn
from .layers import embed, init_normal, rmsnorm, softmax_xent, swiglu, unembed


# ---------------------------------------------------------------------------
# Unit patterns
# ---------------------------------------------------------------------------


def unit_pattern(cfg: ModelConfig) -> Tuple[List[str], int]:
    """Return (block kinds inside one unit, number of units)."""
    L = cfg.n_layers
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


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def _params(**tensors: torch.Tensor) -> nn.Module:
    """A module that only holds the given tensors as parameters."""
    m = nn.Module()
    for name, t in tensors.items():
        m.register_parameter(name, nn.Parameter(t))
    return m


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

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        return attn.attention(
            dict(self.named_parameters(recurse=False)), x,
            n_heads=c.n_heads, n_kv_heads=c.n_kv_heads, d_head=c.head_dim,
            rope_theta=c.rope_theta, positions=positions,
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


class Unit(nn.Module):
    """One repeat of the unit pattern; blocks are named ``b{i}_{kind}`` as
    in the reference's param tree."""

    def __init__(self, kinds: Sequence[str], cfg: ModelConfig, device=None,
                 generator=None):
        super().__init__()
        self.block_names = []
        for i, kind in enumerate(kinds):
            if kind != "attn_mlp":
                raise NotImplementedError(
                    f"block kind {kind!r} is not ported yet: ROADMAP.md module "
                    "queue, item 'Other model families'"
                )
            name = f"b{i}_{kind}"
            self.add_module(name, AttnMLP(cfg, device, generator))
            self.block_names.append(name)

    def forward(self, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        for name in self.block_names:
            h = getattr(self, name)(h, positions)
        return h

    def decode(self, h: torch.Tensor, caches: Dict[str, Dict[str, torch.Tensor]],
               position: torch.Tensor) -> torch.Tensor:
        for name in self.block_names:
            h = getattr(self, name).decode(h, caches[name], position)
        return h


class LM(nn.Module):
    """The language model: embedding → unit chain → final norm → head.

    Parameters are f32 masters on ``device`` (CUDA unless the caller asks
    for the CPU), drawn from ``generator`` (default: seed 0 on ``device``).
    """

    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.pattern, self.n_units = unit_pattern(cfg)
        device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        kw = dict(device=device, generator=generator)
        self.embedding = _params(
            embed=init_normal((cfg.vocab_size, cfg.d_model), 1.0, **kw))
        self.layers = nn.ModuleList(
            Unit(self.pattern, cfg, device, generator) for _ in range(self.n_units))
        self.final_norm = RMSNorm(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.head = _params(unembed=init_normal(
                (cfg.vocab_size, cfg.d_model), cfg.d_model**-0.5, **kw))

    def forward(
        self,
        tokens: torch.Tensor,
        segment_sizes: Optional[Tuple[int, ...]] = None,
        segment_remat: Optional[Tuple[bool, ...]] = None,
    ) -> torch.Tensor:
        """tokens (B, S) → f32 logits (B, S, V)."""
        h = embed(self.embedding.embed, tokens, self.cfg.activation_dtype)
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        h = scan_over_segments(
            h, self.layers, lambda unit, x: unit(x, positions),
            segment_sizes, segment_remat,
        )
        return self._logits(h)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(self.final_norm.scale, h)
        table = self.embedding.embed if self.cfg.tie_embeddings else self.head.unembed
        return unembed(table, h)

    def loss(
        self,
        batch: Dict[str, torch.Tensor],
        segment_sizes: Optional[Tuple[int, ...]] = None,
        segment_remat: Optional[Tuple[bool, ...]] = None,
    ) -> torch.Tensor:
        logits = self.forward(batch["tokens"], segment_sizes, segment_remat)
        return softmax_xent(logits[:, :-1], batch["labels"][:, 1:])

    # ------------------------------------------------------------------ decode

    def init_caches(self, batch: int, max_seq: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Zero KV caches for ``batch`` sequences of up to ``max_seq`` tokens,
        on the model's device: ``{"b{i}_attn_mlp": {"k": t, "v": t}}``, each
        t (n_units, batch, max_seq, KV, D) in the activation dtype."""
        cfg = self.cfg
        shape = (self.n_units, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        kw = dict(dtype=cfg.activation_dtype, device=self.embedding.embed.device)
        return {name: {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}
                for name in self.layers[0].block_names}

    @torch.no_grad()
    def decode_step(
        self,
        tokens: torch.Tensor,
        caches: Dict[str, Dict[str, torch.Tensor]],
        position: torch.Tensor,
    ) -> Tuple[torch.Tensor, Dict[str, Dict[str, torch.Tensor]]]:
        """tokens (B, 1), position (B,) → (f32 logits (B, 1, V), caches).

        Each row's k and v go into the caches at its position, in place; the
        returned caches are the given ones.
        """
        h = embed(self.embedding.embed, tokens, self.cfg.activation_dtype)
        for u, unit in enumerate(self.layers):
            unit_caches = {name: {kv: t[u] for kv, t in c.items()}
                           for name, c in caches.items()}
            h = unit.decode(h, unit_caches, position)
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
    for size, do_remat in zip(segs, remat):
        seg_units = units[offset:offset + size]

        def seg_fn(x: torch.Tensor, seg_units=seg_units) -> torch.Tensor:
            for unit in seg_units:
                x = unit_body(unit, x)
            return x

        h = checkpoint(seg_fn, h, use_reentrant=False) if do_remat else seg_fn(h)
        offset += size
    return h
