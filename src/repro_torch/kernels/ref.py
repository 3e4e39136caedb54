"""Plain PyTorch versions of the flash-attention kernels.

Straight-line f32 torch, no tiling, so a disagreement with a kernel
localizes to the kernel.  ``ops`` and ``flash_attention`` use these for
tensors on the CPU; on the card ``chip_smoke.py`` and the CUDA tests hold
each kernel against them.  Nothing on the CUDA path calls them.

Layouts as in the kernels: q (B, H, Sq, D); k, v (B, KV, Sk, D) with
KV | H.  Causal masking is decode-style: query i sees keys j <= i + Sk - Sq.
A row that sees no key (only when Sq > Sk) has zero output, lse = -1e30
and zero gradients.  The reference gives the mean of v there instead; that
case is outside the parity domain (ROADMAP.md, kernel queue).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, KV, S, D) → (B, H, S, D), repeating each kv head H/KV times."""
    rep = n_heads // k.shape[1]
    return k if rep == 1 else k.repeat_interleave(rep, dim=1)


def _fold_kv(g: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, H, S, D) gradient → (B, KV, S, D): sum each head group."""
    B, H, S, D = g.shape
    return g.reshape(B, n_kv, H // n_kv, S, D).sum(dim=2)


def _masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool):
    """f32 scores (B, H, Sq, Sk) with masked entries at -inf, and the mask."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if not causal:
        return s, None
    rows = torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Sk, device=q.device)[None, :]
    mask = rows + (Sk - Sq) >= cols
    return s.masked_fill(~mask, float("-inf")), mask


def attention_with_lse_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: (out (B,H,Sq,D) in q's dtype, lse (B,H,Sq) f32)."""
    H = q.shape[1]
    kf, vf = expand_kv(k, H), expand_kv(v, H)
    s, _ = _masked_scores(q, kf, causal)
    lse = torch.logsumexp(s, dim=-1)
    seen = torch.isfinite(lse)
    p = torch.exp(s - torch.where(seen, lse, torch.zeros_like(lse))[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf.float())
    return out.to(q.dtype), torch.where(seen, lse, torch.full_like(lse, NEG_INF))


def _recompute(q, k, v, lse, delta, do, causal):
    """Shared by the backward plain versions: (p, ds) in f32, full heads."""
    H, D = q.shape[1], q.shape[3]
    kf, vf = expand_kv(k, H).float(), expand_kv(v, H).float()
    s, mask = _masked_scores(q, kf, causal)
    p = torch.exp(s - lse.float()[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vf)
    ds = p * (dp - delta.float()[..., None]) / math.sqrt(D)
    return p, ds, kf


def attention_bwd_dq_ref(q, k, v, lse, delta, do, causal: bool = True):
    """dq = ds·k, with p = exp(s − lse) and ds = p·(do·vᵀ − delta)·scale."""
    _, ds, kf = _recompute(q, k, v, lse, delta, do, causal)
    return torch.einsum("bhqk,bhkd->bhqd", ds, kf).to(q.dtype)


def attention_bwd_dkv_ref(q, k, v, lse, delta, do, causal: bool = True):
    """dk = dsᵀ·q and dv = pᵀ·do, each head group summed onto its kv head."""
    p, ds, _ = _recompute(q, k, v, lse, delta, do, causal)
    KV = k.shape[1]
    dk = _fold_kv(torch.einsum("bhqk,bhqd->bhkd", ds, q.float()), KV)
    dv = _fold_kv(torch.einsum("bhqk,bhqd->bhkd", p, do.float()), KV)
    return dk.to(k.dtype), dv.to(v.dtype)


def row_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do∘out) in f32, (B, H, Sq) contiguous."""
    return (do.float() * out.float()).sum(dim=-1).contiguous()
