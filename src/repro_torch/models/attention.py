"""Attention for train/prefill (port of ``repro/models/attention.py``).

GQA self-attention over a full sequence.  Unlike the reference, which sends
only TPU runs with ``S % 128 == 0`` to its Pallas kernel, the port sends
every full-sequence attention to ``kernels.flash_attention``: the CUDA
kernels on the card (any length, bounds-checked), their plain versions on
the CPU.  ``dense_attention`` is the O(S²)-memory reference the tests
compare with.  ``decode_attention`` is one step of KV-cache decode in plain
PyTorch, as the reference's is plain array code.  ``chunked_attention``
waits for ROADMAP.md module queue, item 'Other model families'.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.ops import flash_attention
from .layers import apply_rope


def qkv_proj(p: Dict[str, torch.Tensor], x: torch.Tensor, n_heads: int,
             n_kv_heads: int, d_head: int, positions: torch.Tensor,
             rope_theta: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(B, S, n_heads, d_head)
    k = k.reshape(B, S, n_kv_heads, d_head)
    v = v.reshape(B, S, n_kv_heads, d_head)
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, D) → (B, S, H, D) by repeating each kv head H/KV times."""
    rep = n_heads // k.shape[2]
    return k if rep == 1 else k.repeat_interleave(rep, dim=2)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Reference O(S²)-memory attention. q (B,S,H,D), k/v (B,S,KV,D)."""
    S, H, D = q.shape[1], q.shape[2], q.shape[3]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(D)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    d_head: int,
    rope_theta: float,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill), through
    ``kernels.flash_attention``: the CUDA kernels on the card, their plain
    versions on the CPU."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = qkv_proj(p, x, n_heads, n_kv_heads, d_head, positions, rope_theta)
    ctx = flash_attention(q, k, v, causal=causal)
    return ctx.reshape(B, S, n_heads * d_head) @ p["wo"].to(x.dtype)


def decode_attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    position: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    d_head: int,
    rope_theta: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step.  x (B,1,d); cache_k/v (B,S,KV,D); position (B,).

    Writes each row's new k and v into the caches in place and returns
    (out (B,1,d), cache_k, cache_v), the caches being the same tensors.  As
    the reference's ``dynamic_update_slice_in_dim`` does, a position past
    the cache's end writes to its last row, while RoPE and the mask see the
    position itself.
    """
    B = x.shape[0]
    q, k, v = qkv_proj(p, x, n_heads, n_kv_heads, d_head, position[:, None],
                       rope_theta)
    S = cache_k.shape[1]
    rows = torch.arange(B, device=x.device)
    at = position.clamp(0, S - 1)
    cache_k[rows, at] = k[:, 0]
    cache_v[rows, at] = v[:, 0]

    kf = _expand_kv(cache_k, n_heads)
    vf = _expand_kv(cache_v, n_heads)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kf).float() / math.sqrt(d_head)
    valid = torch.arange(S, device=x.device)[None, :] <= position[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return ctx.reshape(B, 1, n_heads * d_head) @ p["wo"].to(x.dtype), cache_k, cache_v
