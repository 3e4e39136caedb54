"""Attention for train/prefill (port of ``repro/models/attention.py``).

GQA self-attention over a full sequence.  Unlike the reference, which sends
only TPU runs with ``S % 128 == 0`` to its Pallas kernel, the port sends
every full-sequence attention to ``kernels.flash_attention``: the CUDA
kernels on the card (any length, bounds-checked), their plain versions on
the CPU.  ``dense_attention`` is the O(S²)-memory reference the tests
compare with.  ``decode_attention`` is one step of KV-cache decode in plain
PyTorch, as the reference's is plain array code (on DTensors, on each
rank's shard of the cache).  ``chunked_attention`` is
the reference's memory-efficient XLA lowering in plain torch (an online
softmax over KV chunks); as in the reference off its kernel, ``attention``
takes it, under a checkpoint, for a CPU tensor longer than
``chunked_threshold``, so the CPU never holds an (S, S) score matrix there
(:data:`CHUNKED_THRESHOLD`, which the dry run raises while its CPU fake
tensors stand in for the card's).  :func:`split_heads` and :func:`merge_heads` gather
a projection's columns around the head reshapes where the model axis does
not divide the heads.
"""

from __future__ import annotations

import contextvars
import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels.ops import flash_attention
from repro_torch.parallel.sharding import logical_shards, resolve, shard, spec_to_placements
from .layers import apply_rope, checkpointed, gather_sequence

#: The length above which ``attention`` takes ``chunked_attention`` for a
#: CPU tensor (unless given ``chunked_threshold=``).  The dry run sets it
#: to infinity while it steps fake CPU tensors that stand in for the card's.
CHUNKED_THRESHOLD: contextvars.ContextVar[float] = contextvars.ContextVar(
    "chunked_threshold", default=8192)


def qkv_proj(p: Dict[str, torch.Tensor], x: torch.Tensor, n_heads: int,
             n_kv_heads: int, d_head: int, positions: torch.Tensor,
             rope_theta: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    dt = x.dtype
    x = gather_sequence(x)
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = split_heads(q, n_heads, d_head)
    k = split_heads(k, n_kv_heads, d_head)
    v = split_heads(v, n_kv_heads, d_head)
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)
    return q, k, v


def split_heads(t: torch.Tensor, n: int, d_head: int) -> torch.Tensor:
    """(..., n·d_head) → (..., n, d_head).  Where the heads axis's shards do
    not divide n (mistral-large's 8 KV heads, qwen2.5-14b's 40 heads or
    xlstm's 4 on a 16-way model axis, whose projections' columns the axis
    still divides), the columns are first gathered whole, as GSPMD
    reshards before the reshape: a DTensor does not split a dim it cannot
    divide."""
    if n % logical_shards(t, "heads"):
        t = shard(t, "batch", *(None,) * (t.dim() - 1))
    return t.reshape(*t.shape[:-1], n, d_head)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(..., n, d_head) → (..., n·d_head); where the heads axis's shards do
    not divide n, the result is constrained whole over them, so that its
    cotangent (split over the output projection's rows) is gathered before
    the reshape's backward splits it into heads."""
    n = t.shape[-2]
    out = t.reshape(*t.shape[:-2], n * t.shape[-1])
    if n % logical_shards(t, "heads"):
        out = shard(out, "batch", *(None,) * (out.dim() - 1))
    return out


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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, q_chunk: int = 1024,
                      kv_chunk: int = 1024, scale: Optional[float] = None) -> torch.Tensor:
    """Memory-efficient attention: online softmax over KV chunks.

    Never materializes more than (B, H, q_chunk, kv_chunk) scores.  S and Sk
    are padded to chunk multiples (the VLM prefix makes S = 32768 + 576):
    padded KV rows sit beyond every real query position, so the causal mask
    excludes them, and padded query rows are sliced off at the end.
    """
    B, S, H, D = q.shape
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    Sk = k.shape[1]
    q_chunk, kv_chunk = min(q_chunk, S), min(kv_chunk, Sk)
    orig_S = S
    pad_q, pad_k = (-S) % q_chunk, (-Sk) % kv_chunk
    if pad_q or pad_k:
        if not causal:
            raise ValueError("chunk padding requires causal masking")
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        S, Sk = S + pad_q, Sk + pad_k
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    outs = []
    for qi in range(S // q_chunk):
        q_blk = q[:, qi * q_chunk:(qi + 1) * q_chunk].transpose(1, 2)  # (B,H,qc,D)
        acc = q.new_zeros((B, H, q_chunk, D), dtype=torch.float32)
        m = q.new_full((B, H, q_chunk), float("-inf"), dtype=torch.float32)
        s = q.new_zeros((B, H, q_chunk), dtype=torch.float32)
        for ki in range(Sk // kv_chunk):
            k_blk = k[:, ki * kv_chunk:(ki + 1) * kv_chunk].transpose(1, 2)
            v_blk = v[:, ki * kv_chunk:(ki + 1) * kv_chunk].transpose(1, 2)
            scores = torch.einsum("bhqd,bhkd->bhqk", q_blk, k_blk).float() * scale
            if causal:
                qpos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
                kpos = ki * kv_chunk + torch.arange(kv_chunk, device=q.device)
                scores = scores.masked_fill(~(qpos[:, None] >= kpos[None, :]),
                                            float("-inf"))
            m_new = torch.maximum(m, scores.amax(dim=-1))
            # guard fully-masked rows (m_new = -inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
            p = torch.exp(scores - m_safe[..., None])
            p = torch.where(torch.isfinite(scores), p, torch.zeros_like(p))
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                torch.zeros_like(m))
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(v_blk.dtype), v_blk).float()
            s = s * alpha + p.sum(dim=-1)
            m = m_new
        outs.append(acc / torch.clamp(s[..., None], min=1e-30))
    out = torch.cat(outs, dim=2).transpose(1, 2)  # (B, S, H, D)
    return out[:, :orig_S].to(q.dtype)


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
    chunked_threshold: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill), through
    ``kernels.flash_attention``: the CUDA kernels on the card, their plain
    versions on the CPU up to ``chunked_threshold`` tokens (None:
    :data:`CHUNKED_THRESHOLD`'s), and above it
    ``chunked_attention`` under a checkpoint, as the reference runs off
    its kernel.  Scores are scaled by ``scale`` (None: 1/sqrt(d_head));
    ``rope_theta`` 0 leaves positions unencoded."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = qkv_proj(p, x, n_heads, n_kv_heads, d_head, positions, rope_theta)
    if chunked_threshold is None:
        chunked_threshold = CHUNKED_THRESHOLD.get()
    if x.device.type == "cpu" and S > chunked_threshold:
        ctx = checkpointed(lambda q_, k_, v_: chunked_attention(q_, k_, v_, causal=causal,
                                                                scale=scale),
                           q, k, v)
    else:
        ctx = flash_attention(q, k, v, causal=causal, scale=scale)
    ctx = shard(ctx, "batch", None, "heads", None)
    out = merge_heads(ctx) @ p["wo"].to(x.dtype)
    return shard(out, "batch", None, "model")


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

    On DTensors each rank writes the rows and heads its cache shard holds,
    on its local tensor (:func:`_write_rows`), and attends on its shard
    (:func:`attend_cache`): the cache is neither gathered nor copied.  The
    reference pins the cache to ``("batch", "seq_sp", "kv_heads", None)``;
    a cache stored in another layout is redistributed to it for the
    attention (a copy), after the write.
    """
    B = x.shape[0]
    q, k, v = qkv_proj(p, x, n_heads, n_kv_heads, d_head, position[:, None],
                       rope_theta)
    if isinstance(cache_k, DTensor):
        _write_rows(cache_k, k, position)
        _write_rows(cache_v, v, position)
        kc, vc = (_pin_cache(c) for c in (cache_k, cache_v))
    else:
        S = cache_k.shape[1]
        rows = torch.arange(B, device=x.device)
        at = position.clamp(0, S - 1)
        cache_k[rows, at] = k[:, 0]
        cache_v[rows, at] = v[:, 0]
        kc, vc = cache_k, cache_v
    ctx = attend_cache(q, kc, vc, position)
    out = merge_heads(ctx) @ p["wo"].to(x.dtype)
    return shard(out, "batch", None, "model"), cache_k, cache_v


def attend_cache(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 position: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One query a row against a cache: q (B,1,H,D), k/v (B,S,KV,D), keys
    past ``position`` (B,) masked (None: none); the softmax in f32, as the
    reference's decode.

    On DTensors (k and v in one layout) the attention runs on each rank's
    local rows, heads and cache positions, with q and the positions
    brought to the same rows and heads; where the cache's sequence is
    split (one long sequence over ``data``) the softmax's max and sum and
    the context's partial sums are all-reduced over that axis."""
    if not isinstance(k, DTensor):
        return _attend(q, k, v, position, 0)
    mesh, lay = k.device_mesh, list(k.placements)
    row_lay = _rows_and_heads(lay)
    pos = None if position is None else _onto(position, _rows(lay)).to_local()
    seq_split = [(mesh, i) for i, pl in enumerate(lay) if isinstance(pl, Shard) and pl.dim == 1]
    ctx = _attend(_onto(q, row_lay).to_local(), k.to_local(), v.to_local(), pos,
                  _offset(k, 1), seq_split)
    return DTensor.from_local(ctx, mesh, row_lay, run_check=False)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            position: Optional[torch.Tensor], key0: int, seq_split=()) -> torch.Tensor:
    """``attend_cache`` on plain tensors whose keys start at global index
    ``key0``; ``seq_split`` lists the mesh dims (``(mesh, dim)`` groups)
    that split the keys, over which the softmax is reduced."""
    H, D = q.shape[2], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, _expand_kv(k, H)).float() / math.sqrt(D)
    if position is not None:
        keys = key0 + torch.arange(k.shape[1], device=k.device)
        scores = scores.masked_fill(~(keys[None, :] <= position[:, None])[:, None, None, :],
                                    float("-inf"))
    if not seq_split:
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, _expand_kv(v, H))
    import torch.distributed._functional_collectives as funcol

    top = scores.amax(dim=-1, keepdim=True)
    for group in seq_split:
        top = funcol.all_reduce(top, "max", group)
    e = torch.exp(scores - top)
    total = e.sum(dim=-1, keepdim=True)
    for group in seq_split:
        total = funcol.all_reduce(total, "sum", group)
    ctx = torch.einsum("bhqk,bkhd->bqhd", (e / total).to(q.dtype), _expand_kv(v, H))
    for group in seq_split:
        ctx = funcol.all_reduce(ctx, "sum", group)
    return ctx


def _rows_and_heads(placements) -> list:
    """A cache's placements with its sequence (dim 1) whole: the layout of
    one new row (B, 1, KV, D), or of a query."""
    return [Replicate() if isinstance(pl, Shard) and pl.dim == 1 else pl
            for pl in placements]


def _rows(placements) -> list:
    """The placements of a (B,) tensor split as a cache's rows."""
    return [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in placements]


def _onto(t: torch.Tensor, placements) -> DTensor:
    return t if list(t.placements) == list(placements) else t.redistribute(
        t.device_mesh, placements)


def _offset(t: DTensor, dim: int) -> int:
    """The global index of this rank's first element of ``t`` along ``dim``."""
    from repro_torch.parallel.sharding import local_shape_and_offset

    return local_shape_and_offset(t.shape, t.device_mesh, t.placements)[1][dim]


def _write_rows(cache: DTensor, new: torch.Tensor, position: torch.Tensor) -> None:
    """cache[b, min(position[b], S-1)] = new[b, 0], in place on each rank's
    shard: the rows, heads and positions it holds."""
    S = cache.shape[1]
    local = cache.to_local()
    nb, ns = local.shape[:2]
    row = _onto(new, _rows_and_heads(cache.placements)).to_local()[:, 0]
    pos = _onto(position, _rows(cache.placements)).to_local()
    at = pos.clamp(0, S - 1) - _offset(cache, 1)
    inside = (at >= 0) & (at < ns)
    rows = torch.arange(nb, device=local.device)
    at = at.clamp(0, ns - 1)
    local[rows, at] = torch.where(inside[:, None, None], row, local[rows, at])


def _pin_cache(cache: DTensor) -> DTensor:
    """The reference's ``shard(cache, "batch", "seq_sp", "kv_heads", None)``:
    the cache itself when it is laid out so, else a redistributed copy."""
    mesh = cache.device_mesh
    want = spec_to_placements(resolve(("batch", "seq_sp", "kv_heads", None), mesh,
                                      shape=tuple(cache.shape)), mesh)
    return _onto(cache, want)
