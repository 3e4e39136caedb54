"""Core layer primitives (port of ``repro/models/layers.py``).

Plain functions on tensors; the ``nn.Module``s in ``models.transformer``
hold the parameters and call them.  As in the reference, weights are cast
to the activation dtype at each use (so autograd saves the cast copies, in
bf16 on the training path), and norms, RoPE and the loss compute in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.fx_graph import tracing
from repro_torch.parallel.sharding import model_parallel, shard
from repro_torch.parallel.vocab import embed_rows, pick


def checkpointed(fn, *args):
    """``fn(*args)`` under a non-reentrant ``torch.utils.checkpoint``, except
    while ``core.fx_graph`` traces: the traced graph then holds ``fn``'s ops
    and the plan decides what they recompute (ROADMAP.md §3)."""
    if tracing():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def init_normal(shape, scale: float, *, device=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """f32 N(0, scale²) parameter tensor drawn from ``generator``."""
    return torch.randn(shape, device=device, generator=generator) * scale


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 over the last axis, with the population variance
    (``jnp.var``'s default: ``correction=0``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., :, None].float() * freqs  # (..., seq, d/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def gather_sequence(x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) activations whole along S where a matmul flattens them or
    their cotangent: Megatron's all-gather of the sequence-parallel
    residual before a matmul, and an MLP's partial sums made whole after
    its down projection (as the reference constrains the attention's
    output), so that the residual's sequence-sharded cotangent is gathered
    before that projection's backward flattens it.  GSPMD and newer
    DTensors redistribute implicitly; older DTensors refuse to flatten a
    sharded S, so the port constrains it (identity off a model axis)."""
    return shard(x, "batch", None, "model")


def swiglu(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    x = gather_sequence(x)
    g = x @ w_gate.to(dt)
    u = x @ w_up.to(dt)
    h = shard(F.silu(g.float()).to(dt) * u, "batch", None, "ffn")
    return gather_sequence(h @ w_down.to(dt))


def gelu_mlp(w_up: torch.Tensor, w_down: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Up projection, GELU in f32 with the tanh approximation
    (``jax.nn.gelu``'s default, not torch's exact one), down projection."""
    dt = x.dtype
    h = F.gelu((gather_sequence(x) @ w_up.to(dt)).float(), approximate="tanh").to(dt)
    h = shard(h, "batch", None, "ffn")
    return gather_sequence(h @ w_down.to(dt))


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows of ``table`` (V, d).  On a model-parallel mesh each vocab shard
    looks up the tokens of its slice and the shards' rows are summed
    (``parallel.vocab.embed_rows``): DTensor's own lookup on a
    vocab-sharded table leaves a masked partial value whose mask lives on
    a shared placement object, which a plan that recomputes the lookup or
    its reader corrupts."""
    table = table.to(dtype)
    if not model_parallel(tokens):
        return F.embedding(tokens, table)
    return embed_rows(table, tokens)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., d) × (V, d) → f32 logits (..., V)."""
    return shard((gather_sequence(x) @ table.to(x.dtype).t()).float(), "batch", None, "vocab")


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy; logits (..., V) f32, labels (...) int.

    The reference picks the gold logit with a one-hot contraction, so that
    GSPMD reduces vocab-sharded logits shard-locally; on one card a gather
    selects the same value.  On a model-parallel mesh the port computes
    the log-partition on the vocab shards: a row max (all-reduced with
    max) and the sum of exponentials (all-reduced with sum), and each
    shard picks the gold logits of its slice (``parallel.vocab.pick``,
    summed over the shards), so no rank holds the full (B, S, V) logits
    (``torch.logsumexp`` on DTensor would all-gather them first; a gather
    along the shards leaves a masked partial value that DTensor can reduce
    only once, which a plan that recomputes its reader cannot honour)."""
    logits = logits.float()
    if not model_parallel(logits):
        logz = torch.logsumexp(logits, dim=-1)
        return (logz - logits.gather(-1, labels.long()[..., None])[..., 0]).mean()
    # the shards' maxima and partial sums all-reduced over the vocab
    # (DTensor would reduce-scatter them over the batch instead)
    top = shard(logits.detach().amax(dim=-1, keepdim=True), "batch", None, None)
    total = shard(torch.exp(logits - top).sum(dim=-1), "batch", None)
    logz = torch.log(total) + top[..., 0]
    gold = shard(pick(logits, labels.long()), "batch", None)
    return (logz - gold).mean()
