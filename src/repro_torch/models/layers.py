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


def init_normal(shape, scale: float, *, device=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """f32 N(0, scale²) parameter tensor drawn from ``generator``."""
    return torch.randn(shape, device=device, generator=generator) * scale


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


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


def swiglu(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = x @ w_gate.to(dt)
    u = x @ w_up.to(dt)
    h = F.silu(g.float()).to(dt) * u
    return h @ w_down.to(dt)


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.embedding(tokens, table.to(dtype))


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., d) × (V, d) → f32 logits (..., V)."""
    return (x @ table.to(x.dtype).t()).float()


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy; logits (..., V) f32, labels (...) int.

    The reference picks the gold logit with a one-hot contraction (for a
    vocab-sharded GSPMD layout); on one card a gather selects the same value.
    """
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()
