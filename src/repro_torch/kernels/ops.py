"""``flash_attention``: a ``torch.autograd.Function`` whose backward
*recomputes* the attention probabilities (port of ``repro/kernels/ops.py``).

Interface matches the model layout (B, S, H, D) / (B, S, KV, D).  The
kernels read and write the transposed (B, H, S, D) views through their
strides, so no layout copy is made.  The residuals saved for the backward
are q, k, v, out and lse only — never the (Sq, Sk) probabilities.  A CUDA
tensor goes to the kernels (or raises); a CPU tensor goes to their plain
versions (``kernels/ref.py``).
"""

from __future__ import annotations

import torch

from . import flash_attention as fa


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = fa.flash_attention_fwd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal
        )
        out = out.transpose(1, 2)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = fa.flash_attention_bwd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            out.transpose(1, 2), lse, do.contiguous().transpose(1, 2),
            causal=ctx.causal,
        )
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2), None


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,
    causal: bool = True,
) -> torch.Tensor:
    """Differentiable flash attention in model layout (B, S, H, D)."""
    return FlashAttention.apply(q, k, v, causal)
