"""``flash_attention``: a ``torch.library.custom_op`` whose backward
*recomputes* the attention probabilities (port of ``repro/kernels/ops.py``).

Interface matches the model layout (B, S, H, D) / (B, S, KV, D).  The
kernels read the transposed (B, H, S, D) views through their strides, so
no layout copy is made of the inputs.  The residuals saved for the
backward are q, k, v, out and lse only — never the (Sq, Sk) probabilities.
A CUDA tensor goes to the kernels (or raises); a CPU tensor goes to their
plain versions (``kernels/ref.py``).  lse is differentiable too: its
cotangent enters the dq and dk/dv kernels through their ``delta``
(``flash_attention_bwd``).

Being one registered operator (``repro_torch::flash_attention``, with a
fake implementation for shapes), attention is a single opaque node when
``core.fx_graph`` traces a model with ``make_fx``: the planner can cache
or recompute it as a whole, and recomputing it launches the forward kernel
again.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import flash_attention as fa


def _bhsd(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(1, 2)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, Sq, H, D) contiguous in q's dtype, lse (B, H, Sq) f32)."""
    out, lse = fa.flash_attention_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal=causal)
    return _bhsd(out).contiguous(), lse


@flash_attention_op.register_fake
def _(q, k, v, causal):
    B, Sq, H, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B, H, Sq), dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    q, k, v, causal = inputs
    out, lse = output
    ctx.causal = causal
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.set_materialize_grads(False)


def _backward(ctx, do, dlse):
    q, k, v, out, lse = ctx.saved_tensors
    if do is None and dlse is None:
        return None, None, None, None
    do = torch.zeros_like(out) if do is None else do.contiguous()
    dq, dk, dv = fa.flash_attention_bwd(_bhsd(q), _bhsd(k), _bhsd(v), _bhsd(out), lse,
                                        _bhsd(do), causal=ctx.causal, dlse=dlse)
    return _bhsd(dq), _bhsd(dk), _bhsd(dv), None


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,
    causal: bool = True,
) -> torch.Tensor:
    """Differentiable flash attention in model layout (B, S, H, D)."""
    return flash_attention_op(q, k, v, causal)[0]
