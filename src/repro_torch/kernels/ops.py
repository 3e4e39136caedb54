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
again.  Its backward is a registered operator too
(``repro_torch::flash_attention_bwd``).

**On DTensors** both operators carry a DTensor sharding rule
(``register_sharding``): batch and heads are shardable, Sq, Sk and D are
replicated, lse follows q's (B, H).  DTensor then runs each operator on
its local shards, so only plain local tensors ever reach the kernels'
wrappers (which raise on a DTensor): on a model axis, each rank's H/model
heads.  q, k and v must arrive in one layout: where they do not (GQA's KV
heads that the model axis does not divide, left whole while q's heads
split), the rule raises instead of letting DTensor gather heads inside
attention.  The rules are registered when this module is imported (a
registry entry: no process group is touched).
"""

from __future__ import annotations

from typing import Optional, Tuple

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


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                           dlse: Optional[torch.Tensor], causal: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in model layout: the recompute backward
    (``flash_attention.flash_attention_bwd``), each a (B, S, H, D) view of
    the kernels' (B, H, S, D) result."""
    dq, dk, dv = fa.flash_attention_bwd(_bhsd(q), _bhsd(k), _bhsd(v), _bhsd(out), lse,
                                        _bhsd(do), causal=causal, dlse=dlse)
    return _bhsd(dq), _bhsd(dk), _bhsd(dv)


@flash_attention_bwd_op.register_fake
def _(q, k, v, out, lse, do, dlse, causal):
    return tuple(_bhsd(_bhsd(t).new_empty(_bhsd(t).shape)) for t in (q, k, v))


def _backward(ctx, do, dlse):
    q, k, v, out, lse = ctx.saved_tensors
    if do is None and dlse is None:
        return None, None, None, None
    do = torch.zeros_like(out) if do is None else do.contiguous()
    dq, dk, dv = flash_attention_bwd_op(q, k, v, out, lse, do, dlse, ctx.causal)
    return dq, dk, dv, None


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


def _register_dtensor_rules() -> None:
    """Both operators' DTensor sharding rules.  Per mesh dim: all
    replicated; batch sharded (dim 0 of every tensor); or heads sharded
    (dim 2 of the (B, S, H, D) tensors, dim 1 of lse and dlse: q's heads
    and k's KV heads split alike, so each shard keeps whole GQA groups
    when the mesh dim divides KV)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    # (placement of the (B, S, H, D) tensors, placement of lse and dlse)
    options = ((Replicate(), Replicate()), (Shard(0), Shard(0)), (Shard(2), Shard(1)))

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _fwd_rule(q, k, v, causal):
        _same_layout(q, k, v)
        return [([big, stats], [big, big, big, None]) for big, stats in options]

    @register_sharding(torch.ops.repro_torch.flash_attention_bwd.default)
    def _bwd_rule(q, k, v, out, lse, do, dlse, causal):
        _same_layout(q, k, v)
        return [([big, big, big],
                 [big, big, big, big, stats, big, None if dlse is None else stats, None])
                for big, stats in options]


def _same_layout(q, k, v) -> None:
    """q, k and v must arrive in one layout: DTensor would otherwise gather
    heads inside attention without a word (q's heads split over the model
    axis while GQA's KV heads, which it does not divide, stay whole)."""
    layouts = [tuple(t.placements) for t in (q, k, v)]
    if layouts[1:] != layouts[:1] * 2:
        from repro_torch.core.lowering.base import not_ported

        raise not_ported(
            f"flash attention on q, k, v in differing layouts {layouts} (KV heads the "
            "model axis does not divide)", "Multi-device")


if torch.distributed.is_available():
    _register_dtensor_rules()


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,
    causal: bool = True,
) -> torch.Tensor:
    """Differentiable flash attention in model layout (B, S, H, D)."""
    return flash_attention_op(q, k, v, causal)[0]
