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
heads.  The rules are registered when this module is imported (a
registry entry: no process group is touched).

**GQA whose KV heads the model axis does not divide** (mistral-large's 8
on a 16-way axis): the reference splits q's heads over ``model`` and
leaves k and v whole.  :func:`flash_attention` (and the replay of a
traced flash node) first brings k and v to q's layout
(:func:`kv_to_q_heads`): each rank repeats, locally, the KV heads that
its own H/m q heads read (m the ranks that split q's heads), so the
global k is ``k.repeat_interleave(H // KV, 2)`` in q's placements and the
local call is MHA at H/m heads (mistral-large on 16: 6 heads, each a copy
of the rank's one KV head).  The forward sends nothing.  Its backward
sums each rank's dk and dv into the KV heads they belong to and
all-reduces the (B, S, KV, D) sums over those ranks, once for k and once
for v in each attention: per layer 2·B_l·S·KV·D activation-dtype elements
all-reduced.  Repeating to all H heads and letting DTensor slice them
(Replicate → Shard) would all-gather 2·B_l·S·H·D in the backward, H/KV
times the payload (12× for mistral-large), and at least as many bytes on
the wire for any KV the axis does not divide (a ring all-reduce sends
2(m−1)/m of its payload, an all-gather (m−1)/m of its output).  Keeping
the local call GQA (repeating to R = lcm(KV, m) heads only, one KV head a
rank for mistral-large) sends the same all-reduce, but leaves the dk/dv
kernel, whose grid runs over KV heads and key blocks, a grid H/m times
smaller: at mistral-large's shard on an H100 the dk/dv kernel took
0.6262 ms as GQA over one KV head and 0.1171 ms as MHA over six, whose
local repeat and sum add 0.0146 and 0.0211 ms (``chip_smoke.py
--gqa-designs``).  Any other mismatch of layouts still raises, so DTensor
never gathers heads inside attention without a word.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import flash_attention as fa


def _bhsd(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(1, 2)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, scale: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, Sq, H, D) contiguous in q's dtype, lse (B, H, Sq) f32);
    scores scaled by ``scale`` (None: 1/sqrt(D))."""
    out, lse = fa.flash_attention_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal=causal,
                                      scale=scale)
    return _bhsd(out).contiguous(), lse


@flash_attention_op.register_fake
def _(q, k, v, causal, scale=None):
    B, Sq, H, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B, H, Sq), dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    out, lse = output
    ctx.causal, ctx.scale = causal, scale
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.set_materialize_grads(False)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                           dlse: Optional[torch.Tensor], causal: bool,
                           scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in model layout: the recompute backward
    (``flash_attention.flash_attention_bwd``), each a (B, S, H, D) view of
    the kernels' (B, H, S, D) result."""
    dq, dk, dv = fa.flash_attention_bwd(_bhsd(q), _bhsd(k), _bhsd(v), _bhsd(out), lse,
                                        _bhsd(do), causal=causal, dlse=dlse, scale=scale)
    return _bhsd(dq), _bhsd(dk), _bhsd(dv)


@flash_attention_bwd_op.register_fake
def _(q, k, v, out, lse, do, dlse, causal, scale=None):
    return tuple(_bhsd(_bhsd(t).new_empty(_bhsd(t).shape)) for t in (q, k, v))


def _backward(ctx, do, dlse):
    q, k, v, out, lse = ctx.saved_tensors
    if do is None and dlse is None:
        return None, None, None, None, None
    do = torch.zeros_like(out) if do is None else do.contiguous()
    if ctx.scale is None:  # the op's default, left out of the call
        dq, dk, dv = flash_attention_bwd_op(q, k, v, out, lse, do, dlse, ctx.causal)
    else:
        dq, dk, dv = flash_attention_bwd_op(q, k, v, out, lse, do, dlse, ctx.causal,
                                            ctx.scale)
    return dq, dk, dv, None, None


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
    def _fwd_rule(q, k, v, causal, scale=None):
        _same_layout(q, k, v)
        return [([big, stats], [big, big, big, None, None]) for big, stats in options]

    @register_sharding(torch.ops.repro_torch.flash_attention_bwd.default)
    def _bwd_rule(q, k, v, out, lse, do, dlse, causal, scale=None):
        _same_layout(q, k, v)
        return [([big, big, big],
                 [big, big, big, big, stats, big, None if dlse is None else stats, None,
                  None])
                for big, stats in options]


def _same_layout(q, k, v) -> None:
    """q, k and v must arrive in one layout (:func:`kv_to_q_heads` brings
    GQA's whole KV heads to q's split ones first): DTensor would otherwise
    gather heads inside attention without a word."""
    layouts = [tuple(t.placements) for t in (q, k, v)]
    if layouts[1:] != layouts[:1] * 2:
        from repro_torch.core.lowering.base import not_ported

        raise not_ported(
            f"flash attention on q, k, v in differing layouts {layouts} (KV heads the "
            "model axis does not divide)", "Multi-device")


if torch.distributed.is_available():
    _register_dtensor_rules()


def _split_heads_dims(q, k) -> list:
    """The mesh dims on which q's heads are split and k's are whole, when
    that is the only difference of their layouts (else [])."""
    from torch.distributed.tensor import DTensor, Shard

    if not (isinstance(q, DTensor) and isinstance(k, DTensor)):
        return []
    dims = []
    for d, (a, b) in enumerate(zip(q.placements, k.placements)):
        if a == b:
            continue
        if not (isinstance(a, Shard) and a.dim == 2 and b.is_replicate()):
            return []
        dims.append(d)
    return dims


class _KVToQHeads(torch.autograd.Function):
    """k (B, S, KV, D), whole over the mesh dims ``dims`` that split q's
    heads, → this rank's H/m heads of k repeated to R = H (the global tensor
    is ``k.repeat_interleave(R // KV, 2)`` in q's placements).  Backward:
    each local head's cotangent summed into its KV head, then all-reduced
    over ``dims`` (a ``Partial`` sum redistributed to k's placements)."""

    @staticmethod
    def forward(ctx, k, q_placements, dims, R):
        from torch.distributed.tensor import DTensor

        from repro_torch.parallel.sharding import local_shape_and_offset

        B, S, KV, D = k.shape
        shape = (B, S, R, D)
        local_shape, offset = local_shape_and_offset(shape, k.device_mesh, q_placements)
        heads = torch.arange(offset[2], offset[2] + local_shape[2], device=k.device)
        kv = torch.div(heads, R // KV, rounding_mode="floor")
        ctx.kv, ctx.placements, ctx.dims = kv, list(k.placements), dims
        ctx.meta = (k.shape, k.stride(), k.device_mesh)
        local = k.to_local().index_select(2, kv)
        stride = (S * R * D, R * D, D, 1)  # contiguous (B, S, R, D)
        return DTensor.from_local(local, k.device_mesh, q_placements, run_check=False,
                                  shape=torch.Size(shape), stride=stride)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial

        shape, stride, mesh = ctx.meta
        g = g.to_local()
        summed = g.new_zeros((*g.shape[:2], shape[2], g.shape[3])).index_add_(2, ctx.kv, g)
        partial = [Partial() if d in ctx.dims else p for d, p in enumerate(ctx.placements)]
        dk = DTensor.from_local(summed, mesh, partial, run_check=False, shape=shape,
                                stride=stride)
        return dk.redistribute(mesh, ctx.placements), None, None, None


def kv_to_q_heads(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """k (or v) in q's layout where GQA's KV heads are whole while q's are
    split over the mesh (the module docstring: repeated to q's H heads,
    each rank making its H/m locally); k itself otherwise."""
    dims = _split_heads_dims(q, k)
    if not dims:
        return k
    return _KVToQHeads.apply(k, list(q.placements), dims, q.shape[2])


def flash_attention_on_mesh(q, k, v, causal: bool, scale: Optional[float] = None):
    """The op ``(out, lse)``, with GQA's whole KV heads first brought to q's
    split heads on a mesh (:func:`kv_to_q_heads`).  A ``scale`` of None
    (1/sqrt(D)) is left out of the op's call, so a trace records the call
    as it was before the op took one."""
    k, v = kv_to_q_heads(q, k), kv_to_q_heads(q, v)
    if scale is None:
        return flash_attention_op(q, k, v, causal)
    return flash_attention_op(q, k, v, causal, scale)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable flash attention in model layout (B, S, H, D); scores
    scaled by ``scale`` (None: 1/sqrt(D))."""
    return flash_attention_on_mesh(q, k, v, causal, scale)[0]
