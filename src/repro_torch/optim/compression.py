"""Block-wise int8 codec (port of the codec half of
``repro/optim/compression.py``).

``compress``/``decompress`` are the reference's symmetric int8 block
quantization (one f32 scale per 256-element block), in plain torch as the
reference's are plain jnp.  ``straight_through_roundtrip`` is the value a
``quantize`` storage strategy replays from storage, with an identity
gradient.  ``quantize_roundtrip_with_feedback`` / ``init_error_feedback``
are the reference's error-feedback round-trip of the gradients, on lists
or dicts of tensors; ``Trainer(compress_grads=True)`` runs its one-tensor
step, ``roundtrip_leaf_with_feedback``, gradient by gradient, on whole
(replicated) gradients: the reference quantizes the global array in
256-element blocks, which a rank's shard of a sharded gradient does not
line up with, so a ``compress_grads`` Trainer on sharded parameters (a
model axis, FSDP) raises, naming ROADMAP.md 'Multi-device'.  The
reference's ``hierarchical_psum`` (a ``shard_map`` collective, which
nothing in the reference calls) waits for ROADMAP.md module queue, item
'Multi-device'.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch.utils._pytree as pytree

import torch

BLOCK = 256


class Compressed(NamedTuple):
    q: torch.Tensor  # int8 payload, (n_blocks, BLOCK)
    scale: torch.Tensor  # f32 per-block scales, (n_blocks,)
    shape: Tuple[int, ...]


def compress(x: torch.Tensor) -> Compressed:
    """f32 cast, zero-pad to whole blocks, scale by max|x|/127 (at least
    1e-12), round half to even, clip to ±127, store int8."""
    shape = tuple(x.shape)
    flat = x.detach().to(torch.float32).reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return Compressed(q=q, scale=scale[:, 0], shape=shape)


def decompress(c: Compressed) -> torch.Tensor:
    """The f32 values of a :class:`Compressed` in its original shape."""
    flat = (c.q.to(torch.float32) * c.scale[:, None]).reshape(-1)
    n = 1
    for d in c.shape:
        n *= d
    return flat[:n].reshape(c.shape)


def straight_through_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """int8 round-trip with a straight-through gradient.

    Value is ``decompress(compress(x))`` (the int8+scale storage a
    ``quantize`` plan strategy keeps on the device); gradient is identity —
    ``round``/``clamp`` have zero derivative, so without the estimator the
    cotangent through a quantized residual would vanish.
    """
    return roundtrip_with_payload(x)[0]


def roundtrip_with_payload(x: torch.Tensor) -> Tuple[torch.Tensor, Compressed]:
    """``straight_through_roundtrip(x)`` and the :class:`Compressed` it
    decompresses (what a quantized residual keeps; the lowerings'
    ``storage`` module)."""
    c = compress(x.detach())
    rt = decompress(c).to(x.dtype)
    return x + (rt - x).detach(), c


def roundtrip_leaf_with_feedback(g: torch.Tensor,
                                 e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 round-trip of one tensor: g' = Q(g + e);
    e' = (g + e) − g' (``e`` f32).  Numerically this is what a compressed
    all-reduce applies to each shard; the Trainer runs it on each
    gradient's local value."""
    target = g.to(torch.float32) + e
    q = decompress(compress(target))
    return q.to(g.dtype), target - q


def quantize_roundtrip_with_feedback(grads: Any, error: Any) -> Tuple[Any, Any]:
    """:func:`roundtrip_leaf_with_feedback` over pytrees of one structure
    (the reference's signature)."""
    flat_g, spec = pytree.tree_flatten(grads)
    flat_e = pytree.tree_leaves(error)
    outs = [roundtrip_leaf_with_feedback(g, e) for g, e in zip(flat_g, flat_e)]
    return (pytree.tree_unflatten([o[0] for o in outs], spec),
            pytree.tree_unflatten([o[1] for o in outs], spec))


def init_error_feedback(like: Any) -> Any:
    """Zero f32 error buffers shaped like ``like``'s tensors (same
    devices; a DTensor gets a DTensor in its placements)."""
    return pytree.tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), like)
