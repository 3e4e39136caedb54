"""Block-wise int8 codec and the compressed cross-pod all-reduce (port of
``repro/optim/compression.py``).

``compress``/``decompress`` are the reference's symmetric int8 block
quantization (one f32 scale per 256-element block), in plain torch as the
reference's are plain jnp.  ``straight_through_roundtrip`` is the value a
``quantize`` storage strategy replays from storage, with an identity
gradient.  ``quantize_roundtrip_with_feedback`` / ``init_error_feedback``
are the reference's error-feedback round-trip of the gradients, on lists
or dicts of tensors; ``Trainer(compress_grads=True)`` runs its one-tensor
step, ``roundtrip_leaf_with_feedback``, gradient by gradient.

**On a DTensor** the codec is the global one: its blocks are 256 elements
of the row-major flattening of the *global* tensor (the reference
quantizes the global array), and each rank quantizes its own elements,
bitwise as ``compress(x.full_tensor())`` restricted to them
(:func:`compress_shard`, :class:`ShardCompressed`).  Where every run of the
rank's box in the global flattening starts on a block boundary and spans
whole blocks (or ends the tensor), the shard's own blocks are the global
ones and it is compressed locally, sending nothing: a replicated tensor, a
``Shard(0)`` of rows whose size is a multiple of 256 elements, a
``Shard(1)`` of 256-element column runs.  Elsewhere each rank takes the
absmax of the global blocks its elements touch (zero for the others) and
all-reduces the vector of every block's absmax with ``max`` over each mesh
dim that shards the tensor: ``4·ceil(N/256)`` bytes a dim, N the global
element count (``analysis.census.CountCollectives`` counts them).  A
``Partial`` tensor is reduced first (its global value is the sum).
``roundtrip_with_payload``, ``straight_through_roundtrip`` and
``roundtrip_leaf_with_feedback`` take this path for a DTensor and return
DTensors in its placements.

``hierarchical_psum`` is the reference's ``shard_map`` collective on the
local tensor inside a ``DeviceMesh``: a reduce-scatter over ``data``, the
int8 payload and the scales all-reduced over ``pod``, an all-gather over
``data``; with its arithmetic kept as it is (ROADMAP.md §3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch
import torch.utils._pytree as pytree

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


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Where a DTensor's local elements lie in its global tensor: the global
    shape, this rank's box (shape and offset; DTensor's
    ``compute_local_shape_and_global_offset``), the mesh and placements,
    and the mesh dims that shard it."""

    shape: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    offset: Tuple[int, ...]
    mesh: Any
    placements: Tuple[Any, ...]
    stride: Tuple[int, ...]

    @property
    def sharding_dims(self) -> Tuple[int, ...]:
        return tuple(d for d, p in enumerate(self.placements) if not p.is_replicate())

    def aligned(self) -> bool:
        """Whether the local flattening's 256-element chunks are global
        blocks: each run of the box in the global flattening starts on a
        block boundary and holds whole blocks, or is the one run and ends
        the tensor."""
        partial = [d for d, (n, m) in enumerate(zip(self.local_shape, self.shape)) if n < m]
        if not partial:
            return True
        k = partial[-1]
        gstride = _contiguous_strides(self.shape)
        run = self.local_shape[k] * gstride[k]
        start = sum(o * s for o, s in zip(self.offset, gstride))
        runs = math.prod(self.local_shape[:k])
        if start % BLOCK or any(gstride[d] % BLOCK for d in range(k) if self.local_shape[d] > 1):
            return False
        return run % BLOCK == 0 or (runs == 1 and start + run == math.prod(self.shape))

    def block_ids(self, device: torch.device) -> torch.Tensor:
        """The global block of each local element, in local row-major order."""
        gstride = _contiguous_strides(self.shape)
        idx = torch.zeros(self.local_shape, dtype=torch.int64, device=device)
        for d, (n, o) in enumerate(zip(self.local_shape, self.offset)):
            view = [1] * len(self.local_shape)
            view[d] = n
            idx += (torch.arange(o, o + n, device=device) * gstride[d]).view(view)
        return idx.reshape(-1) // BLOCK


def _contiguous_strides(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


class ShardCompressed(NamedTuple):
    """One rank's part of the global codec of a DTensor: on an aligned
    layout ``q`` is (n_local_blocks, BLOCK) and ``scale`` their scales (the
    global blocks themselves); elsewhere ``q`` is the local elements'
    payload, flat, and ``scale`` the scales of the global blocks they
    touch, in block order."""

    q: torch.Tensor
    scale: torch.Tensor
    layout: ShardLayout


def shard_layout(x: Any) -> ShardLayout:
    """The :class:`ShardLayout` of a DTensor."""
    from ..parallel.sharding import local_shape_and_offset

    shape = tuple(x.shape)
    local, offset = local_shape_and_offset(shape, x.device_mesh, x.placements)
    return ShardLayout(shape, tuple(local), tuple(offset), x.device_mesh,
                       tuple(x.placements), tuple(x.stride()))


def compress_shard(local: torch.Tensor, layout: ShardLayout) -> ShardCompressed:
    """The global codec of the DTensor ``layout`` describes, on this rank's
    elements ``local``: bitwise ``compress`` of the global tensor restricted
    to them (module doc)."""
    if layout.aligned():
        c = compress(local)
        return ShardCompressed(c.q, c.scale, layout)
    import torch.distributed._functional_collectives as funcol

    flat = local.detach().to(torch.float32).reshape(-1)
    ids = layout.block_ids(flat.device)
    amax = flat.new_zeros(-(-math.prod(layout.shape) // BLOCK))
    amax.scatter_reduce_(0, ids, flat.abs(), "amax")
    for d in layout.sharding_dims:
        amax = funcol.all_reduce(amax, "max", (layout.mesh, d))
    touched, where = torch.unique(ids, sorted=True, return_inverse=True)
    scale = torch.clamp(amax[touched] / 127.0, min=1e-12)
    q = torch.clamp(torch.round(flat / scale[where]), -127, 127).to(torch.int8)
    return ShardCompressed(q, scale, layout)


def decompress_shard(c: ShardCompressed) -> torch.Tensor:
    """This rank's f32 values of a :class:`ShardCompressed`, in its local
    shape (a plain tensor)."""
    layout = c.layout
    if layout.aligned():
        return decompress(Compressed(c.q, c.scale, layout.local_shape))
    _, where = torch.unique(layout.block_ids(c.q.device), sorted=True, return_inverse=True)
    return (c.q.to(torch.float32) * c.scale[where]).reshape(layout.local_shape)


def local_payload(c: ShardCompressed) -> torch.Tensor:
    """The int8 payload of this rank's elements in its local shape (the
    reference's ``q`` of the global tensor restricted to them)."""
    n = math.prod(c.layout.local_shape)
    return c.q.reshape(-1)[:n].reshape(c.layout.local_shape)


def as_dtensor(local: torch.Tensor, layout: ShardLayout) -> Any:
    """``local`` as the DTensor of ``layout`` (no communication)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, layout.mesh, layout.placements, run_check=False,
                              shape=torch.Size(layout.shape), stride=layout.stride)


def reduce_partial(x: Any) -> Any:
    """A DTensor with its ``Partial`` placements reduced (replicated)."""
    from torch.distributed.tensor import Replicate

    if not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh,
                          [Replicate() if p.is_partial() else p for p in x.placements])


def _is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def straight_through_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """int8 round-trip with a straight-through gradient.

    Value is ``decompress(compress(x))`` (the int8+scale storage a
    ``quantize`` plan strategy keeps on the device); gradient is identity —
    ``round``/``clamp`` have zero derivative, so without the estimator the
    cotangent through a quantized residual would vanish.
    """
    return roundtrip_with_payload(x)[0]


def roundtrip_with_payload(x: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """``straight_through_roundtrip(x)`` and the :class:`Compressed` it
    decompresses (what a quantized residual keeps; the lowerings'
    ``storage`` module); for a DTensor the global codec's
    :class:`ShardCompressed` of this rank's elements."""
    if _is_dtensor(x):
        x = reduce_partial(x)
        layout = shard_layout(x)
        c = compress_shard(x.to_local().detach(), layout)
        rt = as_dtensor(decompress_shard(c).to(x.dtype), layout)
    else:
        c = compress(x.detach())
        rt = decompress(c).to(x.dtype)
    return x + (rt - x).detach(), c


def roundtrip_leaf_with_feedback(g: torch.Tensor,
                                 e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 round-trip of one tensor: g' = Q(g + e);
    e' = (g + e) − g' (``e`` f32).  Numerically this is what a compressed
    all-reduce applies to each shard.  A DTensor ``g`` (and ``e`` in its
    placements) runs the global codec on each rank's elements and returns
    DTensors in those placements."""
    if _is_dtensor(g):
        layout = shard_layout(g)
        if tuple(e.placements) != layout.placements:
            raise ValueError(f"error feedback in {e.placements}, gradient in {g.placements}")
        target = g.to_local().to(torch.float32) + e.to_local()
        q = decompress_shard(compress_shard(target, layout))
        return as_dtensor(q.to(g.dtype), layout), as_dtensor(target - q, layout)
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


def hierarchical_psum(x: torch.Tensor, mesh: Any, data_axis: str = "data",
                      pod_axis: str = "pod") -> torch.Tensor:
    """The reference's ``shard_map`` collective on this rank's tensor ``x``
    inside ``mesh`` (a ``DeviceMesh`` with a ``data_axis`` dim): the sum of
    ``x`` over the data and pod ranks.

    A reduce-scatter over ``data`` on dim 0 (tiled: dim 0 must divide by
    the data size), ``compress`` of the scattered sum, an all-reduce over
    ``pod`` of its int8 payload as int32 and one of its scales, the sum
    rebuilt as ``qsum · ssum / pod_size`` (each block's summed payload
    times the *mean* of the pods' scales), and an all-gather over ``data``.
    Without a ``pod_axis`` dim, or with one of size 1, a plain all-reduce
    over ``data``.  The collectives are ``_functional_collectives`` over
    the mesh's dim groups, so ``CountCollectives`` sees them.  The
    reference's arithmetic is kept as it is: the mean scale is not the
    sum's own, and the int32 pod sum moves as many bytes as f32
    (ROADMAP.md §3)."""
    import torch.distributed._functional_collectives as funcol

    names = list(mesh.mesh_dim_names)
    pod_size = mesh.size(names.index(pod_axis)) if pod_axis in names else 1
    data = (mesh, names.index(data_axis))
    if pod_size == 1:
        return funcol.all_reduce(x, "sum", data)
    pod = (mesh, names.index(pod_axis))
    xs = funcol.reduce_scatter_tensor(x, "sum", 0, data)
    c = compress(xs)
    qsum = funcol.all_reduce(c.q.to(torch.int32), "sum", pod)
    ssum = funcol.all_reduce(c.scale, "sum", pod)
    xs = (qsum.to(torch.float32) * (ssum / pod_size)[:, None]).reshape(-1)[
        : xs.numel()].reshape(xs.shape)
    return funcol.all_gather_tensor(xs, 0, data)
