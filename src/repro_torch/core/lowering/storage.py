"""Storage strategies of cached residuals: host offload and int8 blocks.

The reference keeps its boxes in ``repro/core/lowering/interpreter.py``
(``_HostBox``, ``_QuantizedBox``) and its placement helper in
``repro/core/lowering/segment.py`` (``_memory_kind_put``); JAX moves a
value between memory kinds with ``device_put``.  Torch needs autograd
plumbing for the same thing, so the three lowerings share this module.

A :class:`Stored` holds one cached tensor by its strategy between the
segment that made it and its readers:

* ``offload`` — a copy of the tensor's whole storage in host memory (pinned
  when the tensor lives on CUDA, copied on the current stream); reading it
  copies it back.  Values are bitwise unchanged.
* ``quantize`` — the int8 payload and f32 block scales of its base
  (``optim.compression``); reading it decompresses.  The base is the
  ``straight_through_roundtrip`` value, which equals its decompression
  bitwise (a value and its int8 rounding are within a factor of two, so
  their difference is exact), so a reader sees the value it would have
  seen in the segment.

A view is kept as its base's payload plus its size, stride and storage
offset.  When the tensor requires grad, a :class:`Stored` keeps a
*handle*: a one-element tensor expanded to the tensor's shape that
carries its autograd edge, so the gradient of every read flows back to the
producer while the device holds none of its bytes.

A **DTensor** (a twin on a ``DeviceMesh``) is held by its local shard:
``offload`` copies the local storage to pinned host memory and keeps the
placements, global shape and stride, and a read rebuilds the DTensor with
``DTensor.from_local(..., run_check=False)`` (no communication);
``quantize`` keeps the local int8 payload and scales of the global codec
(``optim.compression.compress_shard``: the global tensor's 256-element
blocks, bitwise).  The handle is a DTensor in the same placements whose
local tensor holds one element, so it carries the DTensor's edge.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from ...optim.compression import (
    ShardCompressed,
    as_dtensor,
    compress,
    compress_shard,
    decompress,
    decompress_shard,
    reduce_partial,
    shard_layout,
)

from .base import is_dtensor, local_tensor

OFFLOAD = "offload"
QUANTIZE = "quantize"


def _local(t: torch.Tensor) -> torch.Tensor:
    """The plain tensor holding ``t``'s (local) elements: a DTensor's local
    shard, a functional collective's result waited for."""
    from torch.distributed._functional_collectives import AsyncCollectiveTensor

    t = local_tensor(t)
    return t.trigger_wait() if isinstance(t, AsyncCollectiveTensor) else t


def storage_key(t: torch.Tensor) -> int:
    """The address of the storage holding ``t``'s (local) elements."""
    return _local(t).untyped_storage().data_ptr()


def host_bytes(t: torch.Tensor, memo: Optional[Dict[int, Any]] = None) -> torch.Tensor:
    """A host copy of ``t``'s whole storage as bytes: pinned and copied on
    the current stream from CUDA, a plain copy on the CPU.  ``memo`` (by
    storage address) shares one copy between the views of a storage; an
    entry whose storage has died is stale (its address may hold another
    storage now) and is copied again."""
    from torch.multiprocessing.reductions import StorageWeakRef

    storage = t.untyped_storage()
    key = storage.data_ptr()
    if memo is not None and key in memo and not memo[key][0].expired():
        return memo[key][1]
    src = torch.empty(0, dtype=torch.uint8, device=t.device).set_(storage)
    if t.is_cuda:
        out = torch.empty(src.numel(), dtype=torch.uint8, pin_memory=True)
        out.copy_(src, non_blocking=True)
    else:
        out = src.clone()
    if memo is not None:
        memo[key] = (StorageWeakRef(storage), out)
    return out


class _Handle(torch.autograd.Function):
    """A stand-in of ``x``'s shape that holds one element: it carries the
    autograd edge to ``x`` without its bytes."""

    @staticmethod
    def forward(ctx, x):
        if is_dtensor(x):
            local = x.to_local()
            return as_dtensor(local.new_zeros(()).expand(local.shape), shard_layout(x))
        return x.new_zeros(()).expand(x.shape)

    @staticmethod
    def backward(ctx, g):
        return g


class _Load(torch.autograd.Function):
    """The stored value, with the gradient passed straight to the handle."""

    @staticmethod
    def forward(ctx, handle, stored):
        return stored.materialize()

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclasses.dataclass
class Stored:
    """One cached tensor held by its storage strategy (see module doc)."""

    code: str
    payload: Any  # host bytes (offload), Compressed or ShardCompressed (quantize)
    dtype: torch.dtype
    device: torch.device
    #: size, stride and storage offset of a view of the payload's base
    #: (None: the base itself); a DTensor's local ones
    view: Optional[Tuple[Tuple[int, ...], Tuple[int, ...], int]]
    handle: Optional[torch.Tensor] = None
    #: a DTensor's layout (``optim.compression.ShardLayout``), None for a
    #: plain tensor
    layout: Any = None

    def device_bytes(self) -> int:
        """Bytes this holds on the tensor's device (0 once offloaded)."""
        if self.code == QUANTIZE:
            c = self.payload
            return c.q.numel() * c.q.element_size() + c.scale.numel() * c.scale.element_size()
        return 0

    def materialize(self) -> torch.Tensor:
        """The tensor's value on its device, detached."""
        if self.code == OFFLOAD:
            base = self.payload.to(self.device, non_blocking=True).view(self.dtype)
        elif isinstance(self.payload, ShardCompressed):
            base = decompress_shard(self.payload).to(self.dtype)
        else:
            base = decompress(self.payload).to(self.dtype)
        local = base if self.view is None else base.as_strided(*self.view)
        return local if self.layout is None else as_dtensor(local, self.layout)

    def load(self) -> torch.Tensor:
        """The value, its gradient flowing to the stored tensor's producer."""
        if self.handle is None:
            return self.materialize()
        return _Load.apply(self.handle, self)


def _view_of(t: torch.Tensor) -> Tuple[Tuple[int, ...], Tuple[int, ...], int]:
    t = _local(t)
    return tuple(t.shape), tuple(t.stride()), t.storage_offset()


def _stored(code: str, payload: Any, t: torch.Tensor, view: Any) -> Stored:
    return Stored(code, payload, t.dtype, _local(t).device, view,
                  _Handle.apply(t) if t.requires_grad else None,
                  shard_layout(t) if is_dtensor(t) else None)


def offload(t: torch.Tensor, memo: Optional[Dict[int, Any]] = None) -> Stored:
    """``t`` held in host memory (a DTensor's local shard)."""
    return _stored(OFFLOAD, host_bytes(_local(t), memo), t, _view_of(t))


def quantized(t: torch.Tensor, base: Any) -> Stored:
    """``t`` (a view of a roundtrip value whose compression is ``base``) held
    as int8 blocks."""
    return _stored(QUANTIZE, base, t, _view_of(t))


def compressed(t: torch.Tensor) -> Stored:
    """``t`` itself held as int8 blocks (reads see its roundtrip; a
    DTensor's by the global codec, a ``Partial`` one reduced first)."""
    if is_dtensor(t):
        t = reduce_partial(t)
        return _stored(QUANTIZE, compress_shard(t.to_local(), shard_layout(t)), t, None)
    return _stored(QUANTIZE, compress(t), t, None)


def quantizable(t: Any) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def load(v: Any) -> Any:
    """A value (pytree) as its readers see it: stored tensors loaded."""
    return pytree.tree_map_only(Stored, Stored.load, v)
