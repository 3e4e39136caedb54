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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from ...optim.compression import Compressed, compress, decompress

OFFLOAD = "offload"
QUANTIZE = "quantize"


def host_bytes(t: torch.Tensor, memo: Optional[Dict[int, torch.Tensor]] = None) -> torch.Tensor:
    """A host copy of ``t``'s whole storage as bytes: pinned and copied on
    the current stream from CUDA, a plain copy on the CPU.  ``memo`` (by
    storage address, valid while the source lives) shares one copy between
    the views of a storage."""
    key = t.untyped_storage().data_ptr()
    if memo is not None and key in memo:
        return memo[key]
    src = torch.empty(0, dtype=torch.uint8, device=t.device).set_(t.untyped_storage())
    if t.is_cuda:
        out = torch.empty(src.numel(), dtype=torch.uint8, pin_memory=True)
        out.copy_(src, non_blocking=True)
    else:
        out = src.clone()
    if memo is not None:
        memo[key] = out
    return out


class _Handle(torch.autograd.Function):
    """A stand-in of ``x``'s shape that holds one element: it carries the
    autograd edge to ``x`` without its bytes."""

    @staticmethod
    def forward(ctx, x):
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
    payload: Any  # host bytes (offload) or Compressed (quantize)
    dtype: torch.dtype
    device: torch.device
    #: size, stride and storage offset of a view of the payload's base
    #: (None: the base itself)
    view: Optional[Tuple[Tuple[int, ...], Tuple[int, ...], int]]
    handle: Optional[torch.Tensor] = None

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
        else:
            base = decompress(self.payload).to(self.dtype)
        return base if self.view is None else base.as_strided(*self.view)

    def load(self) -> torch.Tensor:
        """The value, its gradient flowing to the stored tensor's producer."""
        if self.handle is None:
            return self.materialize()
        return _Load.apply(self.handle, self)


def _view_of(t: torch.Tensor) -> Tuple[Tuple[int, ...], Tuple[int, ...], int]:
    return tuple(t.shape), tuple(t.stride()), t.storage_offset()


def offload(t: torch.Tensor, memo: Optional[Dict[int, torch.Tensor]] = None) -> Stored:
    """``t`` held in host memory."""
    return Stored(OFFLOAD, host_bytes(t, memo), t.dtype, t.device, _view_of(t),
                  _Handle.apply(t) if t.requires_grad else None)


def quantized(t: torch.Tensor, base: Compressed) -> Stored:
    """``t`` (a view of a roundtrip value whose compression is ``base``) held
    as int8 blocks."""
    return Stored(QUANTIZE, base, t.dtype, t.device, _view_of(t),
                  _Handle.apply(t) if t.requires_grad else None)


def compressed(t: torch.Tensor) -> Stored:
    """``t`` itself held as int8 blocks (reads see its roundtrip)."""
    return Stored(QUANTIZE, compress(t), t.dtype, t.device, None,
                  _Handle.apply(t) if t.requires_grad else None)


def quantizable(t: Any) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def load(v: Any) -> Any:
    """A value (pytree) as its readers see it: stored tensors loaded."""
    return pytree.tree_map_only(Stored, Stored.load, v)
