"""MoE dispatch on Hopper: the route → slot map, the pack and the combine as
CUDA kernels (``csrc/moe_dispatch.cu``), with their backwards, registered
as the custom ops ``repro_torch::moe_slots``, ``moe_pack``,
``moe_pack_bwd``, ``moe_combine`` and ``moe_combine_bwd``.

Replaces no Pallas kernel: the reference ranks each route in its expert's
queue with ``jnp.cumsum`` over a one-hot and scatters with ``.at[].add``
(``repro/models/moe.py``), and ``models/moe.py`` keeps that as the plain
version, which tensors off the card take.  Here the assignment is computed
once, as a :class:`SlotMap` in which a dropped route has no slot, and the
pack, the combine and both backwards are gathers through it: no scan over a
one-hot, no accumulating ``index_put``, nothing sorted, and every row of
every output written once.

Being registered operators (each with a fake implementation for shapes,
the pack and the combine with their backwards through
``register_autograd``), the dispatch is three nodes when ``core.fx_graph``
traces a model on the card with ``make_fx``, and replaying the trace
launches the kernels, as attention is one ``repro_torch::flash_attention``
node.  A DTensor reaches them through a sharding rule that replicates every
operand (the map ranks routes across all tokens, so no split of them is
local), and a functional collective's pending result is waited for by its
own dispatch before an op runs.  Each op's CPU kernel is its plain
statement in torch ops, which the CPU tests hold against ``_pack`` and
``_combine``; the model itself sends CPU tensors to ``_pack`` and
``_combine`` (:func:`kernel_route`).

The kernels are built into the flash-attention library (``flash_attention.
SOURCES``, one nvcc per source, one link) and loaded with ``ctypes``.  The
wrappers (:func:`slot_map`, :func:`pack`, :func:`combine`) take contiguous
CUDA tensors (float32 and bfloat16 rows, E up to ``MAX_EXPERTS``, K up to
``MAX_TOP_K``) and raise on anything else, on fake tensors of a trace as on
real ones: nothing falls back.  ``LAUNCHES`` counts each C entry point's
calls; ``moe_slots`` is three kernels, ``moe_combine_bwd`` three where both
gradients are wanted (the inverse map written again from ``slot``, the
rows' gradient, the gates').
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from .flash_attention import _library as _flash_library

KERNELS = ("moe_slots", "moe_pack", "moe_pack_bwd", "moe_combine", "moe_combine_bwd")
MAX_EXPERTS = 1024  # the map's per-warp histograms in shared memory (csrc: MAX_EXPERTS)
MAX_TOP_K = 32  # a token's routes in one warp's lanes (csrc: MAX_TOP_K)

#: launches of each C entry point since the last ``reset_launch_counts``
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def kernel_route(x: torch.Tensor) -> bool:
    """Whether the dispatch of ``x`` runs the kernels: a tensor on the card,
    whatever wraps it (a fake tensor of a trace, a DTensor, a collective's
    pending result).  A tensor elsewhere takes the plain version in
    ``models.moe``."""
    return x.device.type == "cuda"


class SlotMap(NamedTuple):
    """Where each of T·K routes sits in the experts' (E, cap) slots.

    ``slot`` (T·K,) int32: ``e·cap + pos`` for a kept route, −1 for a dropped
    one, ``pos`` being the route's rank among the earlier routes to expert
    ``e`` in token-major order (the reference's cumsum); ``src`` (E·cap,)
    int32: the route in each filled slot, slot (e, c) being filled where
    ``c < min(counts[e], cap)`` (the kernel leaves the others unwritten);
    ``counts`` (E,) int32: the routes to each expert, dropped ones too."""

    slot: torch.Tensor
    src: torch.Tensor
    counts: torch.Tensor
    cap: int

    def kept(self) -> torch.Tensor:
        """The kept routes, a device scalar."""
        return self.counts.clamp(max=self.cap).sum()

    def kept_mask(self) -> torch.Tensor:
        """(T·K,) bool: which routes hold a slot."""
        return self.slot >= 0

    def combine(self, out_e: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        """The experts' rows back onto the tokens (:func:`combine`)."""
        return combine(out_e.contiguous(), self, gate.contiguous())


# ---------------------------------------------------------------- binding


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _flash_library()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moe_slots_scratch.argtypes = [i, i]
    lib.moe_slots.argtypes = [p, i, i, i, p, p, p, p, p]
    lib.moe_pack.argtypes = [i, p, p, p, p, i, i, i, i, p]
    lib.moe_pack_bwd.argtypes = [i, p, p, p, i, i, i, p]
    lib.moe_combine.argtypes = [i, p, p, p, p, p, p, i, i, i, p]
    lib.moe_combine_bwd.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    for name in ("moe_slots_scratch", *KERNELS):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_library(), name)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1


def _check(what: str, t: torch.Tensor, dtypes, device: torch.device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the MoE dispatch kernels take CUDA tensors, got {t.device}")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, the dispatch on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: the MoE dispatch kernels take {', '.join(map(str, dtypes))}; "
                        f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_map(sm: SlotMap, T: int, K: int, device: torch.device) -> int:
    E = sm.counts.numel()
    for what, t, n in (("slot", sm.slot, T * K), ("src", sm.src, E * sm.cap),
                       ("counts", sm.counts, E)):
        _check(what, t, (torch.int32,), device)
        if t.numel() != n:
            raise ValueError(f"{what} has {t.numel()} entries, not {n}")
    return E


def _check_limits(E: int, K: int, cap: int, T: int) -> None:
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"the MoE dispatch kernels take 1 to {MAX_EXPERTS} experts (their "
                         f"shared-memory histograms); got E={E}")
    if not 1 <= K <= MAX_TOP_K:
        raise ValueError(f"the MoE dispatch kernels take top-k up to {MAX_TOP_K}; got K={K}")
    if cap < 1 or E * cap >= 2**31 or T * K >= 2**31:
        raise ValueError(f"slots and routes must fit int32: E={E}, cap={cap}, T·K={T * K}")


# ------------------------------------------ the kernels (the ops' CUDA kernels)


def slot_rows(expert_ids: torch.Tensor, E: int, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The map's kernels: expert ids (T, K) int64 → (slot, src, counts)."""
    n, dev = expert_ids.numel(), expert_ids.device
    i32 = dict(dtype=torch.int32, device=dev)
    slot, src, counts = torch.empty(n, **i32), torch.empty(E * cap, **i32), torch.empty(E, **i32)
    scratch = torch.empty(max(_library().moe_slots_scratch(n, E), 1), **i32)
    _launch("moe_slots", dev, _ptr(expert_ids), n, E, cap, _ptr(slot), _ptr(src), _ptr(counts),
            _ptr(scratch))
    return slot, src, counts


def pack_rows(xt: torch.Tensor, slot: torch.Tensor, src: torch.Tensor, counts: torch.Tensor,
              cap: int) -> torch.Tensor:
    """The pack's kernel: (T, D) → (E, cap, D), no autograd."""
    T, D = xt.shape
    E, K = counts.numel(), slot.numel() // T
    disp = xt.new_empty((E, cap, D))
    _launch("moe_pack", xt.device, _DTYPE_CODES[xt.dtype], _ptr(xt), _ptr(src), _ptr(counts),
            _ptr(disp), E, cap, K, D)
    return disp


def pack_rows_bwd(d_disp: torch.Tensor, slot: torch.Tensor, T: int) -> torch.Tensor:
    """The pack's backward kernel: d_disp (E, cap, D) → d_xt (T, D), each
    token's kept slot rows summed in f32 and rounded once."""
    D = d_disp.shape[-1]
    d_xt = d_disp.new_empty((T, D))
    _launch("moe_pack_bwd", d_disp.device, _DTYPE_CODES[d_disp.dtype], _ptr(d_disp), _ptr(slot),
            _ptr(d_xt), T, slot.numel() // T, D)
    return d_xt


def combine_rows(out_e: torch.Tensor, gate: torch.Tensor, slot: torch.Tensor,
                 counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The combine's kernel: y (T, D), and for the backward each route's row
    (T·K, D), zeros where dropped, and its gate in ``out_e``'s dtype (T, K)
    (``counts`` only for the op's signature: the backward reads it)."""
    T, K = gate.shape
    D = out_e.shape[-1]
    y, rows, w = out_e.new_empty((T, D)), out_e.new_empty((T * K, D)), out_e.new_empty((T, K))
    _launch("moe_combine", out_e.device, _DTYPE_CODES[out_e.dtype], _ptr(out_e), _ptr(gate),
            _ptr(slot), _ptr(y), _ptr(rows), _ptr(w), T, K, D)
    return y, rows, w


def combine_rows_bwd(dy: torch.Tensor, w: torch.Tensor, rows: torch.Tensor, slot: torch.Tensor,
                     counts: torch.Tensor, cap: int, want_out: bool, want_gate: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The combine's backward kernels: d_out_e (E, cap, D) from the weights
    ``w`` where ``want_out``, d_gate (T, K) f32 from the ``rows`` where
    ``want_gate``; an empty tensor for a gradient not wanted."""
    T, D = dy.shape
    E, K = counts.numel(), slot.numel() // T
    d_out = dy.new_empty((E, cap, D) if want_out else (0,))
    src = torch.empty(E * cap if want_out else 0, dtype=torch.int32, device=dy.device)
    d_gate = torch.empty((T, K) if want_gate else (0,), dtype=torch.float32, device=dy.device)
    _launch("moe_combine_bwd", dy.device, _DTYPE_CODES[dy.dtype], _ptr(dy), _ptr(w), _ptr(rows),
            _ptr(slot), _ptr(counts), _ptr(src), _ptr(d_out if want_out else None),
            _ptr(d_gate if want_gate else None), E, cap, T, K, D)
    return d_out, d_gate


# ------------------------------------ the plain statements (the ops' CPU kernels)


def _gathered(rows: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """(T·K, D): the row of each route's slot, zeros where dropped."""
    keep = (slot >= 0)[:, None]
    return torch.where(keep, rows[slot.clamp(min=0).long()], 0)


def _slots_plain(expert_ids, E, cap):
    flat = expert_ids.reshape(-1)
    held = (flat >= 0) & (flat < E)  # an id outside [0, E) is no expert here
    onehot = (flat[:, None] == torch.arange(E, device=flat.device)).long()
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    keep = held & (pos < cap)
    slot = torch.where(keep, flat * cap + pos, -1).int()
    src = torch.full((E * cap,), -1, dtype=torch.int32, device=flat.device)
    src[slot[keep].long()] = torch.nonzero(keep).reshape(-1).int()
    return slot, src, torch.bincount(flat[held], minlength=E).int()


def _pack_plain(xt, slot, src, counts, cap):
    T, D = xt.shape
    keep = slot >= 0
    disp = xt.new_zeros((counts.numel() * cap, D))
    disp[slot[keep].long()] = xt[torch.nonzero(keep).reshape(-1) // (slot.numel() // T)]
    return disp.reshape(-1, cap, D)


def _pack_bwd_plain(d_disp, slot, T):
    D = d_disp.shape[-1]
    g = _gathered(d_disp.reshape(-1, D), slot)
    return g.reshape(T, -1, D).float().sum(1).to(d_disp.dtype)


def _combine_plain(out_e, gate, slot, counts):
    T, K = gate.shape
    D = out_e.shape[-1]
    rows = _gathered(out_e.reshape(-1, D), slot)
    w = gate.to(out_e.dtype, copy=True)
    y = (rows * w.reshape(-1, 1)).float().reshape(T, K, D).sum(1).to(out_e.dtype)
    return y, rows, w


def _combine_bwd_plain(dy, w, rows, slot, counts, cap, want_out, want_gate):
    T, D = dy.shape
    K = slot.numel() // T
    dy_r = dy.repeat_interleave(K, dim=0)
    d_out, d_gate = dy.new_zeros((0,)), dy.new_zeros((0,), dtype=torch.float32)
    if want_out:
        keep = slot >= 0
        d_out = dy.new_zeros((counts.numel() * cap, D))
        d_out[slot[keep].long()] = (dy_r * w.reshape(-1, 1))[keep]
        d_out = d_out.reshape(-1, cap, D)
    if want_gate:
        d_gate = (rows * dy_r).float().sum(-1).to(dy.dtype).float().reshape(T, K)
    return d_out, d_gate


# -------------------------------------------------------------- the ops


@torch.library.custom_op("repro_torch::moe_slots", mutates_args=(), device_types="cuda")
def moe_slots_op(expert_ids: torch.Tensor, E: int, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(slot (T·K,), src (E·cap,), counts (E,)), int32: :class:`SlotMap`'s;
    an id outside [0, E) (an expert held elsewhere) is counted nowhere and
    takes no slot."""
    return slot_rows(expert_ids, E, cap)


@torch.library.custom_op("repro_torch::moe_pack", mutates_args=(), device_types="cuda")
def moe_pack_op(xt: torch.Tensor, slot: torch.Tensor, src: torch.Tensor, counts: torch.Tensor,
                cap: int) -> torch.Tensor:
    """Tokens (T, D) → the experts' buffer (E, cap, D)."""
    return pack_rows(xt, slot, src, counts, cap)


@torch.library.custom_op("repro_torch::moe_pack_bwd", mutates_args=(), device_types="cuda")
def moe_pack_bwd_op(d_disp: torch.Tensor, slot: torch.Tensor, T: int) -> torch.Tensor:
    """The pack's backward: d_xt (T, D)."""
    return pack_rows_bwd(d_disp, slot, T)


@torch.library.custom_op("repro_torch::moe_combine", mutates_args=(), device_types="cuda")
def moe_combine_op(out_e: torch.Tensor, gate: torch.Tensor, slot: torch.Tensor,
                   counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y (T, D), each route's row (T·K, D), the gates in the rows' dtype
    (T, K)); the last two are what the backward keeps."""
    return combine_rows(out_e, gate, slot, counts)


@torch.library.custom_op("repro_torch::moe_combine_bwd", mutates_args=(), device_types="cuda")
def moe_combine_bwd_op(dy: torch.Tensor, w: torch.Tensor, rows: torch.Tensor,
                       slot: torch.Tensor, counts: torch.Tensor, cap: int, want_out: bool,
                       want_gate: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_out_e (E, cap, D), d_gate (T, K) f32), each empty where not wanted."""
    return combine_rows_bwd(dy, w, rows, slot, counts, cap, want_out, want_gate)


for _op, _plain in ((moe_slots_op, _slots_plain), (moe_pack_op, _pack_plain),
                    (moe_pack_bwd_op, _pack_bwd_plain), (moe_combine_op, _combine_plain),
                    (moe_combine_bwd_op, _combine_bwd_plain)):
    _op.register_kernel("cpu", _plain)


@moe_slots_op.register_fake
def _(expert_ids, E, cap):
    i32 = dict(dtype=torch.int32)
    return (expert_ids.new_empty(expert_ids.numel(), **i32), expert_ids.new_empty(E * cap, **i32),
            expert_ids.new_empty(E, **i32))


@moe_pack_op.register_fake
def _(xt, slot, src, counts, cap):
    return xt.new_empty((counts.shape[0], cap, xt.shape[1]))


@moe_pack_bwd_op.register_fake
def _(d_disp, slot, T):
    return d_disp.new_empty((T, d_disp.shape[-1]))


@moe_combine_op.register_fake
def _(out_e, gate, slot, counts):
    T, K = gate.shape
    D = out_e.shape[-1]
    return out_e.new_empty((T, D)), out_e.new_empty((T * K, D)), out_e.new_empty((T, K))


@moe_combine_bwd_op.register_fake
def _(dy, w, rows, slot, counts, cap, want_out, want_gate):
    T, D = dy.shape
    return (dy.new_empty((counts.shape[0], cap, D) if want_out else (0,)),
            dy.new_empty((T, slot.shape[0] // T) if want_gate else (0,), dtype=torch.float32))


def _pack_setup(ctx, inputs, output):
    xt, slot, _, _, _ = inputs
    ctx.save_for_backward(slot)
    ctx.T = xt.shape[0]


def _pack_backward(ctx, d_disp):
    (slot,) = ctx.saved_tensors
    return moe_pack_bwd_op(d_disp.contiguous(), slot, ctx.T), None, None, None, None


def _combine_setup(ctx, inputs, output):
    _, _, slot, counts = inputs
    _, rows, w = output
    ctx.mark_non_differentiable(rows, w)
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(rows, w, slot, counts)
    ctx.cap = inputs[0].shape[1]


def _combine_backward(ctx, dy, _rows, _w):
    want_out, want_gate = ctx.needs_input_grad[:2]
    if dy is None or not (want_out or want_gate):
        return None, None, None, None
    rows, w, slot, counts = ctx.saved_tensors
    d_out, d_gate = moe_combine_bwd_op(dy.contiguous(), w, rows, slot, counts, ctx.cap,
                                       want_out, want_gate)
    return d_out if want_out else None, d_gate if want_gate else None, None, None


moe_pack_op.register_autograd(_pack_backward, setup_context=_pack_setup)
moe_combine_op.register_autograd(_combine_backward, setup_context=_combine_setup)


def _register_dtensor_rules() -> None:
    """Every op takes and gives replicated DTensors: a route's slot depends
    on every earlier route, so no split of the tokens or the slots is local."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import register_sharding

    r = Replicate()
    # op: (outputs, the placement of each argument: None for a number)
    rules = {"moe_slots": (3, (r, None, None)), "moe_pack": (1, (r, r, r, r, None)),
             "moe_pack_bwd": (1, (r, r, None)), "moe_combine": (3, (r, r, r, r)),
             "moe_combine_bwd": (2, (r, r, r, r, r, None, None, None))}
    for name, (n_out, ins) in rules.items():
        register_sharding(getattr(torch.ops.repro_torch, name).default)(
            lambda *args, _s=([r] * n_out, list(ins)): [_s])


if torch.distributed.is_available():
    _register_dtensor_rules()


# --------------------------------------------------------------- wrappers


def slot_map(expert_ids: torch.Tensor, E: int, cap: int) -> SlotMap:
    """expert ids (T, K) int64 → their :class:`SlotMap` at ``cap`` slots an
    expert; bitwise the same on every call."""
    if expert_ids.dim() != 2:
        raise ValueError(f"expected expert ids (T, K), got {tuple(expert_ids.shape)}")
    T, K = expert_ids.shape
    _check("expert_ids", expert_ids, (torch.int64,), expert_ids.device)
    _check_limits(E, K, cap, T)
    return SlotMap(*moe_slots_op(expert_ids, E, cap), cap)


def pack(xt: torch.Tensor, sm: SlotMap) -> torch.Tensor:
    """Tokens (T, D) → the experts' buffer (E, cap, D): each kept route's
    token row in its slot, zeros in the slots no route fills."""
    if xt.dim() != 2:
        raise ValueError(f"expected tokens (T, D), got {tuple(xt.shape)}")
    T = xt.shape[0]
    K = sm.slot.numel() // max(T, 1)
    _check("xt", xt, tuple(_DTYPE_CODES), xt.device)
    E = _check_map(sm, T, K, xt.device)
    _check_limits(E, K, sm.cap, T)
    return moe_pack_op(xt, sm.slot, sm.src, sm.counts, sm.cap)


def combine(out_e: torch.Tensor, sm: SlotMap, gate: torch.Tensor) -> torch.Tensor:
    """The experts' rows (E, cap, D) and the gates (T, K) f32 → (T, D): the
    sum over each token's kept routes of gate × its slot's row, each
    product rounded to ``out_e``'s dtype, the sum in f32 rounded once.
    For the backward autograd keeps each route's row (T·K, D) and its gate
    in ``out_e``'s dtype, what the plain version's product keeps, and of
    the map only ``slot`` and ``counts``."""
    if out_e.dim() != 3 or gate.dim() != 2:
        raise ValueError(f"expected rows (E, cap, D) and gates (T, K); got "
                         f"{tuple(out_e.shape)}, {tuple(gate.shape)}")
    T, K = gate.shape
    _check("out_e", out_e, tuple(_DTYPE_CODES), out_e.device)
    _check("gate", gate, (torch.float32,), out_e.device)
    E = _check_map(sm, T, K, out_e.device)
    _check_limits(E, K, sm.cap, T)
    if out_e.shape[:2] != (E, sm.cap):
        raise ValueError(f"rows {tuple(out_e.shape)} do not match {E} experts of {sm.cap} slots")
    return moe_combine_op(out_e, gate, sm.slot, sm.counts)[0]
