"""Per-segment checkpoint backend for BlockGraphs (port of
``repro/core/lowering/segment.py``).

Each plan segment V_i runs inside its own non-reentrant
``torch.utils.checkpoint``: its saved inputs are exactly the cached
boundary values ∂(L_{i-1}) ∪ earlier caches it reads (and its blocks'
parameters), and its interior is recomputed during the backward pass, as
§3's canonical strategy says.  The BlockGraph default is ``"policy"``
(``lowering.policy``), which runs the same regions but keeps the cached
blocks' outputs instead of recomputing them.  The layer-chain projections
(``segment_groups``, ``even_groups``) live in ``launch.plan`` and
``models.transformer``.

Storage strategies (``plan.strategy``, per block name): an offloaded
block's outputs cross to later segments as ``storage.Stored`` copies in
pinned host memory, each reading segment copying them back inside its own
checkpoint (so no frame holds them on the device); a quantized block's
outputs pass through ``optim.compression.straight_through_roundtrip``, so
every later consumer sees the replay-from-storage value.  ``donate=True``
drops this function's references to a value once its last reading segment
has run.

On a ``DeviceMesh`` (a carrier with ``mesh=``, DTensor params and inputs)
every block output with an ``out_sharding`` is pinned onto it
(``blockgraph.block_spec``, ``parallel.sharding.place``); loss and grads come back as ``base``
says (replicated, and in the inputs' placements).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.utils._pytree as pytree
from torch.utils.checkpoint import checkpoint

from ...optim.compression import straight_through_roundtrip
from ..schedule import ExecutionPlan
from . import storage
from ...parallel.sharding import axis_sizes_of, place
from ..blockgraph import block_spec
from .base import (
    Lowering,
    blockgraph_value_and_grad,
    check_plan_on_mesh,
    is_dtensor,
    register_lowering,
    reject_track_live,
)
from .carriers import BlockGraphCarrier
from .interpreter import blockgraph_programs


def _apply_storage_strategy(val: Any, code: Any, memo: Dict[int, Any]) -> Any:
    """Realize one cached value's storage strategy (pytree-wide)."""
    if code == storage.OFFLOAD:
        return pytree.tree_map_only(torch.Tensor, lambda t: storage.offload(t, memo), val)
    if code == storage.QUANTIZE:
        return pytree.tree_map_only(
            torch.Tensor,
            lambda t: straight_through_roundtrip(t) if storage.quantizable(t) else t, val)
    return val


def constrain_block_output(out: Any, block: Any, mesh: Any = None) -> Any:
    """Pin an annotated block output to its sharding: a DTensor output of a
    block with an ``out_sharding`` is placed on ``mesh`` (by default its
    own) in the spec ``blockgraph.block_spec`` resolves; anything else
    passes through."""
    if block.out_sharding is None or not is_dtensor(out):
        return out
    mesh = out.device_mesh if mesh is None or isinstance(mesh, dict) else mesh
    return place(out, mesh, block_spec(block, tuple(out.shape), axis_sizes_of(mesh)))


def apply_segmented(bg, params: Dict[str, Any], inputs: Dict[str, Any],
                    plan: ExecutionPlan, donate: bool = False) -> Any:
    """Execute a BlockGraph under the plan: one checkpoint per segment."""
    values: Dict[Any, Any] = dict(inputs)
    values.update({("param", b.name): params[b.name] for b in bg.blocks})
    strat = {bg.blocks[v].name: code for v, code in (plan.strategy or {}).items()}
    progs = blockgraph_programs(bg, plan)
    last_read = {k: p.index for p in progs for k in p.ext}
    memo: Dict[int, Any] = {}
    for prog in progs:

        def seg_fn(*ext_vals, _prog=prog):
            local = {k: storage.load(v) for k, v in zip(_prog.ext, ext_vals)}
            for name in _prog.steps:
                b = bg.by_name[name]
                local[name] = constrain_block_output(
                    b.apply(local[("param", name)], *[local[i] for i in b.inputs]), b)
            return tuple(local[o] for o in _prog.outs)

        outs = checkpoint(seg_fn, *[values[k] for k in prog.ext], use_reentrant=False)
        values.update((k, _apply_storage_strategy(v, strat.get(k), memo))
                      for k, v in zip(prog.outs, outs))
        del outs
        memo.clear()
        if donate:
            for k in [k for k, i in last_read.items() if i == prog.index]:
                if k not in bg.outputs:
                    values.pop(k, None)
    res = tuple(storage.load(values[o]) for o in bg.outputs)
    return res[0] if len(res) == 1 else res


class SegmentLowering(Lowering):
    """Per-segment ``torch.utils.checkpoint`` over a BlockGraph."""

    name = "segment"

    def supports(self, carrier) -> bool:
        return isinstance(carrier, BlockGraphCarrier)

    def lower(self, carrier, plan: ExecutionPlan, track_live: bool = False,
              donate: bool = False):
        if track_live:
            reject_track_live(self.name)
        check_plan_on_mesh(carrier, plan)
        run = blockgraph_value_and_grad(
            lambda p, x: apply_segmented(carrier.bg, p, x, plan, donate=donate),
            carrier.loss_fn)
        if donate:
            from .donation import donatable_argnums, donation_hints

            run.donate_argnums = donatable_argnums(carrier)
            run.donation_hints = donation_hints(carrier.to_graph(), plan)
        return run


register_lowering(SegmentLowering())
