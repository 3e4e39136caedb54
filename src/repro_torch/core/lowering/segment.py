"""Per-segment checkpoint backend for BlockGraphs (port of
``repro/core/lowering/segment.py``).

Each plan segment V_i runs inside its own non-reentrant
``torch.utils.checkpoint``: its saved inputs are exactly the cached
boundary values ∂(L_{i-1}) ∪ earlier caches it reads (and its blocks'
parameters), and its interior is recomputed during the backward pass, as
§3's canonical strategy says.  This is the port's ``"auto"`` for
BlockGraphs: the reference's ``"policy"`` backend (one checkpoint over the
whole forward, saving named block outputs) is not ported, because one
non-reentrant region recomputes its whole forward at the first backward
access and holds it (ROADMAP.md).  The layer-chain projections
(``segment_groups``, ``even_groups``) live in ``launch.plan`` and
``models.transformer``.
"""

from __future__ import annotations

from typing import Any, Dict

from torch.utils.checkpoint import checkpoint

from ..schedule import ExecutionPlan
from .base import (
    Lowering,
    blockgraph_value_and_grad,
    register_lowering,
    reject_strategies,
    reject_track_live,
)
from .carriers import BlockGraphCarrier
from .interpreter import blockgraph_programs


def apply_segmented(bg, params: Dict[str, Any], inputs: Dict[str, Any],
                    plan: ExecutionPlan) -> Any:
    """Execute a BlockGraph under the plan: one checkpoint per segment."""
    values: Dict[Any, Any] = dict(inputs)
    values.update({("param", b.name): params[b.name] for b in bg.blocks})
    for prog in blockgraph_programs(bg, plan):

        def seg_fn(*ext_vals, _prog=prog):
            local = dict(zip(_prog.ext, ext_vals))
            for name in _prog.steps:
                b = bg.by_name[name]
                local[name] = b.apply(local[("param", name)],
                                      *[local[i] for i in b.inputs])
            return tuple(local[o] for o in _prog.outs)

        outs = checkpoint(seg_fn, *[values[k] for k in prog.ext], use_reentrant=False)
        values.update(zip(prog.outs, outs))
    res = tuple(values[o] for o in bg.outputs)
    return res[0] if len(res) == 1 else res


class SegmentLowering(Lowering):
    """Per-segment ``torch.utils.checkpoint`` over a BlockGraph."""

    name = "segment"

    def supports(self, carrier) -> bool:
        return isinstance(carrier, BlockGraphCarrier)

    def lower(self, carrier, plan: ExecutionPlan, track_live: bool = False):
        if track_live:
            reject_track_live(self.name)
        reject_strategies(plan)
        return blockgraph_value_and_grad(
            lambda p, x: apply_segmented(carrier.bg, p, x, plan), carrier.loss_fn)


register_lowering(SegmentLowering())
