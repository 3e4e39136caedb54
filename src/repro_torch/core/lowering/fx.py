"""The ``"fx"`` backend: a traced function's plan lowered onto autograd with
one checkpoint region per recomputing segment.

It takes the place of the reference's ``"jaxpr"`` backend
(``repro/core/lowering/policy.py``, ``JaxprLowering``), which tags every
equation and runs the whole function under one ``jax.checkpoint`` saving
exactly U_k, and leaves the schedule to XLA.  Eager PyTorch has no such
scheduler: a non-reentrant ``torch.utils.checkpoint`` recomputes its
region's forward at the first backward access to any tensor it saved and
holds every recomputed tensor until that tensor is used, so one region over
the whole function brings the backward's peak back to the vanilla one.

So this backend follows the plan's segments.  A segment with a non-empty
``recompute`` set runs as its own non-reentrant checkpoint region: it takes
the values it reads from earlier segments and returns the values that
later segments read (its ``keep`` nodes, and the loss).  Inside the region
a selective-checkpoint policy (``create_selective_checkpoint_contexts``)
marks the ops of ``keep`` nodes ``MUST_SAVE`` and every other op
``PREFER_RECOMPUTE``, keyed by the fx node the region's loop is executing;
early stop is off, so the backward recomputes exactly V_i \\ U_k, once.  A
segment that recomputes nothing runs plainly.  Loss and gradients are those
of plain autograd, bitwise on the same device.

The twin exposes what the analysis layer reads (``repro_torch.analysis``):
``run.node_now()`` is the fx node being evaluated (None between nodes, so
ops that autograd's derivative formulas run are attributed to no node), and
``run.policy_saves(node)`` is the selective policy's decision for an fx
node of a recomputing segment (None elsewhere).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    set_checkpoint_early_stop,
)

from ..fx_graph import is_view
from ..schedule import ExecutionPlan
from .base import (
    Lowering,
    grads_like,
    register_lowering,
    reject_strategies,
    reject_track_live,
)
from .carriers import TracedCarrier
from .interpreter import SegmentProgram, run_segment, traced_programs


def fx_value_and_grad(carrier: TracedCarrier, plan: ExecutionPlan):
    """``f(*args) -> (value, grads)`` of the traced function under the plan."""
    fxg = carrier.fx
    progs = traced_programs(fxg, plan)
    placeholders = [n for n in fxg.gm.graph.nodes if n.op == "placeholder"]
    current: List[Any] = [None]  # the fx node being evaluated
    region_keep: Dict[Any, Any] = {}  # fx node of a recomputing segment -> its keep

    def evaluate(node, get):
        current[0] = node
        try:
            return fxg.run_node(node, get)
        finally:
            current[0] = None

    def saves(node, keep) -> bool:
        return fxg.owner.get(node) in keep and not is_view(node)

    def region_for(prog: SegmentProgram, keep):
        region_keep.update(dict.fromkeys(prog.steps, keep))

        def policy(ctx, op, *args, **kwargs):
            if saves(current[0], keep):
                return CheckpointPolicy.MUST_SAVE
            return CheckpointPolicy.PREFER_RECOMPUTE

        def region(*ext_vals):
            local = run_segment(prog, evaluate, dict(zip(prog.ext, ext_vals)).__getitem__)
            return tuple(local[k] for k in prog.outs)

        return region, (lambda: create_selective_checkpoint_contexts(policy))

    regions = {
        prog.index: region_for(prog, seg.keep)
        for prog, seg in zip(progs, plan.segments) if seg.recompute
    }

    def forward(flat):
        # returns the loss alone: what the backward needs, autograd holds,
        # and frees as it goes, as the canonical strategy frees U_k
        env = dict(zip(placeholders, flat))
        for prog in progs:
            if prog.index in regions:
                region, context_fn = regions[prog.index]
                with set_checkpoint_early_stop(False):
                    outs = checkpoint(region, *[env[k] for k in prog.ext],
                                      use_reentrant=False, context_fn=context_fn)
            else:
                local = run_segment(prog, evaluate, env.__getitem__)
                outs = [local[k] for k in prog.outs]
            env.update(zip(prog.outs, outs))
        return env[fxg.output]

    def run(*args):
        flat = carrier.flatten_args(args)
        loss = forward(flat)
        return loss.detach(), carrier.grads_out(args, grads_like(loss, flat))

    run.node_now = lambda: current[0]
    run.policy_saves = lambda node: (saves(node, region_keep[node])
                                     if node in region_keep else None)
    return run


class FxLowering(Lowering):
    """Traced-function production path: per-segment selective checkpoints."""

    name = "fx"

    def supports(self, carrier) -> bool:
        return isinstance(carrier, TracedCarrier)

    def lower(self, carrier, plan: ExecutionPlan, track_live: bool = False):
        if track_live:
            reject_track_live(self.name)
        reject_strategies(plan)
        return fx_value_and_grad(carrier, plan)


register_lowering(FxLowering())
