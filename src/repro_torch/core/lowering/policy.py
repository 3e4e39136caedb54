"""The ``"policy"`` backend: a BlockGraph's plan as named block outputs
saved by a selective checkpoint (port of the block half of
``repro/core/lowering/policy.py``; its equation half, ``"jaxpr"``, is the
``"fx"`` backend).

The reference tags each block's output with ``checkpoint_name`` and runs
the whole forward under one ``jax.checkpoint`` whose policy is
``save_only_these_names(U_k)``: XLA keeps exactly the outputs of U_k's
blocks and rematerializes every other value in the backward, the
internals of the cached blocks included, each where the backward needs
it.  Torch has neither names nor that scheduler: one non-reentrant
``torch.utils.checkpoint`` over the whole forward would recompute all of
it at the first backward access and hold it, the vanilla peak (the
``"fx"`` module's docstring).

So the port runs **one region per plan segment**, under the selective
policy of the ``"fx"`` backend (``fx.selective_context``): while a block
of the segment's ``keep`` set runs, each op's outputs are held weakly,
and when the block returns, the ops whose outputs *are* its output
tensors (the same objects, or a DTensor's local tensor) are kept
(``fx._Keep.settle``); every other op of the region is recomputed by the
backward, as the reference's policy recomputes every unnamed value, since
a name tags only a block's output.  Early stop is off, so a region's
backward reruns it once, the kept ops returning their saved outputs.
What autograd holds between the forward and the backward is then, in
every segment, exactly the outputs of U_k's blocks (which are also what
the next segments read, so keeping them costs no byte beyond the plan's
U_k), the parameters and the inputs.  Every segment runs as a region,
the ones that recompute no block too: a block's internals (an attention's
probabilities, an MLP's hidden activations) are never in U_k, and the
reference rematerializes them; a region whose ops save nothing is never
unpacked.  Beside ``"segment"``, which recomputes every block of a
segment in its backward (the cached blocks' outputs too, a second copy of
them while the segment's backward runs), ``"policy"`` reruns the same
blocks' internals but returns the cached outputs.  Loss and gradients
are plain autograd's, bitwise.

On a ``DeviceMesh`` a block output with an ``out_sharding`` is placed as
``"segment"`` places it (:func:`segment.constrain_block_output`).  Storage
strategies, ``track_live`` and ``donate`` are rejected with the
reference's messages.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..schedule import ExecutionPlan
from ..strategies import OFFLOAD
from .base import (
    Lowering,
    blockgraph_value_and_grad,
    check_plan_on_mesh,
    register_lowering,
    reject_donate,
    reject_track_live,
)
from .carriers import BlockGraphCarrier
from .fx import PENDING, selective_context
from .interpreter import blockgraph_programs
from .segment import constrain_block_output


def plan_policy(plan: ExecutionPlan, names: Sequence[str]) -> Tuple[Tuple[str, ...],
                                                                    Tuple[str, ...]]:
    """The plan's cache set U_k as the reference's policy lists it:
    ``(saved, offloaded)`` names, each sorted (``names[v]`` is node v's
    block name); the reference builds ``save_only_these_names(*saved)``
    from them, or ``save_and_offload_only_these_names`` when some are
    offloaded."""
    strategy = plan.strategy or {}
    offloaded = tuple(sorted(names[v] for v in plan.cached if strategy.get(v) == OFFLOAD))
    saved = tuple(sorted(names[v] for v in plan.cached if strategy.get(v) != OFFLOAD))
    return saved, offloaded


def apply_with_policy(bg, params: Dict[str, Any], inputs: Dict[str, Any],
                      plan: ExecutionPlan, mesh: Any = None) -> Any:
    """Run a BlockGraph forward with the plan lowered to the policy (module
    doc).  Differentiating the result recomputes everything but the
    outputs of U_k's blocks."""
    saved = set(plan_policy(plan, [b.name for b in bg.blocks])[0])
    values: Dict[Any, Any] = dict(inputs)
    values.update({("param", b.name): params[b.name] for b in bg.blocks})
    current: List[Optional[str]] = [None]  # the block being run
    for prog in blockgraph_programs(bg, plan):
        keeps: List[Any] = []  # the forward mode of this call's region

        def region(*ext_vals, _prog=prog, _keeps=keeps):
            local = dict(zip(_prog.ext, ext_vals))
            for name in _prog.steps:
                b = bg.by_name[name]
                current[0] = name
                try:
                    out = constrain_block_output(
                        b.apply(local[("param", name)], *[local[i] for i in b.inputs]), b, mesh)
                finally:
                    current[0] = None
                local[name] = out
                if name in saved and _keeps:
                    _keeps[0].settle(out)  # nothing is pending in the recompute
            return tuple(local[o] for o in _prog.outs)

        context_fn = selective_context(
            lambda: PENDING if current[0] in saved else None, {}, on_keep=keeps.append)
        with set_checkpoint_early_stop(False):
            outs = checkpoint(region, *[values[k] for k in prog.ext], use_reentrant=False,
                              context_fn=context_fn)
        values.update(zip(prog.outs, outs))
        del outs
    res = tuple(values[o] for o in bg.outputs)
    return res[0] if len(res) == 1 else res


class PolicyLowering(Lowering):
    """BlockGraph production path: named block outputs, one selective
    checkpoint region per segment."""

    name = "policy"

    def supports(self, carrier) -> bool:
        return isinstance(carrier, BlockGraphCarrier)

    def lower(self, carrier, plan: ExecutionPlan, track_live: bool = False,
              donate: bool = False):
        if track_live:
            reject_track_live(self.name)
        if donate:
            reject_donate(self.name)
        if plan.strategy:
            raise NotImplementedError(
                "the block-granularity 'policy' backend does not realize "
                "storage strategies (block outputs are pytrees under one "
                "checkpoint name); lower strategy plans with "
                "backend='segment' (BlockGraphs) or backend='fx' "
                "(traced functions)"
            )
        check_plan_on_mesh(carrier, plan)
        return blockgraph_value_and_grad(
            lambda p, x: apply_with_policy(carrier.bg, p, x, plan, mesh=carrier.mesh),
            carrier.loss_fn)


register_lowering(PolicyLowering())
