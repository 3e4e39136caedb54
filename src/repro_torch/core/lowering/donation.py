"""Donation hints: which residuals are dead at each backward window (port of
``repro/core/lowering/donation.py``).

The backward-window decomposition (``liveness.transition_excess``) prices
window ``i`` as ``M(U_{i-1}) + excess(L_{i-1}, L_i)``: the only cached
residuals charged are those of *earlier* segments plus the window's own
interior.  Every cached residual of a **later** segment (``U_k \\ U_i``)
is provably dead at window ``i``'s peak — its window already ran (the
backward processes segments last → first).  :func:`donation_hints` names
these per segment.

The reference realizes the hints through ``jax.jit(donate_argnums=...)``,
letting XLA alias the buffers of the twin's non-differentiated arguments.
Torch has no jit donation; the port's ``"fx"`` and ``"segment"``
lowerings with ``donate=True`` drop their own references to each value
that crosses segments once no later segment reads it, and carry
``donate_argnums`` and ``donation_hints`` as the reference's twin does.
Values and gradients are unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from ..graph import Graph
from ..schedule import ExecutionPlan


def donation_hints(g: Graph, plan: ExecutionPlan) -> Dict[int, Tuple[str, ...]]:
    """Names of cached buffers provably dead at each window's in-peak.

    ``hints[i]`` lists the cached residuals **not** charged by the
    functional while segment ``i``'s backward window runs: exactly
    ``U_k \\ L_i`` — cached nodes of later segments, whose windows were
    already consumed when window ``i`` executes.  Sorted for determinism.
    """
    hints: Dict[int, Tuple[str, ...]] = {}
    for seg in plan.segments:
        dead = plan.cached - seg.lower_set
        hints[seg.index] = tuple(sorted(g.nodes[v].name for v in dead))
    return hints


def donatable_argnums(carrier: Any) -> Tuple[int, ...]:
    """Positional arguments of the lowered twin that are safe to donate.

    Traced carriers: every positional arg **not** differentiated
    (``carrier.argnums``) — grads are returned for the others, and the
    backward may hold their values, so they stay caller-owned.  BlockGraph
    carriers: the ``inputs`` dict (arg 1; ``params`` is differentiated).
    """
    slices = getattr(carrier, "arg_slices", None)
    if slices is None:
        return (1,)  # BlockGraph convention: f(params, inputs)
    argnums = carrier.argnums
    diff = {argnums} if isinstance(argnums, int) else set(argnums)
    return tuple(i for i in range(len(slices)) if i not in diff)
