"""Canonical strategy (§3) as an executable plan.

``ExecutionPlan`` is the pivot of the unified pipeline: the DP output (a
lower-set sequence) lowered into segments/cache-set form, which every
registered backend in ``core.lowering`` executes —

* ``"interpreter"`` — segment-by-segment VJP interpreter (paper-faithful
  semantics; validates gradients and audits live bytes);
* ``"policy"`` / ``"jaxpr"`` — one ``jax.checkpoint`` whose
  ``save_only_these_names`` policy is the plan's cache set U_k (production
  paths, composing with jit/pjit sharding, for BlockGraphs and arbitrary
  traced functions respectively);
* ``"segment"`` — per-segment ``jax.checkpoint``, projecting onto grouped
  scan remat for the layer-chain production models.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .graph import EMPTY, Graph, NodeSet


@dataclasses.dataclass(frozen=True)
class Segment:
    """One V_i = L_i \\ L_{i-1} with its caching decisions."""

    index: int
    nodes: Tuple[int, ...]  # V_i in topological order
    lower_set: NodeSet  # L_i
    boundary: NodeSet  # ∂(L_i) ∪ (pins ∩ L_i) — cached after this forward
    keep: NodeSet  # boundary ∩ V_i — newly cached nodes
    recompute: NodeSet  # V_i \ U_k — recomputed during backward


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    segments: Tuple[Segment, ...]
    cached: NodeSet  # U_k — everything ever cached
    overhead: float  # eq. (1), plus strategy taxes for strategy plans
    peak_memory: float  # liveness-tight analytic peak (dp.peak_memory_live)
    #: Per-node storage strategy of the cached set (core.strategies codes).
    #: Empty for the paper's binary plans; keys are a subset of ``cached``
    #: and a missing key means "store".  Lowerings read this to place
    #: offloaded residuals on host and run quantized ones through the
    #: optim.compression round-trip.
    strategy: Dict[int, str] = dataclasses.field(default_factory=dict)

    @property
    def num_segments(self) -> int:
        return len(self.segments)

    def segment_of(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for seg in self.segments:
            for v in seg.nodes:
                out[v] = seg.index
        return out


def make_plan(
    g: Graph,
    sequence: Sequence[NodeSet],
    assignment: Optional[Dict[int, str]] = None,
    strategies: Optional["object"] = None,
) -> ExecutionPlan:
    """Lower a validated lower-set sequence into an ExecutionPlan.

    ``peak_memory`` is the liveness-tight analytic peak — the budget the DP
    admitted the sequence under, and an exact upper bound on the
    interpreter's measured live bytes (equals the §2 event simulation with
    last-use frees).

    ``assignment`` (joint memory-strategy DP output) attaches a per-node
    storage strategy to the cached set: ``peak_memory`` then prices
    offloaded/quantized residuals at their reduced device bytes, and — when
    a ``strategies`` :class:`~repro_torch.core.strategies.StrategyConfig` is
    given — ``overhead`` additionally carries the assignment's transfer /
    codec taxes (the joint DP's time-centric ``t`` axis).
    """
    from .dp import overhead as _overhead, peak_memory_live as _peak
    from .strategies import STORE, assignment_taxes

    g.check_increasing_sequence(sequence)
    order = g.topological_order()
    pos = {v: i for i, v in enumerate(order)}

    segments: List[Segment] = []
    prev: NodeSet = EMPTY
    cached: set = set()
    pins = g.store_pins
    for i, L in enumerate(sequence):
        Vi = L - prev
        # effective cache: boundary plus must_store pins (effect analysis)
        b = g.boundary(L) | (pins & L)
        cached |= b
        segments.append(
            Segment(
                index=i,
                nodes=tuple(sorted(Vi, key=pos.get)),
                lower_set=L,
                boundary=b,
                keep=frozenset(b & Vi),
                recompute=EMPTY,  # filled below once U_k is known
            )
        )
        prev = L
    U_k = frozenset(cached)
    segments = [
        dataclasses.replace(s, recompute=frozenset(set(s.nodes) - U_k))
        for s in segments
    ]
    strategy: Dict[int, str] = {}
    if assignment:
        strategy = {
            v: code for v, code in assignment.items()
            if v in U_k and code != STORE
        }
    overhead = _overhead(g, sequence)
    if strategy and strategies is not None:
        overhead += assignment_taxes(g, strategy, strategies)
    return ExecutionPlan(
        segments=tuple(segments),
        cached=U_k,
        overhead=overhead,
        peak_memory=_peak(g, sequence, strategy or None),
        strategy=strategy,
    )


def plan_summary(g: Graph, plan: ExecutionPlan) -> str:
    lines = [
        f"ExecutionPlan: {plan.num_segments} segments, "
        f"overhead T={plan.overhead:.3g} "
        f"({100 * plan.overhead / g.total_time:.1f}% of fwd), "
        f"analytic peak M={plan.peak_memory:.4g}"
    ]
    if plan.strategy:
        counts: Dict[str, int] = {}
        for code in plan.strategy.values():
            counts[code] = counts.get(code, 0) + 1
        lines[0] += " strategies=" + ",".join(
            f"{c}:{n}" for c, n in sorted(counts.items())
        )
    for s in plan.segments:
        lines.append(
            f"  seg {s.index}: |V|={len(s.nodes)} keep={sorted(s.keep)} "
            f"recompute={len(s.recompute)} nodes"
        )
    return "\n".join(lines)
