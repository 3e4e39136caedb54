"""Static plan verifier: re-derive schedule soundness from first principles
(port of ``repro/analysis/verifier.py``; ``FxGraph`` takes the place of
``JaxprGraph``).

Given any :class:`~repro_torch.core.schedule.ExecutionPlan`, re-check everything
the plan claims **without** going through the DP that produced it — a
verifier bug and a solver bug can't cancel:

* topological validity — each ``L_i`` is a lower set, strictly increasing,
  terminating at ``V``; segments partition ``V`` as ``L_i \\ L_{i-1}``;
* cache-set consistency — ``cached`` equals the re-derived
  ``∪_i (∂(L_i) ∪ (pins ∩ L_i))``, per-segment ``keep`` / ``recompute``
  agree, and no ``must_store`` pin is ever scheduled for recomputation;
* replay soundness — every segment's external inputs ``δ⁻(V_i) \\ V_i``
  are cached *before* the segment replays (members of the effective cache
  of ``L_{i-1}``);
* analytic peak — recomputed via the **event-level simulator**
  (``liveness.simulate``, independent of the DP's closed-form transition
  pricing) and compared against ``plan.peak_memory`` and the budget;
* overhead — eq. (1)'s ``T(V \\ U_k)`` re-summed directly;
* ``M_v`` — each node's bytes re-derived from the fake values of its fx
  node's outputs (``fx_graph.tensor_bytes``); on a mesh-traced carrier the
  per-device shard bytes under the trace's propagated specs.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, FrozenSet, Optional

from ..core.fx_graph import FxGraph
from ..core.graph import Graph
from ..core.schedule import ExecutionPlan
from .report import Report

if TYPE_CHECKING:  # pragma: no cover
    from .effects import EffectAnalysis

_REL_TOL = 1e-9


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= _REL_TOL * max(1.0, abs(a), abs(b))


def check_plan(
    g: Graph,
    plan: ExecutionPlan,
    budget: Optional[float] = None,
    effects: Optional["EffectAnalysis"] = None,
    fx: Optional[FxGraph] = None,
    strategies: Optional[object] = None,
) -> Report:
    """Statically verify ``plan`` against ``g`` (see module docstring).

    ``budget``: enforce ``peak ≤ budget`` when given.  ``effects``: the
    graph's :class:`~repro_torch.analysis.effects.EffectAnalysis` — every
    *storable* tainted equation and every derived ``must_store`` pin must be
    in the plan's cache set (unstorable taint — key plumbing, counter bits —
    replays deterministically once its storable frontier is cached, so it is
    not flagged).  ``fx``: the traced carrier's ``FxGraph``, enabling the
    ``M_v`` consistency check.

    Strategy-annotated plans (``plan.strategy`` non-empty) additionally
    check: every assigned node is cached, codes are known, ``must_store``
    pins / storable-tainted nodes are never quantized (the round-trip is
    lossy, so a pinned node's replay would not be bit-identical; offload is
    legal — host copies are exact), the simulated peak prices offloaded
    residuals at zero device bytes and quantized ones at int8+scale bytes,
    and — when the pricing ``strategies``
    :class:`~repro_torch.core.strategies.StrategyConfig` is supplied — the
    declared overhead equals eq. (1) plus the assignment's transfer/codec
    taxes.  Without the config the tax term cannot be re-derived and only
    ``overhead ≥ T(V \\ U_k)`` is enforced.
    """
    from ..core import liveness

    report = Report(checker="plan")
    n = g.n
    full = frozenset(range(n))

    # ---- 1. sequence validity ------------------------------------------
    seq = [s.lower_set for s in plan.segments]
    if not seq:
        report.add("error", "empty-plan", "plan has no segments")
        return report
    try:
        g.check_increasing_sequence(seq)
    except ValueError as e:
        report.add("error", "invalid-sequence", str(e))
        return report

    pins = g.store_pins
    prev: FrozenSet[int] = frozenset()
    derived_cached: set = set()
    for seg in plan.segments:
        Vi = seg.lower_set - prev
        if frozenset(seg.nodes) != Vi:
            report.add(
                "error",
                "segment-partition",
                f"segment {seg.index}: nodes {sorted(seg.nodes)} != "
                f"L_{seg.index} \\ L_{seg.index - 1} = {sorted(Vi)}",
            )
        # ---- 2. per-segment cache decisions ----------------------------
        b_eff = g.boundary(seg.lower_set) | (pins & seg.lower_set)
        if seg.boundary != b_eff:
            report.add(
                "error",
                "boundary-mismatch",
                f"segment {seg.index}: declared boundary "
                f"{sorted(seg.boundary)} != derived ∂(L)∪pins {sorted(b_eff)}",
            )
        if seg.keep != (b_eff & Vi):
            report.add(
                "error",
                "keep-mismatch",
                f"segment {seg.index}: keep {sorted(seg.keep)} != "
                f"{sorted(b_eff & Vi)}",
            )
        derived_cached |= b_eff
        prev = seg.lower_set

    U_k = frozenset(derived_cached)
    if plan.cached != U_k:
        extra = sorted(plan.cached - U_k)
        missing = sorted(U_k - plan.cached)
        report.add(
            "error",
            "cache-set-mismatch",
            f"plan.cached disagrees with the re-derived U_k "
            f"(extra={extra}, missing={missing}); residuals saved by the "
            "lowering would not match the schedule's replay assumptions",
        )

    # recompute sets + pins never recomputed
    for seg in plan.segments:
        Vi = frozenset(seg.nodes)
        want = Vi - U_k
        if seg.recompute != want:
            report.add(
                "error",
                "recompute-mismatch",
                f"segment {seg.index}: recompute {sorted(seg.recompute)} != "
                f"V_i \\ U_k = {sorted(want)}",
            )
        hit = sorted(pins & seg.recompute)
        if hit:
            report.add(
                "error",
                "pinned-node-recomputed",
                f"segment {seg.index} recomputes must_store node(s) "
                f"{[g.nodes[v].name for v in hit]}",
                node=hit[0],
            )

    # ---- 3. replay soundness -------------------------------------------
    prev = frozenset()
    avail: set = set()  # effective cache of L_{i-1}
    for seg in plan.segments:
        Vi = frozenset(seg.nodes)
        ext = g.delta_minus(Vi) - Vi
        missing = sorted(ext - avail) if seg.index > 0 else sorted(ext)
        if missing:
            report.add(
                "error",
                "replay-missing-input",
                f"segment {seg.index} reads {[g.nodes[v].name for v in missing]} "
                "which are neither recomputed in-segment nor cached by an "
                "earlier segment",
                node=missing[0],
            )
        avail |= g.boundary(seg.lower_set) | (pins & seg.lower_set)
        prev = seg.lower_set

    # ---- 4. recomputed taint -------------------------------------------
    if effects is not None:
        must_cache = frozenset(
            v for v in effects.tainted if effects.effects[v].storable
        ) | effects.pins
        for v in sorted(must_cache - U_k):
            report.add(
                "error",
                "tainted-recompute",
                f"{g.nodes[v].name} absorbs non-pure effects "
                "(effect analysis) but is not in the plan's cache set — "
                "replaying it in the backward pass is not provably "
                "bit-identical; re-plan with its must_store pin applied "
                "(pin_graph)",
                node=v,
            )

    # ---- 4b. storage-strategy validity ---------------------------------
    strategy = dict(plan.strategy or {})
    if strategy:
        from ..core.strategies import OFFLOAD, QUANTIZE, STORE

        known = {STORE, OFFLOAD, QUANTIZE}
        for v in sorted(strategy):
            code = strategy[v]
            if code not in known:
                report.add(
                    "error",
                    "unknown-strategy",
                    f"node {g.nodes[v].name} carries unknown storage "
                    f"strategy {code!r}",
                    node=v,
                )
            if v not in plan.cached:
                report.add(
                    "error",
                    "strategy-uncached-node",
                    f"node {g.nodes[v].name} has strategy {code!r} but is "
                    "not in the plan's cache set — strategies only apply to "
                    "cached residuals",
                    node=v,
                )
        lossy = frozenset(
            v for v, code in strategy.items() if code == QUANTIZE
        )
        no_quantize = pins
        if effects is not None:
            no_quantize = no_quantize | frozenset(
                v for v in effects.tainted if effects.effects[v].storable
            ) | effects.pins
        for v in sorted(lossy & no_quantize):
            report.add(
                "error",
                "pinned-node-quantized",
                f"must_store / effect-tainted node {g.nodes[v].name} is "
                "quantized — the int8 round-trip is lossy, so its replayed "
                "value would not be bit-identical (offload it instead)",
                node=v,
            )

    # stop before the quantitative checks if the schedule itself is broken —
    # the simulator requires a structurally valid plan
    if not report.ok:
        return report

    # ---- 5. analytic peak (event-level, DP-independent) ----------------
    # For strategy plans the simulator reprices cached residuals at their
    # device footprint — offloaded bytes never count against the device
    # peak, quantized ones count at int8+scale bytes.
    sim = liveness.simulate(g, seq, liveness=True,
                            assignment=strategy or None)
    if not _close(sim.peak_memory, plan.peak_memory):
        report.add(
            "error",
            "peak-mismatch",
            f"declared peak {plan.peak_memory:.6g} != simulated last-use "
            f"liveness peak {sim.peak_memory:.6g}",
        )
    if budget is not None and sim.peak_memory > budget * (1 + _REL_TOL):
        report.add(
            "error",
            "over-budget",
            f"simulated peak {sim.peak_memory:.6g} exceeds the budget "
            f"{budget:.6g}",
        )

    # ---- 6. overhead (eq. 1, plus strategy taxes) ----------------------
    want_overhead = g.T(full - U_k)
    if strategy and strategies is not None:
        from ..core.strategies import assignment_taxes

        try:
            want_overhead += assignment_taxes(g, strategy, strategies)
        except ValueError as e:
            report.add("error", "illegal-assignment", str(e))
            return report
    if strategy and strategies is None:
        # without the pricing config the transfer/codec tax term can't be
        # re-derived; the declared overhead must still dominate eq. (1)
        if plan.overhead < want_overhead * (1 - _REL_TOL):
            report.add(
                "error",
                "overhead-mismatch",
                f"declared overhead {plan.overhead:.6g} is below eq. (1)'s "
                f"T(V \\ U_k) = {want_overhead:.6g} — strategy taxes can "
                "only add time",
            )
    elif not _close(want_overhead, plan.overhead):
        report.add(
            "error",
            "overhead-mismatch",
            f"declared overhead {plan.overhead:.6g} != T(V \\ U_k) "
            + ("+ strategy taxes " if strategy else "")
            + f"= {want_overhead:.6g}",
        )

    # ---- 7. M_v vs the trace's fake values -----------------------------
    if fx is not None:
        report.extend(check_graph_memory(fx).findings)

    return report


def check_graph_memory(fx: FxGraph) -> Report:
    """Re-derive every node's ``M_v`` from its fx node's output values.

    Each node's bytes are the bytes of the fake tensors its producing op
    returned in the trace (``fx_graph.tensor_bytes``, at least 1); for a
    mesh-traced carrier, the ceil-divided shard bytes under the propagated
    specs (``fx_graph.node_memory``).  Catches stale graphs (edited costs,
    mismatched specs) before a per-device budget is trusted.
    """
    from ..core.fx_graph import node_memory

    report = Report(checker="graph-memory")
    g = fx.graph
    for idx, node in enumerate(fx.nodes):
        specs = fx.node_specs[idx] if fx.node_specs is not None else None
        mem = float(node_memory(node.meta.get("val"), specs, fx.axis_sizes)[0])
        if mem != g.mem_v[idx]:
            report.add(
                "error",
                "memory-mismatch",
                f"{g.nodes[idx].name}: graph M_v={g.mem_v[idx]:.6g} but the "
                f"node's output values give {mem:.6g} bytes"
                + (" per device" if specs is not None else ""),
                node=idx,
            )
    return report
