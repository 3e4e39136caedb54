"""§4.1 — naive exhaustive search over lower-set sequences.

Exponential; used as the correctness oracle for the DP in tests (the DP's
optimum must match the exhaustive optimum on small graphs) and to expose the
triplet-state ``(L, t, m)`` observation that motivates the DP.

With ``strategies=`` (an extended ``StrategyConfig``) the search also
enumerates, per transition, every legal per-node storage-strategy
assignment of the newly cached set — the brute-force ground truth the
joint memory-strategy DP is property-tested against.  All folds (device
bytes, taxes) run in ascending node id, matching the DP's incremental
Minkowski sums float-for-float, and the budget check reads the same
memoized ``transition_excess`` value — so optimum equality is exact, not
approximate.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

from .dp import DPResult, INF, peak_memory_live, to_mask
from .graph import EMPTY, Graph, NodeSet
from .liveness import transition_excess
from .lower_sets import all_lower_sets
from .strategies import StrategyConfig


def exhaustive_search(
    g: Graph,
    budget: float,
    objective: str = "time_centric",
    family: Optional[Sequence[NodeSet]] = None,
    strategies: Optional[StrategyConfig] = None,
) -> DPResult:
    """DFS over all increasing sequences {L₁ ≺ … ≺ L_k = V} within budget.

    Tracks the triplet (L, t, m) exactly as §4.1 describes:
      t = overhead so far, m = M(U_i) of the cache so far.

    With an extended ``strategies`` config every transition additionally
    branches over the product of its newly cached nodes' legal storage
    options; ``t`` then accumulates the strategy taxes for the
    time-centric objective (memory-centric maximizes pure recomputation
    overhead, so taxes stay out of its objective) and ``m`` accumulates
    the chosen device bytes.
    """
    ext = strategies is not None and strategies.extended
    tc = objective == "time_centric"
    fam = list(family) if family is not None else all_lower_sets(g)
    fam = [L for L in fam if L]  # drop ∅ as a sequence element
    full = frozenset(range(g.n))
    fam_sorted = sorted(fam, key=len)

    best_t = INF if tc else -INF
    best_seq: List[NodeSet] = []
    best_assign: Optional[Dict[int, str]] = None
    states = 0

    # Precompute per-L terms.
    info = {}
    for L in fam_sorted:
        b = g.boundary(L)
        info[L] = (b, to_mask(L), to_mask(b))

    def better(t: float) -> bool:
        return t < best_t if tc else t > best_t

    def rec(L: NodeSet, t: float, m: float, seq: List[NodeSet],
            assign: Dict[int, str]) -> None:
        nonlocal best_t, best_seq, best_assign, states
        states += 1
        if L == full:
            if better(t):
                best_t = t
                best_seq = list(seq)
                best_assign = dict(assign) if ext else None
            return
        mask_L = to_mask(L)
        for Lp in fam_sorted:
            if len(Lp) <= len(L) or not (L < Lp):
                continue
            b, mask_Lp, bd_mask = info[Lp]
            Vp = Lp - L
            # 𝓜⁽ⁱ⁾ with M(U_{i-1}) = m, same functional (and same memoized
            # floats) as the DP it oracles
            Mi = m + transition_excess(g, mask_L, mask_Lp, bd_mask)
            if Mi > budget:
                continue
            base_t = g.T(Vp - b)
            if not ext:
                seq.append(Lp)
                rec(Lp, t + base_t, m + g.M(b - L), seq, assign)
                seq.pop()
                continue
            new_nodes = sorted(b - L)
            per_node = [strategies.node_options(g, v) for v in new_nodes]
            for combo in itertools.product(*per_node):
                # ascending-id left folds, then one add onto the running
                # totals — the DP's exact float shape
                m_add = 0.0
                tax = 0.0
                for _code, bb, tx in combo:
                    m_add += bb
                    tax += tx
                t2 = t + (base_t + tax) if tc else t + base_t
                m2 = m + m_add
                seq.append(Lp)
                for v, (code, _bb, _tx) in zip(new_nodes, combo):
                    assign[v] = code
                rec(Lp, t2, m2, seq, assign)
                for v in new_nodes:
                    del assign[v]
                seq.pop()

    rec(EMPTY, 0.0, 0.0, [], {})

    if not best_seq:
        return DPResult([], INF, INF, feasible=False, states_visited=states)
    return DPResult(
        sequence=best_seq,
        overhead=best_t,
        peak_memory=peak_memory_live(g, best_seq, best_assign),
        feasible=True,
        states_visited=states,
        assignment=best_assign,
    )
