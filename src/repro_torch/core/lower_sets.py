"""Lower-set families for the DP (§4.2 exact, §4.3 pruned).

* ``all_lower_sets``     — enumerate 𝓛_G exactly (exponential in the antichain
                           width; used by the *exact* DP and the tests).
* ``pruned_lower_sets``  — 𝓛_G^Pruned = {L^v | v ∈ V} ∪ {∅, V}; ``#`` ≤ #V + 2
                           (§4.3: the approximate DP's key family).

The exact enumeration walks the lattice of lower sets as an ideal lattice of
the DAG's partial order: a lower set is uniquely determined by its maximal
elements (an antichain), and we enumerate by repeatedly adding any node whose
predecessors are all present.  To avoid duplicates we only add nodes with id
greater than the last-added "frontier" id along each DFS branch — the standard
ideal-enumeration trick.
"""

from __future__ import annotations

from typing import List, Set

from .graph import EMPTY, Graph, NodeSet

# Single source of truth for "how many lower sets is too many".  Shared by
# ``all_lower_sets`` / ``count_lower_sets``, ``dp.exact_dp``, and
# ``planner._family`` so the same graph can never plan through one entry
# point and blow past the limit through another.
DEFAULT_LOWER_SET_LIMIT = 2_000_000


def all_lower_sets(g: Graph, limit: int = DEFAULT_LOWER_SET_LIMIT) -> List[NodeSet]:
    """Enumerate every lower set of ``g`` (including ∅ and V).

    Raises ``RuntimeError`` if more than ``limit`` lower sets exist — the
    caller should fall back to the pruned family (that is the paper's whole
    point for §4.3).
    """
    n = g.n
    results: List[NodeSet] = []

    # The increasing-id DFS below enumerates each ideal exactly once *iff*
    # ids form a linear extension of the DAG (every ideal is then buildable
    # by adding its elements in increasing id order).  Node ids are arbitrary,
    # so work in topological *rank* space and map back at the end.
    topo = g.topological_order()
    rank_of = {v: r for r, v in enumerate(topo)}  # node id -> rank
    succ_r: List[List[int]] = [[] for _ in range(n)]
    indeg = [0] * n
    for v, w in g.edges:
        succ_r[rank_of[v]].append(rank_of[w])
        indeg[rank_of[w]] += 1
    init_candidates = sorted(r for r in range(n) if indeg[r] == 0)

    cur: Set[int] = set()  # ranks
    results.append(EMPTY)

    def dfs(candidates: List[int], min_rank: int, indeg_now: List[int]) -> None:
        for i, r in enumerate(candidates):
            if r < min_rank:
                continue
            # add rank r
            cur.add(r)
            results.append(frozenset(topo[x] for x in cur))
            if len(results) > limit:
                raise RuntimeError(
                    f"more than {limit} lower sets; use pruned_lower_sets"
                )
            new_cands = list(candidates[:i]) + list(candidates[i + 1 :])
            opened = []
            for w in succ_r[r]:
                indeg_now[w] -= 1
                if indeg_now[w] == 0:
                    opened.append(w)  # w > r since ranks are topological
            new_cands.extend(opened)
            dfs(new_cands, r + 1, indeg_now)
            for w in succ_r[r]:
                indeg_now[w] += 1
            cur.discard(r)

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, n * 4 + 1000))
    try:
        dfs(init_candidates, -1, list(indeg))
    finally:
        sys.setrecursionlimit(old_limit)
    # Deduplicate (the frontier trick above makes them unique already, but a
    # frozenset pass is cheap insurance) and sort by size for the DP sweep.
    uniq = sorted(set(results), key=lambda s: (len(s), sorted(s)))
    return uniq


def pruned_lower_sets(g: Graph) -> List[NodeSet]:
    """𝓛_G^Pruned = {L^v | v ∈ V} with L^v = {w | v reachable from w} (§4.3).

    ∅ and V are always included so the DP has its start/terminal states
    (L^v for a sink v already equals... not necessarily V, so V is added
    explicitly; the paper's DP needs L_k = V).
    """
    fam: Set[NodeSet] = {EMPTY, frozenset(range(g.n))}
    for v in range(g.n):
        fam.add(g.ancestors_of(v))
    return sorted(fam, key=lambda s: (len(s), sorted(s)))


def segment_lower_sets(g: Graph, order: List[int] | None = None) -> List[NodeSet]:
    """Beyond-paper helper: prefix lower sets along a topological order.

    For chain-like graphs this equals 𝓛_G; for general graphs it is a cheap
    family (size #V+1) complementary to 𝓛^Pruned.  Every prefix of a
    topological order is a lower set.
    """
    order = order if order is not None else g.topological_order()
    fam: Set[NodeSet] = {EMPTY}
    cur: Set[int] = set()
    for v in order:
        cur.add(v)
        fam.add(frozenset(cur))
    return sorted(fam, key=lambda s: (len(s), sorted(s)))


def count_lower_sets(g: Graph, limit: int = DEFAULT_LOWER_SET_LIMIT) -> int:
    """#𝓛_G (for reporting; paper notes #V ≤ #𝓛_G ≤ 2^#V)."""
    return len(all_lower_sets(g, limit=limit))
