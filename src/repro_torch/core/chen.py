"""Chen et al. [arXiv:1604.06174] √n-segmentation baseline, with the paper's
Appendix-B configuration.

Chen's algorithm divides an n-layer network into ~√n segments, caches segment
boundaries during the forward pass, and recomputes each segment from its
cached input during backprop.  The paper (Appendix B) fills in the two
under-specified pieces:

* topological order: DFS on the computation graph;
* candidate stage-splitting points C: nodes whose removal disconnects the
  graph — the *articulation points* of (the undirected version of) G.

A split at articulation point c induces the prefix lower set
``ancestors_of(c)`` (everything at or before c), so a Chen segmentation is a
special canonical strategy and can be scored with the same eq. (1)/(2) +
liveness machinery — exactly how the paper compares against it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Set, Tuple

from .dp import DPResult, overhead, peak_memory_live
from .graph import Graph, NodeSet


def articulation_points(g: Graph) -> List[int]:
    """Articulation points of the undirected version of G (Tarjan, iterative)."""
    n = g.n
    adj: List[Set[int]] = [set() for _ in range(n)]
    for v, w in g.edges:
        adj[v].add(w)
        adj[w].add(v)

    visited = [False] * n
    disc = [0] * n
    low = [0] * n
    parent = [-1] * n
    ap = [False] * n
    timer = 0

    for root in range(n):
        if visited[root]:
            continue
        stack: List[Tuple[int, iter]] = [(root, iter(adj[root]))]
        visited[root] = True
        disc[root] = low[root] = timer = timer + 1
        root_children = 0
        while stack:
            v, it = stack[-1]
            advanced = False
            for w in it:
                if not visited[w]:
                    if v == root:
                        root_children += 1
                    visited[w] = True
                    timer += 1
                    disc[w] = low[w] = timer
                    parent[w] = v
                    stack.append((w, iter(adj[w])))
                    advanced = True
                    break
                elif w != parent[v]:
                    low[v] = min(low[v], disc[w])
            if not advanced:
                stack.pop()
                if stack:
                    u = stack[-1][0]
                    low[u] = min(low[u], low[v])
                    if u != root and low[v] >= disc[u]:
                        ap[u] = True
        if root_children > 1:
            ap[root] = True
    return [v for v in range(n) if ap[v]]


def candidate_split_points(g: Graph) -> List[int]:
    """Appendix B's C: articulation points, in topological order.

    A valid split point must additionally induce a *prefix*: every node is
    either an ancestor of c or a descendant (otherwise cutting at c leaves
    parallel work straddling the cut).  We keep points where
    ancestors ∪ descendants = V, which is what "removal disconnects the graph
    into a before and an after" means for a DAG stage split.
    """
    aps = set(articulation_points(g))
    full = frozenset(range(g.n))
    order = g.topological_order()
    out = []
    for v in order:
        if v not in aps:
            continue
        anc = g.ancestors_of(v)
        desc = g.reachable_from(v)
        if anc | desc == full:
            out.append(v)
    return out


def chen_sqrt_n(
    g: Graph, budget: Optional[float] = None, num_segments: Optional[int] = None
) -> DPResult:
    """Chen's √n segmentation over candidate split points.

    With no budget given, targets k = ⌈√(#C+1)⌉ segments of roughly equal
    T-cost (the √n rule).  With a budget, greedily packs candidates until
    the analytic peak of the running segmentation would exceed it (Chen's
    Algorithm 3 "Memory Planning with Budget" adapted to the paper's cost
    model), then verifies feasibility.  Peaks and feasibility use the same
    liveness-tight functional as the DP (``dp.peak_memory_live``), so a
    Chen segmentation and a DP plan scored at the same budget are
    comparable like for like.
    """
    cands = candidate_split_points(g)
    full = frozenset(range(g.n))

    if not cands:
        # Indivisible graph (paper §2: e.g. skip connection from every layer
        # to the output) — Chen degenerates to the vanilla single segment.
        seq = [full]
        return DPResult(
            sequence=seq,
            overhead=overhead(g, seq),
            peak_memory=peak_memory_live(g, seq),
            feasible=(budget is None or peak_memory_live(g, seq) <= budget),
        )

    prefixes = [g.ancestors_of(c) for c in cands]

    if budget is None:
        k = num_segments or max(1, int(math.isqrt(len(cands) + 1)))
        # pick k-1 split points equally spaced in cumulative T
        totT = g.total_time
        targets = [totT * i / k for i in range(1, k)]
        chosen: List[NodeSet] = []
        ti = 0
        for L in prefixes:
            if ti >= len(targets):
                break
            if g.T(L) >= targets[ti]:
                if not chosen or len(L) > len(chosen[-1]):
                    chosen.append(L)
                ti += 1
        seq = chosen + [full]
        seq = _dedup(seq)
        return DPResult(
            sequence=seq,
            overhead=overhead(g, seq),
            peak_memory=peak_memory_live(g, seq),
            feasible=True,
        )

    # Budgeted variant: greedy packing — extend current segment until adding
    # the next candidate would push the analytic peak for the segment over B.
    seq: List[NodeSet] = []
    for L in prefixes + [full]:
        if seq and len(L) <= len(seq[-1]):
            continue
        trial = _dedup(seq + ([full] if L != full else [L]))
        if L != full:
            trial = _dedup(seq + [L, full])
        if peak_memory_live(g, trial) <= budget:
            # keep the coarser segmentation (skip this cut) if still feasible
            continue
        if L != full:
            seq.append(L)
    seq = _dedup(seq + [full])
    pk = peak_memory_live(g, seq)
    return DPResult(
        sequence=seq,
        overhead=overhead(g, seq),
        peak_memory=pk,
        feasible=pk <= budget,
    )


def _dedup(seq: List[NodeSet]) -> List[NodeSet]:
    out: List[NodeSet] = []
    for L in seq:
        if not out or len(L) > len(out[-1]):
            out.append(L)
    return out
