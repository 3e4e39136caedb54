"""Computation-graph language of the paper (§2).

A directed acyclic graph ``G = (V, E)`` over the *intermediate* nodes of a
neural network.  Input nodes and parameters are excluded (§2).  Each node
``v`` carries a forward-computation cost ``T_v > 0`` and a memory cost
``M_v > 0``.

Definitions implemented here, verbatim from the paper:

* ``δ⁺(S) = {v ∈ V | (s, v) ∈ E for some s ∈ S}``
* ``δ⁻(S) = {v ∈ V | (v, s) ∈ E for some s ∈ S}``
* ``L ⊆ V`` is a *lower set* iff there is no edge from ``V \\ L`` into ``L``
  (equivalently ``δ⁻(L) ⊆ L``), written ``L ≺ V``.
* the *boundary* ``∂(L) = δ⁻(V \\ L) ∩ L``.

Node sets are represented as Python ``frozenset`` of integer node ids for
hashability (DP table keys), with bitmask fast paths for small graphs.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

NodeSet = FrozenSet[int]

EMPTY: NodeSet = frozenset()


# Bitmask form of node sets (big-int; bit v = node v).  Single source of
# truth for the DP (core.dp) and the liveness analytics (core.liveness).


def to_mask(s: Iterable[int]) -> int:
    m = 0
    for v in s:
        m |= 1 << v
    return m


def from_mask(m: int) -> NodeSet:
    out = []
    v = 0
    while m:
        if m & 1:
            out.append(v)
        m >>= 1
        v += 1
    return frozenset(out)


def mask_iter(m: int) -> Iterable[int]:
    v = 0
    while m:
        if m & 1:
            yield v
        m >>= 1
        v += 1


@dataclasses.dataclass(frozen=True)
class Node:
    """A single intermediate value in the network.

    Attributes:
      idx: integer id, also the index into ``Graph.nodes``.
      name: human-readable name (layer / jaxpr eqn primitive).
      time: forward computation cost ``T_v`` (paper: 10 for conv, 1 otherwise).
      memory: memory consumption cost ``M_v`` (bytes, or abstract units).
      kind: free-form tag ("conv", "matmul", "elementwise", ...).
      must_store: hard pin from effect analysis (the reference's ``repro.analysis``) — the
        node's value may not be recomputed (PRNG draw, side effect, opaque
        higher-order equation), so every plan must keep it resident from its
        forward computation until its last use.
    """

    idx: int
    name: str
    time: float
    memory: float
    kind: str = "generic"
    must_store: bool = False


class Graph:
    """Directed graph ``G = (V, E)`` with per-node costs ``T_v``, ``M_v``.

    Edges mean: ``(v, w) ∈ E`` iff the value of ``v`` is directly required to
    compute ``w``.
    """

    def __init__(
        self,
        nodes: Sequence[Node],
        edges: Iterable[Tuple[int, int]],
        cost_source: str = "",
    ):
        #: Provenance of the ``T_v`` values ("" = analytic / paper costs,
        #: ``"profile:<key>"`` = microbenchmark-calibrated,
        #: ``"compiled:<key>"`` = XLA cost_analysis-calibrated).  Non-empty
        #: sources are hashed into ``graph_digest`` so plans priced under
        #: different cost models never alias in the plan cache, even when the
        #: quantized T_v happen to coincide.
        self.cost_source: str = cost_source
        self.nodes: List[Node] = list(nodes)
        n = len(self.nodes)
        for i, node in enumerate(self.nodes):
            if node.idx != i:
                raise ValueError(f"node {node.name} has idx {node.idx}, expected {i}")
            if node.time <= 0 or node.memory <= 0:
                raise ValueError(
                    f"node {node.name}: costs must be positive "
                    f"(T={node.time}, M={node.memory})"
                )
        self.succ: List[List[int]] = [[] for _ in range(n)]
        self.pred: List[List[int]] = [[] for _ in range(n)]
        seen = set()
        for v, w in edges:
            if not (0 <= v < n and 0 <= w < n):
                raise ValueError(f"edge ({v},{w}) out of range")
            if v == w:
                raise ValueError(f"self loop at {v}")
            if (v, w) in seen:
                continue
            seen.add((v, w))
            self.succ[v].append(w)
            self.pred[w].append(v)
        self.edges: FrozenSet[Tuple[int, int]] = frozenset(seen)
        self._topo: Optional[List[int]] = None
        self._assert_acyclic()
        # Cost vectors.
        self.time_v: List[float] = [nd.time for nd in self.nodes]
        self.mem_v: List[float] = [nd.memory for nd in self.nodes]
        # Hard store pins (effect analysis): bit v set ⇔ nodes[v].must_store.
        self.store_pins_mask: int = to_mask(
            v for v, nd in enumerate(self.nodes) if nd.must_store
        )

    @property
    def store_pins(self) -> NodeSet:
        """Nodes pinned ``must_store`` by effect analysis (∅ when unanalyzed)."""
        return from_mask(self.store_pins_mask)

    # ------------------------------------------------------------------ basics

    def __len__(self) -> int:
        return len(self.nodes)

    @property
    def n(self) -> int:
        return len(self.nodes)

    def _assert_acyclic(self) -> None:
        order = self.topological_order()
        if len(order) != len(self.nodes):
            raise ValueError("graph has a cycle")

    def topological_order(self) -> List[int]:
        """Kahn topological order; cached."""
        if self._topo is not None:
            return self._topo
        indeg = [len(p) for p in self.pred]
        stack = [v for v in range(len(self.nodes)) if indeg[v] == 0]
        order: List[int] = []
        while stack:
            v = stack.pop()
            order.append(v)
            for w in self.succ[v]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    stack.append(w)
        if len(order) == len(self.nodes):
            self._topo = order
        return order

    # --------------------------------------------------------- paper notation

    def delta_plus(self, s: Iterable[int]) -> NodeSet:
        """δ⁺(S): nodes with an incoming edge from S."""
        out = set()
        for v in s:
            out.update(self.succ[v])
        return frozenset(out)

    def delta_minus(self, s: Iterable[int]) -> NodeSet:
        """δ⁻(S): nodes with an outgoing edge into S."""
        out = set()
        for v in s:
            out.update(self.pred[v])
        return frozenset(out)

    def is_lower_set(self, L: Iterable[int]) -> bool:
        """L ≺ V  ⇔  δ⁻(L) ⊆ L (no edge from V\\L into L)."""
        Ls = set(L)
        return all(p in Ls for v in Ls for p in self.pred[v])

    def boundary(self, L: Iterable[int]) -> NodeSet:
        """∂(L) = δ⁻(V \\ L) ∩ L — the nodes of L still needed outside L."""
        Ls = frozenset(L)
        comp = [v for v in range(len(self.nodes)) if v not in Ls]
        return self.delta_minus(comp) & Ls

    # ------------------------------------------------------------- aggregates

    def T(self, s: Iterable[int]) -> float:
        """T(S) = Σ_{v∈S} T_v."""
        return sum(self.time_v[v] for v in s)

    def M(self, s: Iterable[int]) -> float:
        """M(S) = Σ_{v∈S} M_v."""
        return sum(self.mem_v[v] for v in s)

    @property
    def total_time(self) -> float:
        return sum(self.time_v)

    @property
    def total_memory(self) -> float:
        return sum(self.mem_v)

    # ------------------------------------------------------------ reachability

    def reachable_from(self, v: int) -> NodeSet:
        """All nodes reachable from v (including v) following edges forward."""
        seen = {v}
        stack = [v]
        while stack:
            u = stack.pop()
            for w in self.succ[u]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        return frozenset(seen)

    def ancestors_of(self, v: int) -> NodeSet:
        """L^v = {w | v reachable from w} — the principal lower set at v (§4.3)."""
        seen = {v}
        stack = [v]
        while stack:
            u = stack.pop()
            for w in self.pred[u]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        return frozenset(seen)

    # --------------------------------------------------------------- closure

    def lower_closure(self, s: Iterable[int]) -> NodeSet:
        """Smallest lower set containing S (union of ancestor sets)."""
        out: set = set()
        for v in s:
            if v not in out:
                out.update(self.ancestors_of(v))
        return frozenset(out)

    # ------------------------------------------------------------- validation

    def check_increasing_sequence(self, seq: Sequence[NodeSet]) -> None:
        """Validate {L₁ ≺ … ≺ L_k = V}: each Lᵢ a lower set, strictly increasing,
        terminating at V."""
        if not seq:
            raise ValueError("empty sequence")
        prev: NodeSet = EMPTY
        for i, L in enumerate(seq):
            if not self.is_lower_set(L):
                raise ValueError(f"L_{i+1} is not a lower set")
            if not (prev < L):
                raise ValueError(f"L_{i+1} does not strictly contain L_{i}")
            prev = L
        if seq[-1] != frozenset(range(len(self.nodes))):
            raise ValueError("sequence must terminate at V")

    # ------------------------------------------------------------------ debug

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Graph(n={len(self.nodes)}, e={len(self.edges)})"


# ---------------------------------------------------------------------------
# Canonical hashing (plan-cache keys).
#
# ``graph_digest`` is a stable content address for (topology, quantized
# costs, kinds): invariant under node-id permutation, sensitive to any edge
# or cost change.  It is built in two steps:
#
#   1. Weisfeiler–Lehman refinement over both edge directions, seeded with
#      each node's quantized (T_v, M_v, kind) — permutation-invariant colors;
#   2. a canonical topological order (Kahn, ties broken by the canonical
#      positions of already-placed predecessors, then the WL color), which
#      yields an explicit relabeling so cached *plans* — not just digests —
#      transfer between isomorphic labelings (core.plan_cache stores lower-set
#      sequences in canonical coordinates).
#
# WL-equivalent non-automorphic nodes can in principle canonicalize
# differently across labelings; for the DP's DAGs this at worst costs a cache
# miss, never a wrong hit, because plan_cache re-validates every hit against
# the querying graph.
# ---------------------------------------------------------------------------


def _qcost(x: float, sig: int) -> str:
    """Quantize a cost to ``sig`` significant digits (string form, stable)."""
    return f"{float(x):.{sig}g}"


def _h(*parts: object) -> bytes:
    m = hashlib.sha256()
    for p in parts:
        if isinstance(p, bytes):
            m.update(p)
        else:
            m.update(str(p).encode())
        m.update(b"\x1f")
    return m.digest()


def _wl_colors(g: Graph, cost_sig: int) -> List[bytes]:
    """Permutation-invariant per-node colors (bidirectional WL refinement)."""
    colors = [
        _h("node", _qcost(nd.time, cost_sig), _qcost(nd.memory, cost_sig), nd.kind,
           *(("pin",) if nd.must_store else ()))
        for nd in g.nodes
    ]
    rounds = min(g.n, 16) + 1
    for _ in range(rounds):
        colors = [
            _h(
                colors[v],
                b"pred", *sorted(colors[p] for p in g.pred[v]),
                b"succ", *sorted(colors[s] for s in g.succ[v]),
            )
            for v in range(g.n)
        ]
    return colors


def canonical_order(g: Graph, cost_sig: int = 12) -> List[int]:
    """Canonical topological order: position → original node id.

    Deterministic for a given graph and identical (up to automorphism) for
    isomorphic graphs: Kahn's algorithm where the next node is the ready node
    with the lexicographically smallest (canonical-pred-positions, WL-color)
    key.  Cached per (graph, cost_sig) — Graphs are immutable after init.
    """
    cache = getattr(g, "_canon_cache", None)
    if cache is None:
        cache = {}
        g._canon_cache = cache
    if cost_sig in cache:
        return cache[cost_sig][0]

    colors = _wl_colors(g, cost_sig)
    pos: Dict[int, int] = {}
    indeg = [len(p) for p in g.pred]
    ready = [v for v in range(g.n) if indeg[v] == 0]
    order: List[int] = []
    while ready:
        best = min(
            ready, key=lambda v: (tuple(sorted(pos[p] for p in g.pred[v])), colors[v])
        )
        ready.remove(best)
        pos[best] = len(order)
        order.append(best)
        for w in g.succ[best]:
            indeg[w] -= 1
            if indeg[w] == 0:
                ready.append(w)

    digest = hashlib.sha256()
    digest.update(f"G|{g.n}|{len(g.edges)}".encode())
    if getattr(g, "cost_source", ""):
        digest.update(_h("cost_source", g.cost_source))
    for i, v in enumerate(order):
        nd = g.nodes[v]
        preds = sorted(pos[p] for p in g.pred[v])
        digest.update(
            _h(i, _qcost(nd.time, cost_sig), _qcost(nd.memory, cost_sig),
               nd.kind, *preds, *(("pin",) if nd.must_store else ()))
        )
    cache[cost_sig] = (order, digest.hexdigest())
    return order


def graph_digest(g: Graph, cost_sig: int = 12) -> str:
    """Stable content digest of (topology, quantized costs, kinds).

    Equal for isomorphic graphs regardless of node numbering; different
    whenever an edge, a cost (beyond ``cost_sig`` significant digits), or a
    node kind differs.  This is the plan cache's graph key.
    """
    canonical_order(g, cost_sig)
    return g._canon_cache[cost_sig][1]


def canonical_maps(g: Graph, cost_sig: int = 12) -> Tuple[Dict[int, int], List[int]]:
    """(node id → canonical position, canonical position → node id)."""
    order = canonical_order(g, cost_sig)
    return {v: i for i, v in enumerate(order)}, order


# ---------------------------------------------------------------------------
# Constructors for common topologies (used by tests and benchmarks).
# ---------------------------------------------------------------------------


def chain(n: int, time: float = 1.0, memory: float = 1.0, **kw: Any) -> Graph:
    """A simple path v₀ → v₁ → … → v_{n-1} (feed-forward net)."""
    nodes = [Node(i, f"v{i}", time, memory, **kw) for i in range(n)]
    return Graph(nodes, [(i, i + 1) for i in range(n - 1)])


def from_cost_lists(
    times: Sequence[float],
    mems: Sequence[float],
    edges: Iterable[Tuple[int, int]],
    names: Optional[Sequence[str]] = None,
    kinds: Optional[Sequence[str]] = None,
) -> Graph:
    n = len(times)
    assert len(mems) == n
    names = names or [f"v{i}" for i in range(n)]
    kinds = kinds or ["generic"] * n
    nodes = [Node(i, names[i], times[i], mems[i], kinds[i]) for i in range(n)]
    return Graph(nodes, edges)
