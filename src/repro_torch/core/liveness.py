"""Liveness analysis [Appel & Palsberg] + an event-level execution simulator
for the canonical strategy (§3, §4.4, Appendix C).

The paper scores strategies three ways:

* the analytic model, eq. (2)            → ``core.dp.peak_memory``
* measured execution *with liveness analysis*, where every buffer is freed at
  its last use                           → ``simulate(..., liveness=True)``
* measured execution *without* liveness (Appendix C ablation), where buffers
  are freed only at the canonical strategy's own segment-boundary rules
                                          → ``simulate(..., liveness=False)``

The liveness-analyzed execution also has an exact *analytic*
form: :func:`transition_excess` (bottom of this module) decomposes the
liveness=True simulation per DP transition, and ``core.dp`` prices 𝓜⁽ⁱ⁾
with it — so the DP's budgets are last-use-liveness execution peaks, not
eq. 2's looser footprint.

The simulator expands the canonical strategy into a linear event list:

  forward  : for each segment i, compute f(v) for v ∈ V_i in topo order;
             at segment end, discard f(V_i \\ ∂(L_i)) (canonical rule).
  backward : for each segment i = k…1:
               recompute f(v) for uncached v ∈ V_i from the live caches;
               for w ∈ V_i in reverse topo order, run VJP(w): reads
               {f(p) : p ∈ pred(w)} ∪ {f(w), g(w)}, writes {g(p)};
             at segment end discard f/g buffers of V_i, keeping gradient
             contributions flowing to earlier segments
             (the δ⁺(L_{i-1}) ∩ V_i backward-cache rule of §3).

Because a discarded value is *recomputed* later, the same logical buffer has
several **versions** (live intervals).  The canonical strategy's explicit
discards delimit versions; liveness analysis can only shorten a version (free
at its last use inside the interval), never extend it.

Buffer sizes: both f(v) and g(v) occupy M_v (a gradient has the shape of its
value).  Parameters and inputs are excluded, as in §2.
"""

from __future__ import annotations

import dataclasses
import os
import weakref
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
from numpy.typing import NDArray

from .graph import EMPTY, Graph, NodeSet, mask_iter

Buffer = Tuple[str, int]  # ("f"|"g", node)


@dataclasses.dataclass
class SimResult:
    peak_memory: float
    total_compute: float  # forward + recompute T (backward T excluded, §2)
    recompute_overhead: float  # T of recomputed nodes only
    num_events: int


@dataclasses.dataclass
class _Event:
    reads: List[Buffer]
    writes: List[Buffer]
    cost: float  # T_v for fwd/recompute events, 0 for VJP events (§2)
    frees_after: List[Buffer]  # explicit canonical-strategy discards


def _topo_within(g: Graph, nodes: NodeSet) -> List[int]:
    order = g.topological_order()
    return [v for v in order if v in nodes]


def build_events(
    g: Graph, sequence: Sequence[NodeSet], with_marks: bool = False
):
    """Expand a lower-set sequence into the canonical-strategy event list.

    With ``with_marks`` returns ``(events, fwd_end, bwd_start)`` where
    ``fwd_end[i]``/``bwd_start[i]`` are the event index of segment ``i``'s
    last forward event and first backward-window event — the two boundaries
    the storage-strategy repricing in :func:`simulate_events` splits cached
    buffers' live intervals at.
    """
    g.check_increasing_sequence(sequence)
    events: List[_Event] = []
    k = len(sequence)
    fwd_end: List[int] = [0] * k
    bwd_start: List[int] = [0] * k
    prev: NodeSet = EMPTY
    segs: List[NodeSet] = []
    bounds: List[NodeSet] = []
    pins = g.store_pins
    for L in sequence:
        segs.append(L - prev)
        # effective cached set: the paper's boundary plus any must_store pins
        # (effect analysis) — pinned values are kept from their forward
        # computation and never recomputed.
        bounds.append(g.boundary(L) | (pins & L))
        prev = L
    # U_i = ∪_{j≤i} ∂(L_j)  (plus pins, when present)
    Us: List[NodeSet] = []
    acc: Set[int] = set()
    for b in bounds:
        acc |= b
        Us.append(frozenset(acc))
    U_k = Us[-1]

    # ---------------- forward ----------------
    for i, Vi in enumerate(segs):
        for v in _topo_within(g, Vi):
            events.append(
                _Event(
                    reads=[("f", p) for p in g.pred[v]],
                    writes=[("f", v)],
                    cost=g.time_v[v],
                    frees_after=[],
                )
            )
        # canonical rule: cache U_k ∩ V_i (its boundary nodes), discard rest
        drop = Vi - U_k
        if drop and events:
            events[-1].frees_after.extend(("f", v) for v in drop)
        fwd_end[i] = len(events) - 1

    # ---------------- backward ----------------
    for i in range(k - 1, -1, -1):
        Vi = segs[i]
        bwd_start[i] = len(events)
        # recompute uncached forward values of V_i
        for v in _topo_within(g, Vi):
            if v in U_k:
                continue  # cached since the forward pass
            events.append(
                _Event(
                    reads=[("f", p) for p in g.pred[v]],
                    writes=[("f", v)],
                    cost=g.time_v[v],
                    frees_after=[],
                )
            )
        # VJP sweep in reverse topological order
        for w in reversed(_topo_within(g, Vi)):
            reads: List[Buffer] = [("f", p) for p in g.pred[w]]
            reads.append(("f", w))
            if g.succ[w]:
                reads.append(("g", w))
            events.append(
                _Event(
                    reads=reads,
                    writes=[("g", p) for p in g.pred[w]] or [("g", w)],
                    cost=0.0,
                    frees_after=[],
                )
            )
        # segment-end frees: drop f/g of V_i; gradient contributions to
        # earlier segments are ("g", p) with p ∉ V_i and thus survive.
        frees = [("f", v) for v in Vi] + [("g", v) for v in Vi]
        if events:
            events[-1].frees_after.extend(frees)
    if with_marks:
        return events, fwd_end, bwd_start
    return events


def build_vanilla_events(g: Graph) -> List[_Event]:
    """No-recomputation baseline: cache every forward value, then backprop."""
    events: List[_Event] = []
    order = g.topological_order()
    for v in order:
        events.append(
            _Event([("f", p) for p in g.pred[v]], [("f", v)], g.time_v[v], [])
        )
    for w in reversed(order):
        reads: List[Buffer] = [("f", p) for p in g.pred[w]] + [("f", w)]
        if g.succ[w]:
            reads.append(("g", w))
        events.append(
            _Event(reads, [("g", p) for p in g.pred[w]] or [("g", w)], 0.0, [])
        )
    if events:
        events[-1].frees_after = [("f", v) for v in order] + [
            ("g", v) for v in order
        ]
    return events


def simulate_events(
    g: Graph, events: List[_Event], liveness: bool,
    reprice: Optional[Dict[Buffer, Tuple[int, int, float]]] = None,
) -> SimResult:
    """Peak live bytes over an event list, with versioned buffer intervals.

    A buffer *version* opens at its first write (or lazy-read for gradient
    seeds) and closes at the strategy's explicit discard.  liveness=True
    shrinks each version to end at its last use instead.

    ``reprice`` prices the joint memory-strategy DP's reduced footprints:
    it maps a cached f-buffer to ``(retire_idx, bwd_start_idx, carried)``
    — full bytes from the forward write through the end of its segment's
    forward window (the value exists on device before it is offloaded /
    quantized), ``carried`` bytes while the cache holds it (0 for
    offloaded, int8+scale for quantized; reads by *later* backward windows
    are streamed and stay at the carried price), and full bytes again from
    its own backward window's first event (the VJP sweep needs the
    materialized value) to the version's end.  Only the version spanning
    the retire point — the forward-computed cached one — is repriced.
    """

    def size(buf: Buffer) -> float:
        return g.mem_v[buf[1]]

    # Pass 1: version intervals.
    open_ver: Dict[Buffer, int] = {}
    nver: Dict[Buffer, int] = defaultdict(int)
    start: Dict[Tuple[Buffer, int], int] = {}
    last_touch: Dict[Tuple[Buffer, int], int] = {}
    end: Dict[Tuple[Buffer, int], int] = {}

    def touch(b: Buffer, idx: int) -> None:
        if b not in open_ver:
            v = nver[b]
            nver[b] += 1
            open_ver[b] = v
            start[(b, v)] = idx
        last_touch[(b, open_ver[b])] = idx

    n_events = len(events)
    for idx, ev in enumerate(events):
        for b in ev.reads:
            touch(b, idx)
        for b in ev.writes:
            touch(b, idx)
        for b in ev.frees_after:
            if b in open_ver:
                end[(b, open_ver[b])] = idx
                del open_ver[b]
    for b, v in open_ver.items():
        end[(b, v)] = n_events - 1

    # Pass 2: sweep with a difference array.
    delta = [0.0] * (n_events + 1)
    for key, s_idx in start.items():
        e_idx = last_touch[key] if liveness else end[key]
        e_idx = min(e_idx, end.get(key, e_idx))
        full = size(key[0])
        if reprice is not None and key[0] in reprice:
            retire, bstart, carried = reprice[key[0]]
            if s_idx <= retire < e_idx:
                delta[s_idx] += full
                delta[retire + 1] += carried - full
                if retire < bstart <= e_idx:
                    delta[bstart] += full - carried
                    delta[e_idx + 1] -= full
                else:
                    delta[e_idx + 1] -= carried
                continue
        delta[s_idx] += full
        delta[e_idx + 1] -= full
    peak = 0.0
    cur = 0.0
    for idx in range(n_events):
        cur += delta[idx]
        peak = max(peak, cur)

    total_T = sum(ev.cost for ev in events)
    return SimResult(
        peak_memory=peak,
        total_compute=total_T,
        recompute_overhead=total_T - g.total_time,
        num_events=n_events,
    )


def simulate(
    g: Graph, sequence: Sequence[NodeSet], liveness: bool = True,
    assignment: Optional[Dict[int, str]] = None,
) -> SimResult:
    """Simulate the canonical strategy for a lower-set sequence.

    ``assignment`` (node → ``core.strategies`` code) prices cached
    residuals at their storage strategy's device bytes between their
    forward window and their own backward window — the event-level
    counterpart of ``dp.peak_memory_live(g, sequence, assignment)``, and
    the oracle ``analysis.verifier`` replays strategy-annotated plans
    against.
    """
    from .strategies import STORE, device_bytes

    live = {v: c for v, c in (assignment or {}).items() if c != STORE}
    if not live:
        return simulate_events(g, build_events(g, sequence), liveness)
    events, fwd_end, bwd_start = build_events(g, sequence, with_marks=True)
    w = device_bytes(g, live)
    seg_of: Dict[int, int] = {}
    prev: NodeSet = EMPTY
    for i, L in enumerate(sequence):
        for v in L - prev:
            seg_of[v] = i
        prev = L
    reprice: Dict[Buffer, Tuple[int, int, float]] = {
        ("f", v): (fwd_end[seg_of[v]], bwd_start[seg_of[v]], w[v])
        for v in live
        if v in seg_of
    }
    return simulate_events(g, events, liveness, reprice=reprice)


# ---------------------------------------------------------------------------
# Analytic per-transition form of the liveness=True simulation.
#
# The event simulation above decomposes exactly along the strategy's
# transitions: while segment i's window runs (its forward pass, or its
# backward recompute + VJP sweep), the buffers alive from *outside* the
# window are precisely f(U_{i-1}) — every cached value of an earlier segment
# is still awaiting its own VJP — plus window-entry gradients determined by
# (L_{i-1}, L_i) alone.  So with last-use liveness,
#
#     simulated peak  =  max_i ( M(U_{i-1}) + excess(L_{i-1}, L_i) )
#
# where ``excess`` is a pure function of the transition pair — exactly the
# shape Algorithm 1's transition relation needs (eq. 2's
# ``𝓜⁽ⁱ⁾ = m + m_fixed`` with a tighter ``m_fixed``).  ``transition_excess``
# computes it in closed form, without building event lists:
#
# Within the backward window of V' = L' \ L (topo order u_1 … u_s, VJP
# events processed u_s … u_1), nothing dies during the recompute phase, and
# the first VJP event dominates it, so only the VJP events matter.  Each
# buffer contributes one interval on the t-axis (t = the index of VJP(u_t)):
#
#   f(u_i)            [i, s]   recomputed/cached value, read last by VJP(uᵢ)
#   g(u_i)            [i, s]   if u_i ∈ ∂(L')   (gradient arrived at entry)
#                     [i, max succ idx in V']   otherwise (first written by
#                                               the VJP of its latest succ)
#                     [i, i]   pred-less node with no succ in V' (self-seed)
#   g(p), p ∈ L       [1, s]   if p ∈ ∂(L')∩L  (arrived at entry, survives)
#                     [1, max succ idx in V']   if p ∈ δ⁻(V') ∩ L otherwise
#                                               (written here, flows onward)
#
# The forward window of the same transition holds only a subset of f(V')
# over the same baseline M(U_{i-1}) and is dominated by the backward
# window's first VJP event (which holds all of f(V') plus gradients), so the
# backward window alone decides the transition's peak.
# ---------------------------------------------------------------------------


# Per-graph transition memo, weakly keyed: entries die with their graph, so
# long-lived processes (planner services, sweeps over many models) don't
# accumulate excess tables for graphs nothing else references.
_EXCESS_MEMO: "weakref.WeakKeyDictionary[Graph, Dict[Tuple[int, int], float]]" = (
    weakref.WeakKeyDictionary()
)


def _topo_rank(g: Graph) -> List[int]:
    rank = getattr(g, "_topo_rank", None)
    if rank is None:
        rank = [0] * g.n
        for r, v in enumerate(g.topological_order()):
            rank[v] = r
        g._topo_rank = rank
    return rank


def scalar_only() -> bool:
    """True when ``REPRO_DP_SCALAR=1`` pins the DP hot paths to the scalar
    oracles (the per-pair difference-array walk here, the per-candidate
    frontier inserts in ``core.dp``).  The vectorized paths are bit-identical
    — same float expressions, just batched — so this is an escape hatch and
    a CI leg, not a semantic switch."""
    return os.environ.get("REPRO_DP_SCALAR", "") not in ("", "0")


def _excess_scalar(g: Graph, mask_L: int, mask_Lp: int, bd_mask: int) -> float:
    """The per-pair difference-array walk (the vectorized path's oracle).

    Accumulation order per delta slot is canonical — selected nodes in rank
    order emitting (f, g, g-end) triples, then ``maxq`` gradients by
    ascending node id, then entry gradients of ∂(L')∩L by ascending node id
    — and :func:`_excess_row` replays exactly this order with
    ``np.add.at`` (unbuffered, applied in index order) + ``np.cumsum``
    (a sequential left fold), which is what makes the two paths
    bit-identical even for masses where float addition does not commute.
    """
    rank = _topo_rank(g)
    vp_mask = mask_Lp & ~mask_L
    nodes = sorted(mask_iter(vp_mask), key=rank.__getitem__)  # u_1 … u_s
    s = len(nodes)
    idx: Dict[int, int] = {u: i for i, u in enumerate(nodes, 1)}
    mem = g.mem_v
    pred = g.pred
    succ = g.succ

    # interval [lo, hi] → delta[lo] += M, delta[hi+1] -= M
    delta = [0.0] * (s + 2)
    maxq_L: Dict[int, int] = {}  # p ∈ δ⁻(V') ∩ L \ ∂(L') → max succ idx
    for i, u in enumerate(nodes, 1):
        mu = mem[u]
        # f(u): alive from before the VJP sweep until VJP(u) = e_i
        delta[i] += mu
        delta[s + 1] -= mu
        # g(u)
        if (bd_mask >> u) & 1:
            hi = s  # gradient arrived from later segments at window entry
        else:
            hi = 0
            for w in succ[u]:
                j = idx.get(w)  # non-boundary ⇒ every successor is in V'
                if j is not None and j > hi:
                    hi = j
            if hi == 0 and not pred[u]:
                hi = i  # VJP of a pred-less node writes g(u) itself
        if hi:
            delta[i] += mu
            delta[hi + 1] -= mu
        # gradients this window writes for earlier segments
        for p in pred[u]:
            if (mask_L >> p) & 1 and not ((bd_mask >> p) & 1):
                maxq_L[p] = i  # i ascends, so the last write wins
    for p in sorted(maxq_L):  # ascending node id — the canonical slot order
        delta[1] += mem[p]
        delta[maxq_L[p] + 1] -= mem[p]
    for p in mask_iter(bd_mask & mask_L):
        # entry gradients of earlier-segment boundary nodes: live all window
        delta[1] += mem[p]
        delta[s + 1] -= mem[p]

    peak = 0.0
    cur = 0.0
    for t in range(1, s + 1):
        cur += delta[t]
        if cur > peak:
            peak = cur
    return peak


def transition_excess(g: Graph, mask_L: int, mask_Lp: int, bd_mask: int) -> float:
    """Liveness-tight ``m_fixed`` of one DP transition ``L → L'`` (bitmasks).

    The peak live bytes of the transition's execution window *beyond* the
    carried cache mass ``M(U_{i-1})``, with every buffer freed at its last
    use (``simulate(..., liveness=True)`` factored per transition — see the
    derivation above).  ``bd_mask`` must be the bitmask of ``∂(L')``.

    Always ≤ eq. 2's ``2·M(V') + M(δ⁺(L')\\L') + M(δ⁻(δ⁺(L'))\\L')`` on
    chain-like transitions and usually far below it on multi-node segments;
    on graphs whose gradients flow across many segments it can exceed
    eq. 2's (under-counted) charge — eq. 2 ignores gradient buffers held
    for earlier segments, this functional does not.

    Results are memoized per graph (graphs are immutable) in a weakly-keyed
    table, so the DP entry points (``solve`` / ``feasible`` / ``sweep`` /
    ``min_feasible_budget_exact``) all see the *same float* for a pair —
    the foundation of their bit-identity contract — while the memo itself
    never outlives its graph.
    """
    memo = _EXCESS_MEMO.get(g)
    if memo is None:
        memo = _EXCESS_MEMO[g] = {}
    key = (mask_L, mask_Lp)
    hit = memo.get(key)
    if hit is not None:
        return hit
    peak = _excess_scalar(g, mask_L, mask_Lp, bd_mask)
    memo[key] = peak
    return peak


# ---------------------------------------------------------------------------
# Vectorized batch form: one source L priced against many targets L' at once.
#
# The DP's outer loop fixes a source L and walks every superset L' — the
# scalar walk above re-derives the same topo-sorted complement of L, the
# same successor structure, and the same per-node masses for every pair.
# The batch form shares all of that across the targets: the complement's
# topo order, its successor/predecessor CSR and the node masses are built
# once per L, and each target contributes only a boolean membership row.
# Ranks become one cumsum over the (targets × complement) selection matrix,
# g-interval ends one masked segment-max, and the difference arrays one
# ordered np.add.at + np.cumsum — the same float expressions as the scalar
# walk, applied in the same per-slot order, so the peaks are bit-identical.
# ---------------------------------------------------------------------------


def _masks_bools(masks: Sequence[int], n: int) -> NDArray[np.bool_]:
    """(len(masks), n) boolean membership matrix from big-int bitmasks."""
    nb = max(1, (n + 7) // 8)
    buf = b"".join(m.to_bytes(nb, "little") for m in masks)
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(len(masks), nb)
    out: NDArray[np.bool_] = np.unpackbits(
        raw, axis=1, bitorder="little"
    )[:, :n].astype(bool)
    return out


@dataclasses.dataclass(frozen=True)
class _VecGraph:
    """Static per-graph arrays in topo-position coordinates, built once.

    ``topo[k]`` is the node id at position ``k``; ``mem`` is indexed by
    position.  ``slots`` is a ragged successor-slot structure: level ``d``
    holds ``(pos_d, succ_d)`` — the positions with at least ``d+1``
    successors, paired with their ``d``-th successor's position — so a
    max-over-successors fold costs O(Σ out-degree), not O(max-degree · n)
    (DenseNet-style graphs have max-degree ≫ mean).  Pred-less nodes carry
    their *own* position as an extra slot — their VJP self-seeds g(u), so
    the fold naturally yields the scalar walk's ``hi = i`` fallback.
    """

    topo: NDArray[np.int64]
    mem: NDArray[np.float64]
    slots: Tuple[Tuple[NDArray[np.int64], NDArray[np.int64]], ...]


def _vec_arrays(g: Graph) -> _VecGraph:
    cached = getattr(g, "_excess_vec_arrays", None)
    if cached is None:
        n = g.n
        topo = np.asarray(g.topological_order(), dtype=np.int64)
        pos = np.empty(n, dtype=np.int64)
        pos[topo] = np.arange(n)
        pos_l = pos.tolist()
        per_node: List[List[int]] = [[] for _ in range(n)]
        for u in range(n):
            p = pos_l[u]
            for w in g.succ[u]:
                per_node[p].append(pos_l[w])
            if not g.pred[u]:
                per_node[p].append(p)
        deg = max((len(r) for r in per_node), default=0)
        slots = []
        for d in range(deg):
            ps = [p for p in range(n) if len(per_node[p]) > d]
            slots.append(
                (
                    np.asarray(ps, dtype=np.int64),
                    np.asarray(
                        [per_node[p][d] for p in ps], dtype=np.int64
                    ),
                )
            )
        cached = _VecGraph(
            topo=topo,
            mem=np.asarray(g.mem_v, dtype=np.float64)[topo],
            slots=tuple(slots),
        )
        g._excess_vec_arrays = cached
    return cached  # type: ignore[no-any-return]


def transition_excess_many(
    g: Graph, mask_L: int, pairs: Sequence[Tuple[int, int]]
) -> List[float]:
    """``transition_excess`` for one source against many ``(L', ∂(L'))``.

    Returns the per-pair excesses in order, reading/writing the same
    per-graph memo as the scalar entry point — the DP entry points price a
    whole source row with one call and every later per-pair query (e.g.
    ``peak_memory_live``) is a memo hit on the very same float.  Under
    ``REPRO_DP_SCALAR=1`` the missing pairs run the scalar walk instead.
    """
    memo = _EXCESS_MEMO.get(g)
    if memo is None:
        memo = _EXCESS_MEMO[g] = {}
    out = [memo.get((mask_L, mask_Lp)) for mask_Lp, _bd in pairs]
    missing = [p for p, hit in zip(pairs, out) if hit is None]
    if missing:
        if scalar_only():
            for mask_Lp, bd in missing:
                memo[(mask_L, mask_Lp)] = _excess_scalar(
                    g, mask_L, mask_Lp, bd
                )
        else:
            peaks = _excess_row(g, mask_L, missing)
            for (mask_Lp, _bd), pk in zip(missing, peaks.tolist()):
                memo[(mask_L, mask_Lp)] = pk
        it = iter(missing)
        for idx, hit in enumerate(out):
            if hit is None:
                out[idx] = memo[(mask_L, next(it)[0])]
    return out  # type: ignore[return-value]


def transition_excess_row(
    g: Graph,
    mask_L: int,
    pairs: Optional[Sequence[Tuple[int, int]]] = None,
    *,
    tmul: Optional[NDArray[np.bool_]] = None,
    bdful: Optional[NDArray[np.bool_]] = None,
) -> NDArray[np.float64]:
    """Memo-free row pricing for the vectorized DP.

    The DP caches whole ``m_fixed`` rows in its own per-(graph, family)
    table, so populating the per-pair memo here would be pure overhead
    (130k big-int tuple keys on a ResNet-152 family); the DP instead
    seeds the memo for just the pairs its answer uses via
    :func:`record_excess`, which keeps the one-float-per-pair contract
    for ``peak_memory_live`` without paying for the other 99%.  Callers
    that hold the family membership (``tmul``) and boundary (``bdful``)
    boolean matrices pass them to skip the per-row big-int unpack.
    Under ``REPRO_DP_SCALAR=1`` this delegates to the memoized scalar
    walks (``pairs`` required there).
    """
    if scalar_only():
        if pairs is None:
            raise ValueError("pairs required under REPRO_DP_SCALAR=1")
        return np.asarray(
            transition_excess_many(g, mask_L, pairs), dtype=np.float64
        )
    return _excess_row(g, mask_L, pairs, tmul, bdful)


def record_excess(g: Graph, mask_L: int, mask_Lp: int, value: float) -> None:
    """Seed the per-pair memo with a row-priced float (first write wins).

    Called by the vectorized DP for the transitions its chosen sequence
    actually takes, so later scalar queries (``peak_memory_live`` pricing
    the returned plan) read the *same float* the feasibility filter used.
    """
    memo = _EXCESS_MEMO.get(g)
    if memo is None:
        memo = _EXCESS_MEMO[g] = {}
    memo.setdefault((mask_L, mask_Lp), value)


def _excess_row(
    g: Graph,
    mask_L: int,
    pairs: Optional[Sequence[Tuple[int, int]]] = None,
    tmul: Optional[NDArray[np.bool_]] = None,
    bdful: Optional[NDArray[np.bool_]] = None,
) -> NDArray[np.float64]:
    n = g.n
    vg = _vec_arrays(g)
    if tmul is None or bdful is None:
        assert pairs is not None
        tmul = _masks_bools([mask_Lp for mask_Lp, _bd in pairs], n)
        bdful = _masks_bools([bd for _mask_Lp, bd in pairs], n)
    J = len(tmul)
    in_l = _masks_bools([mask_L], n)[0][vg.topo]  # L, position space
    cpos = np.nonzero(~in_l)[0]  # complement positions, topo order
    K = len(cpos)
    if K == 0 or J == 0:
        return np.zeros(J, dtype=np.float64)
    cids = vg.topo[cpos]  # complement node ids, topo order

    # Everything below lives in complement coordinates (k = 0 … K−1, topo
    # order), K-major: row k of a (K, J) matrix is the k-th node outside
    # L across every target.  K-major keeps the hot scatters (the slot
    # folds below) on contiguous rows, and makes ``np.nonzero``'s
    # row-major order mean "k ascending within each target" — the
    # canonical accumulation order the bincount pass needs.  ``cinvx``
    # maps full positions → complement rows, with the sentinel row K
    # (identically zero in ``selrank_pad``) absorbing positions inside L
    # and the static slot matrix's own sentinel ``n``.
    # (L'_j \ L) membership (complement ∩ L'_j), K-major
    sel = np.ascontiguousarray(tmul[:, cids].T)
    bd_c = np.ascontiguousarray(bdful[:, cids].T)
    rank = np.cumsum(sel, axis=0, dtype=np.int32)  # 1-based rank if selected
    s = rank[-1].copy()  # window lengths, per target
    selrank_pad = np.zeros((K + 1, J), dtype=np.int32)
    np.multiply(rank, sel, out=selrank_pad[:K])

    cinvx = np.full(n + 1, K, dtype=np.int64)
    cinvx[cpos] = np.arange(K)

    # max selected-successor rank per (node, target), folded over the
    # ragged slot structure: successors inside L / outside L' gather rank
    # 0 and drop out of the max; a pred-less node's self-slot yields its
    # own rank — exactly the scalar walk's ``hi`` fallback chain.  Slot
    # owners are distinct within a level, so the row gather/scatter is a
    # plain fancy-indexed maximum (no ``.at`` needed).
    succ_max = np.zeros((K, J), dtype=np.int32)
    for pos_d, sp_d in vg.slots:
        col_d = cinvx[pos_d]
        keep = col_d < K  # slot owner outside L
        col_k = col_d[keep]
        succ_max[col_k] = np.maximum(
            succ_max[col_k], selrank_pad[cinvx[sp_d[keep]]]
        )

    # g-interval end: boundary → s; else the successor fold.  Only
    # selected entries are ever read below, so no window mask is applied.
    gend = succ_max
    np.copyto(gend, np.broadcast_to(s[None, :], (K, J)), where=bd_c)

    S = int(s.max())
    W = S + 2  # delta row width; column 0 is a write-only dump slot
    if J * W < 2**31:
        idt = np.int32
    else:  # pragma: no cover - gigantic batches only
        idt = np.int64

    # Group 1 — per selected node, in rank order (= topo order restricted
    # to the complement): f-add @ rank, g-add @ rank, g-sub @ gend+1.  The
    # f-sub @ s+1 lands past every read slot and is dropped; a node with
    # no g-interval routes its g entries to the unread dump slot 0.
    # Compressed to the selected entries only: ``np.nonzero`` on the
    # K-major matrix emits (k, j) pairs k-ascending within each j, so the
    # per-(j, t) accumulation order below is exactly the scalar walk's.
    kk, jj = np.nonzero(sel)
    r_s = rank[kk, jj]
    ge = gend[kk, jj]
    hg = ge > 0
    cols3 = np.empty((len(kk), 3), dtype=idt)
    cols3[:, 0] = r_s
    np.multiply(r_s, hg, out=cols3[:, 1], casting="unsafe")
    np.add(ge, hg, out=cols3[:, 2], casting="unsafe")
    cols3 += (jj * W).astype(idt)[:, None]
    mem_c = vg.mem[cpos]
    m_s = mem_c[kk]
    w3 = np.empty((len(kk), 3), dtype=np.float64)
    w3[:, 0] = m_s
    w3[:, 1] = m_s
    np.negative(m_s, out=w3[:, 2])
    flat = cols3.ravel()
    w = w3.ravel()

    # Candidate earlier-segment gradient holders: p ∈ L with a successor
    # outside L — exactly ∂(L) ⊇ δ⁻(V')∩L and ⊇ ∂(L')∩L for every L' ⊇ L.
    # Ascending node id is the canonical slot order for both groups below.
    has_out = np.zeros(n, dtype=bool)
    for pos_d, sp_d in vg.slots:
        has_out[pos_d] |= cinvx[sp_d] < K
    cand = np.nonzero(in_l & has_out)[0]
    cand = cand[np.argsort(vg.topo[cand])]
    if len(cand):
        P = len(cand)
        mem_p = vg.mem[cand]
        bd_p = np.ascontiguousarray(bdful[:, vg.topo[cand]].T)  # P-major
        candinv = np.full(n, P, dtype=np.int64)
        candinv[cand] = np.arange(P)
        # qmax per candidate: max selected-successor rank via the same
        # slot fold (successors inside L gather the sentinel rank 0; a
        # pred-less candidate's self-slot is inside L, equally inert)
        qmax = np.zeros((P, J), dtype=np.int32)
        for pos_d, sp_d in vg.slots:
            ci = candinv[pos_d]
            keep = ci < P
            ci_k = ci[keep]
            qmax[ci_k] = np.maximum(
                qmax[ci_k], selrank_pad[cinvx[sp_d[keep]]]
            )
        # Group 2 — maxq gradients, alive [1, qmax]: p qualifies when it
        # is outside ∂(L') and has at least one selected successor (add @
        # 1, sub @ qmax+1 ≥ 2 — never colliding with the adds).  Group 3 —
        # entry gradients of ∂(L')∩L, alive the whole window (add @ 1; the
        # matching sub @ s+1 is past every read slot).  Both compressed to
        # the qualifying entries; p-major nonzero keeps each group's
        # per-(j, t) order p-ascending, and concatenation order (group 1,
        # then 2, then 3) matches the scalar walk's per-slot fold order.
        ok_q = (qmax > 0) & ~bd_p
        pq, jq = np.nonzero(ok_q)
        colq = np.empty((len(pq), 2), dtype=idt)
        base_q = (jq * W).astype(idt)
        np.add(base_q, 1, out=colq[:, 0])
        colq[:, 1] = qmax[pq, jq]
        colq[:, 1] += base_q
        colq[:, 1] += 1
        wq = np.empty((len(pq), 2), dtype=np.float64)
        wq[:, 0] = mem_p[pq]
        np.negative(wq[:, 0], out=wq[:, 1])
        pb, jb = np.nonzero(bd_p)
        colb = (jb * W).astype(idt)
        colb += 1
        flat = np.concatenate([flat, colq.ravel(), colb])
        w = np.concatenate([w, wq.ravel(), mem_p[pb]])

    # One sequential accumulation pass: bincount adds weights in input
    # order per bin — the same left-fold per delta slot as the scalar walk.
    delta = np.bincount(flat, weights=w, minlength=J * W).reshape(J, W)

    # Kill slots past each window with a −inf sentinel at s+1: the cumsum
    # then propagates −inf through every unread slot, so a plain row max
    # over t = 1 … S+1 reads only t ≤ s — no mask materialization.
    delta[np.arange(J), s.astype(np.int64) + 1] = -np.inf
    csum = np.cumsum(delta[:, 1:], axis=1)
    peaks: NDArray[np.float64] = np.maximum(np.max(csum, axis=1), 0.0)
    return peaks


def vanilla_peak(g: Graph, liveness: bool = True) -> float:
    """Peak of the no-recomputation baseline (cache everything)."""
    return simulate_events(g, build_vanilla_events(g), liveness).peak_memory
