"""Dynamic-programming solutions to the General Recomputation Problem.

Implements Algorithm 1 of the paper (Appendix A) with the practical
accelerations the paper describes in §4.2:

* sparse DP table — ``opt[L, ·]`` holds only the *Pareto frontier* of
  ``(t, m)`` pairs ("when t < t' and opt[L,t] < opt[L,t'], we can skip the
  iteration for the entry opt[L,t']");
* node sets as arbitrary-precision integer bitmasks, so ``L ⊆ L'`` is one
  big-int AND;
* per-``L'`` segment terms (∂(L'), δ⁺(L')\\L', δ⁻(δ⁺(L'))\\L') precomputed
  once.

Entry points:

* ``solve(graph, budget, family, objective="time_centric")`` — Algorithm 1;
  ``objective="memory_centric"`` replaces ``min`` with ``max`` at line 15
  (§4.4 / Appendix A note).
* ``exact_dp(graph, budget, ...)``  — family = 𝓛_G        (§4.2)
* ``approx_dp(graph, budget, ...)`` — family = 𝓛_G^Pruned (§4.3)
* ``sweep(graph, family, objective)`` — the **budget-free sweep solver**:
  one DP pass with the running peak of the memory functional's 𝓜⁽ⁱ⁾
  carried as a third frontier coordinate ``(t, m, peak)`` instead of the
  per-budget filter ``𝓜⁽ⁱ⁾ > B``.  The resulting :class:`Sweep` answers *every* budget:
  ``Sweep.extract(B)`` reproduces ``solve(graph, B, family, objective)``
  bit-identically (same lower-set sequence, same overhead), and the minimal
  peak at the terminal state is the *exact* minimal feasible budget — no
  binary search (§5.1) required.  ``Sweep.frontier()`` is the full
  (budget → overhead) Pareto staircase, e.g. a whole trade-off grid from
  one pass.  Sweeps serialize (``Sweep.encode``/``decode_sweep``) in
  canonical coordinates so ``core.plan_cache`` can admit every future
  budget query on a graph from one cold solve.

Bit-identity of ``Sweep.extract`` with the per-budget DP rests on the
per-cell tie-break both use: among equally cheap transitions into a table
cell ``(L', t')`` the winner is the one whose source lower set comes first
in the size-ascending family order (the per-budget DP realises this as
first-writer-wins; the sweep stores the source position explicitly and
minimizes ``(m, pos)``).

The DP requires integer ``T_v`` (the ``t`` axis of the table).  The paper
uses ``T_v ∈ {1, 10}``; for FLOP-derived costs use
``quantize_times(graph, levels)`` first.

**Memory functional.**  The paper's eq. 2 charges every transition its full
segment footprint ``m + 2·M(V') + M(δ⁺(L')\\L') + M(δ⁻(δ⁺(L'))\\L')``; the
interpreter's measured live-byte traces consistently undershoot it because
buffers die at their last use *inside* a segment.  The DP here therefore
prices transitions with the **liveness-tight** functional
``𝓜⁽ⁱ⁾ = m + liveness.transition_excess(L, L')`` — the exact per-transition
decomposition of ``liveness.simulate(..., liveness=True)`` — so
``peak_memory`` of a result is exactly the last-use-liveness execution
peak of its schedule, and budgets are honest in both directions: on
segment-structured graphs (chains, the benchmark CNNs) the tighter charge
admits more strategies per budget, while on gradient-dense graphs it can
sit *above* eq. 2, which under-counts gradient buffers held for earlier
segments (see ``transition_excess``).  Eq. 2 stays
available for the Appendix C ablation: the strategy evaluator
:func:`peak_memory` and the ``functional="eq2"`` knob on :func:`solve` /
:func:`feasible` / :func:`min_feasible_budget_exact` (benchmarks only — the
sweep and the plan cache speak the liveness functional, versioned by
:data:`MEMORY_FUNCTIONAL`).
"""

from __future__ import annotations

import dataclasses
import weakref
from bisect import bisect_left, bisect_right
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
from numpy.typing import NDArray

from .graph import EMPTY, Graph, NodeSet, from_mask, mask_iter, to_mask
from .liveness import (
    _masks_bools,
    record_excess,
    scalar_only,
    transition_excess,
    transition_excess_many,
    transition_excess_row,
)
from .lower_sets import all_lower_sets, pruned_lower_sets
from .strategies import (
    StrategyConfig,
    assignment_of,
    device_bytes,
    transition_options,
)

if TYPE_CHECKING:  # pragma: no cover - typing only (avoids an import cycle)
    from .cost_model import OpProfile

# Version tag of the DP's memory functional, content-addressed into every
# plan-cache key (core.plan_cache) so plans solved under an older functional
# (e.g. the pre-liveness eq. 2) invalidate by construction.
MEMORY_FUNCTIONAL = "live-v1"

_FUNCTIONALS = ("liveness", "eq2")


def _check_functional(functional: str, g: Optional[Graph] = None) -> None:
    if functional not in _FUNCTIONALS:
        raise ValueError(f"unknown memory functional {functional!r}")
    if functional == "eq2" and g is not None and g.store_pins_mask:
        raise ValueError(
            "functional='eq2' cannot price must_store pins (the paper's "
            "eq. 2 predates effect analysis); use the liveness functional"
        )


# Bitmask helpers live in core.graph (shared with core.liveness);
# re-exported here for the existing callers.


# ---------------------------------------------------------------------------
# Result container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DPResult:
    """Solution of the general recomputation problem.

    Attributes:
      sequence: the increasing lower-set sequence {L₁ ≺ … ≺ L_k = V}.
      overhead: T(V \\ U_k) — total recomputation overhead (eq. 1).
      peak_memory: max_i 𝓜⁽ⁱ⁾ under the planner's liveness-tight
        functional (:func:`peak_memory_live` — equals the last-use-liveness
        execution peak of the schedule; ``functional="eq2"`` solves report
        the paper's eq. 2 instead, see :func:`peak_memory`).
      feasible: False if no sequence satisfies the budget ("Impossible").
      states_visited: DP work counter (for the §5.1 runtime comparison).
      assignment: per-cached-node storage strategy (node id → "store" /
        "offload" / "quantize") when the solve ran over an extended
        strategy lattice (``strategies=``); None for the paper's binary.
    """

    sequence: List[NodeSet]
    overhead: float
    peak_memory: float
    feasible: bool
    states_visited: int = 0
    assignment: Optional[Dict[int, str]] = None

    @property
    def num_segments(self) -> int:
        return len(self.sequence)


INF = float("inf")


# ---------------------------------------------------------------------------
# Segment-term precomputation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _LowerSetInfo:
    mask: int
    size: int
    T: float  # T(L)
    M: float  # M(L)
    boundary_mask: int  # ∂(L)
    cache_mask: int  # ∂(L) ∪ (pins ∩ L) — the effective cached set
    T_boundary: float  # T(∂(L))
    m_after: float  # M(δ⁺(L) \ L) + M(δ⁻(δ⁺(L)) \ L)   (terms iii+iv of eq. 2)


def _prepare(g: Graph, family: Sequence[NodeSet]) -> List[_LowerSetInfo]:
    infos = []
    pins = g.store_pins_mask
    for L in family:
        mask = to_mask(L)
        dplus = g.delta_plus(L)
        dplus_out = to_mask(dplus) & ~mask  # δ⁺(L) \ L
        dmd_out = to_mask(g.delta_minus(dplus)) & ~mask  # δ⁻(δ⁺(L)) \ L
        boundary = g.boundary(L)
        boundary_mask = to_mask(boundary)
        infos.append(
            _LowerSetInfo(
                mask=mask,
                size=len(L),
                T=g.T(L),
                M=g.M(L),
                boundary_mask=boundary_mask,
                cache_mask=boundary_mask | (pins & mask),
                T_boundary=g.T(boundary),
                m_after=sum(g.mem_v[v] for v in mask_iter(dplus_out))
                + sum(g.mem_v[v] for v in mask_iter(dmd_out)),
            )
        )
    return infos


def _mask_M(g: Graph, mask: int) -> float:
    return sum(g.mem_v[v] for v in mask_iter(mask))


def _mask_M_w(weights: Sequence[float], mask: int) -> float:
    """Ascending-id left fold of arbitrary per-node byte weights.

    The strategy lattice's analogue of :func:`_mask_M` — same fold shape,
    so an all-store weight vector reproduces ``_mask_M`` bit-for-bit.
    """
    return sum(weights[v] for v in mask_iter(mask))


def _mask_T(g: Graph, mask: int) -> float:
    return sum(g.time_v[v] for v in mask_iter(mask))


# ---------------------------------------------------------------------------
# Vectorized hot path (shared by solve / feasible / mfb / sweep)
# ---------------------------------------------------------------------------
#
# The DP's per-(L, L') work — the subset test, the cache-mass and overhead
# steps (_mask_M/_mask_T), the liveness excess, and the frontier merges —
# is batched with numpy one *source row* at a time: for each L in size
# order, all its targets L' ⊇ L are handled in one shot.  The scalar loops
# above stay byte-for-byte as oracles behind REPRO_DP_SCALAR=1.
#
# Bit-identity rests on three facts, each load-bearing:
#   * the segment sums fold node masses in ascending node id exactly like
#     ``sum(mem_v[v] for v in mask_iter(mask))`` — ``np.bincount`` with
#     weights accumulates sequentially in input order, and ``np.nonzero``
#     on a (J, n) mask emits row-major (= per-row ascending id) pairs, so
#     one bincount per source row is the scalar left fold, batched;
#   * every per-candidate expression (``m + m_step``, ``m + m_fixed``,
#     ``max(peak, Mi)``, the ``Mi > budget`` filter) is evaluated as the
#     same single IEEE operation, just elementwise;
#   * the scalar frontier inserts maintain exactly the Pareto-minimal set
#     of everything ever inserted — an order-independent *set* — so
#     gathering a cell's incoming candidates and canonically filtering
#     them once (sort + strict prefix-min scan) when the cell's lower set
#     becomes a source reproduces the scalar frontier arrays exactly.


@dataclasses.dataclass
class _VecPrep:
    """Per-(graph, family) batched transition terms, source-row major.

    ``targets[pos]`` are the family ids reachable from ``order[pos]``
    (strictly larger sets L' ⊇ L, in size order — the same jpos order the
    scalar loops walk).  ``m_step``/``t_step`` are the per-pair cache-mass
    and overhead steps; ``m_fixed`` rows are priced lazily (first DP that
    walks the row batches the liveness kernel) and shared by every entry
    point via this cache, so a solve after a min-budget pass re-prices
    nothing.
    """

    infos: List[_LowerSetInfo]
    order: List[int]
    sizes: List[int]
    empty_id: int
    full_id: int
    targets: List[NDArray[np.int64]]
    m_step: List[NDArray[np.float64]]
    t_step: List[NDArray[np.float64]]
    m_fixed: List[Optional[NDArray[np.float64]]]
    fam_b: NDArray[np.bool_]  # (F, n) family membership rows, by node id
    bound_b: NDArray[np.bool_]  # (F, n) boundary ∂(L) rows, by node id


_VEC_PREP: "weakref.WeakKeyDictionary[Graph, Dict[Tuple[int, ...], _VecPrep]]" = (
    weakref.WeakKeyDictionary()
)


def _vec_prep(
    g: Graph,
    family: Sequence[NodeSet],
    mem_w: Optional[Sequence[float]] = None,
    tag: str = "",
) -> _VecPrep:
    """``mem_w``/``tag`` override the cache-mass weights (strategy lattice:
    the ``mem_eff`` minimal-device-bytes vector for feasibility/mfb); the
    tag keys the cache so differently weighted preps never alias."""
    key: Tuple[Any, ...] = (tag,) + tuple(to_mask(L) for L in family)
    per_g = _VEC_PREP.setdefault(g, {})
    cached = per_g.get(key)
    if cached is not None:
        return cached
    infos = _prepare(g, family)
    order = sorted(range(len(infos)), key=lambda i: infos[i].size)
    sizes = [infos[i].size for i in order]
    full_mask = (1 << g.n) - 1
    empty_id = full_id = -1
    for i, info in enumerate(infos):
        if info.mask == 0:
            empty_id = i
        if info.mask == full_mask:
            full_id = i
    # ∅/V may legitimately be absent for feasible(); solve/sweep/mfb raise
    # via _require_terminals, matching their scalar paths.

    n = g.n
    fam_b = _masks_bools([info.mask for info in infos], n)
    bound_b = _masks_bools([info.boundary_mask for info in infos], n)
    cache_b = _masks_bools([info.cache_mask for info in infos], n)
    # byte-packed family rows: the superset filter compares n/8 bytes
    # instead of n bools per candidate
    fam_p = np.packbits(fam_b, axis=1, bitorder="little")
    mem = np.asarray(g.mem_v if mem_w is None else mem_w, dtype=np.float64)
    tim = np.asarray(g.time_v, dtype=np.float64)
    t_of = np.array([info.T for info in infos], dtype=np.float64)
    order_arr = np.asarray(order, dtype=np.int64)

    targets: List[NDArray[np.int64]] = []
    m_steps: List[NDArray[np.float64]] = []
    t_steps: List[NDArray[np.float64]] = []
    empty_f = np.zeros(0, dtype=np.float64)
    empty_i = np.zeros(0, dtype=np.int64)
    for pos, i in enumerate(order):
        start = bisect_right(sizes, infos[i].size)
        cand = order_arr[start:]
        lb = fam_b[i]
        if len(cand) == 0:
            targets.append(empty_i)
            m_steps.append(empty_f)
            t_steps.append(empty_f)
            continue
        tg = cand[~((~fam_p[cand] & fam_p[i]).any(axis=1))]
        j_cnt = len(tg)
        if j_cnt == 0:
            targets.append(empty_i)
            m_steps.append(empty_f)
            t_steps.append(empty_f)
            continue
        # m_step = Σ mem over cache(L') \ L, left-folded in ascending id:
        # np.nonzero is row-major, bincount accumulates in input order.
        sel_m = cache_b[tg] & ~lb
        rr, cc = np.nonzero(sel_m)
        m_step = np.bincount(rr, weights=mem[cc], minlength=j_cnt)
        # t_step = (T(L') − T(L)) − Σ time over (L' \ L) ∩ cache(L').
        # (L'\L) ∩ cache(L') ⊆ cache(L') \ L, so compress the sel_m pairs
        # by L'-membership instead of scanning a second (J, n) matrix —
        # the surviving (rr, cc) keep their ascending-cc-per-row order.
        ft = fam_b[tg[rr], cc]
        t_sum = np.bincount(
            rr[ft], weights=tim[cc[ft]], minlength=j_cnt
        )
        t_step = (t_of[tg] - infos[i].T) - t_sum
        targets.append(tg)
        m_steps.append(m_step)
        t_steps.append(t_step)

    vp = _VecPrep(
        infos=infos,
        order=order,
        sizes=sizes,
        empty_id=empty_id,
        full_id=full_id,
        targets=targets,
        m_step=m_steps,
        t_step=t_steps,
        m_fixed=[None] * len(order),
        fam_b=fam_b,
        bound_b=bound_b,
    )
    per_g[key] = vp
    return vp


def _require_terminals(vp: _VecPrep) -> None:
    if vp.empty_id < 0 or vp.full_id < 0:
        raise ValueError("family must contain ∅ and V")


def _price_row(g: Graph, vp: _VecPrep, pos: int) -> NDArray[np.float64]:
    """Liveness excess for every target of source row ``pos`` (one batch).

    Memo-free: the row is cached here (shared by every entry point via
    ``_VEC_PREP``), and the traceback seeds the per-pair liveness memo for
    just the transitions the answer takes (:func:`_seed_chain_excess`).
    """
    mf = vp.m_fixed[pos]
    if mf is None:
        i = vp.order[pos]
        tg = vp.targets[pos]
        mf = transition_excess_row(
            g,
            vp.infos[i].mask,
            tmul=vp.fam_b[tg],
            bdful=vp.bound_b[tg],
        )
        vp.m_fixed[pos] = mf
    return mf


def _seed_chain_excess(g: Graph, vp: _VecPrep, chain: List[int]) -> None:
    """Seed the liveness memo along a traceback chain (full → ∅ order).

    The row pricer skips the per-pair memo (130k keys on a ResNet-152
    family, 99% never read back); the handful of transitions the chosen
    sequence takes are recorded here so ``peak_memory_live`` prices the
    returned plan with the *same floats* the DP's budget filter used.
    """
    pos_of = {i: p for p, i in enumerate(vp.order)}
    for child, parent in zip(chain[:-1], chain[1:]):
        pos = pos_of[parent]
        mf = vp.m_fixed[pos]
        if mf is None:  # pragma: no cover - chain rows are always priced
            continue
        idx = int(np.nonzero(vp.targets[pos] == child)[0][0])
        record_excess(
            g,
            vp.infos[parent].mask,
            vp.infos[child].mask,
            float(mf[idx]),
        )


def _pareto_keep(
    ms: NDArray[np.float64], ps: NDArray[np.float64]
) -> NDArray[np.bool_]:
    """Canonical (m, p) Pareto filter: sort callers pass (m asc, p asc)-
    sorted arrays; a point survives iff its p is strictly below every
    earlier point's — the same set the scalar bisect-insert loops keep."""
    keep = np.empty(len(ms), dtype=bool)
    keep[0] = True
    pm = np.minimum.accumulate(ps)
    keep[1:] = ps[1:] < pm[:-1]
    return keep


# ---------------------------------------------------------------------------
# Strategy-lattice solve (per-node {store, offload, quantize} choice)
# ---------------------------------------------------------------------------
#
# The joint memory-strategy DP keeps the legacy state (L, t) → minimal m
# and expands each transition once *per strategy option* of its newly
# cached set (core.strategies.transition_options — the Pareto frontier of
# the per-node Minkowski sum).  The strategy affects only the carried
# cache mass (m2 = m + option.m_add) and, for the time-centric and
# wallclock objectives, the t axis (t2 = t + (t_step + option.tax)); the
# transition's 𝓜⁽ⁱ⁾ = m + transition_excess stays strategy-independent
# because a node occupies full bytes during its own forward window and is
# compressed/offloaded only when the segment retires (see
# core.strategies).  Exactness over (sequence × assignment) follows from
# the legacy argument plus: each node is charged once (m_step counts
# cache(L')\L), smaller m weakly dominates, and the per-option folds are
# additive so intermediate Pareto pruning of options is lossless.
#
# Ordering contract (scalar ↔ vectorized bit-identity): the scalar loop
# iterates, per source, targets in jpos order with *options outer and
# entries inner*; the vectorized path flattens candidate rows
# target-major, option-minor, so the arrival sequence numbers
# (target, option, entry) reproduce the scalar first-writer-wins
# tie-break exactly.


def _strat_traceback(
    infos: List[_LowerSetInfo],
    chain: List[Tuple[int, float, Optional[Tuple[int, Tuple[str, ...]]]]],
) -> Tuple[List[NodeSet], Dict[int, str]]:
    """Masks (∅ dropped) + merged per-node assignment of a traceback chain.

    ``chain`` is in full → ∅ order; each element carries the lower-set id,
    its table t, and the arriving transition's (new_mask, codes) — None
    for the ∅ seed.
    """
    assignment: Dict[int, str] = {}
    masks: List[int] = []
    for cid, _t, opt in chain:
        if infos[cid].mask:
            masks.append(infos[cid].mask)
        if opt is not None:
            assignment.update(assignment_of(opt[0], opt[1]))
    masks.reverse()
    return [from_mask(mk) for mk in masks], assignment


def _solve_strat_scalar(
    g: Graph, budget: float, family: Sequence[NodeSet], objective: str,
    cfg: StrategyConfig,
) -> DPResult:
    """Scalar oracle of the joint memory-strategy DP (liveness functional)."""
    tc = objective == "time_centric"
    infos = _prepare(g, family)
    order = sorted(range(len(infos)), key=lambda i: infos[i].size)
    sizes = [infos[i].size for i in order]
    full_mask = (1 << g.n) - 1
    empty_id = full_id = -1
    for i, info in enumerate(infos):
        if info.mask == 0:
            empty_id = i
        if info.mask == full_mask:
            full_id = i
    if empty_id < 0 or full_id < 0:
        raise ValueError("family must contain ∅ and V")

    # t → (m, parent=(id, t) | None, (new_mask, codes) | None)
    table: List[Dict[float, Tuple[float, Any, Any]]] = [{} for _ in infos]
    table[empty_id][0.0] = (0.0, None, None)
    states = 0
    n_fam = len(order)
    for pos, i in enumerate(order):
        info_L = infos[i]
        entries = table[i]
        if not entries:
            continue
        pruned = _prune_generic(entries, reverse=not tc)
        table[i] = pruned
        pruned_items = list(pruned.items())
        mask_L = info_L.mask
        start = bisect_right(sizes, info_L.size)
        for jpos in range(start, n_fam):
            j = order[jpos]
            info_Lp = infos[j]
            if mask_L & ~info_Lp.mask:
                continue  # L ⊄ L'
            Vp_mask = info_Lp.mask & ~mask_L
            inter = Vp_mask & info_Lp.cache_mask
            t_step = (info_Lp.T - info_L.T) - _mask_T(g, inter)
            new_mask = info_Lp.cache_mask & ~mask_L
            m_fixed = transition_excess(
                g, mask_L, info_Lp.mask, info_Lp.boundary_mask
            )
            row = table[j]
            for opt in transition_options(g, cfg, new_mask, tc):
                t_step_o = t_step + opt.tax if tc else t_step
                for t, (m, _p, _o) in pruned_items:
                    states += 1
                    Mi = m + m_fixed  # 𝓜⁽ⁱ⁾, strategy-independent
                    if Mi > budget:
                        continue
                    t2 = t + t_step_o
                    m2 = m + opt.m_add
                    cur = row.get(t2)
                    if cur is None or cur[0] > m2:
                        row[t2] = (m2, (i, t), (new_mask, opt.codes))

    final = table[full_id]
    if not final:
        return DPResult([], INF, INF, feasible=False, states_visited=states)
    t_star = min(final) if tc else max(final)
    chain: List[Tuple[int, float, Any]] = []
    cur_id, cur_t = full_id, t_star
    while cur_id >= 0:
        m, parent, opt = table[cur_id][cur_t]
        chain.append((cur_id, cur_t, opt))
        if parent is None:
            break
        cur_id, cur_t = parent
    sequence, assignment = _strat_traceback(infos, chain)
    return DPResult(
        sequence=sequence,
        overhead=t_star,
        peak_memory=peak_memory_live(g, sequence, assignment),
        feasible=True,
        states_visited=states,
        assignment=assignment,
    )


def _prune_generic(
    entries: Dict[float, Tuple[float, Any, Any]], reverse: bool
) -> Dict[float, Tuple[float, Any, Any]]:
    """:func:`_pareto` / :func:`_pareto_mc` over value tuples of any width
    (index 0 is m)."""
    out: Dict[float, Tuple[float, Any, Any]] = {}
    best = INF
    for t in sorted(entries, reverse=reverse):
        val = entries[t]
        if val[0] < best:
            out[t] = val
            best = val[0]
    return out


def _solve_strat_vec(
    g: Graph, budget: float, family: Sequence[NodeSet], objective: str,
    cfg: StrategyConfig,
) -> DPResult:
    """Vectorized joint memory-strategy DP.

    The legacy :func:`_solve_vec` with each source row's (target × option)
    pairs flattened target-major / option-minor — the arrival-sequence
    lexsort key then reproduces the scalar loop's first-writer-wins
    tie-break (options outer, entries inner) exactly.
    """
    tc = objective == "time_centric"
    vp = _vec_prep(g, family)
    _require_terminals(vp)
    n_infos = len(vp.infos)
    # pending chunks: (t2, m2, parent_id, parent_t, arrival seq, opt ref)
    pend: List[List[Tuple[NDArray[np.float64], NDArray[np.float64],
                          NDArray[np.int64], NDArray[np.float64],
                          NDArray[np.int64], NDArray[np.int64]]]] = [
        [] for _ in range(n_infos)
    ]
    zero = np.zeros(1, dtype=np.float64)
    neg1 = np.full(1, -1, dtype=np.int64)
    pend[vp.empty_id].append((zero, zero, neg1, zero, neg1, neg1))
    rows: List[Optional[Tuple[NDArray[np.float64], NDArray[np.float64],
                              NDArray[np.int64], NDArray[np.float64],
                              NDArray[np.int64]]]] = [None] * n_infos
    opt_tab: List[Tuple[int, Tuple[str, ...]]] = []  # ref → (new_mask, codes)
    states = 0
    seq_base = 0
    for pos, i in enumerate(vp.order):
        chunks = pend[i]
        pend[i] = []
        if not chunks:
            continue
        t2 = np.concatenate([c[0] for c in chunks])
        m2 = np.concatenate([c[1] for c in chunks])
        pid = np.concatenate([c[2] for c in chunks])
        pt = np.concatenate([c[3] for c in chunks])
        seq = np.concatenate([c[4] for c in chunks])
        oc = np.concatenate([c[5] for c in chunks])
        o = np.lexsort((seq, m2, t2))
        t2, m2, pid, pt, oc = t2[o], m2[o], pid[o], pt[o], oc[o]
        first = np.empty(len(t2), dtype=bool)
        first[0] = True
        first[1:] = t2[1:] != t2[:-1]
        t2, m2, pid, pt, oc = (
            t2[first], m2[first], pid[first], pt[first], oc[first]
        )
        if not tc:
            t2, m2, pid, pt, oc = (
                t2[::-1], m2[::-1], pid[::-1], pt[::-1], oc[::-1]
            )
        keepb = np.empty(len(m2), dtype=bool)
        keepb[0] = True
        pm = np.minimum.accumulate(m2)
        keepb[1:] = m2[1:] < pm[:-1]
        t_e, m_e, pid_e, pt_e, oc_e = (
            t2[keepb], m2[keepb], pid[keepb], pt[keepb], oc[keepb]
        )
        rows[i] = (t_e, m_e, pid_e, pt_e, oc_e)
        tg = vp.targets[pos]
        j_cnt, e_cnt = len(tg), len(t_e)
        if j_cnt == 0 or e_cnt == 0:
            continue
        mf = _price_row(g, vp, pos)
        t_stepv = vp.t_step[pos]
        mask_L = vp.infos[i].mask
        # flatten (target, option) rows: target-major, option-minor
        flat_j: List[int] = []
        flat_m: List[float] = []
        flat_t: List[float] = []
        flat_oc: List[int] = []
        for jj in range(j_cnt):
            j = int(tg[jj])
            new_mask = vp.infos[j].cache_mask & ~mask_L
            for opt in transition_options(g, cfg, new_mask, tc):
                flat_j.append(jj)
                flat_m.append(opt.m_add)
                flat_t.append(
                    float(t_stepv[jj]) + opt.tax if tc else float(t_stepv[jj])
                )
                flat_oc.append(len(opt_tab))
                opt_tab.append((new_mask, opt.codes))
        r_cnt = len(flat_j)
        states += r_cnt * e_cnt
        fj = np.asarray(flat_j, dtype=np.int64)
        fm = np.asarray(flat_m, dtype=np.float64)
        ft = np.asarray(flat_t, dtype=np.float64)
        foc = np.asarray(flat_oc, dtype=np.int64)
        t2m = t_e[None, :] + ft[:, None]
        m2m = m_e[None, :] + fm[:, None]
        ok = (m_e[None, :] + mf[fj][:, None]) <= budget
        seqm = seq_base + np.arange(r_cnt, dtype=np.int64)[:, None] * e_cnt + \
            np.arange(e_cnt, dtype=np.int64)
        seq_base += r_cnt * e_cnt
        pid_i = np.full(e_cnt, i, dtype=np.int64)
        cnt = ok.sum(axis=1)
        for rr, c in zip(range(r_cnt), cnt.tolist()):
            if c == 0:
                continue
            ocr = np.full(e_cnt, foc[rr], dtype=np.int64)
            if c == e_cnt:
                pend[int(tg[fj[rr]])].append(
                    (t2m[rr], m2m[rr], pid_i, t_e, seqm[rr], ocr)
                )
            else:
                okr = ok[rr]
                pend[int(tg[fj[rr]])].append(
                    (t2m[rr][okr], m2m[rr][okr], pid_i[okr], t_e[okr],
                     seqm[rr][okr], ocr[okr])
                )
    final = rows[vp.full_id]
    if final is None or len(final[0]) == 0:
        return DPResult([], INF, INF, feasible=False, states_visited=states)
    t_star = float(final[0][0])
    chain: List[Tuple[int, float, Any]] = []
    id_chain: List[int] = []
    cur_id, cur_t = vp.full_id, t_star
    while cur_id >= 0:
        row = rows[cur_id]
        assert row is not None
        k = int(np.nonzero(row[0] == cur_t)[0][0])
        ref = int(row[4][k])
        chain.append((cur_id, cur_t, opt_tab[ref] if ref >= 0 else None))
        id_chain.append(cur_id)
        cur_id, cur_t = int(row[2][k]), float(row[3][k])
    _seed_chain_excess(g, vp, id_chain)
    sequence, assignment = _strat_traceback(vp.infos, chain)
    return DPResult(
        sequence=sequence,
        overhead=t_star,
        peak_memory=peak_memory_live(g, sequence, assignment),
        feasible=True,
        states_visited=states,
        assignment=assignment,
    )


def _solve_strat(
    g: Graph, budget: float, family: Sequence[NodeSet], objective: str,
    cfg: StrategyConfig,
) -> DPResult:
    if scalar_only():
        return _solve_strat_scalar(g, budget, family, objective, cfg)
    return _solve_strat_vec(g, budget, family, objective, cfg)


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------


def _solve_vec(
    g: Graph, budget: float, family: Sequence[NodeSet], objective: str
) -> DPResult:
    """Vectorized Algorithm 1 (liveness functional).

    Table rows are finalized by gathering each lower set's incoming
    candidates and picking, per distinct t, the minimal-m entry with the
    smallest arrival sequence number — the scalar ``row.get``-and-compare
    loop's first-writer-wins tie-break, reproduced as a lexsort key.
    """
    tc = objective == "time_centric"
    vp = _vec_prep(g, family)
    _require_terminals(vp)
    n_infos = len(vp.infos)
    # pending chunks per set: (t2, m2, parent_id, parent_t, arrival seq) —
    # rows here are wide (one entry per distinct t), so ndarray chunks beat
    # the flat-list accumulation _mfb_vec uses for its ~6-wide frontiers.
    pend: List[
        List[
            Tuple[
                NDArray[np.float64],
                NDArray[np.float64],
                NDArray[np.int64],
                NDArray[np.float64],
                NDArray[np.int64],
            ]
        ]
    ] = [[] for _ in range(n_infos)]
    zero = np.zeros(1, dtype=np.float64)
    neg1 = np.full(1, -1, dtype=np.int64)
    pend[vp.empty_id].append((zero, zero, neg1, zero, neg1))
    # finalized + Pareto-pruned rows, in expansion order (t asc for TC,
    # t desc for MC — the scalar dict-iteration order)
    rows: List[
        Optional[
            Tuple[
                NDArray[np.float64],
                NDArray[np.float64],
                NDArray[np.int64],
                NDArray[np.float64],
            ]
        ]
    ] = [None] * n_infos
    states = 0
    seq_base = 0
    for pos, i in enumerate(vp.order):
        chunks = pend[i]
        pend[i] = []
        if not chunks:
            continue
        t2 = np.concatenate([c[0] for c in chunks])
        m2 = np.concatenate([c[1] for c in chunks])
        pid = np.concatenate([c[2] for c in chunks])
        pt = np.concatenate([c[3] for c in chunks])
        seq = np.concatenate([c[4] for c in chunks])
        o = np.lexsort((seq, m2, t2))
        t2, m2, pid, pt = t2[o], m2[o], pid[o], pt[o]
        first = np.empty(len(t2), dtype=bool)
        first[0] = True
        first[1:] = t2[1:] != t2[:-1]
        t2, m2, pid, pt = t2[first], m2[first], pid[first], pt[first]
        if not tc:  # MC prunes (and expands) in descending-t order
            t2, m2, pid, pt = t2[::-1], m2[::-1], pid[::-1], pt[::-1]
        # _pareto/_pareto_mc: walk t (asc TC / desc MC), keep m strictly
        # below the running best
        keepb = np.empty(len(m2), dtype=bool)
        keepb[0] = True
        pm = np.minimum.accumulate(m2)
        keepb[1:] = m2[1:] < pm[:-1]
        t_e, m_e, pid_e, pt_e = t2[keepb], m2[keepb], pid[keepb], pt[keepb]
        rows[i] = (t_e, m_e, pid_e, pt_e)
        tg = vp.targets[pos]
        j_cnt, e_cnt = len(tg), len(t_e)
        if j_cnt == 0 or e_cnt == 0:
            continue
        states += j_cnt * e_cnt
        mf = _price_row(g, vp, pos)
        t2m = t_e[None, :] + vp.t_step[pos][:, None]
        m2m = m_e[None, :] + vp.m_step[pos][:, None]
        ok = (m_e[None, :] + mf[:, None]) <= budget  # scalar: skip Mi > B
        seqm = seq_base + np.arange(j_cnt, dtype=np.int64)[:, None] * e_cnt + np.arange(
            e_cnt, dtype=np.int64
        )
        seq_base += j_cnt * e_cnt
        pid_i = np.full(e_cnt, i, dtype=np.int64)
        cnt = ok.sum(axis=1)  # one reduction replaces 2 per-row dispatches
        for jj, c in zip(range(j_cnt), cnt.tolist()):
            if c == 0:
                continue
            if c == e_cnt:
                pend[tg[jj]].append((t2m[jj], m2m[jj], pid_i, t_e, seqm[jj]))
            else:
                okr = ok[jj]
                pend[tg[jj]].append(
                    (t2m[jj][okr], m2m[jj][okr], pid_i[okr], t_e[okr], seqm[jj][okr])
                )
    final = rows[vp.full_id]
    if final is None or len(final[0]) == 0:
        return DPResult([], INF, INF, feasible=False, states_visited=states)
    # rows are stored in expansion order: TC ascending t (min first), MC
    # descending t (max first) — the optimum is the first entry either way.
    t_star = float(final[0][0])
    chain: List[int] = []
    cur_id, cur_t = vp.full_id, t_star
    while cur_id >= 0:
        chain.append(cur_id)
        row = rows[cur_id]
        assert row is not None
        k = int(np.nonzero(row[0] == cur_t)[0][0])
        cur_id, cur_t = int(row[2][k]), float(row[3][k])
    _seed_chain_excess(g, vp, chain)
    masks = [
        vp.infos[cid].mask for cid in reversed(chain) if vp.infos[cid].mask != 0
    ]
    sequence = [from_mask(mk) for mk in masks]
    return DPResult(
        sequence=sequence,
        overhead=t_star,
        peak_memory=peak_memory_live(g, sequence),
        feasible=True,
        states_visited=states,
    )


def solve(
    g: Graph,
    budget: float,
    family: Sequence[NodeSet],
    objective: str = "time_centric",
    functional: str = "liveness",
    strategies: Optional[StrategyConfig] = None,
) -> DPResult:
    """Algorithm 1 (Appendix A) over an arbitrary lower-set family.

    objective:
      * "time_centric"   — minimize overhead (line 15: min)   §4.2/§4.3
      * "memory_centric" — maximize overhead (line 15: max)   §4.4
      * "wallclock"      — minimize *replayed step time* under the budget:
        the time-centric Pareto surface is swept, every feasible terminal
        overhead is lowered to a plan and priced by the discrete-event
        replay (``core.replay``), and the wall-clock winner is returned.
        Requires the liveness functional (the replay's overlap windows are
        its backward-window decomposition).

    functional:
      * "liveness" — 𝓜⁽ⁱ⁾ priced by ``liveness.transition_excess`` (the
        framework default; see the module docstring);
      * "eq2"      — the paper's original eq. 2 charge (Appendix C
        ablation / benchmarks only).

    strategies:
      an extended :class:`~repro_torch.core.strategies.StrategyConfig` switches
      to the joint memory-strategy DP (per-node {store, offload,
      quantize} choice; liveness functional only) and the result carries
      ``assignment``.  ``None`` or a non-extended config routes through
      the untouched legacy paths — bit-identical to the pre-lattice
      solver by construction.
    """
    if strategies is not None and strategies.extended:
        if functional != "liveness":
            raise ValueError(
                "the strategy lattice requires functional='liveness'"
            )
        if objective == "wallclock":
            return solve_wallclock(g, budget, family, strategies=strategies)
        if objective not in ("time_centric", "memory_centric"):
            raise ValueError(f"unknown objective {objective!r}")
        return _solve_strat(g, budget, family, objective, strategies)
    if objective == "wallclock":
        if functional != "liveness":
            raise ValueError(
                "objective='wallclock' requires functional='liveness'"
            )
        return solve_wallclock(g, budget, family)
    if objective not in ("time_centric", "memory_centric"):
        raise ValueError(f"unknown objective {objective!r}")
    _check_functional(functional, g)
    live = functional == "liveness"
    if live and not scalar_only():
        return _solve_vec(g, budget, family, objective)

    infos = _prepare(g, family)
    # ascending order of set size (line 3)
    order = sorted(range(len(infos)), key=lambda i: infos[i].size)
    full_mask = (1 << g.n) - 1

    empty_id = None
    full_id = None
    for i, info in enumerate(infos):
        if info.mask == 0:
            empty_id = i
        if info.mask == full_mask:
            full_id = i
    if empty_id is None or full_id is None:
        raise ValueError("family must contain ∅ and V")

    # Sparse DP table: per lower-set id, a dict t -> (m, parent=(id, t)).
    # Pareto pruning: keep only entries where no t'' < t has m'' <= m.
    table: List[Dict[float, Tuple[float, Optional[Tuple[int, float]]]]] = [
        {} for _ in infos
    ]
    table[empty_id][0.0] = (0.0, None)

    states = 0
    n_fam = len(order)
    sizes = [infos[i].size for i in order]
    import bisect

    for pos, i in enumerate(order):
        info_L = infos[i]
        entries = table[i]
        if not entries:
            continue
        # Pareto-prune the source entries once before expanding (§4.2 note).
        # The dominance direction depends on the objective: TC keeps the
        # (t↓, m↓) frontier; MC keeps the (t↑, m↓) frontier — an entry is
        # dominated by one with ≥ overhead so far AND ≤ cache mass.
        pruned = (_pareto(entries) if objective == "time_centric"
                  else _pareto_mc(entries))
        table[i] = pruned
        pruned_items = list(pruned.items())
        mask_L = info_L.mask
        # strictly larger sets only: start past the last equal-size entry
        start = bisect.bisect_right(sizes, info_L.size)
        for jpos in range(start, n_fam):
            j = order[jpos]
            info_Lp = infos[j]
            if mask_L & ~info_Lp.mask:
                continue  # L ⊄ L'
            # Pair terms (cache_mask = ∂(L') plus must_store pins in L').
            Vp_mask = info_Lp.mask & ~mask_L  # V' = L' \ L
            # T(V' \ cached) — pinned nodes are stored, never recomputed
            inter = Vp_mask & info_Lp.cache_mask
            t_step = (info_Lp.T - info_L.T) - _mask_T(g, inter)
            # M(cached(L') \ L)
            m_step = _mask_M(g, info_Lp.cache_mask & ~mask_L)
            m_fixed = (
                transition_excess(g, mask_L, info_Lp.mask, info_Lp.boundary_mask)
                if live
                else 2.0 * (info_Lp.M - info_L.M) + info_Lp.m_after
            )
            row = table[j]
            for t, (m, _parent) in pruned_items:
                states += 1
                Mi = m + m_fixed  # 𝓜⁽ⁱ⁾: M(U_{i-1}) + the transition charge
                if Mi > budget:
                    continue
                t2 = t + t_step
                m2 = m + m_step
                cur = row.get(t2)
                if cur is None or cur[0] > m2:
                    row[t2] = (m2, (i, t))

    final = table[full_id]
    if not final:
        return DPResult([], INF, INF, feasible=False, states_visited=states)

    if objective == "time_centric":
        t_star = min(final)
    else:  # memory_centric: max at line 15
        t_star = max(final)

    # Traceback (line 16).
    seq_ids: List[Tuple[int, float]] = []
    cur: Optional[Tuple[int, float]] = (full_id, t_star)
    while cur is not None:
        seq_ids.append(cur)
        _m, parent = table[cur[0]][cur[1]]
        cur = parent
    seq_ids.reverse()
    sequence = [from_mask(infos[i].mask) for i, _t in seq_ids if infos[i].mask != 0]

    peak = (peak_memory_live if live else peak_memory)(g, sequence)
    return DPResult(
        sequence=sequence,
        overhead=t_star,
        peak_memory=peak,
        feasible=True,
        states_visited=states,
    )


def solve_wallclock(
    g: Graph,
    budget: float,
    family: Sequence[NodeSet],
    profile: Optional["OpProfile"] = None,
    strategies: Optional[StrategyConfig] = None,
    **replay_kw: Any,
) -> DPResult:
    """Wall-clock plan selection: sweep the surface, replay the terminals.

    Every feasible terminal overhead of the (time-centric-shaped) sweep is
    a distinct Pareto plan at ``budget``; each is lowered via ``make_plan``
    and priced by :func:`repro_torch.core.replay.replay`, and the minimal
    replayed-seconds candidate wins (deterministic tie-break on analytic
    peak, then overhead).  ``replay_kw`` is forwarded to the replay
    (``mesh=``, ``comm_bytes=``, ``segment_costs=``, ...).

    With an extended ``strategies`` config the candidate pool is the
    *union* of the legacy (all-store) sweep's terminals and the strategy
    sweep's terminals, ranked jointly by replayed seconds — so enabling
    strategies can never select a plan that replays slower than the
    legacy winner at the same budget (the legacy winner stays in the
    pool), which is the monotonicity the strategy-ablation benchmark
    guards.
    """
    from .replay import rank_by_replay

    sw = sweep(g, family, "wallclock", cap=budget)
    if strategies is None or not strategies.extended:
        return sw.extract_wallclock(g, budget, profile=profile, **replay_kw)

    ssw = sweep(g, family, "wallclock", cap=budget, strategies=strategies)
    ts = sw.terminal_candidates(budget)
    cands: List[Tuple[float, List[NodeSet], Optional[Dict[int, str]]]] = [
        (t, [from_mask(mk) for mk in sw._traceback(budget, t)], None)
        for t in ts
    ]
    assert isinstance(ssw, StrategySweep)
    for t in ssw.terminal_candidates(budget):
        masks, assignment = ssw.traceback_with_assignment(budget, t)
        cands.append((t, [from_mask(mk) for mk in masks], assignment))
    if not cands:
        return DPResult([], INF, INF, feasible=False,
                        states_visited=sw.states_visited + ssw.states_visited)
    replay_kw.setdefault("budget", budget)
    idx, plan, _res = rank_by_replay(
        g,
        [c[1] for c in cands],
        assignments=[c[2] for c in cands],
        strategies=strategies,
        profile=profile,
        **replay_kw,
    )
    t_win, seq_win, asg_win = cands[idx]
    return DPResult(
        sequence=seq_win,
        overhead=t_win,
        peak_memory=plan.peak_memory,
        feasible=True,
        states_visited=sw.states_visited + ssw.states_visited,
        assignment=asg_win,  # None ⇒ the legacy all-store candidate won
    )


def feasible(g: Graph, budget: float, family: Sequence[NodeSet],
             infos: Optional[List[_LowerSetInfo]] = None,
             functional: str = "liveness",
             strategies: Optional[StrategyConfig] = None) -> bool:
    """Fast feasibility oracle for the budget binary search (§5.1).

    For feasibility the t axis is irrelevant and smaller cache mass m is
    always at least as good, so one min-m entry per lower set suffices —
    O(#𝓛²) instead of O(T(V)·#𝓛²).

    With an extended ``strategies`` config the same argument collapses the
    strategy lattice: only each node's minimal legal device bytes matter
    (taxes never affect feasibility), so the joint problem is the binary
    one with ``mem_v`` replaced by ``StrategyConfig.min_device_bytes``.
    """
    import bisect

    _check_functional(functional, g)
    live = functional == "liveness"
    ext = strategies is not None and strategies.extended
    if ext and not live:
        raise ValueError("the strategy lattice requires functional='liveness'")
    mem_eff = strategies.min_device_bytes(g) if ext else None
    if ext and scalar_only():
        return _feasible_strat_scalar(g, budget, family, mem_eff)
    if live and not scalar_only():
        vp = (_vec_prep(g, family) if not ext else
              _vec_prep(g, family, mem_w=mem_eff,
                        tag=strategies.digest_token()))
        if vp.full_id < 0:
            return False
        best = np.full(len(vp.infos), INF, dtype=np.float64)
        if vp.empty_id >= 0:
            best[vp.empty_id] = 0.0
        for pos, i in enumerate(vp.order):
            m = best[i]
            if m == INF:
                continue
            tg = vp.targets[pos]
            if len(tg) == 0:
                continue
            mf = _price_row(g, vp, pos)
            ok = (m + mf) <= budget  # scalar: skip Mi > B
            if not ok.any():
                continue
            sel = tg[ok]
            m2 = m + vp.m_step[pos][ok]
            cur = best[sel]
            upd = m2 < cur
            best[sel[upd]] = m2[upd]
        return bool(best[vp.full_id] < INF)
    infos = infos if infos is not None else _prepare(g, family)
    order = sorted(range(len(infos)), key=lambda i: infos[i].size)
    sizes = [infos[i].size for i in order]
    full_mask = (1 << g.n) - 1
    best: List[float] = [INF] * len(infos)
    for i, info in enumerate(infos):
        if info.mask == 0:
            best[i] = 0.0
    n_fam = len(order)
    for pos, i in enumerate(order):
        m = best[i]
        if m == INF:
            continue
        info_L = infos[i]
        mask_L = info_L.mask
        start = bisect.bisect_right(sizes, info_L.size)
        for jpos in range(start, n_fam):
            j = order[jpos]
            info_Lp = infos[j]
            if mask_L & ~info_Lp.mask:
                continue
            m_fixed = (
                transition_excess(g, mask_L, info_Lp.mask, info_Lp.boundary_mask)
                if live
                else 2.0 * (info_Lp.M - info_L.M) + info_Lp.m_after
            )
            Mi = m + m_fixed
            if Mi > budget:
                continue
            m2 = m + _mask_M(g, info_Lp.cache_mask & ~mask_L)
            if m2 < best[j]:
                best[j] = m2
    for i, info in enumerate(infos):
        if info.mask == full_mask:
            return best[i] < INF
    return False


def _feasible_strat_scalar(
    g: Graph, budget: float, family: Sequence[NodeSet],
    mem_eff: Sequence[float],
) -> bool:
    """Scalar strategy-lattice feasibility: min-m per set over mem_eff."""
    infos = _prepare(g, family)
    order = sorted(range(len(infos)), key=lambda i: infos[i].size)
    sizes = [infos[i].size for i in order]
    full_mask = (1 << g.n) - 1
    best: List[float] = [INF] * len(infos)
    for i, info in enumerate(infos):
        if info.mask == 0:
            best[i] = 0.0
    n_fam = len(order)
    for pos, i in enumerate(order):
        m = best[i]
        if m == INF:
            continue
        info_L = infos[i]
        mask_L = info_L.mask
        start = bisect_right(sizes, info_L.size)
        for jpos in range(start, n_fam):
            j = order[jpos]
            info_Lp = infos[j]
            if mask_L & ~info_Lp.mask:
                continue
            m_fixed = transition_excess(
                g, mask_L, info_Lp.mask, info_Lp.boundary_mask
            )
            if m + m_fixed > budget:
                continue
            m2 = m + _mask_M_w(mem_eff, info_Lp.cache_mask & ~mask_L)
            if m2 < best[j]:
                best[j] = m2
    for i, info in enumerate(infos):
        if info.mask == full_mask:
            return best[i] < INF
    return False


def _pareto(
    entries: Dict[float, Tuple[float, Optional[Tuple[int, float]]]]
) -> Dict[float, Tuple[float, Optional[Tuple[int, float]]]]:
    """Keep only (t, m) not dominated by some (t'' ≤ t, m'' ≤ m), except both equal."""
    out: Dict[float, Tuple[float, Optional[Tuple[int, float]]]] = {}
    best = INF
    for t in sorted(entries):
        m, parent = entries[t]
        if m < best:
            out[t] = (m, parent)
            best = m
    return out


def _pareto_mc(
    entries: Dict[float, Tuple[float, Optional[Tuple[int, float]]]]
) -> Dict[float, Tuple[float, Optional[Tuple[int, float]]]]:
    """MC dominance: (t, m) is dominated by (t'' ≥ t, m'' ≤ m) — any feasible
    continuation of the dominated entry is feasible from the dominating one
    and ends with at least as much total overhead."""
    out: Dict[float, Tuple[float, Optional[Tuple[int, float]]]] = {}
    best = INF
    for t in sorted(entries, reverse=True):
        m, parent = entries[t]
        if m < best:
            out[t] = (m, parent)
            best = m
    return out


# ---------------------------------------------------------------------------
# Budget-free sweep solver
# ---------------------------------------------------------------------------
#
# The per-budget DP keeps, per (lower set, t), the minimal cache mass m of
# any transition chain whose every 𝓜⁽ⁱ⁾ fits the budget.  The sweep drops
# the filter and instead carries peak = max_i 𝓜⁽ⁱ⁾ along each chain, so a
# cell holds a small Pareto frontier over (m, peak):
#
#   * sorted by peak strictly ascending;
#   * (m, pos) lexicographically *strictly descending*, where pos is the
#     size-order position of the transition's source lower set.
#
# Projecting a cell at budget B (candidates with peak ≤ B, winner = minimal
# (m, pos)) recovers exactly the per-budget DP's cell: m matches its value
# and pos identifies the same first-writer parent.  Because the frontier
# keys are monotone, the projection winner is simply the candidate with the
# largest peak ≤ B — one bisect per cell.


class _Cell:
    """Frontier of one DP cell ``(lower set, t)``: parallel candidate lists.

    Invariants: ``peaks`` strictly ascending, ``(ms, poss)`` lex strictly
    descending.  ``parent_ids``/``parent_ts`` locate the predecessor cell
    (family index and t); the ∅-seed candidate uses ``(-1, 0.0)``.
    """

    __slots__ = ("peaks", "ms", "poss", "parent_ids", "parent_ts")

    def __init__(self):
        self.peaks: List[float] = []
        self.ms: List[float] = []
        self.poss: List[int] = []
        self.parent_ids: List[int] = []
        self.parent_ts: List[float] = []

    def insert(self, m: float, peak: float, pos: int, pid: int, pt: float) -> None:
        peaks = self.peaks
        ms = self.ms
        poss = self.poss
        i = bisect_left(peaks, peak)
        if i > 0:
            pm = ms[i - 1]
            if pm < m or (pm == m and poss[i - 1] <= pos):
                return  # dominated by a lower-peak candidate with a ≤ key
        j = i
        n = len(peaks)
        while j < n:
            jm = ms[j]
            if jm > m or (jm == m and poss[j] >= pos):
                j += 1  # evict candidates the newcomer dominates
            else:
                break
        if j < n and peaks[j] == peak:
            return  # an equal-peak candidate with a strictly smaller key
        del peaks[i:j], ms[i:j], poss[i:j]
        del self.parent_ids[i:j], self.parent_ts[i:j]
        peaks.insert(i, peak)
        ms.insert(i, m)
        poss.insert(i, pos)
        self.parent_ids.insert(i, pid)
        self.parent_ts.insert(i, pt)

    def winner(self, budget: float) -> int:
        """Index of the budget-B projection winner, or -1 if none fits."""
        return bisect_right(self.peaks, budget) - 1

    def min_peak(self) -> float:
        return self.peaks[0] if self.peaks else INF

    def copy(self) -> "_Cell":
        out = _Cell()
        out.peaks = list(self.peaks)
        out.ms = list(self.ms)
        out.poss = list(self.poss)
        out.parent_ids = list(self.parent_ids)
        out.parent_ts = list(self.parent_ts)
        return out


class SweepOverflow(RuntimeError):
    """Raised when a sweep would exceed its ``max_states`` work cap.

    The (t, m, peak) surface of a graph can be much larger than any single
    budget's slice of it (one slice per *budget regime*); callers that only
    need one budget catch this and fall back to the per-budget DP.
    """


def _mfb_vec(g: Graph, family: Sequence[NodeSet],
             vp: Optional[_VecPrep] = None) -> float:
    """Vectorized :func:`min_feasible_budget_exact` (liveness functional).

    Gather formulation: candidates pushed into a lower set are buffered as
    raw (m, peak) chunks and canonically Pareto-filtered once, when the
    set's turn comes as a source — the scalar insert loop maintains the
    same order-independent set incrementally.  ``vp`` lets the strategy
    lattice substitute its ``mem_eff``-weighted prep.
    """
    vp = vp if vp is not None else _vec_prep(g, family)
    _require_terminals(vp)
    # Incoming candidates accumulate as flat python float lists — 130k
    # tiny per-(source, target) ndarrays cost more to concatenate than the
    # whole DP; ``tolist``/``asarray`` round-trip float64 exactly, and
    # ``extend`` preserves the source-order arrival the canonical filter
    # expects.
    pend_m: List[List[float]] = [[] for _ in vp.infos]
    pend_p: List[List[float]] = [[] for _ in vp.infos]
    pend_m[vp.empty_id].append(0.0)
    pend_p[vp.empty_id].append(0.0)
    final_p: Optional[NDArray[np.float64]] = None
    for pos, i in enumerate(vp.order):
        mlist = pend_m[i]
        plist = pend_p[i]
        pend_m[i] = []
        pend_p[i] = []
        if not mlist:
            continue
        ms = np.asarray(mlist, dtype=np.float64)
        ps = np.asarray(plist, dtype=np.float64)
        o = np.lexsort((ps, ms))
        ms, ps = ms[o], ps[o]
        keep = _pareto_keep(ms, ps)
        src_m, src_p = ms[keep], ps[keep]
        if i == vp.full_id:
            final_p = src_p
        tg = vp.targets[pos]
        if len(tg) == 0:
            continue
        mf = _price_row(g, vp, pos)
        m_step = vp.m_step[pos]
        # (J, F) candidate blocks — the scalar expressions, elementwise.
        m2 = src_m[None, :] + m_step[:, None]
        peak2 = np.maximum(src_m[None, :] + mf[:, None], src_p[None, :])
        for t, mrow, prow in zip(tg.tolist(), m2.tolist(), peak2.tolist()):
            pend_m[t].extend(mrow)
            pend_p[t].extend(prow)
    if final_p is None or len(final_p) == 0:
        return INF
    return float(final_p[-1])


def min_feasible_budget_exact(g: Graph, family: Sequence[NodeSet],
                              functional: str = "liveness",
                              strategies: Optional[StrategyConfig] = None,
                              ) -> float:
    """Exact minimal feasible budget in one forward pass (no search).

    min over canonical strategies of max_i 𝓜⁽ⁱ⁾ (the liveness-tight
    functional; ``functional="eq2"`` prices by the paper's eq. 2 for the
    ablation benchmarks) — replaces the §5.1 binary search and its
    per-probe feasibility DPs, and unlike the search's tolerance the result
    is itself exactly feasible.

    This is the t-less projection of :func:`sweep`: per lower set a Pareto
    frontier over ``(m, peak)`` only.  Every arithmetic expression — the
    left-folded cache mass ``m + m_step`` and the transition peak
    ``m + m_fixed`` — is written *identically* to :func:`solve` /
    :func:`feasible`, so the returned budget sits exactly on the per-budget
    DP's own float feasibility threshold: ``solve(g, B)`` is feasible at
    ``B = result`` and infeasible one ulp below (a re-associated closed
    form, e.g. ``2·M(L') + m_after − 2·M(L)``, can land an ulp off and
    return a budget the DP rejects; the liveness functional sidesteps this
    by having all four entry points read the same memoized
    ``transition_excess`` value per pair).

    With an extended ``strategies`` config the lattice collapses exactly
    as in :func:`feasible` — a chain's peak only falls when carried bytes
    fall, so every node takes its minimal legal device bytes
    (``mem_eff``) and the legacy algorithm runs over that weight vector.
    The result sits on the joint DP's own float threshold:
    ``solve(..., strategies=cfg)`` is feasible at the returned budget and
    infeasible one ulp below, because the DP's all-min-bytes transition
    option folds the identical floats.
    """
    _check_functional(functional, g)
    live = functional == "liveness"
    ext = strategies is not None and strategies.extended
    if ext and not live:
        raise ValueError("the strategy lattice requires functional='liveness'")
    mem_eff = strategies.min_device_bytes(g) if ext else None
    if live and not scalar_only():
        if ext:
            return _mfb_vec(
                g, family,
                vp=_vec_prep(g, family, mem_w=mem_eff,
                             tag=strategies.digest_token()),
            )
        return _mfb_vec(g, family)
    infos = _prepare(g, family)
    order = sorted(range(len(infos)), key=lambda i: infos[i].size)
    sizes = [infos[i].size for i in order]
    full_mask = (1 << g.n) - 1
    empty_id = full_id = None
    for i, info in enumerate(infos):
        if info.mask == 0:
            empty_id = i
        if info.mask == full_mask:
            full_id = i
    if empty_id is None or full_id is None:
        raise ValueError("family must contain ∅ and V")

    # per lower set: ms ascending, peaks strictly descending (Pareto)
    fr_m: List[List[float]] = [[] for _ in infos]
    fr_p: List[List[float]] = [[] for _ in infos]
    fr_m[empty_id].append(0.0)
    fr_p[empty_id].append(0.0)
    n_fam = len(order)
    for pos, i in enumerate(order):
        src_m = fr_m[i]
        if not src_m:
            continue
        src_p = fr_p[i]
        info_L = infos[i]
        mask_L = info_L.mask
        start = bisect_right(sizes, info_L.size)
        for jpos in range(start, n_fam):
            j = order[jpos]
            info_Lp = infos[j]
            if mask_L & ~info_Lp.mask:
                continue  # L ⊄ L'
            m_step = (
                _mask_M(g, info_Lp.cache_mask & ~mask_L)
                if mem_eff is None
                else _mask_M_w(mem_eff, info_Lp.cache_mask & ~mask_L)
            )
            m_fixed = (
                transition_excess(g, mask_L, info_Lp.mask, info_Lp.boundary_mask)
                if live
                else 2.0 * (info_Lp.M - info_L.M) + info_Lp.m_after
            )
            tm = fr_m[j]
            tp = fr_p[j]
            for m, peak in zip(src_m, src_p):
                Mi = m + m_fixed  # 𝓜⁽ⁱ⁾, same floats as solve()
                peak2 = Mi if Mi > peak else peak
                m2 = m + m_step
                idx = bisect_right(tm, m2) - 1
                if idx >= 0 and tp[idx] <= peak2:
                    continue  # dominated
                lo = bisect_left(tm, m2)
                hi = lo
                while hi < len(tm) and tp[hi] >= peak2:
                    hi += 1
                del tm[lo:hi], tp[lo:hi]
                tm.insert(lo, m2)
                tp.insert(lo, peak2)
    peaks = fr_p[full_id]
    return peaks[-1] if peaks else INF


@dataclasses.dataclass
class Sweep:
    """Full (budget → plan) Pareto surface of one planning problem.

    Produced by :func:`sweep`; ``extract(B)`` reproduces the per-budget
    ``solve`` bit-identically for any ``B``.  ``family_masks`` are node-set
    bitmasks in the coordinate system the sweep was built in (the source
    graph's node ids, or canonical positions after :meth:`to_canonical`);
    everything else — cells, t/m/peak values, parent links — is
    coordinate-free, which is what makes cached sweeps transfer between
    isomorphic graph labelings.
    """

    objective: str
    n: int
    family_masks: List[int]
    cells: List[Dict[float, _Cell]]
    empty_id: int
    full_id: int
    states_visited: int = 0
    cap: Optional[float] = None  # budgets > cap were not swept (None = all)

    def covers(self, budget: float) -> bool:
        """True iff ``extract(budget)`` is answerable from this sweep."""
        return self.cap is None or budget <= self.cap

    def extend(self, g: Graph, cap: Optional[float] = None,
               max_states: Optional[int] = None) -> "Sweep":
        """Grow this capped surface to ``cap`` (None = the full surface).

        Lazy refinement: a capped sweep's cells are exactly the full
        surface's cells with every candidate of peak > cap dropped — a
        large-peak candidate can only dominate/evict larger-peak ones, so
        the ≤ cap band is unaffected by the missing tail.  Extension
        therefore re-runs the transition pass seeded with the existing
        cells and only *inserts* candidates in the new ``(old cap, cap]``
        band; the already-materialized band is never re-built, and pairs
        that cannot reach the new band are skipped outright.

        ``g`` must be labeled in the sweep's own coordinates (as for
        :meth:`solve`); the planner remaps cached canonical sweeps first.
        Returns a **new** Sweep (``self`` is not mutated) whose
        ``extract(B)`` is bit-identical to a fresh
        ``sweep(g, family, cap=cap)`` at every ``B ≤ cap``.
        """
        if self.cap is None or (cap is not None and cap <= self.cap):
            return self  # already covers the requested range
        family = [from_mask(mk) for mk in self.family_masks]
        return sweep(g, family, self.objective, max_states=max_states,
                     cap=cap, prior=self)

    # ------------------------------------------------------------ extraction

    def _terminal_t(self, budget: float) -> Optional[float]:
        term = self.cells[self.full_id]
        ts = [t for t, cell in term.items() if cell.min_peak() <= budget]
        if not ts:
            return None
        return max(ts) if self.objective == "memory_centric" else min(ts)

    def extract(self, budget: float) -> Tuple[bool, float, List[int]]:
        """Budget-B projection: ``(feasible, overhead, sequence-of-masks)``.

        The mask sequence excludes ∅ and is expressed in the sweep's own
        coordinates (see class docstring).
        """
        if not self.covers(budget):
            raise ValueError(
                f"budget {budget!r} beyond this sweep's cap {self.cap!r}"
            )
        t_star = self._terminal_t(budget)
        if t_star is None:
            return False, INF, []
        return True, t_star, self._traceback(budget, t_star)

    def _traceback(self, budget: float, t_star: float) -> List[int]:
        """Mask sequence of the budget-B winner ending at terminal t_star."""
        masks: List[int] = []
        pid, pt = self.full_id, t_star
        while pid >= 0:
            cell = self.cells[pid][pt]
            k = cell.winner(budget)
            if self.family_masks[pid]:
                masks.append(self.family_masks[pid])
            pid, pt = cell.parent_ids[k], cell.parent_ts[k]
        masks.reverse()
        return masks

    def terminal_candidates(self, budget: float) -> List[float]:
        """Every feasible terminal overhead at ``budget``, ascending.

        Each entry is a distinct Pareto plan the budget admits —
        ``extract_at(budget, t)`` materializes any of them, and the
        wall-clock objective ranks them all by replayed time instead of
        taking the min/max one.
        """
        if not self.covers(budget):
            raise ValueError(
                f"budget {budget!r} beyond this sweep's cap {self.cap!r}"
            )
        term = self.cells[self.full_id]
        return sorted(
            t for t, cell in term.items() if cell.min_peak() <= budget
        )

    def extract_at(self, budget: float, t: float) -> List[int]:
        """Mask sequence of the plan ending at terminal overhead ``t``."""
        cell = self.cells[self.full_id].get(t)
        if cell is None or cell.min_peak() > budget:
            raise ValueError(
                f"terminal t={t!r} is not feasible at budget {budget!r}"
            )
        return self._traceback(budget, t)

    def extract_wallclock(
        self, g: Graph, budget: float,
        profile: Optional["OpProfile"] = None, **replay_kw: Any,
    ) -> DPResult:
        """Replay-ranked extraction: the minimal replayed-seconds terminal.

        ``g`` must be labeled in the sweep's coordinates.  Feasibility is
        unchanged from the other objectives (peak-based); only the choice
        among feasible terminals differs.  ``replay_kw`` forwards to
        :func:`repro_torch.core.replay.replay` (``mesh=``, ``comm_bytes=``, ...).
        """
        from .replay import rank_by_replay

        ts = self.terminal_candidates(budget)
        if not ts:
            return DPResult([], INF, INF, feasible=False,
                            states_visited=self.states_visited)
        seqs = [
            [from_mask(mk) for mk in self._traceback(budget, t)] for t in ts
        ]
        replay_kw.setdefault("budget", budget)
        idx, plan, _res = rank_by_replay(g, seqs, profile=profile, **replay_kw)
        return DPResult(
            sequence=seqs[idx],
            overhead=ts[idx],
            peak_memory=plan.peak_memory,
            feasible=True,
            states_visited=self.states_visited,
        )

    def solve(self, g: Graph, budget: float) -> DPResult:
        """``solve(g, budget, family, objective)`` via frontier lookup.

        ``g`` must be labeled in the sweep's coordinates (i.e. the graph the
        sweep was built from); the planner handles relabeled graphs itself.
        """
        if self.objective == "wallclock":
            return self.extract_wallclock(g, budget)
        ok, t_star, masks = self.extract(budget)
        if not ok:
            return DPResult([], INF, INF, feasible=False,
                            states_visited=self.states_visited)
        sequence = [from_mask(mk) for mk in masks]
        return DPResult(
            sequence=sequence,
            overhead=t_star,
            peak_memory=peak_memory_live(g, sequence),
            feasible=True,
            states_visited=self.states_visited,
        )

    def min_feasible_budget(self) -> float:
        """Exact minimal feasible budget: min over terminal cells of the
        smallest achievable peak (replaces the §5.1 binary search).

        On a capped sweep, INF means "infeasible within the cap", not
        globally infeasible — ``dp.min_feasible_budget_exact`` answers the
        uncapped question in one cheap scalar pass.
        """
        term = self.cells[self.full_id]
        return min((cell.min_peak() for cell in term.values()), default=INF)

    def frontier(self) -> List[Tuple[float, float]]:
        """(budget, overhead) Pareto staircase at the terminal state.

        Returns the critical budgets in increasing order with the overhead
        each unlocks; ``extract(B)`` for any ``B`` equals the entry with the
        largest budget ≤ B.  Time-centric: overhead strictly decreasing.
        Memory-centric: overhead strictly increasing (§4.4 maximizes).
        """
        term = self.cells[self.full_id]
        # empty cells (every candidate above the cap) carry peak = INF and
        # would otherwise emit phantom staircase entries
        pts = sorted(
            (cell.min_peak(), t) for t, cell in term.items() if cell.peaks
        )
        out: List[Tuple[float, float]] = []
        better = (lambda a, b: a > b) if self.objective == "memory_centric" else (
            lambda a, b: a < b)
        for peak, t in pts:
            if not out or better(t, out[-1][1]):
                if out and out[-1][0] == peak:
                    out[-1] = (peak, t)
                else:
                    out.append((peak, t))
        return out

    # ---------------------------------------------------------- relabeling

    def remap(self, mapping: Dict[int, int]) -> "Sweep":
        """New Sweep with every family mask pushed through ``mapping``."""
        remapped = []
        for mask in self.family_masks:
            m2 = 0
            for v in mask_iter(mask):
                m2 |= 1 << mapping[v]
            remapped.append(m2)
        return dataclasses.replace(self, family_masks=remapped)

    def to_canonical(self, to_pos: Dict[int, int]) -> "Sweep":
        """Sweep re-expressed in canonical positions (cache storage form)."""
        return self.remap(to_pos)

    # -------------------------------------------------------- serialization

    def encode(self) -> dict:
        """JSON-able form (store sweeps in canonical coordinates)."""
        return {
            "objective": self.objective,
            "cap": self.cap,
            "n": self.n,
            "family": [sorted(mask_iter(mk)) for mk in self.family_masks],
            "cells": [
                [
                    [t, cell.peaks, cell.ms, cell.parent_ids, cell.parent_ts]
                    for t, cell in sorted(cdict.items())
                ]
                for cdict in self.cells
            ],
            "states_visited": int(self.states_visited),
        }


class _SCell(_Cell):
    """A sweep cell that additionally remembers each candidate's strategy
    option (index into ``StrategySweep.opt_tab``)."""

    __slots__ = ("opt_ids",)

    def __init__(self):
        super().__init__()
        self.opt_ids: List[int] = []

    def insert_opt(self, m: float, peak: float, pos: int, pid: int,
                   pt: float, oc: int) -> None:
        """:meth:`_Cell.insert` with the option id carried alongside."""
        peaks = self.peaks
        ms = self.ms
        poss = self.poss
        i = bisect_left(peaks, peak)
        if i > 0:
            pm = ms[i - 1]
            if pm < m or (pm == m and poss[i - 1] <= pos):
                return
        j = i
        n = len(peaks)
        while j < n:
            jm = ms[j]
            if jm > m or (jm == m and poss[j] >= pos):
                j += 1
            else:
                break
        if j < n and peaks[j] == peak:
            return
        del peaks[i:j], ms[i:j], poss[i:j]
        del self.parent_ids[i:j], self.parent_ts[i:j], self.opt_ids[i:j]
        peaks.insert(i, peak)
        ms.insert(i, m)
        poss.insert(i, pos)
        self.parent_ids.insert(i, pid)
        self.parent_ts.insert(i, pt)
        self.opt_ids.insert(i, oc)

    def copy(self) -> "_SCell":
        out = _SCell()
        out.peaks = list(self.peaks)
        out.ms = list(self.ms)
        out.poss = list(self.poss)
        out.parent_ids = list(self.parent_ids)
        out.parent_ts = list(self.parent_ts)
        out.opt_ids = list(self.opt_ids)
        return out


@dataclasses.dataclass
class StrategySweep(Sweep):
    """Budget-free surface of the joint memory-strategy DP.

    ``opt_tab[k]`` is the ``(new_mask, codes)`` of one transition option;
    each cell candidate's ``opt_ids`` entry points into it, so a traceback
    recovers the per-node strategy assignment alongside the sequence.
    Strategy sweeps are in-memory objects: :meth:`encode` marks them with
    the config's digest token and ``decode_sweep`` refuses such entries,
    so they never alias a legacy surface in the plan cache.

    Tie-break note: when two strategy assignments reach a cell with the
    exact same carried mass ``m``, the cell keeps the lower-peak one while
    the per-budget ``_solve_strat`` table keeps the first writer — so
    :meth:`solve` here may return a *different equally-optimal* assignment
    than :func:`solve` (identical overhead and feasibility; both within
    budget).  The quantize byte ratio makes such exact ties more common
    than in the binary DP.
    """

    config: Optional[StrategyConfig] = None
    opt_tab: List[Tuple[int, Tuple[str, ...]]] = dataclasses.field(
        default_factory=list
    )

    def extend(self, g: Graph, cap: Optional[float] = None,
               max_states: Optional[int] = None) -> "Sweep":
        if self.cap is None or (cap is not None and cap <= self.cap):
            return self
        family = [from_mask(mk) for mk in self.family_masks]
        return sweep(g, family, self.objective, max_states=max_states,
                     cap=cap, strategies=self.config)

    def traceback_with_assignment(
        self, budget: float, t_star: float
    ) -> Tuple[List[int], Dict[int, str]]:
        """(mask sequence, merged node → strategy map) of the budget-B winner."""
        masks: List[int] = []
        assignment: Dict[int, str] = {}
        pid, pt = self.full_id, t_star
        while pid >= 0:
            cell = self.cells[pid][pt]
            assert isinstance(cell, _SCell)
            k = cell.winner(budget)
            if self.family_masks[pid]:
                masks.append(self.family_masks[pid])
            oc = cell.opt_ids[k]
            if oc >= 0:
                new_mask, codes = self.opt_tab[oc]
                assignment.update(assignment_of(new_mask, codes))
            pid, pt = cell.parent_ids[k], cell.parent_ts[k]
        masks.reverse()
        return masks, assignment

    def solve(self, g: Graph, budget: float) -> DPResult:
        if self.objective == "wallclock":
            return self.extract_wallclock(g, budget)
        ok, t_star, _masks = self.extract(budget)
        if not ok:
            return DPResult([], INF, INF, feasible=False,
                            states_visited=self.states_visited)
        masks, assignment = self.traceback_with_assignment(budget, t_star)
        sequence = [from_mask(mk) for mk in masks]
        return DPResult(
            sequence=sequence,
            overhead=t_star,
            peak_memory=peak_memory_live(g, sequence, assignment),
            feasible=True,
            states_visited=self.states_visited,
            assignment=assignment,
        )

    def extract_wallclock(
        self, g: Graph, budget: float,
        profile: Optional["OpProfile"] = None, **replay_kw: Any,
    ) -> DPResult:
        """Replay-ranked extraction over this surface's own candidates.

        Joint ranking against the legacy all-store surface lives in
        :func:`solve_wallclock` — that is the entry point that guarantees
        never-worse-than-legacy step time.
        """
        from .replay import rank_by_replay

        ts = self.terminal_candidates(budget)
        if not ts:
            return DPResult([], INF, INF, feasible=False,
                            states_visited=self.states_visited)
        pairs = [self.traceback_with_assignment(budget, t) for t in ts]
        seqs = [[from_mask(mk) for mk in masks] for masks, _a in pairs]
        replay_kw.setdefault("budget", budget)
        idx, plan, _res = rank_by_replay(
            g, seqs, assignments=[a for _m, a in pairs],
            strategies=self.config, profile=profile, **replay_kw,
        )
        return DPResult(
            sequence=seqs[idx],
            overhead=ts[idx],
            peak_memory=plan.peak_memory,
            feasible=True,
            states_visited=self.states_visited,
            assignment=pairs[idx][1],
        )

    def remap(self, mapping: Dict[int, int]) -> "StrategySweep":
        out = super().remap(mapping)
        tab = []
        for mask, codes in self.opt_tab:
            m2 = 0
            for v in mask_iter(mask):
                m2 |= 1 << mapping[v]
            tab.append((m2, codes))
        return dataclasses.replace(out, opt_tab=tab)

    def encode(self) -> dict:
        out = super().encode()
        out["strategy"] = self.config.digest_token() if self.config else ""
        return out


def _sweep_strat(g: Graph, family: Sequence[NodeSet], objective: str,
                 max_states: Optional[int], cap: Optional[float],
                 cfg: StrategyConfig) -> StrategySweep:
    """Budget-free joint memory-strategy sweep (scalar in both modes).

    One implementation serves vectorized and ``REPRO_DP_SCALAR=1``
    sessions alike — trivially bit-identical across modes; the strategy
    surface's option fan-out is frontier-bounded on the segment-structured
    graphs the planner sweeps, so the scalar loop is not the bottleneck.
    Candidate floats are folded exactly as :func:`_solve_strat_scalar`
    does (``m + option.m_add``, ``t + (t_step + option.tax)``,
    ``max(peak, m + m_fixed)``), so projecting the surface at a budget
    lands on the same feasibility thresholds the per-budget joint DP
    filters on.
    """
    tc = objective != "memory_centric"  # "wallclock" sweeps the TC surface
    infos = _prepare(g, family)
    order = sorted(range(len(infos)), key=lambda i: infos[i].size)
    pos_of = [0] * len(order)
    for p, i in enumerate(order):
        pos_of[i] = p
    sizes = [infos[i].size for i in order]
    full_mask = (1 << g.n) - 1
    empty_id = full_id = -1
    for i, info in enumerate(infos):
        if info.mask == 0:
            empty_id = i
        if info.mask == full_mask:
            full_id = i
    if empty_id < 0 or full_id < 0:
        raise ValueError("family must contain ∅ and V")

    cells: List[Dict[float, _Cell]] = [{} for _ in infos]
    seed = _SCell()
    seed.insert_opt(0.0, 0.0, -1, -1, 0.0, -1)
    cells[empty_id][0.0] = seed
    opt_tab: List[Tuple[int, Tuple[str, ...]]] = []

    states = 0
    state_cap = max_states if max_states is not None else INF
    budget_cap = cap if cap is not None else INF
    n_fam = len(order)

    for pos, i in enumerate(order):
        info_L = infos[i]
        cdict = cells[i]
        if not cdict:
            continue
        # Source-side (m, peak) frontier over cells in t order — identical
        # dominance rule to the legacy scalar sweep.
        fr_m: List[float] = []
        fr_p: List[float] = []
        expansions: List[Tuple[float, List[float], List[float]]] = []
        for t in sorted(cdict, reverse=not tc):
            cell = cdict[t]
            kms: List[float] = []
            kpeaks: List[float] = []
            for k in range(len(cell.peaks) - 1, -1, -1):  # m asc / peak desc
                m, peak = cell.ms[k], cell.peaks[k]
                idx = bisect_right(fr_m, m) - 1
                if idx >= 0 and fr_p[idx] <= peak:
                    continue
                kms.append(m)
                kpeaks.append(peak)
            if kms:
                expansions.append((t, kms, kpeaks))
            for m, peak in zip(kms, kpeaks):
                idx = bisect_right(fr_m, m) - 1
                if idx >= 0 and fr_p[idx] <= peak:
                    continue
                lo = bisect_left(fr_m, m)
                hi = lo
                while hi < len(fr_m) and fr_p[hi] >= peak:
                    hi += 1
                del fr_m[lo:hi], fr_p[lo:hi]
                fr_m.insert(lo, m)
                fr_p.insert(lo, peak)

        if not expansions:
            continue
        mask_L = info_L.mask
        src_pos = pos_of[i]
        start = bisect_right(sizes, info_L.size)
        for jpos in range(start, n_fam):
            j = order[jpos]
            info_Lp = infos[j]
            if mask_L & ~info_Lp.mask:
                continue  # L ⊄ L'
            Vp_mask = info_Lp.mask & ~mask_L
            inter = Vp_mask & info_Lp.cache_mask
            t_step = (info_Lp.T - info_L.T) - _mask_T(g, inter)
            new_mask = info_Lp.cache_mask & ~mask_L
            m_fixed = transition_excess(
                g, mask_L, info_Lp.mask, info_Lp.boundary_mask
            )
            target = cells[j]
            for opt in transition_options(g, cfg, new_mask, tc):
                t_step_o = t_step + opt.tax if tc else t_step
                oc = len(opt_tab)
                oc_used = False
                for t, kms, kpeaks in expansions:
                    t2 = t + t_step_o
                    cell2 = target.get(t2)
                    for k in range(len(kms)):
                        m = kms[k]
                        peak = kpeaks[k]
                        Mi = m + m_fixed  # same floats as the joint DP
                        if Mi > peak:
                            peak = Mi
                        if peak > budget_cap:
                            continue
                        states += 1
                        if cell2 is None:
                            cell2 = target[t2] = _SCell()
                        assert isinstance(cell2, _SCell)
                        cell2.insert_opt(
                            m + opt.m_add, peak, src_pos, i, t, oc
                        )
                        oc_used = True
                if oc_used:
                    opt_tab.append((new_mask, opt.codes))
        if states > state_cap:
            raise SweepOverflow(
                f"strategy sweep exceeded max_states={max_states} "
                f"({states} transitions; family of {n_fam})"
            )

    return StrategySweep(
        objective=objective,
        n=g.n,
        family_masks=[info.mask for info in infos],
        cells=cells,
        empty_id=empty_id,
        full_id=full_id,
        states_visited=states,
        cap=cap,
        config=cfg,
        opt_tab=opt_tab,
    )


def decode_sweep(entry: dict) -> Optional[Sweep]:
    """Inverse of ``Sweep.encode``; returns None on any malformed input."""
    try:
        if entry.get("strategy"):
            return None  # strategy surfaces are in-memory only
        objective = entry["objective"]
        if objective not in ("time_centric", "memory_centric", "wallclock"):
            return None
        n = int(entry["n"])
        family_masks = [to_mask(members) for members in entry["family"]]
        full_mask = (1 << n) - 1
        empty_id = family_masks.index(0)
        full_id = family_masks.index(full_mask)
        sizes = [mk.bit_count() for mk in family_masks]
        order = sorted(range(len(family_masks)), key=lambda i: sizes[i])
        pos_of = [0] * len(order)
        for p, i in enumerate(order):
            pos_of[i] = p
        cells: List[Dict[float, _Cell]] = []
        for cdict_enc in entry["cells"]:
            cdict: Dict[float, _Cell] = {}
            for t, peaks, ms, pids, pts in cdict_enc:
                cell = _Cell()
                cell.peaks = [float(x) for x in peaks]
                cell.ms = [float(x) for x in ms]
                cell.parent_ids = [int(x) for x in pids]
                cell.parent_ts = [float(x) for x in pts]
                cell.poss = [
                    pos_of[pid] if pid >= 0 else -1 for pid in cell.parent_ids
                ]
                k = len(cell.peaks)
                if not (len(cell.ms) == len(cell.parent_ids)
                        == len(cell.parent_ts) == k) or k == 0:
                    return None
                cdict[float(t)] = cell
            cells.append(cdict)
        if len(cells) != len(family_masks):
            return None
        cap = entry.get("cap")
        return Sweep(
            objective=objective,
            n=n,
            family_masks=family_masks,
            cells=cells,
            empty_id=empty_id,
            full_id=full_id,
            states_visited=int(entry.get("states_visited", 0)),
            cap=float(cap) if cap is not None else None,
        )
    except (KeyError, IndexError, TypeError, ValueError):
        return None


def _finalize_cell(
    pk: NDArray[np.float64],
    mm: NDArray[np.float64],
    po: NDArray[np.int64],
    pid: NDArray[np.int64],
    pt: NDArray[np.float64],
) -> _Cell:
    """Canonical (peak, (m, pos)) frontier of one cell's gathered candidates.

    Reproduces what a sequence of :meth:`_Cell.insert` calls retains: the
    Pareto-minimal set under (peak ≤, (m, pos) lex ≤) with duplicates
    collapsed — order-independent, so one sort + strict prefix-min scan
    over a lex *rank* of (m, pos) equals the incremental result.
    """
    o2 = np.lexsort((po, mm))
    rk = np.empty(len(mm), dtype=np.int64)
    ch = np.empty(len(mm), dtype=np.int64)
    ch[0] = 0
    ch[1:] = np.cumsum(
        (mm[o2][1:] != mm[o2][:-1]) | (po[o2][1:] != po[o2][:-1])
    )
    rk[o2] = ch
    o = np.lexsort((rk, pk))
    rks = rk[o]
    keep = np.empty(len(o), dtype=bool)
    keep[0] = True
    pm = np.minimum.accumulate(rks)
    keep[1:] = rks[1:] < pm[:-1]
    ks = o[keep]
    cell = _Cell()
    cell.peaks = [float(x) for x in pk[ks]]
    cell.ms = [float(x) for x in mm[ks]]
    cell.poss = [int(x) for x in po[ks]]
    cell.parent_ids = [int(x) for x in pid[ks]]
    cell.parent_ts = [float(x) for x in pt[ks]]
    return cell


# A pending-candidate column: a full per-candidate array, or one scalar
# broadcast over the chunk (chunks from a single expansion share their
# source position/id, so materializing constant columns is wasted work).
_Col = Union[float, int, NDArray[np.float64], NDArray[np.int64]]


def _fill_col(vals: Sequence[_Col], counts: Sequence[int], total: int,
              dtype: type) -> np.ndarray:
    """Concatenate mixed scalar/array columns into one array.

    Scalars broadcast over their chunk's length — the assembly-time
    equivalent of the ``np.full`` columns chunks used to carry.
    """
    out = np.empty(total, dtype=dtype)
    off = 0
    for v, c in zip(vals, counts):
        out[off:off + c] = v
        off += c
    return out


def _sweep_vec(g: Graph, family: Sequence[NodeSet], objective: str,
               max_states: Optional[int], cap: Optional[float],
               prior: Optional[Sweep]) -> Sweep:
    """Vectorized :func:`sweep` — gather-then-filter frontier merges.

    Candidates bound for a cell are buffered as raw array chunks and
    canonically filtered once when the cell's lower set becomes a source
    (:func:`_finalize_cell`); per-pair expansion windows, cap filters and
    the work counter are evaluated as one (J targets × ΣF candidates)
    block per source, with the source's cells laid out as contiguous
    column segments (the per-cell crossover scan becomes a segmented
    min-reduce).  Small graphs are dominated by per-call overhead, so the
    kernel touches numpy O(sources) times, not O(source cells) times.
    """
    tc = objective != "memory_centric"  # "wallclock" sweeps the TC surface
    vp = _vec_prep(g, family)
    _require_terminals(vp)
    n_infos = len(vp.infos)
    n_fam = len(vp.order)

    # pending chunks per set: (t, peak, m, pos, parent_id, parent_t)
    pend: List[
        List[Tuple[_Col, NDArray[np.float64], NDArray[np.float64],
                   _Col, _Col, _Col]]
    ] = [[] for _ in range(n_infos)]

    skip_cap = -INF
    prior_states = 0
    if prior is not None:
        if prior.objective != objective:
            raise ValueError(
                f"prior sweep objective {prior.objective!r} != {objective!r}"
            )
        if prior.family_masks != [info.mask for info in vp.infos]:
            raise ValueError("prior sweep was built over a different family")
        if prior.cap is None or (cap is not None and cap <= prior.cap):
            return prior  # nothing to extend
        skip_cap = prior.cap
        prior_states = prior.states_visited
        for j, cdict_prior in enumerate(prior.cells):
            for t, cell in cdict_prior.items():
                pend[j].append((
                    t,
                    np.asarray(cell.peaks, dtype=np.float64),
                    np.asarray(cell.ms, dtype=np.float64),
                    np.asarray(cell.poss, dtype=np.int64),
                    np.asarray(cell.parent_ids, dtype=np.int64),
                    np.asarray(cell.parent_ts, dtype=np.float64),
                ))
    else:
        zero = np.zeros(1, dtype=np.float64)
        pend[vp.empty_id].append((0.0, zero, zero, -1, -1, 0.0))

    states = 0
    state_cap = max_states if max_states is not None else INF
    budget_cap = cap if cap is not None else INF
    cells: List[Dict[float, _Cell]] = [{} for _ in range(n_infos)]
    empty_f = np.zeros(0, dtype=np.float64)

    for pos, i in enumerate(vp.order):
        chunks = pend[i]
        pend[i] = []
        cdict = cells[i]
        if chunks:
            counts = [len(c[1]) for c in chunks]
            total = sum(counts)
            tt = _fill_col([c[0] for c in chunks], counts, total, np.float64)
            pk = np.concatenate([c[1] for c in chunks])
            mm = np.concatenate([c[2] for c in chunks])
            po = _fill_col([c[3] for c in chunks], counts, total, np.int64)
            pidv = _fill_col([c[4] for c in chunks], counts, total, np.int64)
            ptv = _fill_col([c[5] for c in chunks], counts, total, np.float64)
            ts_u, inv = np.unique(tt, return_inverse=True)
            so = np.argsort(inv, kind="stable")
            bnd = np.concatenate(
                [np.zeros(1, dtype=np.int64), np.cumsum(np.bincount(inv))]
            )
            for gi in range(len(ts_u)):
                idx = so[bnd[gi]:bnd[gi + 1]]
                cdict[float(ts_u[gi])] = _finalize_cell(
                    pk[idx], mm[idx], po[idx], pidv[idx], ptv[idx]
                )
        if not cdict:
            continue

        # Source-side pruning — the scalar running (m, peak) frontier over
        # cells in t order, with the per-cell scans batched.
        fr_m = empty_f
        fr_p = empty_f
        expansions: List[Tuple[float, NDArray[np.float64], NDArray[np.float64]]] = []
        for t in sorted(cdict, reverse=not tc):
            cell = cdict[t]
            m_a = np.asarray(cell.ms[::-1], dtype=np.float64)  # m asc / peak desc
            p_a = np.asarray(cell.peaks[::-1], dtype=np.float64)
            if len(fr_m):
                idx = np.searchsorted(fr_m, m_a, side="right") - 1
                dom = (idx >= 0) & (fr_p[np.maximum(idx, 0)] <= p_a)
                kms, kp = m_a[~dom], p_a[~dom]
            else:
                kms, kp = m_a, p_a
            if len(kms) == 0:
                continue
            expansions.append((t, kms, kp))
            am = np.concatenate([fr_m, kms])
            ap = np.concatenate([fr_p, kp])
            o = np.lexsort((ap, am))
            am, ap = am[o], ap[o]
            keep = _pareto_keep(am, ap)
            fr_m, fr_p = am[keep], ap[keep]

        if not expansions:
            continue
        tg = vp.targets[pos]
        j_cnt = len(tg)
        if j_cnt:
            mf = _price_row(g, vp, pos)
            m_step = vp.m_step[pos]
            t_step = vp.t_step[pos]
            # All of this source's cells in one block: columns are the
            # flattened per-cell candidates, contiguous per cell.
            t_cells = np.array([e[0] for e in expansions], dtype=np.float64)
            seg_len = np.array([len(e[1]) for e in expansions],
                               dtype=np.int64)
            seg_bnd = np.concatenate(
                [np.zeros(1, dtype=np.int64), np.cumsum(seg_len)]
            )
            f_tot = int(seg_bnd[-1])
            kms = np.concatenate([e[1] for e in expansions])
            kp = np.concatenate([e[2] for e in expansions])
            cell_of = np.repeat(
                np.arange(len(expansions), dtype=np.int64), seg_len
            )
            cols = np.arange(f_tot, dtype=np.int64)
            k_local = cols - seg_bnd[cell_of]
            # crossover: first k with kpeaks[k] <= kms[k] + m_fixed —
            # expansion stops one past it (see the scalar comment);
            # per (target, cell) via a segmented min over flagged columns
            pred = kp[None, :] <= (kms[None, :] + mf[:, None])
            first = np.minimum.reduceat(
                np.where(pred, cols[None, :], f_tot), seg_bnd[:-1], axis=1
            )
            found = first < seg_bnd[1:][None, :]
            end = np.where(
                found, first - seg_bnd[:-1][None, :] + 1, seg_len[None, :]
            )
            if prior is not None:
                # extension: cells already inside the old band only keep
                # pairs that can reach the new band
                old_cell = kp[seg_bnd[:-1]] <= skip_cap  # kp[0] per cell
                last_m = kms[seg_bnd[1:] - 1]            # kms[-1] per cell
                end = np.where(
                    old_cell[None, :]
                    & ((last_m[None, :] + mf[:, None]) <= skip_cap),
                    0, end,
                )
            if prior is None:
                states += int(end.sum())
            active = k_local[None, :] < end[:, cell_of]
            peak = np.maximum(kms[None, :] + mf[:, None], kp[None, :])
            okc = active & (peak <= budget_cap) & (peak > skip_cap)
            if prior is not None:
                states += int(okc.sum())  # new-band work only
            if okc.any():
                m2 = kms[None, :] + m_step[:, None]
                t2 = t_cells[None, :] + t_step[:, None]  # (J, cells)
                jj_nz, kk_nz = np.nonzero(okc)
                sel_cell = cell_of[kk_nz]
                pk_sel = peak[jj_nz, kk_nz]
                m2_sel = m2[jj_nz, kk_nz]
                t2_sel = t2[jj_nz, sel_cell]
                pt_sel = t_cells[sel_cell]
                bnds = np.searchsorted(jj_nz, np.arange(j_cnt + 1))
                for jj in range(j_cnt):
                    a, b = int(bnds[jj]), int(bnds[jj + 1])
                    if a == b:
                        continue
                    pend[int(tg[jj])].append((
                        t2_sel[a:b],
                        pk_sel[a:b],
                        m2_sel[a:b],
                        pos,
                        i,
                        pt_sel[a:b],
                    ))
        if prior_states + states > state_cap:
            raise SweepOverflow(
                f"budget sweep exceeded max_states={max_states} "
                f"({prior_states + states} transitions; family of {n_fam})"
            )

    return Sweep(
        objective=objective,
        n=g.n,
        family_masks=[info.mask for info in vp.infos],
        cells=cells,
        empty_id=vp.empty_id,
        full_id=vp.full_id,
        states_visited=prior_states + states,
        cap=cap,
    )


def sweep(g: Graph, family: Sequence[NodeSet],
          objective: str = "time_centric",
          max_states: Optional[int] = None,
          cap: Optional[float] = None,
          prior: Optional[Sweep] = None,
          strategies: Optional[StrategyConfig] = None) -> Sweep:
    """One budget-free DP pass carrying ``(t, m, peak)`` frontiers.

    Identical transition structure to :func:`solve` (liveness functional —
    the cached-surface contract is versioned by :data:`MEMORY_FUNCTIONAL`),
    with 𝓜⁽ⁱ⁾ folded into each chain's running ``peak`` instead of
    compared against a budget.  The source-side Pareto pruning mirrors :func:`_pareto` /
    :func:`_pareto_mc` with the peak coordinate added, so for every budget
    the set of expanded transitions is a superset of the per-budget DP's —
    and the per-cell ``(m, pos)`` tie-break makes ``extract`` land on the
    same plan the per-budget DP would have returned.

    Bit-identity holds in *float* arithmetic, not just on paper: every
    expression a candidate carries — the left-folded cache mass
    ``m + m_step`` and the peak ``max(peak, m + m_fixed)`` — is written
    identically to :func:`solve`'s, so ``extract(B)`` compares B against
    the very same float values the per-budget DP filters on.  (No
    re-associated shortcuts here: an ulp of drift in a peak moves a
    feasibility threshold and silently changes which plan a budget maps
    to.)

    ``max_states`` caps the transition work; a surface wider than the cap
    raises :class:`SweepOverflow` (deterministically for a given problem)
    so callers can fall back to per-budget solves.

    ``cap`` bounds the swept budget range: transitions whose peak exceeds
    ``cap`` are dropped — exactly the per-budget DP's ``𝓜⁽ⁱ⁾ > B`` filter
    at ``B = cap`` — so the sweep costs roughly one ``solve`` at the
    *largest* budget of interest times the number of regimes below it,
    instead of the full surface.  ``extract(B)`` stays bit-identical for
    every ``B ≤ cap`` and raises beyond it.

    ``prior`` (normally via :meth:`Sweep.extend`) seeds the pass with an
    existing capped sweep over the *same* graph/family/objective: only
    candidates with peak in ``(prior.cap, cap]`` are inserted, and
    transition pairs that cannot reach that band are skipped, so growing a
    cap costs the new band, not a rebuild.  ``states_visited`` then counts
    the prior's work plus this pass's *new* expansion work only.
    """
    if objective not in ("time_centric", "memory_centric", "wallclock"):
        raise ValueError(f"unknown objective {objective!r}")
    if strategies is not None and strategies.extended:
        if prior is not None:
            raise ValueError(
                "strategy sweeps do not support lazy extension from a "
                "prior surface; rebuild with the larger cap"
            )
        return _sweep_strat(g, family, objective, max_states, cap, strategies)
    if not scalar_only():
        return _sweep_vec(g, family, objective, max_states, cap, prior)
    # "wallclock" shares the time-centric transition structure bit-for-bit
    # (the surface is objective-agnostic; only extraction ranks by replay).
    tc = objective != "memory_centric"

    infos = _prepare(g, family)
    order = sorted(range(len(infos)), key=lambda i: infos[i].size)
    pos_of = [0] * len(order)
    for p, i in enumerate(order):
        pos_of[i] = p
    full_mask = (1 << g.n) - 1

    empty_id = None
    full_id = None
    for i, info in enumerate(infos):
        if info.mask == 0:
            empty_id = i
        if info.mask == full_mask:
            full_id = i
    if empty_id is None or full_id is None:
        raise ValueError("family must contain ∅ and V")

    skip_cap = -INF  # candidates with peak ≤ skip_cap are already present
    prior_states = 0
    if prior is not None:
        if prior.objective != objective:
            raise ValueError(
                f"prior sweep objective {prior.objective!r} != {objective!r}"
            )
        if prior.family_masks != [info.mask for info in infos]:
            raise ValueError("prior sweep was built over a different family")
        if prior.cap is None or (cap is not None and cap <= prior.cap):
            return prior  # nothing to extend
        skip_cap = prior.cap
        prior_states = prior.states_visited
        cells = [
            {t: cell.copy() for t, cell in cdict.items()}
            for cdict in prior.cells
        ]
    else:
        cells = [{} for _ in infos]

    states = 0
    state_cap = max_states if max_states is not None else INF
    budget_cap = cap if cap is not None else INF
    n_fam = len(order)
    sizes = [infos[i].size for i in order]

    if prior is None:
        seed = _Cell()
        seed.insert(0.0, 0.0, -1, -1, 0.0)
        cells[empty_id][0.0] = seed

    for pos, i in enumerate(order):
        info_L = infos[i]
        cdict = cells[i]
        if not cdict:
            continue
        # Source-side pruning, the sweep analogue of _pareto/_pareto_mc: a
        # candidate is skipped when a strictly-better-t cell (smaller t for
        # TC, larger for MC) holds one with m' ≤ m and peak' ≤ peak — for
        # every budget where the skipped candidate is its cell's projection
        # winner, the per-budget DP prunes the cell too.  fr_m ascending /
        # fr_p strictly descending is the running (m, peak) frontier.
        fr_m: List[float] = []
        fr_p: List[float] = []
        # per surviving cell: (t, ms ascending, peaks descending)
        expansions: List[Tuple[float, List[float], List[float]]] = []
        for t in sorted(cdict, reverse=not tc):
            cell = cdict[t]
            kms: List[float] = []
            kpeaks: List[float] = []
            for k in range(len(cell.peaks) - 1, -1, -1):  # m asc / peak desc
                m, peak = cell.ms[k], cell.peaks[k]
                idx = bisect_right(fr_m, m) - 1
                if idx >= 0 and fr_p[idx] <= peak:
                    continue
                kms.append(m)
                kpeaks.append(peak)
            if kms:
                expansions.append((t, kms, kpeaks))
            for m, peak in zip(kms, kpeaks):
                idx = bisect_right(fr_m, m) - 1
                if idx >= 0 and fr_p[idx] <= peak:
                    continue
                lo = bisect_left(fr_m, m)
                hi = lo
                while hi < len(fr_m) and fr_p[hi] >= peak:
                    hi += 1
                del fr_m[lo:hi], fr_p[lo:hi]
                fr_m.insert(lo, m)
                fr_p.insert(lo, peak)

        if not expansions:
            continue
        mask_L = info_L.mask
        src_pos = pos_of[i]
        start = bisect_right(sizes, info_L.size)
        for jpos in range(start, n_fam):
            j = order[jpos]
            info_Lp = infos[j]
            if mask_L & ~info_Lp.mask:
                continue  # L ⊄ L'
            Vp_mask = info_Lp.mask & ~mask_L
            inter = Vp_mask & info_Lp.cache_mask
            t_step = (info_Lp.T - info_L.T) - _mask_T(g, inter)
            m_step = _mask_M(g, info_Lp.cache_mask & ~mask_L)
            m_fixed = transition_excess(
                g, mask_L, info_Lp.mask, info_Lp.boundary_mask
            )
            target = cells[j]
            for t, kms, kpeaks in expansions:
                if kpeaks[0] <= skip_cap and kms[-1] + m_fixed <= skip_cap:
                    continue  # extension: every candidate is in the old band
                t2 = t + t_step
                # cells materialize only when a candidate survives the cap
                # filters below — a husk cell would make the encoded sweep
                # undecodable (decode_sweep rejects empty cells), silently
                # defeating the cache for capped surfaces
                cell2 = target.get(t2)
                # Once this transition's own 𝓜⁽ⁱ⁾ = m + m_fixed reaches a
                # candidate's carried peak, peak₂ = m + m_fixed grows with m
                # exactly as m₂ does — every candidate past the first such
                # one arrives strictly dominated (same source position), so
                # expansion stops one past the crossover.  kpeaks descends
                # and m + m_fixed ascends, so the predicate flips once.
                lo, hi = 0, len(kms)
                while lo < hi:
                    mid = (lo + hi) // 2
                    if kpeaks[mid] <= kms[mid] + m_fixed:
                        hi = mid
                    else:
                        lo = mid + 1
                end = lo + 1 if lo < len(kms) else lo
                if prior is None:
                    states += end
                # extension pass: counted per new-band candidate below —
                # each unit of count is a candidate that can actually grow
                # the surface, so cumulative extensions stay bounded by
                # max_states (a lower bound on a fresh build's count, i.e.
                # extensions never overflow where a fresh build would fit)
                # inlined _Cell.insert — this is the sweep's hot loop
                if cell2 is not None:
                    peaks2 = cell2.peaks
                    ms2 = cell2.ms
                    poss2 = cell2.poss
                    pids2 = cell2.parent_ids
                    pts2 = cell2.parent_ts
                for k in range(end):
                    m = kms[k]
                    peak = kpeaks[k]
                    Mi = m + m_fixed  # 𝓜⁽ⁱ⁾, same floats as solve()
                    if Mi > peak:
                        peak = Mi
                    if peak > budget_cap:
                        continue  # beyond the swept budget range
                    if peak <= skip_cap:
                        continue  # already materialized by the prior sweep
                    if prior is not None:
                        states += 1  # extension: count new-band work only
                    if cell2 is None:
                        cell2 = target[t2] = _Cell()
                        peaks2 = cell2.peaks
                        ms2 = cell2.ms
                        poss2 = cell2.poss
                        pids2 = cell2.parent_ids
                        pts2 = cell2.parent_ts
                    m2 = m + m_step
                    ci = bisect_left(peaks2, peak)
                    if ci > 0:
                        pm = ms2[ci - 1]
                        if pm < m2 or (pm == m2 and poss2[ci - 1] <= src_pos):
                            continue
                    cj = ci
                    cn = len(peaks2)
                    while cj < cn:
                        jm = ms2[cj]
                        if jm > m2 or (jm == m2 and poss2[cj] >= src_pos):
                            cj += 1
                        else:
                            break
                    if cj < cn and peaks2[cj] == peak:
                        continue
                    del peaks2[ci:cj], ms2[ci:cj], poss2[ci:cj]
                    del pids2[ci:cj], pts2[ci:cj]
                    peaks2.insert(ci, peak)
                    ms2.insert(ci, m2)
                    poss2.insert(ci, src_pos)
                    pids2.insert(ci, i)
                    pts2.insert(ci, t)
        # the cap bounds the *cumulative* surface (prior + extension): a
        # runaway sequence of lazy extensions trips it just as unbounded
        # fresh builds would (extension counts only surface-growing work,
        # so it is the permissive side of the fresh-build count)
        if prior_states + states > state_cap:
            raise SweepOverflow(
                f"budget sweep exceeded max_states={max_states} "
                f"({prior_states + states} transitions; family of {n_fam})"
            )

    return Sweep(
        objective=objective,
        n=g.n,
        family_masks=[info.mask for info in infos],
        cells=cells,
        empty_id=empty_id,
        full_id=full_id,
        states_visited=prior_states + states,
        cap=cap,
    )


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def exact_dp(
    g: Graph, budget: float, objective: str = "time_centric",
    limit: Optional[int] = None,
) -> DPResult:
    """§4.2 — DP over the full lattice 𝓛_G.

    ``limit`` caps the family enumeration; defaults to
    ``lower_sets.DEFAULT_LOWER_SET_LIMIT`` (the single source of truth
    shared with ``Planner`` and ``all_lower_sets``).
    """
    from .lower_sets import DEFAULT_LOWER_SET_LIMIT

    if limit is None:
        limit = DEFAULT_LOWER_SET_LIMIT
    return solve(g, budget, all_lower_sets(g, limit=limit), objective)


def approx_dp(g: Graph, budget: float, objective: str = "time_centric") -> DPResult:
    """§4.3 — DP over 𝓛_G^Pruned (keys = principal lower sets L^v)."""
    return solve(g, budget, pruned_lower_sets(g), objective)


# ---------------------------------------------------------------------------
# Strategy evaluation (shared with DFS / Chen / tests)
# ---------------------------------------------------------------------------


def cached_sets(g: Graph, sequence: Sequence[NodeSet]) -> List[NodeSet]:
    """U_i = ∪_{j≤i} (∂(L_j) ∪ (pins ∩ L_j)) for each prefix.

    With no ``must_store`` pins this is the paper's U_i exactly; pinned
    nodes (effect analysis) additionally join the cache at their own
    segment and are never recomputed.
    """
    pins = g.store_pins
    u: set = set()
    out = []
    for L in sequence:
        u |= g.boundary(L) | (pins & L)
        out.append(frozenset(u))
    return out


def overhead(g: Graph, sequence: Sequence[NodeSet]) -> float:
    """Eq. (1): T(V \\ U_k)."""
    U_k = cached_sets(g, sequence)[-1]
    allv = frozenset(range(g.n))
    return g.T(allv - U_k)


def peak_memory(g: Graph, sequence: Sequence[NodeSet]) -> float:
    """Eq. (2): max_i 𝓜⁽ⁱ⁾ (the paper's original segment-footprint model,
    kept for the Appendix C ablation — the DP itself prices transitions
    with :func:`peak_memory_live`)."""
    _check_functional("eq2", g)
    Us = cached_sets(g, sequence)
    peak = 0.0
    prev: NodeSet = EMPTY
    for i, L in enumerate(sequence):
        Vi = L - prev
        U_prev = Us[i - 1] if i > 0 else EMPTY
        dplus_out = g.delta_plus(L) - L
        dmd_out = g.delta_minus(g.delta_plus(L)) - L
        Mi = g.M(U_prev) + 2.0 * g.M(Vi) + g.M(dplus_out) + g.M(dmd_out)
        peak = max(peak, Mi)
        prev = L
    return peak


def peak_memory_live(g: Graph, sequence: Sequence[NodeSet],
                     assignment: Optional[Dict[int, str]] = None) -> float:
    """Liveness-tight analytic peak: max_i (M(U_{i-1}) + transition excess).

    The strategy evaluator of the DP's memory functional
    (``liveness.transition_excess`` per transition, cache mass left-folded
    exactly as the DP's ``m + m_step``) — for any valid schedule it equals
    ``liveness.simulate(g, sequence, liveness=True).peak_memory`` (the
    property test in tests/test_liveness.py pins this), and it is the value
    every feasible ``DPResult.peak_memory`` reports, so
    ``result.peak_memory ≤ budget`` holds exactly.

    ``assignment`` prices a strategy-annotated plan: the carried cache
    mass folds each node's *device* bytes (offloaded → 0, quantized →
    int8+scales; ``strategies.device_bytes``) while the per-transition
    excess stays at full bytes — a node lives on device at full precision
    during its own forward window (see ``core.strategies``).  The fold is
    float-identical to the joint DP's ``m + option.m_add``.
    """
    pins = g.store_pins_mask
    prev_mask = 0
    m = 0.0
    peak = 0.0
    w = device_bytes(g, assignment) if assignment else None
    for L in sequence:
        mask_Lp = to_mask(L)
        bd_mask = to_mask(g.boundary(L))
        # The excess is priced against the *true* boundary (gradient flow is
        # graph-structural); pins only add cache mass.
        Mi = m + transition_excess(g, prev_mask, mask_Lp, bd_mask)
        if Mi > peak:
            peak = Mi
        new_mask = (bd_mask | (pins & mask_Lp)) & ~prev_mask
        m = m + (_mask_M(g, new_mask) if w is None else _mask_M_w(w, new_mask))
        prev_mask = mask_Lp
    return peak


def quantize_times(g: Graph, levels: int = 64) -> Graph:
    """Rescale T_v to small positive integers so the DP's t-axis stays compact.

    Beyond-paper utility for FLOP-derived costs: T_v → max(1,
    round(levels · T_v / max_v T_v)).  The paper's {1, 10} costs pass through
    unchanged when levels ≥ 10·max/max.

    Degenerate graphs pass through unchanged: an empty graph has no times to
    rescale, and a graph whose times are all ≤ 0 (e.g. a pure-view subgraph
    assembled outside the ``Graph`` constructor's validation) has no usable
    scale — rescaling would divide by zero.
    """
    from .graph import Node

    if g.n == 0:
        return g
    tmax = max(g.time_v)
    if tmax <= 0:
        return g
    nodes = [
        Node(
            nd.idx,
            nd.name,
            float(max(1, round(levels * nd.time / tmax))),
            nd.memory,
            nd.kind,
            must_store=nd.must_store,
        )
        for nd in g.nodes
    ]
    return Graph(nodes, g.edges, cost_source=getattr(g, "cost_source", ""))
