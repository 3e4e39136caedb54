"""High-level planning API: solve the general recomputation problem for a
graph (or a traced JAX function) under a memory budget.

The paper's §5.1 protocol: "for the memory budget B … we chose the minimal
value B for which the solution … exists.  This value was determined using
binary search."  The budget-sweep engine (``core.dp.sweep``) retires that
search: ``min_feasible_budget`` reads the *exact* minimal budget off the
sweep's terminal frontier, and ``plan`` is the one-call front door used by
the framework.  Budgets are priced by the DP's liveness-tight memory
functional (``dp.MEMORY_FUNCTIONAL``; see core/dp.py) — a strategy is
feasible at B iff its last-use-liveness execution peak fits B.

Plan compilation pipeline (beyond-paper): planning is memoized through
``core.plan_cache`` behind a canonical graph digest.  For the DP methods
the cached object is a **budget-free sweep** — the full ``(t, m, peak)``
Pareto surface of ``core.dp.sweep``, stored under the ``sweep`` entry kind
keyed by ``(graph_digest, family, objective)`` with *no budget* — so one
cold solve admits every future budget query on that graph: per-budget
``solve`` calls become frontier lookups (bit-identical to the per-budget
DP), ``min_feasible_budget`` becomes a terminal-frontier min, and whole
trade-off grids (benchmarks/fig3_tradeoff.py) cost one DP pass.
``Planner`` is the stateful front door carrying the cache, a small decoded
sweep memo, and an optional measured cost model (``core.cost_model``); the
module-level ``plan``/``min_feasible_budget`` functions route through a
process-default ``Planner`` so existing callers inherit the caching
transparently.
"""

from __future__ import annotations

import dataclasses
import logging
import time as _time
from typing import List, Optional, Sequence, Tuple, Union

from . import dp as dp_mod
from .chen import chen_sqrt_n
from .cost_model import OpProfile, calibrated_graph
from .dp import DPResult, approx_dp, exact_dp, solve
from .graph import Graph, NodeSet, canonical_maps, graph_digest
from .liveness import simulate
from .lower_sets import all_lower_sets, pruned_lower_sets
from .plan_cache import PlanCache, SweepKey, default_cache
from .schedule import ExecutionPlan, make_plan
from .strategies import StrategyConfig

_LOG = logging.getLogger(__name__)


@dataclasses.dataclass
class PlanReport:
    """Everything the framework (and the benchmarks) need about one plan."""

    method: str  # "exact_dp" | "approx_dp" | "chen" | "vanilla"
    objective: str  # "time_centric" | "memory_centric" | "wallclock" | "-"
    budget: float
    result: DPResult
    plan: Optional[ExecutionPlan]
    peak_with_liveness: float
    peak_without_liveness: float
    plan_seconds: float
    # Replayed step time (core.replay, overlap on, budget-headroom overlap
    # stream) — filled for objective="wallclock" plans, None otherwise.
    replayed_seconds: Optional[float] = None

    @property
    def feasible(self) -> bool:
        return self.result.feasible


def _surface_objective(objective: str) -> str:
    """Sweep-surface key for an objective.

    "wallclock" shares the time-centric transition surface bit-for-bit
    (only *extraction* differs: replay ranking instead of min-t), so it
    reuses — and warms — the ``time_centric`` cache entry instead of
    storing a duplicate.
    """
    return "time_centric" if objective == "wallclock" else objective


def _family(g: Graph, method: str) -> Sequence[NodeSet]:
    """Canonical lower-set family for ``method``.

    ``exact_dp`` falls back to the pruned family (§4.3) when 𝓛_G overflows
    ``lower_sets.DEFAULT_LOWER_SET_LIMIT`` — that is the paper's own escape
    hatch for wide graphs, and it keeps the planner total (a logged note
    replaces the ``RuntimeError`` the raw enumeration raises).
    """
    if method == "exact_dp":
        from . import lower_sets

        try:
            return all_lower_sets(g, limit=lower_sets.DEFAULT_LOWER_SET_LIMIT)
        except RuntimeError as e:
            _LOG.warning(
                "exact lower-set family overflowed for %r (%s); "
                "falling back to the pruned family (§4.3)", g, e,
            )
            return pruned_lower_sets(g)
    if method == "approx_dp":
        return pruned_lower_sets(g)
    raise ValueError(method)


def _min_feasible_budget_uncached(
    g: Graph,
    method: str = "approx_dp",
    tol: float = 1e-3,
    family: Optional[Sequence[NodeSet]] = None,
) -> float:
    """Binary search the minimal B with a feasible canonical strategy (§5.1).

    Superseded by the exact terminal-frontier minimum of ``core.dp.sweep``
    (see ``Planner.min_feasible_budget``); kept as the paper-faithful
    reference that benchmarks/dp_runtime.py compares the sweep against.

    Bounds: any strategy needs at least max_v M_v; the single-segment
    strategy needs at most 2·M(V) plus one cached boundary value, so we
    search in [max_v M_v, 2·M(V) + max_v M_v] to relative tolerance
    ``tol``, using the fast feasibility-only DP (core.dp.feasible) per
    probe.  The returned budget is always one of the *feasible* probes
    (``hi`` only ever shrinks onto feasible midpoints), which the final
    check enforces.
    """
    from .dp import _prepare, feasible

    fam = list(family) if family is not None else list(_family(g, method))
    infos = _prepare(g, fam)
    lo = max(g.mem_v)
    hi = 2.0 * g.total_memory + max(g.mem_v)
    # verify hi feasible
    if not feasible(g, hi, fam, infos):
        raise RuntimeError("even the maximal budget is infeasible — bug")
    while hi - lo > tol * max(1.0, hi):
        mid = 0.5 * (lo + hi)
        if feasible(g, mid, fam, infos):
            hi = mid
        else:
            lo = mid
    if not feasible(g, hi, fam, infos):  # pragma: no cover — invariant guard
        raise RuntimeError(
            f"binary search returned an infeasible budget {hi!r} — bug"
        )
    return hi


class Planner:
    """Stateful planning front door: DP + plan cache + optional cost model.

    * ``cache``  — a ``core.plan_cache.PlanCache``; defaults to the process
      default cache (in-memory LRU, plus disk when a cache dir is attached).
    * ``profile``— an ``OpProfile`` from ``core.cost_model``; when set, every
      graph is re-priced to measured seconds and re-quantized before the DP,
      so the solved t-axis reflects the hardware instead of FLOP proxies.
    * ``quantize_levels`` — integer t-axis resolution for the calibration
      path (also usable without a profile to quantize FLOP-valued graphs).

    Budget sweeps: ``solve_grid``/``frontier`` build one **budget-free
    sweep** (``core.dp.sweep``) cached under ``(graph_digest, family,
    objective)`` — no budget in the key — and every ``solve`` first checks
    for one, so any budget on a swept graph is a frontier lookup,
    bit-identical to the per-budget DP.  When a later query outgrows a
    cached *capped* surface, the surface is **lazily extended**
    (``Sweep.extend``: only the new budget band is materialized; the cap
    only ever grows) instead of rebuilt.  ``min_feasible_budget`` is exact
    (one scalar pass, no binary search).  Custom lower-set families bypass
    the cache (their identity isn't captured by the method name).
    """

    CACHEABLE_METHODS = ("exact_dp", "approx_dp")

    def __init__(
        self,
        cache: Optional[PlanCache] = None,
        profile: Optional[OpProfile] = None,
        quantize_levels: Optional[int] = None,
        sweep_max_states: int = 10_000_000,
        strategies: Optional[Union[StrategyConfig, Sequence[str]]] = None,
    ):
        self.cache = default_cache() if cache is None else cache
        self.profile = profile
        self.quantize_levels = quantize_levels
        # Joint memory-strategy planning (core.strategies): a StrategyConfig
        # or a tuple of strategy names.  Names are priced with the profile's
        # measured host/codec bandwidths when one is attached.  A config
        # that enables nothing beyond {store, recompute} is normalized to
        # None — the planner then behaves (and caches) exactly as the
        # binary planner always has.
        if strategies is not None and not isinstance(strategies, StrategyConfig):
            strategies = StrategyConfig(
                strategies=tuple(strategies),
                offload_bytes_per_sec=(
                    profile.host_bytes_per_sec if profile is not None else 0.0
                ),
                quantize_bytes_per_sec=(
                    profile.quantize_bytes_per_sec if profile is not None else 0.0
                ),
            )
        if strategies is not None and not strategies.extended:
            strategies = None
        self.strategies = strategies
        self._strategy_token = (
            strategies.digest_token() if strategies is not None else ""
        )
        # Work cap for budget-free sweeps (dp.sweep max_states): surfaces
        # wider than this fall back to per-budget DP solves deterministically.
        self.sweep_max_states = sweep_max_states
        # Tiny memo of the most recent canonical lower-set families:
        # enumerating 𝓛_G is the dominant cold-path cost (§4.2), and one
        # budget search + solve (or a multi-budget sweep) re-enumerates the
        # same family many times.  Kept small — families can be exponential.
        from collections import OrderedDict

        self._family_memo: "OrderedDict[Tuple[str, str], List[NodeSet]]" = (
            OrderedDict()
        )
        # Decoded sweeps (canonical coordinates), so repeat budget queries
        # skip both the DP and the cache-entry decode.  The PlanCache tiers
        # below this hold the JSON-able form.
        self._sweep_memo: "OrderedDict[Tuple[str, str, str], dp_mod.Sweep]" = (
            OrderedDict()
        )

    def family(self, g: Graph, method: str = "approx_dp") -> Sequence[NodeSet]:
        """The canonical lower-set family for ``method`` (memoized).

        Public so tooling (e.g. examples/plan_explorer.py) can inspect the
        family without paying a second enumeration on top of the planner's.
        """
        return self._family_for(self.prepare(g), method)

    def _family_for(self, gp: Graph, method: str) -> Sequence[NodeSet]:
        key = (graph_digest(gp), method)
        fam = self._family_memo.get(key)
        if fam is None:
            fam = list(_family(gp, method))
            self._family_memo[key] = fam
            while len(self._family_memo) > 4:
                self._family_memo.popitem(last=False)
        else:
            self._family_memo.move_to_end(key)
        return fam

    # -------------------------------------------------------------- prepare

    def prepare(self, g: Graph) -> Graph:
        """Apply the measured cost model / quantization (identity without)."""
        if self.profile is not None:
            return calibrated_graph(
                g, self.profile, levels=self.quantize_levels or 64
            )
        if self.quantize_levels:
            return dp_mod.quantize_times(g, levels=self.quantize_levels)
        return g

    # ---------------------------------------------------------------- sweeps

    def _sweep_memo_put(self, key: Tuple[str, str, str], sw: dp_mod.Sweep) -> None:
        self._sweep_memo[key] = sw
        self._sweep_memo.move_to_end(key)
        while len(self._sweep_memo) > 4:
            self._sweep_memo.popitem(last=False)

    def _cached_sweep(
        self, gp: Graph, method: str, objective: str, count_miss: bool = False
    ) -> Optional[dp_mod.Sweep]:
        """An already-available sweep (memo or cache), never a fresh build.

        ``count_miss=False`` makes the cache probe silent on miss — used by
        ``solve``/``min_feasible_budget``, whose own primary lookups do the
        stats accounting; a found sweep is always counted as a hit.
        """
        key = (graph_digest(gp), method, objective)
        sw = self._sweep_memo.get(key)
        if sw is not None:
            self._sweep_memo.move_to_end(key)
            return sw
        if self.cache is not None:
            sw = self.cache.get_sweep(SweepKey(*key), count_miss=count_miss)
            if sw is not None:
                self._sweep_memo_put(key, sw)
        return sw

    def _build_sweep(
        self,
        gp: Graph,
        method: str,
        objective: str,
        cap: Optional[float],
        raise_overflow: bool = False,
        prior: Optional[dp_mod.Sweep] = None,
    ) -> Optional[dp_mod.Sweep]:
        """Build (or lazily extend) + cache a sweep; on ``sweep_max_states``
        overflow either re-raise (``raise_overflow``) or return None (the
        caller falls back to per-budget solves).

        ``prior`` is an already-cached *capped* sweep in canonical
        coordinates: instead of rebuilding, its surface is grown to ``cap``
        via ``Sweep.extend`` (cap only ever grows; the cache key is
        budget-free, so the extended surface simply replaces the entry).
        """
        to_pos, from_pos = canonical_maps(gp)
        try:
            if prior is not None and prior.cap is not None:
                # canonical → graph coordinates, extend, and back
                sw = prior.remap(from_pos).extend(
                    gp, cap=cap, max_states=self.sweep_max_states
                )
            else:
                fam = self._family_for(gp, method)
                sw = dp_mod.sweep(gp, fam, objective,
                                  max_states=self.sweep_max_states, cap=cap)
        except dp_mod.SweepOverflow as e:
            if raise_overflow:
                raise
            _LOG.info("budget sweep overflow for %r (%s); "
                      "falling back to per-budget DP", gp, e)
            return None
        sw = sw.to_canonical(to_pos)
        key = (graph_digest(gp), method, objective)
        if self.cache is not None:
            self.cache.put_sweep(SweepKey(*key), sw)
        self._sweep_memo_put(key, sw)
        return sw

    def _extract(
        self, sw: dp_mod.Sweep, gp: Graph, budget: float
    ) -> Optional[DPResult]:
        """Budget-B frontier lookup, validated against ``gp``; None means the
        sweep is unusable for this graph (corruption / digest collision)."""
        try:
            ok, t_star, masks = sw.extract(budget)
        except (KeyError, IndexError, TypeError, ValueError):
            return None
        if not ok:
            return DPResult([], dp_mod.INF, dp_mod.INF, feasible=False,
                            states_visited=sw.states_visited)
        _, from_pos = canonical_maps(gp)
        try:
            seq = [
                frozenset(from_pos[p] for p in dp_mod.mask_iter(mk))
                for mk in masks
            ]
            gp.check_increasing_sequence(seq)
        except (ValueError, IndexError, KeyError):
            return None
        return DPResult(
            sequence=seq,
            overhead=t_star,
            peak_memory=dp_mod.peak_memory_live(gp, seq),
            feasible=True,
            states_visited=sw.states_visited,
        )

    def _extract_wallclock(
        self, sw: dp_mod.Sweep, gp: Graph, budget: float
    ) -> Optional[DPResult]:
        """Replay-ranked budget-B extraction (``objective="wallclock"``).

        The sweep is stored in canonical coordinates; remap to the graph's
        own labels first, then rank every feasible terminal by replayed
        step time (``dp.Sweep.extract_wallclock``).  ``gp`` is already
        calibrated by :meth:`prepare`, so the replay reads its ``T_v``
        directly — the ranking is profile-aware through the calibration.
        """
        _, from_pos = canonical_maps(gp)
        try:
            res = sw.remap(from_pos).extract_wallclock(gp, budget)
        except (KeyError, IndexError, TypeError, ValueError):
            return None
        if res.feasible:
            try:
                gp.check_increasing_sequence(res.sequence)
            except (ValueError, IndexError, KeyError):
                return None
        return res

    def _solve_wallclock(
        self, gp: Graph, budget: float, method: str
    ) -> DPResult:
        """Wall-clock plan selection over the shared time-centric surface.

        The "wallclock" objective needs the whole candidate set at
        ``budget``, not one extraction — and its transition surface is
        bit-identical to the time-centric one — so it reuses (and warms)
        the *time_centric* sweep cache entry rather than storing a
        duplicate surface under its own key.  On sweep overflow the
        objective degrades to plain time-centric selection (logged).
        """
        sw = self._cached_sweep(gp, method, "time_centric", count_miss=True)
        if sw is None or not sw.covers(budget):
            sw = self._build_sweep(gp, method, "time_centric", cap=budget,
                                   prior=sw)
        if sw is not None:
            res = self._extract_wallclock(sw, gp, budget)
            if res is not None:
                return res
        _LOG.info("wallclock selection unavailable for %r (sweep overflow "
                  "or corrupt entry); degrading to time_centric", gp)
        return self.solve(gp, budget, method, "time_centric", prepared=True)

    def prewarm(
        self,
        g: Graph,
        method: str = "exact_dp",
        objective: str = "time_centric",
    ) -> bool:
        """Make sure a **full** budget-free sweep for ``(g, method,
        objective)`` is hot in this planner's tiers; returns True when it
        already was (memo, disk, or fleet store — no DP ran).

        This is the boot-time pre-warm hook: a serving replica calls it for
        every expected planning signature before taking traffic, so its
        first planned step is a warm frontier lookup.  In a fleet with a
        shared store exactly one replica pays the cold solve — everyone
        else read-throughs the pushed sweep.  A sweep wider than
        ``sweep_max_states`` stays unwarmed (False; ``solve`` falls back to
        the per-budget DP as usual).
        """
        if self.strategies is not None:
            raise ValueError(
                "prewarm builds binary (all-store) sweep surfaces; strategy "
                "planners solve per budget and have nothing to pre-warm"
            )
        gp = self.prepare(g)
        objective = _surface_objective(objective)
        sw = self._cached_sweep(gp, method, objective, count_miss=False)
        if sw is not None and sw.cap is None:
            return True
        self._build_sweep(gp, method, objective, cap=None, prior=sw)
        return False

    def frontier(
        self,
        g: Graph,
        method: str = "approx_dp",
        objective: str = "time_centric",
        prepared: bool = False,
    ) -> List[Tuple[float, float]]:
        """The full (budget → overhead) Pareto staircase from one sweep.

        Each entry is a critical budget and the overhead it unlocks; the
        plan at any budget B is ``solve(g, B, ...)`` (a frontier lookup on
        the same cached sweep).  Raises ``dp.SweepOverflow`` when the full
        surface exceeds ``sweep_max_states`` — use ``solve_grid`` with
        explicit budgets (a capped, much cheaper sweep) in that case.
        """
        if self.strategies is not None:
            raise ValueError(
                "frontier() reads the binary (all-store) sweep surface; use "
                "solve_grid for a strategy planner's budget staircase"
            )
        gp = g if prepared else self.prepare(g)
        objective = _surface_objective(objective)
        sw = self._cached_sweep(gp, method, objective, count_miss=True)
        if sw is None or sw.cap is not None:
            sw = self._build_sweep(gp, method, objective, cap=None,
                                   raise_overflow=True, prior=sw)
        return sw.frontier()

    def solve_grid(
        self,
        g: Graph,
        budgets: Sequence[float],
        method: str = "approx_dp",
        objective: str = "time_centric",
        prepared: bool = False,
    ) -> List[DPResult]:
        """Solve a whole budget grid from one (capped) sweep.

        One DP pass capped at ``max(budgets)`` answers every point —
        bit-identical to per-budget ``solve`` at each — and is cached, so
        re-grids and co-located jobs pay nothing.  Falls back to per-budget
        solves when the capped surface still overflows
        ``sweep_max_states``.
        """
        budgets = list(budgets)
        if not budgets:
            return []
        gp = g if prepared else self.prepare(g)
        if method in self.CACHEABLE_METHODS and self.strategies is None:
            b_max = max(budgets)
            surface = _surface_objective(objective)
            sw = self._cached_sweep(gp, method, surface, count_miss=True)
            if sw is None or not sw.covers(b_max):
                # lazy refinement: an existing capped surface grows to the
                # new largest budget instead of being rebuilt
                sw = self._build_sweep(gp, method, surface, cap=b_max,
                                       prior=sw)
            if sw is not None:
                out = [
                    self._extract_wallclock(sw, gp, b)
                    if objective == "wallclock"
                    else self._extract(sw, gp, b)
                    for b in budgets
                ]
                if all(r is not None for r in out):
                    return out
        return [
            self.solve(gp, b, method, objective, prepared=True)
            for b in budgets
        ]

    # ---------------------------------------------------------------- solve

    def solve(
        self,
        g: Graph,
        budget: float,
        method: str = "approx_dp",
        objective: str = "time_centric",
        family: Optional[Sequence[NodeSet]] = None,
        prepared: bool = False,
    ) -> DPResult:
        """Algorithm 1 through the cache; bit-identical to an uncached solve.

        A sweep already cached for ``(graph, family, objective)`` — by a
        prior ``solve_grid``/``frontier`` call here or in another process
        sharing the store — answers any budget it covers as a frontier
        lookup; otherwise this is the per-budget DP memoized under the
        ``plan`` entry kind, exactly as before.
        """
        gp = g if prepared else self.prepare(g)
        cfg = self.strategies
        if family is not None:
            return solve(gp, budget, list(family), objective, strategies=cfg)
        if method not in self.CACHEABLE_METHODS:
            return solve(gp, budget, self._family_for(gp, method), objective,
                         strategies=cfg)
        if cfg is not None:
            return self._solve_strategies(gp, budget, method, objective)
        if objective == "wallclock":
            return self._solve_wallclock(gp, budget, method)
        sw = self._cached_sweep(gp, method, objective)
        if sw is not None and sw.covers(budget):
            res = self._extract(sw, gp, budget)
            if res is not None:
                return res
        cacheable = self.cache is not None
        key = None
        if cacheable:
            key = PlanCache.key_for(gp, budget, method, objective)
            hit = self.cache.get(gp, key)
            if hit is not None:
                return hit
        res = solve(gp, budget, self._family_for(gp, method), objective)
        if cacheable:
            self.cache.put(gp, key, res)
        return res

    def _solve_strategies(
        self, gp: Graph, budget: float, method: str, objective: str
    ) -> DPResult:
        """Per-budget joint memory-strategy solve through the plan cache.

        Strategy planning has no budget-free sweep tier (strategy surfaces
        are in-memory only, see ``dp.StrategySweep``); per-budget results
        are memoized under :class:`~repro_torch.core.plan_cache.PlanKey`\\ s that
        carry the config's ``digest_token()`` — disjoint by construction
        from every legacy digest.  ``wallclock`` results are not cached:
        their ranking depends on replay parameters the key does not carry.
        """
        cfg = self.strategies
        assert cfg is not None
        cacheable = self.cache is not None and objective != "wallclock"
        key = None
        if cacheable:
            key = PlanCache.key_for(
                gp, budget, method, objective, strategy=self._strategy_token
            )
            hit = self.cache.get(gp, key)
            if hit is not None:
                return hit
        res = solve(gp, budget, self._family_for(gp, method), objective,
                    strategies=cfg)
        if cacheable:
            self.cache.put(gp, key, res)
        return res

    def min_feasible_budget(
        self,
        g: Graph,
        method: str = "approx_dp",
        tol: float = 1e-3,
        family: Optional[Sequence[NodeSet]] = None,
        prepared: bool = False,
    ) -> float:
        """Exact minimal feasible budget (the §5.1 binary search, retired).

        One O(#𝓛²) scalar pass (``dp.min_feasible_budget_exact``) computes
        min over strategies of max_i 𝓜⁽ⁱ⁾ directly — faster than a single
        binary-search probe, and the result is itself exactly feasible.
        ``tol`` is kept for API compatibility and ignored.  An already
        cached sweep (whose terminal frontier carries the same value)
        answers first; feasibility does not depend on the objective.
        """
        del tol  # the scalar DP is exact — nothing to tolerate
        gp = g if prepared else self.prepare(g)
        cfg = self.strategies
        if family is not None:
            return dp_mod.min_feasible_budget_exact(
                gp, list(family), strategies=cfg
            )
        if cfg is None and method in self.CACHEABLE_METHODS:
            # legacy sweep surfaces price full-byte caches only — a strategy
            # planner's minimum is (weakly) lower, so it never reads them
            for objective in ("time_centric", "memory_centric"):
                sw = self._cached_sweep(gp, method, objective)
                if sw is not None:
                    b = sw.min_feasible_budget()
                    if b < dp_mod.INF:  # capped sweeps may not know
                        return b
        aux_key = None
        if self.cache is not None:
            # MEMORY_FUNCTIONAL in the key: min budgets computed under an
            # older functional (eq. 2) must invalidate by construction.
            # The strategy token (empty for the binary planner) keeps joint
            # minimums from ever aliasing legacy ones.
            aux_key = (f"{graph_digest(gp)}|{method}|"
                       f"{dp_mod.MEMORY_FUNCTIONAL}|exact")
            if self._strategy_token:
                aux_key += f"|{self._strategy_token}"
            v = self.cache.get_aux("min_budget", aux_key)
            if v is not None:
                return v
        b = dp_mod.min_feasible_budget_exact(
            gp, self._family_for(gp, method), strategies=cfg
        )
        if self.cache is not None:
            self.cache.put_aux("min_budget", aux_key, b)
        return b

    # ----------------------------------------------------------------- plan

    def plan(
        self,
        g: Graph,
        budget: Optional[float] = None,
        method: str = "approx_dp",
        objective: str = "time_centric",
    ) -> PlanReport:
        """Solve and lower to an ExecutionPlan (cached for the DP methods).

        budget=None reproduces the paper's protocol: minimal feasible B.
        method ∈ {"exact_dp", "approx_dp", "chen", "vanilla"}.
        """
        t0 = _time.perf_counter()
        gp = self.prepare(g)
        full = frozenset(range(gp.n))

        if method == "vanilla":
            res = DPResult(
                sequence=[full],
                overhead=0.0,
                peak_memory=dp_mod.peak_memory_live(gp, [full]),
                feasible=True,
            )
        elif method == "chen":
            res = chen_sqrt_n(gp, budget=None)
        else:
            if budget is None:
                budget = self.min_feasible_budget(gp, method, prepared=True)
            res = self.solve(gp, budget, method, objective, prepared=True)
        dt = _time.perf_counter() - t0

        if not res.feasible:
            return PlanReport(
                method=method,
                objective=objective if method.endswith("dp") else "-",
                budget=budget if budget is not None else float("nan"),
                result=res,
                plan=None,
                peak_with_liveness=float("inf"),
                peak_without_liveness=float("inf"),
                plan_seconds=dt,
            )

        ep = make_plan(gp, res.sequence, assignment=res.assignment,
                       strategies=self.strategies)
        sim_live = simulate(gp, res.sequence, liveness=True,
                            assignment=res.assignment)
        sim_nolive = simulate(gp, res.sequence, liveness=False,
                              assignment=res.assignment)
        replayed = None
        if objective == "wallclock" and method.endswith("dp"):
            from .replay import replay as _replay

            replayed = _replay(gp, ep, budget=budget,
                               strategies=self.strategies).seconds
        return PlanReport(
            method=method,
            objective=objective if method.endswith("dp") else "-",
            budget=budget if budget is not None else res.peak_memory,
            result=res,
            plan=ep,
            peak_with_liveness=sim_live.peak_memory,
            peak_without_liveness=sim_nolive.peak_memory,
            plan_seconds=dt,
            replayed_seconds=replayed,
        )


_DEFAULT_PLANNER = Planner()


def get_default_planner() -> Planner:
    """The process-wide Planner behind the module-level functions."""
    return _DEFAULT_PLANNER


def min_feasible_budget(
    g: Graph,
    method: str = "approx_dp",
    tol: float = 1e-3,
    family: Optional[Sequence[NodeSet]] = None,
) -> float:
    """§5.1 minimal feasible budget — exact, from the default Planner's
    cached sweep (the paper's binary search is retired; ``tol`` is accepted
    for compatibility and ignored)."""
    return _DEFAULT_PLANNER.min_feasible_budget(g, method, tol, family)


def plan(
    g: Graph,
    budget: Optional[float] = None,
    method: str = "approx_dp",
    objective: str = "time_centric",
    planner: Optional[Planner] = None,
) -> PlanReport:
    """Solve and lower to an ExecutionPlan (one-call front door).

    Routes through the process-default ``Planner`` — repeated calls on the
    same (graph, budget) hit the plan cache instead of re-running the DP.
    """
    return (planner or _DEFAULT_PLANNER).plan(g, budget, method, objective)


def compare_methods(
    g: Graph, budget: Optional[float] = None, include_exact: bool = True
) -> List[PlanReport]:
    """The paper's Table-1 row for one network: all methods, one graph."""
    reports = [plan(g, method="vanilla")]
    reports.append(plan(g, method="chen"))
    for objective in ("memory_centric", "time_centric"):
        reports.append(plan(g, budget, "approx_dp", objective))
        if include_exact:
            reports.append(plan(g, budget, "exact_dp", objective))
    return reports
