"""``plan_function`` — the one-call front door of the planning pipeline
(port of ``repro/core/lowering/front_door.py``).

    planned = repro_torch.plan_function(loss_fn, budget=2 * 2**30)
    loss, grads = planned(params, x)          # value-and-grad twin

Any torch function of tensors (or a ``BlockGraph``) goes through the same
pipeline:

    carrier (make_fx trace / blocks) → core.Graph → Planner (plan cache +
    budget sweep) → a registered Lowering backend → runnable value_and_grad

Tracing and planning happen lazily on the first call and are memoized per
argument structure, shapes, dtypes, devices and DTensor placements (a
planned function holds one mesh and one set of input shardings, so its
memo is keyed by them too); re-creating the planned function re-plans
through the content-addressed plan cache instead of re-running the DP.
The twin runs on the device of its arguments; with a ``DeviceMesh`` on
DTensors over it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
import torch.utils._pytree as pytree

from ..schedule import ExecutionPlan
from .base import InfeasibleBudgetError, resolve_backend
from .carriers import BlockGraphCarrier, TracedCarrier, abstract_signature


@dataclasses.dataclass
class LoweredPlan:
    """One (argument-signature → plan → backend) lowering of a function."""

    carrier: Any
    report: Any  # core.planner.PlanReport
    plan: ExecutionPlan
    backend: str
    run: Callable[..., Any]
    #: the census and drift record (``analysis.census.HloAnalysis``) when
    #: ``verify_hlo`` ran
    hlo: Optional[Any] = None


class PlannedFunction:
    """Lazy value-and-grad twin of a function under a memory budget.

    Calling it traces and plans on first use (memoized per argument
    signature) and then runs the lowered form.  ``lowered_for(*args)``
    exposes the underlying :class:`LoweredPlan` (plan, PlanReport, backend).
    """

    def __init__(
        self,
        fn: Any,
        budget: Optional[float],
        backend: str,
        method: str,
        objective: str,
        cost_model: str,
        argnums: Union[int, Tuple[int, ...]],
        loss_fn: Optional[Callable[..., Any]],
        planner: Optional[Any],
        track_live: bool,
        mesh: Any = None,
        in_shardings: Any = None,
        analyze_effects: bool = False,
        verify: bool = False,
        verify_hlo: bool = False,
        donate: bool = False,
        strategies: Any = None,
    ):
        self.fn = fn
        self.budget = budget
        self.backend = backend
        self.method = method
        self.objective = objective
        self.cost_model = cost_model
        self.argnums = argnums
        self.loss_fn = loss_fn
        self.planner = planner
        self.track_live = track_live
        self.mesh = mesh
        self.in_shardings = in_shardings
        self.analyze_effects = analyze_effects
        self.verify = verify
        self.verify_hlo = verify_hlo
        self.donate = donate
        self.strategies = strategies
        self._memo: Dict[Tuple, LoweredPlan] = {}

    @property
    def _trace_cost_model(self) -> str:
        # "compiled" calibration re-prices the graph after a pilot plan
        # exists (extract_segment_costs needs segments); the trace itself is
        # priced analytically by FLOPs and re-priced in lowered_for.
        return "flops" if self.cost_model == "compiled" else self.cost_model

    def _carrier_for(self, args) -> Any:
        fn = self.fn
        # BlockGraph carrier: duck-typed to avoid importing blockgraph here
        if hasattr(fn, "blocks") and hasattr(fn, "by_name"):
            if self.loss_fn is None:
                raise ValueError("plan_function over a BlockGraph needs loss_fn=")
            if len(args) != 2:
                raise TypeError("BlockGraph planned functions take (params, inputs)")
            # only shapes matter for planning — don't pin the first call's
            # concrete weights in the memo for the function's lifetime
            meta = pytree.tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
                if isinstance(t, torch.Tensor) else t, args)
            return BlockGraphCarrier(bg=fn, loss_fn=self.loss_fn, params=meta[0],
                                     inputs=meta[1], cost_model=self._trace_cost_model,
                                     mesh=self.mesh)
        return TracedCarrier.trace(fn, args, argnums=self.argnums,
                                   cost_model=self._trace_cost_model, mesh=self.mesh,
                                   in_shardings=self.in_shardings,
                                   analyze_effects=self.analyze_effects)

    def lowered_for(self, *args) -> LoweredPlan:
        """Trace + plan + lower for this argument signature (memoized)."""
        key = abstract_signature(args)
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        from ..planner import get_default_planner

        carrier = self._carrier_for(args)
        g = carrier.to_graph()
        pl = self.planner or get_default_planner()
        if self.strategies is not None:
            # Joint memory-strategy planning: a planner configured with the
            # requested strategy set, sharing the base planner's plan cache
            # and profile, so legacy and strategy plans coexist under
            # distinct content addresses.
            from ..planner import Planner

            pl = Planner(cache=pl.cache, profile=pl.profile,
                         quantize_levels=pl.quantize_levels,
                         sweep_max_states=pl.sweep_max_states,
                         strategies=self.strategies)
        report = pl.plan(g, self.budget, self.method, self.objective)
        if report.plan is None:
            hint = ""
            if self.method in ("exact_dp", "approx_dp"):
                needed = pl.min_feasible_budget(g, self.method)
                hint = f"; minimal feasible budget is {needed:g}"
            raise InfeasibleBudgetError(
                f"no feasible strategy for budget {self.budget!r} "
                f"({self.method}/{self.objective}){hint}"
            )
        if self.cost_model == "compiled" and isinstance(carrier, TracedCarrier):
            # Two-phase calibration: the pilot plan above (FLOP priced)
            # defines segments; each segment's FLOPs and bytes re-price the
            # graph (with the "compiled" source hashed into its digest) and
            # the DP re-runs.
            from ...analysis.costs import extract_segment_costs
            from ..cost_model import DEFAULT_PROFILE, compiled_calibrated_graph, device_key

            flat = pytree.tree_leaves(args)
            dev = flat[0].device if flat else torch.device("cpu")
            profile = dataclasses.replace(DEFAULT_PROFILE, backend=device_key(dev),
                                          jax_version=torch.__version__, source="compiled")
            seg_costs = extract_segment_costs(carrier, report.plan)
            g = compiled_calibrated_graph(g, report.plan, seg_costs, profile)
            report = pl.plan(g, self.budget, self.method, self.objective)
            if report.plan is None:
                raise InfeasibleBudgetError(
                    f"budget {self.budget!r} became infeasible after "
                    "compiled-cost recalibration"
                )
        env_verify = os.environ.get("REPRO_VERIFY_PLANS", "")
        if self.verify or env_verify:
            from ...analysis import check_plan
            from ...analysis.report import PlanVerificationError

            vrep = check_plan(g, report.plan, budget=self.budget,
                              effects=getattr(carrier, "effects", None),
                              fx=getattr(carrier, "fx", None),
                              strategies=getattr(pl, "strategies", None))
            if not vrep.ok:
                raise PlanVerificationError(str(vrep))
        hlo = None
        if self.verify_hlo or env_verify.strip().lower() == "hlo":
            from ...analysis.census import analyze_hlo
            from ...analysis.report import PlanVerificationError

            hlo = analyze_hlo(carrier, report.plan, args=args, donate=self.donate)
            if not hlo.report.ok:
                raise PlanVerificationError(str(hlo.report))
        backend = resolve_backend(self.backend, carrier)
        run = backend.lower(carrier, report.plan, track_live=self.track_live,
                            donate=self.donate)
        lowered = LoweredPlan(carrier=carrier, report=report, plan=report.plan,
                              backend=backend.name, run=run, hlo=hlo)
        self._memo[key] = lowered
        return lowered

    def __call__(self, *args):
        return self.lowered_for(*args).run(*args)


def plan_function(
    fn: Any,
    budget: Optional[float] = None,
    *,
    backend: str = "auto",
    method: str = "approx_dp",
    objective: str = "time_centric",
    cost_model: str = "paper",
    argnums: Union[int, Tuple[int, ...]] = 0,
    loss_fn: Optional[Callable[..., Any]] = None,
    planner: Optional[Any] = None,
    track_live: bool = False,
    mesh: Any = None,
    in_shardings: Any = None,
    analyze_effects: bool = False,
    verify: bool = False,
    verify_hlo: bool = False,
    donate: bool = False,
    strategies: Any = None,
) -> PlannedFunction:
    """Plan ``fn``'s recomputation under ``budget`` bytes; return its
    value-and-grad twin.

    Parameters
    ----------
    fn:
        Any scalar-output torch function of tensors (and pytrees of them) —
        traced on first call by ``core.fx_graph`` (``make_fx`` in fake mode,
        one node per aten op) — or a ``core.blockgraph.BlockGraph`` (then
        ``loss_fn`` is required and calls take ``(params, inputs)``).
    budget:
        Memory budget in bytes for the analytic peak (the liveness-tight
        refinement of eq. 2).  ``None`` reproduces the paper's §5.1
        protocol: the exact minimal feasible budget.  An infeasible budget
        raises :class:`InfeasibleBudgetError` naming the minimal one.
    backend:
        ``"auto"`` (``"fx"`` for traced functions, ``"policy"`` for
        BlockGraphs), or any registered lowering: ``"interpreter"``,
        ``"policy"``, ``"segment"``, ``"fx"``.
    method / objective:
        Planner knobs (§4): ``"approx_dp"``/``"exact_dp"`` ×
        ``"time_centric"``/``"memory_centric"``/``"wallclock"``.
    argnums:
        Which positional args to differentiate (traced carrier only).
    planner:
        A ``core.planner.Planner``; defaults to the process-wide one, so
        repeated plans hit the content-addressed plan cache.
    track_live:
        Interpreter backend only: calls return ``(value, grads, trace)``
        where ``trace`` is the live-intermediate-bytes audit trail.
    analyze_effects:
        Run ``repro_torch.analysis``'s effect/determinism pass on the trace:
        random draws, side-effecting ops and opaque custom ops (the
        flash-attention op among them) taint the graph and their storable
        frontier is pinned ``must_store`` — the planner then prices those
        nodes store-only (never recomputed), and pinned and unpinned
        variants hash to distinct plan-cache digests.
    verify:
        Statically re-verify every produced plan (``analysis.check_plan``:
        topology, replay soundness, simulated peak vs. budget, eq. (1)
        overhead, ``M_v``) and raise
        :class:`~repro_torch.analysis.report.PlanVerificationError` on any
        error finding before the plan is lowered.
    verify_hlo:
        Additionally run the dispatch-truth checks (``analysis.check_hlo``)
        on the first call's arguments: the planned twin's heavy-op census
        against plain autograd and the plan's eq. (1) recompute counts, and
        the memory-drift gate on the card's allocator (the reference's
        compiled-HLO checks; ``analysis.census`` says what replaced what).
        Traced carriers only (BlockGraph carriers report ``not-applicable``).

    donate:
        ``"fx"``/``"segment"``: the twin drops its own references to values
        that cross segments once no later segment reads them, and carries
        ``donate_argnums`` (the non-differentiated positional args) and the
        per-segment dead-at-peak ``donation_hints`` (``lowering.donation``),
        as the reference's donated twin does (torch has no jit donation).
        Values and gradients are unchanged.  ``"interpreter"`` rejects it.
    strategies:
        Joint memory-strategy planning: a ``core.strategies.StrategyConfig``
        or a tuple of strategy names drawn from ``{"store", "recompute",
        "offload", "quantize"}``.  The planner then picks a per-node storage
        strategy for every cached residual — offloaded nodes cost
        host-transfer time but zero device bytes; quantized nodes cost codec
        time and int8+scale bytes — and the lowered twin realizes the
        assignment (pinned host memory / the ``optim.compression``
        round-trip; ``core.lowering.storage``).  ``None`` (or a set
        enabling nothing beyond store+recompute) is the paper's binary
        planning.

    The ``REPRO_VERIFY_PLANS`` environment variable overrides both flags:
    any value enables ``verify``; the value ``"hlo"`` enables ``verify``
    *and* ``verify_hlo``.

    ``cost_model="compiled"`` selects two-phase planning: a FLOP-priced
    pilot plan defines segments, each segment's FLOPs and bytes
    (``analysis.costs``: ``FlopCounterMode`` on fake tensors and the
    trace's bytes, the twin of XLA's ``cost_analysis()``) re-price the
    graph, and the DP re-runs on it (its digest carries the ``compiled:``
    cost source, so such plans never alias flops-priced cache entries).

    mesh / in_shardings:
        Sharding-aware planning: ``mesh`` is a ``torch.distributed``
        ``DeviceMesh`` (or a plain ``{axis: size}`` dict when only the
        accounting is needed); ``in_shardings`` aligns with the positional
        args — each entry is None (a DTensor keeps its placements, anything
        else is replicated), one spec (a tuple of mesh-axis entries such as
        ``("data", None)``, or DTensor placements) for every leaf of that
        arg, or a matching pytree of specs.  Specs are propagated through
        the trace (conservative replicated fallback), node ``M_v`` becomes
        per-device bytes (distinct shardings therefore hash to distinct
        plan-cache digests) and the budget is **per-device**.  On a
        ``DeviceMesh`` the twin runs on DTensors in the caller's
        placements: the loss comes back replicated and every gradient in
        its input's placements (a replicated parameter's gradient is
        all-reduced).  The mesh's data axes and its model axis run; any
        other axis larger than 1, a strategy plan and a recomputed random
        draw raise ``NotImplementedError`` (ROADMAP.md 'Multi-device').  BlockGraphs
        take ``mesh`` only (their blocks' ``out_sharding``).
    """
    if in_shardings is not None and mesh is None:
        raise ValueError("in_shardings= needs mesh=")
    if track_live and backend == "auto":
        backend = "interpreter"
    return PlannedFunction(
        fn=fn, budget=budget, backend=backend, method=method,
        objective=objective, cost_model=cost_model, argnums=argnums,
        loss_fn=loss_fn, planner=planner, track_live=track_live, mesh=mesh,
        in_shardings=in_shardings, analyze_effects=analyze_effects, verify=verify, verify_hlo=verify_hlo,
        donate=donate, strategies=strategies,
    )
