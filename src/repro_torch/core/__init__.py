"""repro_torch.core — the paper's planning core, copied from ``repro.core``.

Graph-theoretic recomputation planning (Kusumoto et al., NeurIPS 2019):
the paper's ``Graph`` (§2), lower-set families (§4.2/§4.3), the exact and
approximate DP (Algorithm 1) with its budget-free sweep, the exact minimal
feasible budget, Chen's √n baseline, the discrete-event replay, and the
content-addressed plan cache behind the ``Planner``.  These modules are
numpy/stdlib only and are copies of the reference with imports re-pointed.

Unlike ``repro/core/__init__.py``, this package exports no lowerings (the
reference's import of ``.lowering`` is what pulls jax in); the torch
lowerings and ``plan_function`` wait for ROADMAP.md module queue, item
'Torch graph carrier and lowerings'.
"""

from .chen import articulation_points, candidate_split_points, chen_sqrt_n
from .cost_model import (
    OpProfile,
    calibrated_graph,
    load_or_profile,
    measured_times,
    profile_ops,
)
from .dp import (
    MEMORY_FUNCTIONAL,
    DPResult,
    Sweep,
    SweepOverflow,
    approx_dp,
    cached_sets,
    decode_sweep,
    exact_dp,
    min_feasible_budget_exact,
    overhead,
    peak_memory,
    peak_memory_live,
    quantize_times,
    solve,
    sweep,
)
from .graph import (
    Graph,
    Node,
    canonical_maps,
    canonical_order,
    chain,
    from_cost_lists,
    graph_digest,
)
from .liveness import SimResult, simulate, transition_excess, vanilla_peak
from .lower_sets import all_lower_sets, count_lower_sets, pruned_lower_sets
from .plan_cache import (
    CallableStore,
    PlanCache,
    PlanKey,
    RemoteStore,
    SharedFSStore,
    SweepKey,
    default_cache,
    register_transport,
    remote_store_from_url,
    set_default_cache_dir,
    set_default_remote_store,
)
from .planner import (
    Planner,
    PlanReport,
    compare_methods,
    get_default_planner,
    min_feasible_budget,
    plan,
)
from .replay import (
    ReplayResult,
    SegmentTiming,
    rank_by_replay,
    replay,
    window_peaks,
)
from .schedule import ExecutionPlan, Segment, make_plan, plan_summary

__all__ = [
    "Graph",
    "Node",
    "chain",
    "from_cost_lists",
    "all_lower_sets",
    "pruned_lower_sets",
    "count_lower_sets",
    "DPResult",
    "solve",
    "sweep",
    "Sweep",
    "SweepOverflow",
    "decode_sweep",
    "min_feasible_budget_exact",
    "exact_dp",
    "approx_dp",
    "overhead",
    "peak_memory",
    "peak_memory_live",
    "MEMORY_FUNCTIONAL",
    "cached_sets",
    "quantize_times",
    "articulation_points",
    "candidate_split_points",
    "chen_sqrt_n",
    "SimResult",
    "simulate",
    "transition_excess",
    "vanilla_peak",
    # discrete-event replay (wall-clock pricing)
    "ReplayResult",
    "SegmentTiming",
    "replay",
    "rank_by_replay",
    "window_peaks",
    "ExecutionPlan",
    "Segment",
    "make_plan",
    "plan_summary",
    "PlanReport",
    "plan",
    "compare_methods",
    "min_feasible_budget",
    # plan compilation pipeline
    "graph_digest",
    "canonical_order",
    "canonical_maps",
    "PlanCache",
    "PlanKey",
    "RemoteStore",
    "SharedFSStore",
    "CallableStore",
    "SweepKey",
    "default_cache",
    "register_transport",
    "remote_store_from_url",
    "set_default_cache_dir",
    "set_default_remote_store",
    "Planner",
    "get_default_planner",
    "OpProfile",
    "profile_ops",
    "load_or_profile",
    "measured_times",
    "calibrated_graph",
]
