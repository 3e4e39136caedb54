"""Lowering conformance: does the lowered twin save exactly ``U_k``? (port
of ``repro/analysis/conformance.py``).

The ``"fx"`` backend lowers a plan onto autograd: each recomputing segment
runs as a non-reentrant checkpoint region whose selective policy marks the
ops of its ``keep`` nodes ``MUST_SAVE`` and all others
``PREFER_RECOMPUTE`` (``core/lowering/fx.py``).  The reference reads the
``checkpoint_name`` tags of the lowered twin's jaxpr; eager torch has no
tags, so this checker reads the twin itself.  It runs the twin once under
``saved_tensors_hooks`` and a ``TorchDispatchMode`` (``census.CountOps``)
keyed by the fx node the twin is evaluating (``run.node_now()``), and
recovers what the twin really saves, three ways:

* **structurally** — a node whose ops run again inside the backward is
  rematerialized, so a cached node found there is a hard conformance error
  (the twin recomputes what the plan claims to save).  The converse is
  deliberately **not** an error: a node that never reruns is either saved
  *or* not read by any backward, and one run cannot tell those apart.  The
  same run checks that every tensor autograd packs outside the checkpoint
  regions belongs to a cached node or a graph input: a region saves its
  inputs that way, a plain segment everything its ops save;
* **by policy** — the twin's own policy predicate (``run.policy_saves``)
  applied to every storable node of a recomputing segment must admit
  exactly the cached ones there;
* **by reference** — when a deployed callable is passed in, the nodes it
  reruns must equal those of a freshly lowered twin of the *same* plan; a
  stale lowering (built from a different plan) reruns a different set and
  is caught in both directions.

The run needs concrete arguments: ``args``, or ``census.example_args`` of
the trace.  It forks the RNG, so the caller's draws are unchanged.  A
sharded carrier is checked the same way: on an ``{axis: size}`` dict the
twin runs on plain tensors, on a ``DeviceMesh`` on DTensors (storages are
those of the local shards).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Set, Tuple

import torch

from ..core.schedule import ExecutionPlan
from .report import Report


def _watch(carrier: Any, fn: Callable[..., Any], args: Sequence[Any],
           report: Report) -> Optional[Tuple[Set[int], Set[int]]]:
    """Run the twin ``fn`` once.  Returns ``(rerun, packed)``: the graph nodes
    whose ops ran again inside the backward, and those whose outputs
    autograd packed outside the checkpoint regions.  Adds an error finding
    and returns None if ``fn`` is no ``"fx"`` twin or fails."""
    from .census import CountOps, _device_of, _forked_rng, storage_key

    node_now = getattr(fn, "node_now", None)
    if node_now is None:
        report.add(
            "error",
            "lowering-untraceable",
            "the callable is not an \"fx\" twin (no node_now hook): "
            "conformance reads the nodes the twin evaluates",
        )
        return None
    owner = carrier.fx.owner
    made: dict = {}  # live output storage -> the graph node that made it
    packed: Set[int] = set()

    class Watch(CountOps):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            node = node_now()
            if node is not None and torch._C._current_graph_task_id() == -1:
                for t in _leaves(out):
                    made[storage_key(t)] = owner.get(node)
            return out

    def pack(t):
        # looked up now: the allocator reuses a freed node's storage later
        v = made.get(storage_key(t))
        if v is not None:
            packed.add(v)
        return t

    try:
        with _forked_rng(_device_of(args)), Watch(node_now) as w, \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn(*args)
    except Exception as e:  # a failing twin is itself a finding
        report.add("error", "lowering-untraceable",
                   f"could not run the lowered twin: {type(e).__name__}: {e}")
        return None
    return {owner.get(n) for n in w.rerun} - {None}, packed


def _leaves(tree: Any):
    return [t for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def check_lowering(
    carrier: Any,
    plan: ExecutionPlan,
    lowered: Optional[Callable[..., Any]] = None,
    args: Optional[Sequence[Any]] = None,
) -> Report:
    """Verify the lowered twin's save-set against ``plan`` by running it.

    ``carrier`` must be a traced carrier (``TracedCarrier``); for other
    carriers the check is not applicable and the report says so.
    ``lowered`` overrides the callable to inspect (default: the ``"fx"``
    backend's ``fx_value_and_grad(carrier, plan)``) — pass the actual
    deployed callable to detect drift between it and the plan.  ``args``
    are concrete arguments (default: ``census.example_args``).
    """
    from ..core.lowering.carriers import TracedCarrier
    from ..core.lowering.fx import fx_value_and_grad
    from .census import example_args

    report = Report(checker="lowering")
    if not isinstance(carrier, TracedCarrier):
        report.add(
            "info",
            "not-applicable",
            f"conformance checking needs a traced carrier "
            f"(got {type(carrier).__name__}); the interpreter backend "
            "validates itself at runtime instead",
        )
        return report

    names = carrier.node_names()
    fxg = carrier.fx
    user_lowered = lowered is not None
    if lowered is None:
        lowered = fx_value_and_grad(carrier, plan)
    args = tuple(args) if args is not None else example_args(carrier)

    watched = _watch(carrier, lowered, args, report)
    if watched is None:
        return report
    rerun, packed = watched

    # Expected save-set: cached nodes whose outputs the lowering can save.
    from .effects import _storable

    expected: Set[int] = set()
    for v in sorted(plan.cached):
        if _storable(fxg.nodes[v]):
            expected.add(v)
        else:
            report.add(
                "warning",
                "cached-untaggable",
                f"{names[v]} is in the plan's cache set but its outputs are "
                "not floating — the selective policy cannot save it, so it "
                "will be rematerialized despite the plan",
                node=v,
            )

    # The sound structural direction: a cached node whose ops rerun inside
    # the backward is rematerialized by the twin — a direct plan violation.
    remade = sorted(expected & rerun)
    if remade:
        report.add(
            "error",
            "residual-not-saved",
            f"plan caches {[names[v] for v in remade]} but the lowered twin "
            "reruns them inside its backward — planner↔lowering drift",
            node=remade[0],
        )
    held = sorted(packed - plan.cached)
    if held:
        report.add(
            "error",
            "residual-not-saved",
            "autograd packs outside the checkpoint regions the outputs of "
            f"{[names[v] for v in held][:8]}, which the plan recomputes — the "
            "twin holds what it should rerun",
            node=held[0],
        )

    if user_lowered:
        # Reference comparison: lower the *same* plan freshly and demand the
        # deployed callable reruns exactly the same nodes.
        ref = _watch(carrier, fx_value_and_grad(carrier, plan), args, report)
        if ref is not None and rerun != ref[0]:
            report.add(
                "error",
                "remat-set-mismatch",
                "the deployed callable reruns "
                f"{sorted(rerun - ref[0])} beyond and omits "
                f"{sorted(ref[0] - rerun)} of what this plan's own lowering "
                "reruns — it was lowered from a different (stale?) plan",
            )

    # Independent cross-check: apply the twin's policy predicate directly.
    policy = getattr(lowered, "policy_saves", None)
    if policy is not None:
        decided = {v: policy(n) for v, n in enumerate(fxg.nodes) if _storable(n)}
        in_regions = {v for v, d in decided.items() if d is not None}
        saved_policy = {v for v, d in decided.items() if d}
        if saved_policy != (expected & in_regions):
            report.add(
                "error",
                "policy-mismatch",
                f"the selective policy saves {sorted(saved_policy)} but the "
                f"plan expects {sorted(expected & in_regions)}",
            )

    if report.ok and not report.findings:
        report.add(
            "info",
            "conformant",
            f"lowered twin saves the plan's {len(expected)} storable cached "
            f"residuals and reruns {len(rerun)} of its recomputed nodes",
        )
    return report
