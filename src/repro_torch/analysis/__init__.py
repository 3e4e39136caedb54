"""repro_torch.analysis — static soundness layer over carriers, plans and
lowerings (port of ``repro.analysis``).

Cooperating checkers prove a plan sound before (and as) it runs:

* :func:`check_graph` — effect/determinism analysis: classify every traced
  aten op (pure / prng / effectful / opaque; ``donated`` has no torch
  twin), propagate taint, emit ``must_store`` pins the planner consumes as
  hard constraints (``analysis.effects``);
* :func:`check_plan` — plan verifier: topological validity, replay
  soundness, event-simulated peak vs. budget, eq. (1) overhead, ``M_v`` —
  all re-derived independently of the DP (``analysis.verifier``);
* :func:`check_lowering` — lowering conformance: the ``"fx"`` twin saves
  the plan's ``U_k`` and reruns nothing it caches, read by running it
  under ``saved_tensors_hooks`` and a dispatch mode
  (``analysis.conformance``);
* :func:`check_hlo` — dispatch truth in place of the reference's compiler
  truth: a heavy-op census of the planned twin against plain autograd and
  the plan's eq. (1) recompute counts, and the memory-drift gate against
  ``torch.cuda.max_memory_allocated`` (``analysis.census``).  The
  reference's HLO-text helpers (``hlo_text.py``) have no twin: there is no
  HLO to parse.

``analysis.costs.extract_segment_costs`` prices each plan segment in FLOPs
(``FlopCounterMode``) and bytes (the trace) for
``plan_function(cost_model="compiled")``, in place of the reference's
``cost_analysis()`` of compiled segments.

The ``plan_lint`` CLI (``python -m repro_torch.analysis``) runs the
checkers over traced functions and emits a JSON report (``--hlo`` adds the
census and the drift-record artifact).
"""

from __future__ import annotations

from typing import Any

from .census import HloAnalysis, analyze_hlo, check_hlo, drift_findings
from .conformance import check_lowering
from .effects import (
    CLASSES,
    EffectAnalysis,
    EqnEffect,
    analyze_effects,
    classify_eqns,
    pin_graph,
)
from .report import Finding, PlanVerificationError, Report
from .verifier import check_graph_memory, check_plan

__all__ = [
    "Finding",
    "PlanVerificationError",
    "Report",
    "CLASSES",
    "EqnEffect",
    "EffectAnalysis",
    "classify_eqns",
    "analyze_effects",
    "pin_graph",
    "check_graph",
    "check_plan",
    "check_graph_memory",
    "check_lowering",
    "check_hlo",
    "analyze_hlo",
    "HloAnalysis",
    "drift_findings",
]


def check_graph(target: Any) -> Report:
    """Effect-analysis report for a traced carrier or an ``FxGraph``.

    Accepts a ``TracedCarrier`` or an ``FxGraph`` (``core.fx_graph.trace``);
    pure graphs come back with an empty report.  Use
    :func:`analyze_effects` directly when you also need the pins / taint
    sets.
    """
    fxg = target.fx if hasattr(target, "fx") else target
    return analyze_effects(fxg).report
