"""repro_torch.core.lowering — one planning pipeline, many executable forms
(port of ``repro/core/lowering``).

    graph carriers (BlockGraph | traced torch fn)
        → core.planner.Planner (plan cache + budget sweep)
        → ExecutionPlan
        → a registered Lowering backend
        → runnable value-and-grad on PyTorch autograd

Backends (``base.register_lowering``):

* ``"interpreter"`` — §3 interpreted step by step; validation + live-byte
  audit (both carriers);
* ``"policy"``      — one selective checkpoint region per plan segment
  keeping the outputs of U_k's blocks (BlockGraph production path);
* ``"segment"``     — one non-reentrant checkpoint per plan segment
  (BlockGraphs, strategy plans and donation);
* ``"fx"``          — per-segment checkpoint regions with a selective
  policy keyed by fx node (the trace-anything production path; takes the
  place of the reference's ``"jaxpr"``).

Storage-strategy plans (``plan.strategy``: offload to pinned host memory,
int8 quantization; ``lowering.storage``) are realized by ``"interpreter"``
and ``"fx"`` on traced functions and by ``"segment"`` on BlockGraphs;
``"fx"`` and ``"segment"`` take ``donate=True`` (``lowering.donation``).
``plan_function`` is the front door.
"""

from .base import (
    InfeasibleBudgetError,
    Lowering,
    available_backends,
    get_lowering,
    register_lowering,
    resolve_backend,
)
from .carriers import BlockGraphCarrier, TracedCarrier, abstract_signature
from .front_door import LoweredPlan, PlannedFunction, plan_function
from .fx import fx_value_and_grad
from .policy import apply_with_policy, plan_policy
from .interpreter import (
    planned_value_and_grad,
    traced_planned_value_and_grad,
    vanilla_traced_value_and_grad,
    vanilla_value_and_grad,
)
from .segment import apply_segmented

__all__ = [
    "InfeasibleBudgetError",
    "Lowering",
    "register_lowering",
    "get_lowering",
    "available_backends",
    "resolve_backend",
    "BlockGraphCarrier",
    "TracedCarrier",
    "abstract_signature",
    "plan_function",
    "PlannedFunction",
    "LoweredPlan",
    "fx_value_and_grad",
    "planned_value_and_grad",
    "traced_planned_value_and_grad",
    "vanilla_traced_value_and_grad",
    "vanilla_value_and_grad",
    "apply_segmented",
    "apply_with_policy",
    "plan_policy",
]
