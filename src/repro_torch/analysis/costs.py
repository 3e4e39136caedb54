"""Per-segment FLOPs and bytes of a traced function under a plan: the port's
twin of ``extract_segment_costs`` in ``repro/analysis/hlo.py``.

The reference compiles each segment's sub-jaxpr alone and asks XLA's
``cost_analysis()`` for its FLOPs and bytes accessed.  Eager torch has no
compiler to ask, so the port counts:

* **FLOPs** with ``torch.utils.flop_counter.FlopCounterMode``, running the
  segment's fx nodes on fake tensors (shapes, dtypes and devices only:
  nothing is allocated or computed).  The flash-attention custom op has no
  formula there; its nodes add the analytic 4·B·H·Sq·Sk·D (halved when
  causal) of ``core.fx_graph.node_flops``.
* **bytes accessed** from the trace's metadata: each node of the segment
  reads its operands' bytes and writes its outputs' bytes once (views fold
  into their base and move nothing).

The result feeds ``core.cost_model.compiled_calibrated_graph`` for
``plan_function(cost_model="compiled")``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from ..core.fx_graph import is_view, node_flops, op_name, tensor_bytes
from ..core.prims import FLASH_OP
from ..core.schedule import ExecutionPlan


def _fake_like(mode: FakeTensorMode, val: Any) -> Any:
    def one(t):
        with mode:
            return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)

    return pytree.tree_map_only(torch.Tensor, one, val)


def extract_segment_costs(carrier: Any, plan: ExecutionPlan) -> List[Dict[str, float]]:
    """``[{"flops", "bytes"}]``, one per ``plan.segments`` entry."""
    from ..core.lowering.interpreter import run_segment, traced_programs

    fxg = carrier.fx
    out: List[Dict[str, float]] = []
    for prog in traced_programs(fxg, plan):
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        ext = {k: _fake_like(mode, k.meta["val"]) for k in prog.ext}
        flash = 0.0
        nbytes = 0.0
        for n in prog.steps:
            if fxg.owner.get(n) is None or is_view(n):
                continue
            nbytes += tensor_bytes(n.meta.get("val"))
            nbytes += sum(tensor_bytes(a.meta.get("val")) for a in n.all_input_nodes)
            if op_name(n.target) == FLASH_OP:
                flash += node_flops(n)
        with mode, FlopCounterMode(display=False) as counter:
            run_segment(prog, lambda n, get: fxg.run_node(n, get), ext.__getitem__)
        out.append({"flops": float(counter.get_total_flops()) + flash, "bytes": nbytes})
    return out
