"""The comparison that decides ``correct`` for a training cell.

Both sides report three readings of the checked steps (the first three of
the run): each step's loss, each leaf's gradient norm at step 1 before
clipping, and each leaf's change over the three steps.  The numbers
compared, each against its cell's limit (``workloads/<cell>.json``):

* ``loss``: the largest |program - reference| / |reference| over the steps;
* ``grad``: the worst leaf's |program norm - reference norm|, over the
  larger of that leaf's reference norm and the median leaf's;
* ``change``: the same of the change's norms, over the leaves whose
  reference gradient is at least a thousandth of the median leaf's (a leaf
  with a gradient nought to rounding moves by round-off alone).
"""

from __future__ import annotations

import statistics
from typing import Dict, Tuple

#: a leaf whose step-1 reference gradient norm is under this share of the
#: median leaf's is left out of ``change``
NOUGHT = 1e-3


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float], names) -> Tuple[float, str]:
    names = list(names)
    floor = statistics.median(ref[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30)
        if gap > worst or not at:
            worst, at = gap, n
    return worst, at


def numbers(prog: Dict, ref: Dict) -> Dict[str, Dict]:
    """name -> {"value", "at"}: the three numbers compared."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = float("inf")
    grad, g_at = _worst_leaf(prog["grad_norms"], ref["grad_norms"], ref["grad_norms"])
    floor = statistics.median(ref["grad_norms"].values())
    moving = [n for n, g in ref["grad_norms"].items() if g >= NOUGHT * floor]
    change, c_at = _worst_leaf(prog["change_norms"], ref["change_norms"], moving)
    return {"loss": {"value": loss, "at": "steps 1-%d" % len(ref["losses"])},
            "grad": {"value": grad, "at": g_at},
            "change": {"value": change, "at": c_at,
                       "left_out": len(ref["grad_norms"]) - len(moving)}}


def judge(found: Dict[str, Dict], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    checks = {n: {"value": found[n]["value"], "limit": limits[n]} for n in ("loss", "grad",
                                                                              "change")}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
