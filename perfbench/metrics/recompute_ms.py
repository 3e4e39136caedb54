"""recompute_ms: device time of the segments' re-runs inside the backward,
ms a step, from the program's ``remat.recompute`` span in the traced run's
span pass (``perfbench.spans.recompute_ms``); 0.0 where the plan
recomputes nothing."""

from perfbench import spans


def read(rec):
    return spans.recompute_ms(rec.get("spans"))
