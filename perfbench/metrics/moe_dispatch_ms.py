"""moe_dispatch_ms: device time of the MoE dispatch, ms a step: the
forwards, re-runs and backward nodes of the program's ``moe.route``,
``moe.pack`` and ``moe.combine`` spans in the traced run's span pass
(``perfbench.spans.moe_dispatch_ms``); nothing where no MoE layer ran."""

from perfbench import spans


def read(rec):
    return spans.moe_dispatch_ms(rec.get("spans"))
