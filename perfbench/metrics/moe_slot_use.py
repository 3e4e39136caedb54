"""moe_slot_use: the share of the experts' capacity slots that carry a kept
route in the traced run's span pass, in %: 100 x the program's ``moe.kept``
counter over its ``moe.slots`` (``perfbench.spans.moe_slot_use``); nothing
where no MoE layer ran."""

from perfbench import spans


def read(rec):
    return spans.moe_slot_use(rec.get("spans"))
