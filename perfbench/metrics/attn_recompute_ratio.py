"""attn_recompute_ratio: flash forward launches over dq launches in the
window (the port's ``LAUNCHES`` counter); 1.0 when no attention is
recomputed, 1 + recomputed units / units under the plan."""


def read(rec):
    n = rec["launches"]
    if not n.get("flash_bwd_dq"):
        return None
    return n["flash_fwd"] / n["flash_bwd_dq"]
