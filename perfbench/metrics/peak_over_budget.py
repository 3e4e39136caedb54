"""peak_over_budget: the window's ``max_memory_allocated`` over the cell's
memory budget (the ``hbm_bytes`` the plan was made for)."""


def read(rec):
    if not rec["peak_bytes"]:
        return None
    return rec["peak_bytes"] / rec["budget_bytes"]
