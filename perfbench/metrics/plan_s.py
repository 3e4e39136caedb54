"""plan_s: wall seconds of ``build_train_step``'s planning in set-up (a
plan-cache lookup once the checkout's first run has planned)."""


def read(rec):
    return rec["plan"]["seconds"]
