"""update_ms: the AdamW update's time a step, from CUDA events around the
Trainer instance's ``_update`` over the window's steps, in ms."""

import statistics


def read(rec):
    spans = rec["window"].get("update_ms")
    return statistics.fmean(spans) if spans else None
