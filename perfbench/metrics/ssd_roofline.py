"""ssd_roofline: the Mamba-2 scan's share of its roofline in the traced
run's span pass, in %: the least time the card could take for the scans a
step (``perfbench.flops.least_seconds`` of the configuration's model
module's ``ssd_work``: operations over 989 TFLOP/s or bytes over 3.35
TB/s, whichever is longer) over the ``ssm.scan`` span's device time a step
(what ``ssd_scan_ms`` reads).  The scans a step: each call of the span, a
layer's forward or its re-run, and the backward of each layer's first
forward at twice a forward's work: the same count whatever implements the
scan."""

from perfbench import flops
from perfbench.reference import model


def read(rec):
    spans = rec.get("spans")
    row = spans["spans"].get("ssm.scan") if spans else None
    if not row or not row["device_ms"] + row["bwd_device_ms"]:
        return None
    config, mix = rec["config"], rec["mix"]
    module = model(config)
    n_micro = rec["plan"]["n_micro"] or 1
    ops, nbytes = module.ssd_work(config, mix["seq_len"])
    rows = mix["rows"] / n_micro  # the rows one call scans
    call = flops.least_seconds(ops * rows, nbytes * rows)
    calls = row["calls"] / spans["steps"]
    firsts = module.kinds(config).count("mamba_moe") * n_micro
    spent = (row["device_ms"] + row["bwd_device_ms"]) / spans["steps"] / 1e3
    return 100.0 * (calls + 2 * firsts) * call / spent
