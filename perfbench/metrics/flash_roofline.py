"""flash_roofline: the flash kernels' share of their roofline in the
profiled steps, in %: the sum over their launches of the least time the
card could take (``perfbench.flops``: operations over 989 TFLOP/s or bytes
over 3.35 TB/s, whichever is longer) over their summed device time."""

from perfbench import flops


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    p, mix = rec["config"]["port"], rec["mix"]
    rows = mix["rows"] // rec["plan"]["n_micro"]
    work = flops.attention_work(rows, p["n_heads"], p["n_kv_heads"], mix["seq_len"],
                                mix["seq_len"], p["d_head"])
    bound = spent = 0.0
    for name, _, dur in prof["kernels"]:
        kind = next((k for k, frag in flops.FLASH_KERNELS.items() if frag in name), None)
        if kind is None:
            continue
        bound += flops.least_seconds(*work[kind])
        spent += dur * 1e-6
    return 100.0 * bound / spent if spent else None
