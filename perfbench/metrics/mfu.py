"""mfu: the window's model FLOPs (``perfbench.flops.model_flops``, no
recomputation counted) over its wall time, as a share of the H100's bf16
peak, in %.  The traced run's window steps run without the profiler."""

from perfbench import flops


def read(rec):
    win = rec["window"]
    if not win["steps"]:
        return None
    done = flops.model_flops(rec["config"], rec["mix"]["rows"], rec["mix"]["seq_len"]) * win["steps"]
    return 100.0 * done / win["seconds"] / flops.PEAK_FLOPS_BF16
