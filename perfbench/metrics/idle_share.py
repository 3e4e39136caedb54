"""idle_share: share of the profiled steps' wall time in which no kernel,
copy or fill runs on the card, in %: one minus their device-busy time (the
union of the trace's device intervals) over their wall time on the host's
clock, from the first step's batch to the sync after the last; both terms
from the same steps, as ``device.busy_s`` and ``device.window_s`` give
them.  The profiler slows the host's dispatch, so where the host sets the
pace this reads above an unprofiled step's idle share."""

from perfbench.harness import busy_seconds


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["kernels"] or not prof["wall_s"]:
        return None
    return 100.0 * (1.0 - busy_seconds(prof["kernels"]) / prof["wall_s"])
