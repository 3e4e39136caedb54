"""matmul_ms: device time of matrix-product kernels a step in the profiled
steps, in ms (kernel names as the profile's classification: flash kernels
first, then gemm, xmma, nvjet, cutlass or cublas)."""

from perfbench import flops
from perfbench.harness import MATMUL_FRAGMENTS


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["kernels"]:
        return None
    total = 0.0
    for name, _, dur in prof["kernels"]:
        if any(f in name for f in flops.FLASH_KERNELS.values()):
            continue
        if any(f in name.lower() for f in MATMUL_FRAGMENTS):
            total += dur
    return total / 1e3 / prof["steps"]
