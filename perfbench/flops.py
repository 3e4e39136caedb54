"""Operations and bytes, counted from shapes: the model's FLOPs a training
step needs, and the work of each flash-attention kernel launch, with the
H100's published peaks they are held against.

A step's model FLOPs are the configuration's model module's
(:func:`model_flops`: ``model_flops`` of the module under
``perfbench/reference/`` that the configuration names), so a new
architecture brings its own count.  The kernel counts are copied from the
port's ``chip_smoke.py`` (``attention_bounds``): a product over the (query,
key) pairs the causal mask keeps; the forward does two, the dq kernel
three, the dk/dv kernel four; each input byte is counted once and each
output byte once.
"""

from __future__ import annotations

from typing import Dict, Tuple

#: NVIDIA H100 SXM data sheet, dense, at its 700 W power limit
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12

#: the kernels' names in the port's launch counter, and fragments of their
#: device function names in a profiler trace (bf16 and f32 routes alike)
FLASH_KERNELS = {"flash_fwd": "fwd_kernel", "flash_bwd_dq": "dq_kernel",
                 "flash_bwd_dkv": "dkv_kernel"}


def causal_pairs(sq: int, sk: int, causal: bool = True) -> int:
    """(query, key) pairs the mask keeps; queries end-aligned to the keys."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(max(i + off + 1, 0), sk) for i in range(sq))


def attention_work(B: int, H: int, KV: int, Sq: int, Sk: int, D: int,
                   itemsize: int = 2, causal: bool = True) -> Dict[str, Tuple[float, float]]:
    """Kernel name -> (operations, bytes) of one launch."""
    product = 2.0 * D * causal_pairs(Sq, Sk, causal) * B * H
    x = B * H * Sq * D * itemsize
    kv = B * KV * Sk * D * itemsize
    stat = B * H * Sq * 4
    return {
        "flash_fwd": (2 * product, x + 2 * kv + x + stat),
        "flash_bwd_dq": (3 * product, x + 2 * kv + x + 2 * stat + x),
        "flash_bwd_dkv": (4 * product, x + 2 * kv + x + 2 * stat + 2 * kv),
    }


def least_seconds(ops: float, nbytes: float, peak: float = PEAK_FLOPS_BF16) -> float:
    """The roofline's bound on one launch: the larger of its operations over
    the peak rate and its bytes over the memory's rate."""
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)


def model_flops(config: dict, rows: int, seq_len: int) -> float:
    """FLOPs of one training step on ``rows`` x ``seq_len`` tokens, not
    counting recomputation, as the configuration's model module counts them
    (``model_flops`` of ``perfbench.reference.model(config)``)."""
    from perfbench.reference import model

    return model(config).model_flops(config, rows, seq_len)
