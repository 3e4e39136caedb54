"""Hardware constants of the port's target card (NVIDIA H100 SXM).

The reference's ``repro/launch/mesh.py`` holds TPU v5e constants and builds
jax meshes.  One card needs no mesh; what the planners need from this
module is the card's memory, which is read from the device itself
(``torch.cuda.get_device_properties(dev).total_memory``) and threaded
through ``launch.plan`` as ``hbm_bytes``.  ``REFERENCE_HBM_BYTES`` is the
reference's 16 GiB v5e figure, kept so tests can pin the reference's budget.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

# H100 SXM data-sheet peaks (dense, at the 700 W power limit)
PEAK_FLOPS_BF16 = 989e12  # per card, tensor cores
PEAK_FLOPS_F32 = 67e12  # per card, CUDA cores (no TF32)
HBM_BW = 3.35e12  # bytes/s per card
#: the reference's per-chip HBM (TPU v5e, ``repro/launch/mesh.py:20``)
REFERENCE_HBM_BYTES = 16 * 1024**3


def device_hbm_bytes(device: Optional[Union[str, torch.device]] = None) -> int:
    """Total memory of one CUDA card; raises when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"device memory is read from a CUDA card, got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass hbm_bytes explicitly on the CPU")
    return int(torch.cuda.get_device_properties(dev).total_memory)


def planning_hbm_bytes(device: torch.device) -> float:
    """The memory a launcher plans against on ``device``: the card's on
    CUDA, the reference's per-device figure on the CPU (so CPU plans equal
    the reference's)."""
    return device_hbm_bytes(device) if device.type == "cuda" else REFERENCE_HBM_BYTES
