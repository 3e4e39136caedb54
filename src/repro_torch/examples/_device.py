"""The examples' device: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def pick(device: str) -> torch.device:
    """``device`` as a ``torch.device``; CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run this example on the CPU")
    return dev
