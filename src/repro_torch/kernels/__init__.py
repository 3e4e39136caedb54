"""Hand-written Hopper kernels of the port (CUDA C++ for sm_90a).

flash_attention: online-softmax attention whose backward *recomputes* the
probability tiles instead of caching the O(S²) score matrix — the paper's
recompute-don't-cache trade at the tile level.  Replaces the Pallas TPU
kernels of ``repro.kernels``; the plain versions in ``kernels.ref`` serve
CPU tensors and are what the kernels are held against on the card.
"""

from .ops import flash_attention

__all__ = ["flash_attention"]
