"""repro_torch — the PyTorch/CUDA port of ``repro`` (graph-theoretic
recomputation planning, Kusumoto et al.), beside the JAX reference.

It never imports jax or ``repro``.  The planning core (``core``) is a copy
of the reference's numpy/stdlib modules; the dense LM, its trainer and
launcher are written in PyTorch; the flash-attention kernels are CUDA C++
for Hopper (``kernels/csrc``).  Entry points run on CUDA unless the caller
asks for the CPU.
"""
