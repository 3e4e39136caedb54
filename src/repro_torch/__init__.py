"""repro_torch — the PyTorch/CUDA port of ``repro`` (graph-theoretic
recomputation planning, Kusumoto et al.), beside the JAX reference.

It never imports jax or ``repro``.  The planning core (``core``) is a copy
of the reference's numpy/stdlib modules; the dense, MoE and
Mamba2-hybrid LMs, their trainer and launchers are written in PyTorch; the flash-attention kernels are CUDA C++
for Hopper (``kernels/csrc``).  Entry points run on CUDA unless the caller
asks for the CPU.

    planned = repro_torch.plan_function(loss_fn, budget_bytes)
    loss, grads = planned(params, x)       # value-and-grad twin
"""


def __getattr__(name):  # PEP 562 lazy re-exports
    if name in ("plan_function", "PlannedFunction"):
        from repro_torch.core import lowering

        return getattr(lowering, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
