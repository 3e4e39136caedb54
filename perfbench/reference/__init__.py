"""The plain reference of the benchmark's training cells: a float32 dense
or MoE language model with its loss, gradients and AdamW steps, written in
plain PyTorch (TF32 off) and computed in blocks so that it fits on the
card beside nothing else.  It imports nothing of the program; its weights
and batches come from the benchmark (``perfbench.weights``,
``perfbench.traffic``)."""

from .lm import follow, Fp8Arith, F32Arith

__all__ = ["follow", "Fp8Arith", "F32Arith"]
