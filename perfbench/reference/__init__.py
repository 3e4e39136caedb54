"""The plain reference of the benchmark's training cells, written in plain
PyTorch (float32, TF32 off) and computed in blocks so that it fits on the
card beside nothing else.  It imports nothing of the program; its weights
and batches come from the benchmark (``perfbench.weights``,
``perfbench.traffic``).

**A configuration names its model.**  ``configs/<config>.json`` may carry
``"model": "<module>"``, a module of this package; a file without the key
runs ``lm``.  A model module gives three things:

* ``leaves(config)``: every parameter as ``(name, shape, scale)``, named
  as the port's model names its parameters, in the order they are drawn
  (``scale`` multiplies an N(0, 1) draw; ``None`` is a leaf of ones).
  ``perfbench.weights`` draws them, and the harness holds the port's
  parameters to them, name for name and shape for shape;
* ``row_loss(P, config, tokens, labels, mm)``: the float32 summed
  next-token loss of one row (``tokens`` and ``labels`` (1, S)) over the
  leaves ``P`` (name -> tensor), with every product but a router's through
  ``mm``, so that the float8 control (:class:`Fp8Arith`) reaches it;
* ``model_flops(config, rows, seq_len)``: the model FLOPs of one training
  step, no recomputation counted (``perfbench.flops.model_flops``, read by
  ``metrics/mfu.py``).

:func:`follow` (``train.py``) runs any of them through the same row loop,
gradient norms and AdamW.  A new architecture is a new module here and a
configuration file that names it: no file that is here changes.
"""

import importlib

#: the model module of a configuration without ``"model"``
DEFAULT_MODEL = "lm"


def model(config: dict):
    """The model module that ``config`` names (``"model"``, else ``lm``)."""
    name = config.get("model", DEFAULT_MODEL)
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"a configuration's model is a module name: {name!r}")
    return importlib.import_module(f"{__name__}.{name}")


from .train import F32Arith, Fp8Arith, follow  # noqa: E402

__all__ = ["follow", "model", "Fp8Arith", "F32Arith"]
