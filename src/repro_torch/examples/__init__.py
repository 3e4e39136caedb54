"""Torch twins of the reference's ``examples/`` (``quickstart``,
``train_lm``, ``serve_lm``, ``plan_explorer``), run as
``python -m repro_torch.examples.<name>``.  They default to the CUDA card
and raise without one; pass ``--device cpu`` to run them on the CPU."""
