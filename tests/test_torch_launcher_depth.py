"""The training launcher's first three losses by depth, on the card.

At full stablelm-3b width, batch 2 x seq 1024, the launcher's schedule
(``--steps 3``: lr 3e-4, warmup 2) and its own weights (``--seed 0``, the
port's torch init), the launcher's loss rises after step 1 at 32 units.
At 2 units the reference's and the port's Trainers agree and neither rises
(``tests/test_torch_full_width_parity.py``, on the reference's weights).
This file separates the remaining causes: it runs the launcher itself
(``repro_torch.launch.train.main``, plan and all) with the depth cut to
2-32 units on the port's own init, at 32 units in f32, and at 32 units
with a tenth of the learning rate, and prints each run's losses and grad
norms.  It imports neither jax nor the reference:

    PYTHONPATH=src python -m pytest -q -s --noconftest -m cuda \\
        tests/test_torch_launcher_depth.py

Without a card every case skips.
"""

import dataclasses
import gc
import importlib
import math

import pytest

torch = pytest.importorskip("torch")

TRAIN_ARGS = ["--arch", "stablelm-3b", "--steps", "3", "--batch", "2", "--seq", "1024"]

CASES = [(2, "bfloat16", 3e-4), (4, "bfloat16", 3e-4), (8, "bfloat16", 3e-4),
         (16, "bfloat16", 3e-4), (32, "bfloat16", 3e-4), (32, "float32", 3e-4),
         (32, "bfloat16", 3e-5)]


@pytest.mark.cuda
@pytest.mark.parametrize("units,dtype,lr", CASES)
def test_launcher_losses_by_depth(units, dtype, lr, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the launcher runs the port's kernels")
    train = importlib.import_module("repro_torch.launch.train")
    configs = importlib.import_module("repro_torch.configs")

    def cut(arch):
        return dataclasses.replace(configs.get_config(arch), n_layers=units, dtype=dtype)

    monkeypatch.setattr(train, "get_config", cut)
    gc.collect()
    torch.cuda.empty_cache()
    out = train.main(TRAIN_ARGS + ["--lr", str(lr)])
    losses, norms = out["losses"], out["grad_norms"]
    print(f"\n[depth] units {units} {dtype} lr {lr:g}: losses "
          + " ".join(f"{x:.6f}" for x in losses) + "; grad norms "
          + " ".join(f"{x:.6f}" for x in norms))
    assert out["n_units"] == units and out["step"] == 3 and out["skipped"] == 0
    assert all(math.isfinite(x) for x in losses + norms)
