"""A tiny cell end to end on the card: the flash kernels built and
launched, ``correct`` true, and the traced run's readers in range.  Skips
without a CUDA card."""

import pytest
import torch

from perfbench.tests.tiny import tiny_cell


@pytest.mark.cuda
def test_tiny_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    from perfbench import harness

    files = tiny_cell("stablelm-3b", "bfloat16", rows=2, seq=256)
    metrics = ["mfu", "attn_recompute_ratio", "flash_roofline", "idle_share", "matmul_ms",
               "update_ms", "peak_over_budget"]
    out = harness.run_cell(files["cell"]["name"], 5, 0.5, True, device="cuda", loaded=files,
                           metrics=metrics)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert out["metrics"]["attn_recompute_ratio"]["value"] >= 1.0
    assert 0 < out["metrics"]["flash_roofline"]["value"] <= 105
    assert 0 <= out["metrics"]["idle_share"]["value"] < 100
