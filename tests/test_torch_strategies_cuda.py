"""Offloaded residuals on the card: the ``"fx"`` twin of an offload plan
keeps its cached residuals in pinned host memory between the forward and
the backward, holds fewer device bytes there and peaks lower than the same
lower-set sequence stored on the device, with bitwise the same values.

This file imports neither jax nor the reference, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_strategies_cuda.py

Without a card every case skips.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import make_plan  # noqa: E402
from repro_torch.core.dp import min_feasible_budget_exact, solve  # noqa: E402
from repro_torch.core.lower_sets import all_lower_sets  # noqa: E402
from repro_torch.core.lowering import TracedCarrier  # noqa: E402
from repro_torch.core.lowering import fx as fx_lowering  # noqa: E402
from repro_torch.core.lowering import storage  # noqa: E402
from repro_torch.core.strategies import OFFLOAD, StrategyConfig  # noqa: E402

WIDTH, DEPTH, BATCH = 512, 8, 4096  # activations (128 MB) dominate the grads (8 MB)


def mlp(params, x):
    h = x
    for w in params:
        h = torch.tanh(h @ w)
    return torch.sum(h * h)


@pytest.mark.cuda
def test_offloaded_residuals_live_in_pinned_host_memory(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: offload moves residuals off the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = [torch.randn(WIDTH, WIDTH, device=dev, generator=gen) / WIDTH ** 0.5
              for _ in range(DEPTH)]
    x = torch.randn(BATCH, WIDTH, device=dev, generator=gen)
    carrier = TracedCarrier.trace(mlp, (params, x))
    g = carrier.to_graph()
    cfg = StrategyConfig(strategies=("store", "recompute", "offload"))
    fam = all_lower_sets(g)
    budget = min_feasible_budget_exact(g, fam, strategies=cfg)
    res = solve(g, budget, fam, objective="memory_centric", strategies=cfg)
    offload = make_plan(g, res.sequence, assignment=res.assignment, strategies=cfg)
    stored = make_plan(g, res.sequence)  # the same sequence, every residual on the card
    assert any(c == OFFLOAD for c in offload.strategy.values())

    copies, at_backward = [], {}
    host_bytes, grads_like = storage.host_bytes, fx_lowering.grads_like

    def spy_copy(t, memo=None):
        out = host_bytes(t, memo)
        copies.append(out)
        return out

    def spy_backward(loss, leaves):
        torch.cuda.synchronize()
        at_backward[spy_backward.tag] = torch.cuda.memory_allocated()
        return grads_like(loss, leaves)

    monkeypatch.setattr(storage, "host_bytes", spy_copy)
    monkeypatch.setattr(fx_lowering, "grads_like", spy_backward)
    out, peaks = {}, {}
    for tag, plan in (("stored", stored), ("offload", offload)):
        run = fx_lowering.fx_value_and_grad(carrier, plan)
        spy_backward.tag = tag
        run(params, x)  # warm-up: cuBLAS workspaces stay out of the peaks
        copies.clear()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out[tag] = run(params, x)
        torch.cuda.synchronize()
        peaks[tag] = torch.cuda.max_memory_allocated() - before
        at_backward[tag] -= before
        if tag == "offload":
            assert copies and all(c.device.type == "cpu" and c.is_pinned() for c in copies)
            assert sum(c.numel() for c in copies) >= sum(
                g.nodes[v].memory for v, c in offload.strategy.items() if c == OFFLOAD)
        else:
            assert not copies
    assert at_backward["offload"] < at_backward["stored"]
    assert peaks["offload"] < peaks["stored"]
    (v0, g0), (v1, g1) = out["stored"], out["offload"]
    assert torch.equal(v0, v1) and all(torch.equal(a, b) for a, b in zip(g0, g1))
