"""Quickstart: plan ANY torch function's recomputation in three lines (port
of ``examples/quickstart.py``).

    planned = repro_torch.plan_function(loss_fn, budget_bytes)
    loss, grads = planned(params, x)       # value-and-grad twin

Behind the front door: the function is traced to the paper's graph
G = (V, E) (one node per aten op, ``make_fx`` in fake mode), the General
Recomputation Problem is solved under the byte budget by the DP (through
the content-addressed plan cache), and the plan is lowered onto autograd
by the ``"fx"`` backend, which caches exactly the set U_k.

Run: python -m repro_torch.examples.quickstart [--device cpu]
(The assertions double as the smoke test of the front door.)
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

import repro_torch
from repro_torch.core import PlanCache, Planner, vanilla_peak
from repro_torch.core.fx_graph import trace

from ._device import pick


def mlp_loss(params: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """A plain torch function: no BlockGraph, no framework cooperation."""
    h = x
    for w in params:
        h = torch.tanh(h @ w)
    return torch.sum(h * h)


def example_inputs(seed: int = 0) -> tuple:
    """Ten 32×32 weights (scale 0.3) and an (8, 32) input, from ``seed``."""
    rng = np.random.default_rng(seed)
    params = [(rng.standard_normal((32, 32)) * 0.3).astype(np.float32) for _ in range(10)]
    return params, rng.standard_normal((8, 32)).astype(np.float32)


def run(params: List[np.ndarray], x: np.ndarray, device: torch.device,
        log=print) -> Dict[str, Any]:
    """The quickstart on the given arrays; returns what it printed."""
    params = [torch.tensor(w, device=device) for w in params]
    x = torch.tensor(x, device=device)

    # 1. halve the activation budget and plan through the front door
    g = trace(mlp_loss, params, x).graph
    budget = vanilla_peak(g, liveness=False) / 2
    planner = Planner(cache=PlanCache())
    planned = repro_torch.plan_function(mlp_loss, budget, planner=planner)
    loss, grads = planned(params, x)
    lowered = planned.lowered_for(params, x)
    log(f"graph: {g.n} equations; budget {budget:.0f} B "
        f"(vanilla needs {vanilla_peak(g, liveness=False):.0f} B)")
    log(f"plan: {len(lowered.plan.segments)} segments, "
        f"analytic peak {lowered.plan.peak_memory:.0f} B, "
        f"overhead {lowered.plan.overhead:.0f} T-units, "
        f"backend {lowered.backend!r}")
    assert lowered.plan.peak_memory <= budget

    # 2. the canonical strategy never alters the computation (§3): loss and
    #    gradients are bit-identical to plain autograd
    leaves = [w.detach().requires_grad_() for w in params]
    ref_loss = mlp_loss(leaves, x)
    ref_grads = torch.autograd.grad(ref_loss, leaves)
    assert torch.equal(loss, ref_loss.detach())
    assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
    log(f"loss {float(loss):.6f} == vanilla, gradients bit-identical")

    # the paper-faithful interpreter backend audits the memory claim live
    audited = repro_torch.plan_function(mlp_loss, budget, backend="interpreter",
                                        planner=planner, track_live=True)
    _, _, live = audited(params, x)
    peak_live = max(b for _, b in live)
    log(f"measured live intermediates {peak_live} B <= "
        f"plan peak {lowered.plan.peak_memory:.0f} B")
    assert peak_live <= lowered.plan.peak_memory

    # 3. re-planning is a cache hit: a fresh planned function solves nothing
    before = planner.cache.stats()
    again = repro_torch.plan_function(mlp_loss, budget, planner=planner)
    again(params, x)
    after = planner.cache.stats()
    assert after["hits"] > before["hits"], (before, after)
    assert again.lowered_for(params, x).plan == lowered.plan
    log(f"second plan_function call: plan-cache hit "
        f"({after['hits']} hits, {after['misses']} misses)")
    log("OK — one pipeline: trace -> plan (cached) -> lowering.")
    return {"nodes": g.n, "budget": budget, "segments": len(lowered.plan.segments),
            "peak": lowered.plan.peak_memory, "overhead": lowered.plan.overhead,
            "loss": float(loss), "peak_live": peak_live}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return run(*example_inputs(args.seed), pick(args.device))


if __name__ == "__main__":
    main()
