"""Plan explorer: the paper's Table-1 methods on an assigned architecture or
an **arbitrary traced torch function**, with an ASCII memory-vs-overhead
frontier (port of ``examples/plan_explorer.py``).

The whole exploration is ONE budget-free DP pass: ``Planner.solve_grid``
builds a capped sweep (``core.dp.sweep``) whose terminal frontier carries
the exact ``min_feasible_budget`` and every (budget → plan) point at once,
and caches it in the content-addressed plan cache under the budget-free
``sweep`` entry kind — so re-exploring a graph, or pointing --cache-dir
(or REPRO_PLAN_CACHE_DIR) at a shared store, re-runs no DP at all.

Run: python -m repro_torch.examples.plan_explorer --arch stablelm-3b
     python -m repro_torch.examples.plan_explorer --traced demo --device cpu
     python -m repro_torch.examples.plan_explorer --traced pkg.mod:factory

``--traced`` explores any model via the ``plan_function`` front door: pass
``module:factory`` where ``factory()`` returns ``(fn, example_args)`` (the
arguments move to ``--device``) — the function is traced (one graph node
per aten op) and explored.  ``demo`` uses a built-in MLP factory,
``bg-demo`` a BlockGraph.  ``--network`` needs the paper's benchmark graphs
(``benchmarks.networks``), which are not ported: it raises.  ``--arch``
plans the launcher's unit chain and runs nothing.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch
import torch.utils._pytree as pytree

from repro_torch.core import chen_sqrt_n, get_default_planner, simulate, vanilla_peak

from ._device import pick


def _gb(x: float) -> str:
    """Adaptive byte formatting (architecture chains are GB, traced demos KB)."""
    if x >= 1e8:
        return f"{x/1e9:.2f} GB"
    if x >= 1e5:
        return f"{x/1e6:.2f} MB"
    return f"{x:.0f} B"


def frontier(g, n_points: int = 8, budget: Optional[float] = None) -> None:
    """One sweep: exact min budget + the whole trade-off curve.

    ``budget`` anchors the explored range at a caller-chosen B instead of
    the minimal feasible one; an infeasible B exits non-zero (code 2) and
    prints the exact budget that would have worked.
    """
    planner = get_default_planner()
    fam = planner.family(g, "approx_dp")  # memoized — shared with the solves
    B_min = planner.min_feasible_budget(g, "approx_dp")  # exact, no search
    van = vanilla_peak(g, liveness=True)
    print(f"#V={g.n}  #L^pruned={len(fam)}  vanilla peak={_gb(van)}  "
          f"min_feasible_budget={_gb(B_min)} (exact)")
    if budget is not None and budget < B_min:
        print(f"budget {_gb(budget)} is INFEASIBLE: no strategy fits — "
              f"the exact minimal feasible budget is {_gb(B_min)} "
              f"({B_min:.0f} bytes); re-run with at least that")
        raise SystemExit(2)
    chen = chen_sqrt_n(g)
    chen_pk = simulate(g, chen.sequence, liveness=True).peak_memory
    print(f"Chen √n: peak {_gb(chen_pk)}, overhead "
          f"{100*chen.overhead/g.total_time:.0f}% of fwd\n")

    B_lo = budget if budget is not None else B_min
    budgets = [B_lo * (1.0 + 3.0 * i / max(n_points - 1, 1)) for i in range(n_points)]
    t0 = time.perf_counter()
    results = planner.solve_grid(g, budgets, "approx_dp")  # one capped sweep
    grid_s = time.perf_counter() - t0
    grid_tier = planner.cache.last_tier or "local DP (now cached)"
    planner.cache.last_tier = None  # so the warm label reflects this call
    t0 = time.perf_counter()
    planner.solve(g, budgets[0], "approx_dp")
    warm_s = time.perf_counter() - t0
    warm_tier = planner.cache.last_tier or "in-process memo"
    print(f"solve_grid: {grid_s*1e3:.1f} ms (plan from {grid_tier}); "
          f"warm re-solve {warm_s*1e3:.2f} ms (from {warm_tier})\n")
    rows = []
    for res in results:
        if not res.feasible:
            continue
        pk = simulate(g, res.sequence, liveness=True).peak_memory
        rows.append((pk, 100 * res.overhead / g.total_time, res.num_segments))
    if not rows:
        print(f"no feasible plan in the explored range "
              f"[{_gb(budgets[0])}, {_gb(budgets[-1])}] — the exact minimal "
              f"feasible budget is {_gb(B_min)}")
        raise SystemExit(2)
    print(f"{'peak':>12s} {'overhead%':>10s} {'segments':>9s}  frontier")
    max_oh = max(oh for _, oh, _ in rows) or 1
    for pk, oh, k in rows:
        bar = "#" * int(1 + 40 * oh / max_oh)
        print(f"{_gb(pk):>12s} {oh:10.1f} {k:9d}  {bar}")

    # the sweep's own Pareto staircase: every budget regime below the cap
    from repro_torch.core import SweepOverflow

    try:
        crit = planner.frontier(g, "approx_dp")
    except SweepOverflow:
        return  # surface too wide for a full sweep — grid above suffices
    print(f"\n{len(crit)} critical budgets (full frontier from one sweep; "
          f"the first is min_feasible_budget):")
    for B, oh in crit[:12]:
        print(f"  B ≥ {_gb(B):>12s} → overhead {100*oh/g.total_time:5.1f}%")
    if len(crit) > 12:
        print(f"  … {len(crit) - 12} more")


def _demo_factory():
    """Built-in --traced entry: a 12-layer tanh MLP with a skip connection
    (weights scale 0.2, a (16, 64) input, from torch's generator seed 0)."""

    def fn(params, x):
        h = x
        skip = None
        for i, w in enumerate(params):
            h = torch.tanh(h @ w)
            if i == 2:
                skip = h
            if i == 8:
                h = h + skip
        return torch.sum(h * h)

    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(64, 64, generator=gen) * 0.2 for _ in range(12)]
    return fn, (params, torch.randn(16, 64, generator=gen))


def _bg_demo_factory():
    """Built-in BlockGraph demo: a 6-block tanh·matmul chain plus loss."""
    from repro_torch.core.blockgraph import Block, BlockGraph

    def mk(name, src):
        return Block(
            name=name,
            apply=lambda p, h: torch.tanh(h @ p["w"]),
            inputs=(src,),
            init=lambda gen, shp: {"w": torch.randn(shp[-1], shp[-1], generator=gen) * 0.2},
        )

    bg = BlockGraph([mk(f"b{i}", "x" if i == 0 else f"b{i-1}") for i in range(6)],
                    ["x"], ["b5"])
    gen = torch.Generator().manual_seed(0)
    params = bg.init(gen, {"x": (16, 64)})
    inputs = {"x": torch.randn(16, 64, generator=gen)}
    return bg, (params, inputs), lambda out: torch.sum(out * out)


def traced_graph(spec: str, backend: str = "auto", device: str = "cuda"):
    """``module:factory`` / ``demo`` / ``bg-demo`` → paper graph via the
    front door, planned with the chosen lowering ``backend``."""
    dev = pick(device)
    loss_fn = None
    if spec == "demo":
        fn, args = _demo_factory()
    elif spec == "bg-demo":
        fn, args, loss_fn = _bg_demo_factory()
    else:
        import importlib

        mod_name, _, attr = spec.partition(":")
        if not attr:
            raise SystemExit(
                f"--traced wants 'module:factory', 'demo' or 'bg-demo', got {spec!r}")
        fn, args = getattr(importlib.import_module(mod_name), attr)()
    args = pytree.tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t, args)
    import repro_torch

    planned = repro_torch.plan_function(fn, backend=backend, loss_fn=loss_fn)
    lowered = planned.lowered_for(*args)
    g = lowered.carrier.to_graph()
    print(f"traced {spec}: {g.n} nodes, backend {lowered.backend!r}, "
          f"plan at min_feasible_budget: {len(lowered.plan.segments)} "
          f"segments, overhead {lowered.plan.overhead:.0f} T-units")
    return g


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--network", default=None,
                    help="one of the paper's nets (not ported: raises)")
    ap.add_argument("--arch", default=None, help="assigned architecture id")
    ap.add_argument("--traced", default=None,
                    help="'demo', 'bg-demo' or 'module:factory' returning "
                         "(fn, example_args)")
    ap.add_argument("--backend", default="auto",
                    help="lowering backend for --traced (auto | fx | segment | interpreter)")
    ap.add_argument("--budget", type=float, default=None,
                    help="anchor the explored budget range at B bytes; an "
                         "infeasible B exits with code 2 and prints the "
                         "exact minimal feasible budget")
    ap.add_argument("--cache-dir", default=None,
                    help="on-disk plan cache (re-runs become lookups)")
    ap.add_argument("--remote", default=None,
                    help="fleet plan store path/URL (read-through under the local tiers)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where --traced runs its twin and "
                         "whose memory --arch budgets")
    args = ap.parse_args(argv)
    dev = pick(args.device)

    if args.cache_dir:
        from repro_torch.core import set_default_cache_dir

        set_default_cache_dir(args.cache_dir)
    if args.remote:
        from repro_torch.core import set_default_remote_store

        set_default_remote_store(args.remote)

    if args.traced:
        g = traced_graph(args.traced, backend=args.backend, device=args.device)
    elif args.arch:
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.launch.plan import chain_graph, plan_inputs

        cfg = get_config(args.arch)
        from repro_torch.launch.mesh import REFERENCE_HBM_BYTES

        # the card's memory on CUDA, the reference's on the CPU
        pi = plan_inputs(cfg, SHAPES["train_4k"], dp_shards=16, model_shards=16,
                         hbm_bytes=REFERENCE_HBM_BYTES if dev.type == "cpu" else None)
        g = chain_graph(pi)
        print(f"arch {args.arch}: unit chain, {pi.n_units} units, "
              f"interior {pi.bytes_interior/1e9:.2f} GB/unit")
    else:
        from repro_torch.core.lowering.base import not_ported

        raise not_ported("--network (the paper's benchmark graphs, benchmarks.networks)",
                         "Benchmarks + examples")
    frontier(g, budget=args.budget)


if __name__ == "__main__":
    main()
