"""``plan_lint`` — run the checkers over the paper's networks and traced
torch functions (port of ``repro/analysis/cli.py``).

    python -m repro_torch.analysis --network unet --device cpu
    python -m repro_torch.analysis --network unet --budget 2e9 --device cpu
    python -m repro_torch.analysis --smoke --json lint_report.json
    python -m repro_torch.analysis --hlo --drift-json BENCH_hlo_drift.json

``--network`` lints one of the paper's seven benchmark graphs
(``configs.paper_networks``): plan at the given budget (default: the exact
minimal feasible one) and run the plan verifier.  ``--traced
module:factory`` (or the built-in ``quickstart``) lints a real torch
function end to end: effect analysis → pinned planning → plan
verification → lowering conformance.  The factory returns ``(fn,
example_args)``; the arguments are moved to ``--device``.  ``--smoke``
runs every benchmark network plus the quickstart traced function — the CI
gate.

``--hlo`` adds the dispatch-truth checkers (``analysis.census``): each
network's abstract plan is lowered onto its executable twin
(``paper_networks.twin_value_and_grad``: the plan's cached nodes as the
``"policy"`` backend's names) on ``--device``, and the twin's heavy-op
census is held against plain autograd and the plan's eq. (1) recompute
count, its memory against the plan's analytic peak in the twin's bytes;
traced targets get the same through their carrier.  The drift gate reads
the card's allocator (on the CPU it warns ``memory-analysis-unavailable``).
Per-target drift records land in ``--drift-json`` (default
``BENCH_hlo_drift.json``).  ``--hlo`` alone runs every network plus the
quickstart.

``--device`` is ``cuda`` unless given; without a card ``cuda`` raises.
Planning alone touches no device.

Exit codes: 0 all clean, 1 lint errors, 2 infeasible budget (the exact
minimal feasible budget is printed — re-run with at least that).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .report import Report

EXIT_OK, EXIT_LINT, EXIT_INFEASIBLE = 0, 1, 2


def _quickstart_factory() -> Tuple[Callable[..., Any], Tuple[Any, ...]]:
    """The reference CLI's quickstart MLP in torch — the traced smoke target."""
    import torch

    def mlp_loss(params: Any, x: Any) -> Any:
        h = x
        for w in params:
            h = torch.tanh(h @ w)
        return torch.sum(h * h)

    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(16, 16, generator=gen) * 0.3 for _ in range(6)]
    x = torch.randn(4, 16, generator=gen)
    return mlp_loss, (params, x)


def _resolve_traced(spec: str) -> Tuple[Callable[..., Any], Tuple[Any, ...]]:
    if spec == "quickstart":
        return _quickstart_factory()
    import importlib

    mod_name, _, attr = spec.partition(":")
    if not attr:
        raise SystemExit(
            f"--traced wants 'module:factory' or 'quickstart', got {spec!r}"
        )
    return getattr(importlib.import_module(mod_name), attr)()


def _infeasible(planner: Any, g: Any, budget: Optional[float], method: str,
                prefix: str = "") -> Report:
    needed = planner.min_feasible_budget(g, method)
    r = Report(checker="plan")
    r.add(
        "error",
        "infeasible-budget",
        f"{prefix}no feasible strategy under budget {budget:g}; the exact minimal "
        f"feasible budget is {needed:g}",
    )
    return r


def lint_graph(
    g: Any,
    name: str,
    budget: Optional[float],
    method: str,
    hlo_records: Optional[List[Dict[str, Any]]] = None,
    device: Any = "cpu",
) -> Tuple[List[Report], bool]:
    """Plan ``g`` and verify; returns (reports, infeasible).

    With ``hlo_records`` (a list to append drift records to) the
    dispatch-truth checkers also run: the abstract plan is lowered onto the
    network's executable twin on ``device`` (``paper_networks``: one
    ``"policy"`` block a node, the plan's cached nodes kept) and its
    heavy-op census and memory are held against plain autograd and the
    plan.  Every node of the twin saves its inputs for its backward, so the
    backward unpacks every region: the eq. (1) band is exact, its low end
    the plan's own count.
    """
    from ..core.planner import get_default_planner

    planner = get_default_planner()
    rep = planner.plan(g, budget, method=method)
    if rep.plan is None:
        return [_infeasible(planner, g, budget, method, prefix=f"{name}: ")], True
    from .verifier import check_plan

    reports = [check_plan(g, rep.plan, budget=budget)]
    if hlo_records is not None:
        from ..configs import paper_networks as pn
        from ..core import dp
        from ..core.liveness import vanilla_peak
        from .census import HEAVY_NODE_KINDS, analyze_twin

        plan = rep.plan
        _, ex_args, byte_graph = pn.executable_twin(g, device=device)
        # analytic peak in the *twin's* byte units: same lower-set sequence,
        # per-node activation bytes of the toy shapes
        analytic_peak = dp.peak_memory_live(byte_graph, [s.lower_set for s in plan.segments])
        recompute = frozenset(range(g.n)) - plan.cached
        plan_heavy = sum(1 for v in recompute if g.nodes[v].kind in HEAVY_NODE_KINDS)
        res = analyze_twin(
            pn.twin_value_and_grad(g, plan),
            ex_args,
            recompute=recompute,
            owner={v: v for v in range(g.n)},
            plan_heavy_recompute=plan_heavy,
            unpacked_heavy_recompute=plan_heavy,
            analytic_peak=analytic_peak,
            vanilla_grad=pn.twin_value_and_grad(g),
            vanilla_peak=vanilla_peak(byte_graph, liveness=True),
        )
        res.drift.update(target=name, nodes=g.n, segments=len(plan.segments))
        hlo_records.append(res.drift)
        reports.append(res.report)
    return reports, False


def lint_traced(
    fn: Callable[..., Any],
    args: Sequence[Any],
    budget: Optional[float],
    method: str,
    hlo_records: Optional[List[Dict[str, Any]]] = None,
    target: str = "traced",
) -> Tuple[List[Report], bool]:
    """Full three-checker lint of a traced function; returns (reports,
    infeasible).

    With ``hlo_records`` (a list to append drift records to) the census and
    drift gate (``analysis.census``) run as a fourth stage.
    """
    from ..core.lowering.carriers import TracedCarrier
    from ..core.planner import get_default_planner
    from .conformance import check_lowering
    from .verifier import check_plan

    carrier = TracedCarrier.trace(fn, tuple(args), analyze_effects=True)
    ea = carrier.effects
    g = carrier.to_graph()
    planner = get_default_planner()
    rep = planner.plan(g, budget, method=method)
    if rep.plan is None:
        return [ea.report, _infeasible(planner, g, budget, method)], True
    reports = [
        ea.report,
        check_plan(g, rep.plan, budget=budget, effects=ea, fx=carrier.fx),
        check_lowering(carrier, rep.plan, args=args),
    ]
    if hlo_records is not None:
        from .census import analyze_hlo

        res = analyze_hlo(carrier, rep.plan, args=args)
        res.drift.update(target=target, nodes=g.n, segments=len(rep.plan.segments))
        hlo_records.append(res.drift)
        reports.append(res.report)
    return reports, False


def _run_target(
    name: str,
    run: Callable[[], Tuple[List[Report], bool]],
    results: List[Dict[str, Any]],
) -> Tuple[bool, bool]:
    """Execute one lint target; returns (had_errors, infeasible)."""
    t0 = time.perf_counter()
    reports, infeasible = run()
    dt = time.perf_counter() - t0
    ok = all(r.ok for r in reports)
    n_warn = sum(len(r.warnings()) for r in reports)
    print(f"{name:>16s}  {'OK' if ok else 'FAIL'}  "
          f"({len(reports)} checker(s), {n_warn} warning(s), {dt:.2f}s)")
    for r in reports:
        for f in r.findings:
            if f.severity != "info":
                where = f" @node {f.node}" if f.node is not None else ""
                print(f"    {f.severity}: [{r.checker}] {f.code}{where}: "
                      f"{f.message}")
    results.append({
        "target": name,
        "ok": ok,
        "seconds": dt,
        "reports": [r.to_dict() for r in reports],
    })
    return (not ok), infeasible


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="plan_lint: static soundness checks over plans",
    )
    ap.add_argument("--network", default=None,
                    help="one benchmark network (configs.paper_networks)")
    ap.add_argument("--traced", default=None,
                    help="'quickstart' or 'module:factory' returning "
                         "(fn, example_args)")
    ap.add_argument("--smoke", action="store_true",
                    help="lint every benchmark network plus the quickstart "
                         "traced function")
    ap.add_argument("--hlo", action="store_true",
                    help="dispatch-truth checks: heavy-op census of each "
                         "target's planned twin and the memory-drift gate "
                         "(alone, runs every network + quickstart)")
    ap.add_argument("--drift-json", default=None, metavar="PATH",
                    help="where --hlo writes its drift records "
                         "(default BENCH_hlo_drift.json)")
    ap.add_argument("--budget", type=float, default=None,
                    help="byte budget (default: exact minimal feasible)")
    ap.add_argument("--method", default="approx_dp",
                    choices=("approx_dp", "exact_dp"))
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the merged findings as a JSON artifact")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the twins and traced targets run (cuda "
                         "raises without a card)")
    args = ap.parse_args(argv)

    if not (args.network or args.traced or args.smoke or args.hlo):
        ap.error("pick one of --network / --traced / --smoke / --hlo")

    import torch
    import torch.utils._pytree as pytree

    from ..launch.train import resolve_device

    device = resolve_device(args.device)
    run_all = args.smoke or (args.hlo and not (args.network or args.traced))
    drift_records: List[Dict[str, Any]] = []
    hlo_records = drift_records if args.hlo else None

    targets: List[Tuple[str, Callable[[], Tuple[List[Report], bool]]]] = []
    if args.network or run_all:
        from ..configs.paper_networks import NETWORKS

        names = [args.network] if args.network else sorted(NETWORKS)
        for name in names:
            if name not in NETWORKS:
                raise SystemExit(
                    f"unknown network {name!r}; pick from {sorted(NETWORKS)}"
                )
            targets.append((
                name,
                lambda name=name: lint_graph(
                    NETWORKS[name](), name, args.budget, args.method,
                    hlo_records=hlo_records, device=device,
                ),
            ))
    if args.traced or run_all:
        spec = args.traced or "quickstart"
        fn, ex_args = _resolve_traced(spec)
        ex_args = pytree.tree_map(
            lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tuple(ex_args))
        targets.append((
            spec,
            lambda: lint_traced(fn, ex_args, args.budget, args.method,
                                hlo_records=hlo_records, target=spec),
        ))

    results: List[Dict[str, Any]] = []
    any_errors = False
    any_infeasible = False
    for name, run in targets:
        had_errors, infeasible = _run_target(name, run, results)
        any_errors |= had_errors
        any_infeasible |= infeasible

    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"ok": not any_errors, "targets": results}, fh,
                      indent=2)
        print(f"report written to {args.json}")

    if args.hlo:
        drift_path = args.drift_json or "BENCH_hlo_drift.json"
        with open(drift_path, "w") as fh:
            json.dump({"ok": not any_errors, "records": drift_records}, fh,
                      indent=2)
        print(f"drift records written to {drift_path}")

    if any_infeasible:
        return EXIT_INFEASIBLE
    return EXIT_LINT if any_errors else EXIT_OK


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
