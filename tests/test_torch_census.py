"""The port's dispatch-truth checks (``repro_torch.analysis.census``), the
twin of the reference's HLO checks (``tests/test_hlo_analysis.py``, its
CPU-runnable cases restated).

* on a planned MLP the heavy-op census is exact: the planned twin runs plain
  autograd's heavy ops plus one per heavy node of ``V \\ U_k``, and reruns
  only nodes of ``V \\ U_k``; the census agrees with the reference's own
  census of the same plan over the JAX twin;
* a lowering that recomputes beyond the plan fails (``recompute-exceeds-eq1``);
* the band ``[unpacked, V \\ U_k]`` admits the ``"fx"`` lowering's documented
  elision and rejects counts outside it;
* ``drift_findings`` gives its three statuses; on the CPU the gate warns
  ``memory-analysis-unavailable`` and records no bytes;
* plain autograd's runs are skipped, with a warning, when its peak does not
  fit on the device;
* ``plan_function(verify_hlo=True)`` runs end to end, keeps its record on
  the lowering, and the checks leave the caller's RNG untouched.

Tolerances: counts are exact integers; losses and grads bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

import repro_torch  # noqa: E402
from repro.analysis.hlo import heavy_census as rheavy_census  # noqa: E402
from repro.core.lowering.carriers import TracedCarrier as RTracedCarrier  # noqa: E402
from repro.core.lowering.policy import traced_value_and_grad as rtwin  # noqa: E402
from repro.core.schedule import make_plan as rmake_plan  # noqa: E402
from repro_torch.analysis import Report, census  # noqa: E402
from repro_torch.analysis.census import (  # noqa: E402
    DRIFT_ABS_SLACK,
    DRIFT_REL,
    analyze_hlo,
    analyze_twin,
    check_hlo,
    drift_findings,
    example_args,
)
from repro_torch.core import PlanCache, Planner, vanilla_peak  # noqa: E402
from repro_torch.core.lowering import fx_value_and_grad, vanilla_traced_value_and_grad  # noqa: E402
from repro_torch.core.lowering.carriers import BlockGraphCarrier, TracedCarrier  # noqa: E402

DN = (((1,), (0,)), ((), ()))


def _np_mlp(n=6, d=16, seed=0):
    r = np.random.default_rng(seed)
    params = [(r.standard_normal((d, d)) * 0.3).astype(np.float32) for _ in range(n)]
    return params, r.standard_normal((4, d)).astype(np.float32)


def mlp(params, x):
    h = x
    for w in params:
        h = torch.tanh(h @ w)
    return torch.sum(h * h)


def jmlp(params, x):
    h = x
    for w in params:
        h = lax.tanh(lax.dot_general(h, w, DN))
    return jnp.sum(h * h)


def _planned(budget=None, n=6):
    np_args = _np_mlp(n)
    args = ([torch.tensor(w) for w in np_args[0]], torch.tensor(np_args[1]))
    c = TracedCarrier.trace(mlp, args)
    g = c.to_graph()
    plan = Planner(cache=PlanCache()).plan(g, budget, "exact_dp").plan
    return c, g, plan, args, np_args


def _heavy_recompute(g, plan):
    rec = set(range(g.n)) - plan.cached
    return sum(1 for v in rec if g.nodes[v].kind in census.HEAVY_NODE_KINDS)


def test_census_is_exact_on_a_planned_mlp():
    c, g, plan, args, np_args = _planned()
    heavy = _heavy_recompute(g, plan)
    assert heavy > 0
    res = analyze_hlo(c, plan, args=args)
    assert res.report.ok, str(res.report)
    cen = res.census
    assert cen.extra == cen.plan_recompute == cen.unpacked_recompute == heavy
    assert cen.rerun and cen.rerun <= set(range(g.n)) - plan.cached
    assert "heavy-multiplicity-ok" in {f.code for f in res.report.findings}
    rec = res.drift
    assert rec["heavy_planned"] - rec["heavy_vanilla"] == heavy
    # the reference's census of the same plan over its JAX twin counts the
    # same heavy recompute (its remat bodies' named dot_generals)
    jc = RTracedCarrier.trace(jmlp, jax.tree_util.tree_map(jnp.asarray, np_args))
    rplan = rmake_plan(jc.to_graph(), [s.lower_set for s in plan.segments])
    closed = jax.make_jaxpr(rtwin(jc, rplan))(*jax.tree_util.tree_map(jnp.asarray, np_args))
    assert rheavy_census(closed).remat_named == heavy


def test_unpacked_recompute_frees_every_value_it_made():
    """The census's plain run keeps no value alive after it returns (its
    saved-tensor hook once returned each tensor itself, a cycle through
    ``grad_fn`` that Python cannot collect: on the card phase analysis left
    7.5e9 B allocated)."""
    import gc
    import weakref

    c, g, plan, args, _ = _planned()
    made = []
    run_node = c.fx.run_node

    def watched(node, read):
        out = run_node(node, read)
        if isinstance(out, torch.Tensor):
            made.append(weakref.ref(out))
        return out

    c.fx.run_node = watched
    assert census.unpacked_recompute(c, plan, args)
    gc.collect()
    assert made and all(r() is None for r in made)


def test_census_fails_on_a_lowering_that_recomputes_beyond_the_plan():
    c, g, tight, args, _ = _planned()
    roomy = Planner(cache=PlanCache()).plan(g, vanilla_peak(g, liveness=True), "exact_dp").plan
    assert _heavy_recompute(g, tight) > _heavy_recompute(g, roomy)
    r = check_hlo(c, roomy, args=args, lowered=fx_value_and_grad(c, tight))
    assert not r.ok
    assert "recompute-exceeds-eq1" in {f.code for f in r.errors()}
    assert check_hlo(c, roomy, args=args).ok


@pytest.mark.parametrize("high,low,code,ok", [
    (None, None, "heavy-multiplicity-ok", True),
    (+1, 0, "recompute-elided", True),       # one planned rerun elided
    (-1, -1, "recompute-exceeds-eq1", False),  # more reruns than the plan has
    (+1, +1, "heavy-multiplicity-mismatch", False),  # fewer than the band allows
])
def test_the_band_admits_only_the_documented_elision(high, low, code, ok):
    c, g, plan, args, _ = _planned()
    heavy = _heavy_recompute(g, plan)
    res = analyze_twin(
        fx_value_and_grad(c, plan), args,
        recompute=frozenset(range(g.n)) - plan.cached, owner=c.fx.owner,
        plan_heavy_recompute=heavy + (high or 0),
        unpacked_heavy_recompute=heavy + (low or 0),
        analytic_peak=plan.peak_memory,
        vanilla_grad=vanilla_traced_value_and_grad(c))
    assert code in {f.code for f in res.report.findings}
    assert res.report.ok == ok


def test_drift_findings_three_statuses():
    r = Report(checker="hlo")
    assert drift_findings(r, analytic_peak=1e6, temp_bytes=1.2e6) == "ok"
    assert drift_findings(r, analytic_peak=1e6, temp_bytes=5e6, ceiling=4e6) == "remat-elided"
    assert drift_findings(r, analytic_peak=1e6, temp_bytes=5e6) == "drift"
    assert drift_findings(r, analytic_peak=1e6, temp_bytes=1e7, ceiling=2e6) == "drift"
    assert [f.code for f in r.findings] == ["memory-drift-ok", "memory-drift-remat-elided",
                                            "memory-drift", "memory-drift"]
    assert [f.severity for f in r.findings] == ["info", "warning", "error", "error"]
    band = 1e6 * (1 + DRIFT_REL) + DRIFT_ABS_SLACK
    assert drift_findings(Report("hlo"), analytic_peak=1e6, temp_bytes=band) == "ok"
    assert drift_findings(Report("hlo"), analytic_peak=1e6, temp_bytes=band + 1) == "drift"


def test_the_cpu_gate_warns_and_invents_no_number():
    c, g, plan, args, _ = _planned()
    res = analyze_hlo(c, plan, args=args)
    warns = [f.code for f in res.report.warnings()]
    assert warns == ["memory-analysis-unavailable"]
    assert res.drift["analytic_peak_bytes"] == plan.peak_memory
    for key in ("temp_bytes", "vanilla_temp_bytes", "drift_status"):
        assert key not in res.drift
    assert census.temp_bytes(lambda *a: None, args) is None


def test_vanilla_runs_are_skipped_when_they_do_not_fit(monkeypatch):
    """Plain autograd needs its own peak: when the device cannot hold it the
    census and the gate run without it and say so, and the planned twin is
    still checked."""
    c, g, plan, args, _ = _planned()
    full = analyze_hlo(c, plan, args=args)
    assert full.census.vanilla is not None
    monkeypatch.setattr(census, "free_device_bytes", lambda dev: int(vanilla_peak(g)) - 1)
    res = analyze_hlo(c, plan, args=args)
    assert res.report.ok
    assert [f.code for f in res.report.warnings()] == ["vanilla-run-skipped",
                                                       "memory-analysis-unavailable"]
    assert res.census.vanilla is None and res.census.planned == full.census.planned
    assert "vanilla_temp_bytes" not in res.drift
    monkeypatch.setattr(census, "free_device_bytes", lambda dev: int(vanilla_peak(g)))
    assert analyze_hlo(c, plan, args=args).census.vanilla == full.census.vanilla


def test_check_hlo_is_not_applicable_to_a_blockgraph():
    r = check_hlo(BlockGraphCarrier(bg=None, loss_fn=None, params=None, inputs={}), None)
    assert r.ok and [f.code for f in r.findings] == ["not-applicable"]


def test_example_args_follow_the_traced_signature():
    c, _, plan, args, _ = _planned()
    ex = example_args(c)
    assert [(t.shape, t.dtype) for t in torch.utils._pytree.tree_leaves(ex)] == \
        [(t.shape, t.dtype) for t in torch.utils._pytree.tree_leaves(args)]
    assert analyze_hlo(c, plan).report.ok  # default arguments


def test_plan_function_verify_hlo_end_to_end():
    """The checks run on the first call's arguments, inside a forked RNG: a
    dropout net's planned call still draws plain autograd's masks."""
    _, _, _, args, _ = _planned(n=4)

    def dropout_net(params, x):
        h = x
        for w in params:
            h = torch.nn.functional.dropout(torch.tanh(h @ w), 0.1, training=True)
        return torch.sum(h * h)

    planned = repro_torch.plan_function(dropout_net, analyze_effects=True, verify=True,
                                        verify_hlo=True, planner=Planner(cache=PlanCache()))
    torch.manual_seed(5)
    loss, grads = planned(*args)  # traces, plans, checks, then runs
    hlo = planned.lowered_for(*args).hlo  # the checks' record, kept
    assert hlo.report.ok and hlo.census.extra == hlo.census.plan_recompute
    torch.manual_seed(5)
    ref_loss, ref_grads = vanilla_traced_value_and_grad(planned.lowered_for(*args).carrier)(*args)
    assert torch.equal(loss, ref_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
