"""The port's analysis layer (``repro_torch.analysis``): effect pins, the
plan verifier, lowering conformance, the front door's and the launcher's
verification hooks and the ``plan_lint`` CLI (``tests/test_analysis.py``
restated over aten ops).

* a pure MLP has no taint; dropout's ``bernoulli`` is ``prng`` and pins
  itself; an integer draw's taint flows to its storable successor; the
  flash-attention op and a user's custom op are ``opaque`` and pinned; a
  write to an input is ``effectful``; pins change the digest only when
  present;
* the verifier accepts valid plans and rejects a corrupted save set, an
  over-budget plan, a wrong peak or overhead and an unpinned PRNG plan with
  the reference's codes; on the quickstart MLP and the random nets of
  ``tests/test_torch_fx_graph.py`` its findings equal
  ``repro.analysis.check_plan``'s code for code on the same plans;
* ``exhaustive_search`` equals the reference's and the DP's optimum;
* conformance accepts the port's own lowering and rejects a stale one;
* a seeded-dropout net planned with ``analyze_effects=True`` gives plain
  autograd's loss and grads bitwise on ``"fx"`` and ``"interpreter"``;
* ``plan_function(verify=True)``, ``REPRO_VERIFY_PLANS`` and the CLI's exit
  codes 0/1/2.

Tolerances: bitwise throughout (framework-free planning and planned vs
unplanned on the CPU in f32).
"""

import dataclasses
import json
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import repro_torch  # noqa: E402
from repro import analysis as ranalysis  # noqa: E402
from repro.core import exhaustive_search as rexhaustive  # noqa: E402
from repro.core import schedule as rschedule  # noqa: E402
from repro.core.graph import Graph as RGraph  # noqa: E402
from repro.core.graph import Node as RNode  # noqa: E402
from repro.core.jaxpr_graph import trace as rtrace  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.analysis.cli import main as lint  # noqa: E402
from repro_torch.analysis.report import PlanVerificationError  # noqa: E402
from repro_torch.core import dp, exhaustive_search, min_feasible_budget  # noqa: E402
from repro_torch.core.fx_graph import trace  # noqa: E402
from repro_torch.core.graph import Graph, Node, graph_digest  # noqa: E402
from repro_torch.core.liveness import vanilla_peak  # noqa: E402
from repro_torch.core.lowering import (  # noqa: E402
    fx_value_and_grad,
    traced_planned_value_and_grad,
    vanilla_traced_value_and_grad,
    vanilla_value_and_grad,
)
from repro_torch.core.lowering.carriers import TracedCarrier  # noqa: E402
from repro_torch.core import PlanCache, Planner  # noqa: E402
from repro_torch.core.schedule import make_plan  # noqa: E402
from repro_torch.kernels.ops import flash_attention  # noqa: E402
from repro_torch.core.blockgraph import Block, BlockGraph  # noqa: E402
from test_torch_fx_graph import _mlp_pair, _rand_pair  # noqa: E402
from test_torch_lowering import _blockgraph_case  # noqa: E402

D = 16
HBM = 16 * 2**30  # the reference's per-device memory, which the CPU launcher budgets


def _params(n=6, d=D, seed=0):
    r = np.random.default_rng(seed)
    params = [torch.tensor((r.standard_normal((d, d)) * 0.3).astype(np.float32))
              for _ in range(n)]
    return params, torch.tensor(r.standard_normal((4, d)).astype(np.float32))


def mlp(params, x):
    h = x
    for w in params:
        h = torch.tanh(h @ w)
    return torch.sum(h * h)


def dropout_net(params, x):
    """Seeded-dropout MLP — the PRNG canary."""
    h = x
    for w in params:
        h = F.dropout(torch.tanh(h @ w), 0.1, training=True)
    return torch.sum(h * h)


def _dropout_factory():
    return dropout_net, _params(3)


def _chain_graph(n=6, mem=10.0):
    nodes = [Node(i, f"v{i}", 1.0, mem, "op") for i in range(n)]
    return Graph(nodes, [(i, i + 1) for i in range(n - 1)])


def _plan(g, budget=None, method="approx_dp"):
    return Planner(cache=PlanCache()).plan(g, budget, method)


def _codes(report):
    return [(f.severity, f.code, f.node) for f in report.findings]


# ------------------------------------------------------------ effect analysis


def test_pure_function_has_no_taint():
    c = TracedCarrier.trace(mlp, _params(), analyze_effects=True)
    ea = c.effects
    assert ea.pure and not ea.pins and not ea.report.findings
    assert all(e.klass == "pure" and e.storable for e in ea.effects)
    assert c.to_graph().store_pins == frozenset()
    assert analysis.check_graph(c).findings == []


def test_dropout_taints_and_pins_storable_frontier():
    c = TracedCarrier.trace(dropout_net, _params(3), analyze_effects=True)
    ea, g = c.effects, c.to_graph()
    prng = [e for e in ea.effects if e.klass == "prng"]
    assert [e.primitive for e in prng] == ["bernoulli"] * 3
    assert ea.tainted == {e.index for e in prng}
    assert ea.pins == ea.tainted  # a float mask is storable: it pins itself
    assert g.store_pins == ea.pins
    assert {f.code for f in ea.report.findings} == {"prng-taint", "must-store-pin"}


def test_unstorable_taint_flows_to_its_storable_successor():
    def fn(w, x):
        bits = torch.randint(0, 2, (4, D))  # integer draw: cannot be a residual
        return torch.sum(torch.tanh(x @ w) * bits.to(torch.float32))

    params, x = _params(1)
    ea = analysis.analyze_effects(trace(fn, params[0], x))
    g = trace(fn, params[0], x).graph
    (draw,) = [e for e in ea.effects if e.klass == "prng"]
    assert draw.primitive == "randint" and not draw.storable
    assert draw.index not in ea.pins
    assert ea.pins == frozenset(g.succ[draw.index])
    assert all(ea.effects[v].storable for v in ea.pins)


def test_flash_attention_and_custom_ops_are_opaque_and_pinned():
    @torch.library.custom_op("repro_torch_test::twice", mutates_args=())
    def twice(x: torch.Tensor) -> torch.Tensor:
        return 2 * x

    twice.register_fake(lambda x: torch.empty_like(x))

    def fn(w, x):
        q = (x @ w).reshape(1, 4, 2, 8)
        o = flash_attention(q, q, q, causal=True)
        return torch.sum(twice(o))

    params, x = _params(1)
    fxg = trace(fn, params[0], x)
    ea = analysis.analyze_effects(fxg)
    opaque = {e.primitive: e for e in ea.effects if e.klass == "opaque"}
    assert set(opaque) == {"repro_torch::flash_attention", "repro_torch_test::twice"}
    assert {e.index for e in opaque.values()} == ea.pins == ea.tainted


def test_a_write_to_an_input_is_effectful():
    def fn(w, x):
        x.mul_(2)
        return torch.sum(torch.tanh(x @ w))

    params, x = _params(1)
    ea = analysis.analyze_effects(trace(fn, params[0], x))
    (eff,) = [e for e in ea.effects if e.klass == "effectful"]
    assert eff.primitive == "copy_" and "writes the graph input" in eff.reason


def test_pin_marker_changes_digest_only_when_pinned():
    g = _chain_graph()
    unpinned_digest = graph_digest(g)
    assert graph_digest(analysis.pin_graph(g, frozenset())) == unpinned_digest
    pinned = analysis.pin_graph(g, frozenset({2}))
    assert graph_digest(pinned) != unpinned_digest
    assert pinned.store_pins == frozenset({2})
    # on traces: a pure function hashes alike either way, dropout does not
    for fn, same in ((mlp, True), (dropout_net, False)):
        args = _params(3)
        a = TracedCarrier.trace(fn, args).to_graph()
        b = TracedCarrier.trace(fn, args, analyze_effects=True).to_graph()
        assert (graph_digest(a) == graph_digest(b)) == same


def test_pins_are_cached_and_never_recomputed():
    g = analysis.pin_graph(_chain_graph(8), frozenset({2, 5}))
    plan = _plan(g, method="exact_dp").plan
    assert frozenset({2, 5}) <= plan.cached
    for seg in plan.segments:
        assert not (frozenset({2, 5}) & seg.recompute)
    assert analysis.check_plan(g, plan).ok


# ------------------------------------------------------------------- verifier


def test_verifier_accepts_valid_plan_and_budget():
    g = _chain_graph(8)
    plan = _plan(g, method="exact_dp").plan
    assert analysis.check_plan(g, plan, budget=plan.peak_memory).ok
    c = TracedCarrier.trace(mlp, _params())
    plan = _plan(c.to_graph()).plan
    r = analysis.check_plan(c.to_graph(), plan, budget=plan.peak_memory, fx=c.fx)
    assert r.ok and not r.findings
    assert analysis.check_graph_memory(c.fx).ok


def test_verifier_rejects_corrupted_save_set():
    g = _chain_graph(8)
    plan = _plan(g, method="exact_dp").plan
    seg = next(s for s in plan.segments if s.keep)
    victim = max(seg.keep)
    bad_seg = dataclasses.replace(seg, boundary=seg.boundary - {victim},
                                  keep=seg.keep - {victim})
    bad = dataclasses.replace(plan, segments=tuple(
        bad_seg if s.index == seg.index else s for s in plan.segments))
    r = analysis.check_plan(g, bad)
    assert not r.ok
    assert {f.code for f in r.errors()} & {"boundary-mismatch", "keep-mismatch",
                                          "cache-set-mismatch"}
    assert any(str(victim) in f.message for f in r.errors())


def test_verifier_rejects_over_budget_and_wrong_peak():
    g = _chain_graph(8)
    plan = _plan(g, method="exact_dp").plan
    r = analysis.check_plan(g, plan, budget=plan.peak_memory / 2)
    assert any(f.code == "over-budget" for f in r.errors())
    r2 = analysis.check_plan(g, dataclasses.replace(plan, peak_memory=plan.peak_memory * 2))
    assert any(f.code == "peak-mismatch" for f in r2.errors())
    r3 = analysis.check_plan(g, dataclasses.replace(plan, overhead=plan.overhead + 5.0))
    assert any(f.code == "overhead-mismatch" for f in r3.errors())


def test_verifier_rejects_prng_tainted_unpinned_plan():
    args = _params(3)
    c = TracedCarrier.trace(dropout_net, args, analyze_effects=True)
    unpinned = TracedCarrier.trace(dropout_net, args).to_graph()
    plan = make_plan(unpinned, [frozenset(range(unpinned.n))])
    assert not plan.cached
    r = analysis.check_plan(unpinned, plan, effects=c.effects)
    errs = [f for f in r.errors() if f.code == "tainted-recompute"]
    assert errs and "must_store pin" in errs[0].message
    pinned_plan = _plan(c.to_graph()).plan
    assert analysis.check_plan(c.to_graph(), pinned_plan, effects=c.effects, fx=c.fx).ok


def test_verifier_rejects_a_stale_graph_memory():
    c = TracedCarrier.trace(mlp, _params())
    nodes = list(c.fx.graph.nodes)
    nodes[3] = dataclasses.replace(nodes[3], memory=nodes[3].memory + 4)
    stale = dataclasses.replace(c.fx, graph=Graph(nodes, c.fx.graph.edges))
    r = analysis.check_graph_memory(stale)
    assert [(f.code, f.node) for f in r.errors()] == [("memory-mismatch", 3)]


def _moved(plan):
    """The plan with its first segment's smallest cached node moved into
    that segment's recompute set."""
    seg = next(s for s in plan.segments if s.keep)
    victim = min(seg.keep)
    moved = dataclasses.replace(seg, keep=seg.keep - {victim},
                                recompute=seg.recompute | {victim})
    return dataclasses.replace(
        plan, segments=tuple(moved if s.index == seg.index else s for s in plan.segments),
        cached=plan.cached - {victim})


def _corruptions(plan):
    """(name, plan, budget) variants: valid, one cached node moved to the
    recompute set, a wrong peak, a wrong overhead, an over-budget check."""
    yield "valid", plan, plan.peak_memory
    yield "moved", _moved(plan), None
    yield "peak", dataclasses.replace(plan, peak_memory=plan.peak_memory * 1.5), None
    yield "overhead", dataclasses.replace(plan, overhead=plan.overhead + 3.0), None
    yield "budget", plan, plan.peak_memory * 0.75


PAIRS = {"quickstart": _mlp_pair, **{f"rand{s}_{d}": (lambda s=s, d=d: _rand_pair(s, d))
                                      for s, d in [(0, 4), (3, 5), (7, 6), (11, 8), (42, 9)]}}


@pytest.mark.parametrize("name", list(PAIRS))
def test_check_plan_equals_the_reference_code_for_code(name):
    jfn, tfn, np_args = PAIRS[name]()
    jg = rtrace(jfn, *jax.tree_util.tree_map(jnp.asarray, np_args))
    fxg = trace(tfn, *jax.tree_util.tree_map(torch.tensor, np_args))
    g, rg = fxg.graph, jg.graph
    plan = _plan(g, min_feasible_budget(g, "approx_dp")).plan
    rplan = rschedule.make_plan(rg, [s.lower_set for s in plan.segments])
    assert plan.cached == rplan.cached and plan.num_segments > 1
    for what, bad, budget in _corruptions(plan):
        rbad = dataclasses.replace(rplan, segments=tuple(
            rschedule.Segment(**dataclasses.asdict(s)) for s in bad.segments),
            cached=bad.cached, peak_memory=bad.peak_memory, overhead=bad.overhead)
        got = analysis.check_plan(g, bad, budget=budget, fx=fxg)
        want = ranalysis.check_plan(rg, rbad, budget=budget, jg=jg)
        assert _codes(got) == _codes(want), what
        assert got.ok == (what == "valid"), what
    moved = dict((w, b) for w, b, _ in _corruptions(plan))["moved"]
    codes = {f.code for f in analysis.check_plan(g, moved).errors()}
    assert {"cache-set-mismatch", "keep-mismatch", "recompute-mismatch"} <= codes


def _random_dags(seed, n, p=0.35):
    """One random DAG (``conftest.random_dag``'s recipe) as a reference and
    a port graph, built from the same node and edge lists."""
    r = random.Random(seed)
    edges = [(i, j) for i in range(n) for j in range(i + 1, n) if r.random() < p]
    costs = [(r.choice([1.0, 10.0]), float(r.randint(1, 6))) for _ in range(n)]
    return (RGraph([RNode(i, f"v{i}", t, m) for i, (t, m) in enumerate(costs)], edges),
            Graph([Node(i, f"v{i}", t, m) for i, (t, m) in enumerate(costs)], edges))


@pytest.mark.parametrize("seed,n", [(s, n) for s in range(6) for n in (3, 5, 6)])
def test_exhaustive_search_equals_the_reference_and_the_dp(seed, n):
    rg, g = _random_dags(seed, n)
    for slack in (1.0, 1.7):
        B = min_feasible_budget(g, "exact_dp") * slack
        got = exhaustive_search(g, B)
        assert dataclasses.asdict(got) == dataclasses.asdict(rexhaustive(rg, B))
        d = dp.exact_dp(g, B)
        assert got.feasible and d.feasible and d.overhead == pytest.approx(got.overhead)


# ---------------------------------------------------------------- conformance


@pytest.mark.parametrize("fn", [mlp, dropout_net])
def test_conformance_accepts_own_lowering(fn):
    args = _params(4)
    c = TracedCarrier.trace(fn, args, analyze_effects=True)
    plan = _plan(c.to_graph()).plan
    assert any(s.recompute for s in plan.segments)
    r = analysis.check_lowering(c, plan, args=args)
    assert r.ok and [f.code for f in r.findings] == ["conformant"], str(r)
    # the deployed twin of the same plan is no stale lowering
    r2 = analysis.check_lowering(c, plan, lowered=fx_value_and_grad(c, plan), args=args)
    assert r2.ok, str(r2)


def test_conformance_rejects_stale_lowering():
    args = _params(6, d=8)
    c = TracedCarrier.trace(mlp, args)
    g = c.to_graph()
    tight = _plan(g, None, "exact_dp").plan
    roomy = _plan(g, vanilla_peak(g, liveness=True), "exact_dp").plan
    assert tight.cached != roomy.cached
    r = analysis.check_lowering(c, roomy, lowered=fx_value_and_grad(c, tight), args=args)
    codes = {f.code for f in r.errors()}
    assert {"remat-set-mismatch", "residual-not-saved", "policy-mismatch"} <= codes


def test_conformance_needs_an_fx_twin():
    args = _params(4)
    c = TracedCarrier.trace(mlp, args)
    plan = _plan(c.to_graph()).plan
    r = analysis.check_lowering(c, plan, lowered=traced_planned_value_and_grad(c, plan),
                                args=args)
    assert [f.code for f in r.errors()] == ["lowering-untraceable"]
    r2 = analysis.check_lowering(object(), plan)
    assert r2.ok and [f.code for f in r2.findings] == ["not-applicable"]


# -------------------------------------------------------- the front door


@pytest.mark.parametrize("backend", ["fx", "interpreter"])
def test_planned_dropout_is_bitwise_vanilla(backend):
    args = _params(4)
    planned = repro_torch.plan_function(
        dropout_net, backend=backend, analyze_effects=True, verify=True,
        planner=Planner(cache=PlanCache()))
    lowered = planned.lowered_for(*args)
    g = lowered.carrier.to_graph()
    assert g.store_pins and g.store_pins <= lowered.plan.cached
    assert any(s.recompute for s in lowered.plan.segments)
    torch.manual_seed(3)
    loss, grads = planned(*args)
    torch.manual_seed(3)
    ref_loss, ref_grads = vanilla_traced_value_and_grad(lowered.carrier)(*args)
    assert torch.equal(loss, ref_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads))


def test_unpinned_dropout_replays_its_mask_in_the_interpreter():
    """Without the pins the plan recomputes a ``bernoulli``: the verifier
    flags it, and the interpreter replays it with the generator state of its
    first draw, so loss and grads still equal plain autograd's bitwise."""
    args = _params(4)
    c = TracedCarrier.trace(dropout_net, args, analyze_effects=True)
    planned = repro_torch.plan_function(dropout_net, backend="interpreter",
                                        planner=Planner(cache=PlanCache()))
    plan = planned.lowered_for(*args).plan
    recomputed = set().union(*(s.recompute for s in plan.segments))
    assert c.effects.pins & recomputed
    assert not analysis.check_plan(c.to_graph(), plan, effects=c.effects).ok
    torch.manual_seed(3)
    loss, grads = planned(*args)
    after = torch.get_rng_state()
    torch.manual_seed(3)
    ref_loss, ref_grads = vanilla_traced_value_and_grad(c)(*args)
    assert torch.equal(loss, ref_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
    assert torch.equal(after, torch.get_rng_state())


def test_blockgraph_interpreter_replays_dropout_masks():
    """The same replay over a BlockGraph: every block may draw, so a
    recomputed block redraws nothing."""
    bg, params, inputs, loss_fn = _blockgraph_case(3, 5)

    def dropped(b):
        return Block(b.name, lambda p, *xs, b=b: F.dropout(b.apply(p, *xs), 0.3),
                     b.inputs, b.init)

    bg = BlockGraph([dropped(b) for b in bg.blocks], bg.graph_inputs, bg.outputs)
    planner = Planner(cache=PlanCache())
    budget = planner.min_feasible_budget(bg.to_graph(params, inputs), "approx_dp") * 1.2
    pf = repro_torch.plan_function(bg, budget, backend="interpreter", loss_fn=loss_fn,
                                   planner=planner)
    torch.manual_seed(5)
    loss, grads = pf(params, inputs)
    assert pf.lowered_for(params, inputs).plan.overhead > 0
    torch.manual_seed(5)
    ref_loss, ref_grads = vanilla_value_and_grad(bg, loss_fn)(params, inputs)
    assert torch.equal(loss, ref_loss)
    assert all(torch.equal(a, b) for a, b in zip(torch.utils._pytree.tree_leaves(grads),
                                                 torch.utils._pytree.tree_leaves(ref_grads)))


class CorruptingPlanner(Planner):
    """Moves one cached node of each plan into its segment's recompute set."""

    def plan(self, *a, **kw):
        rep = super().plan(*a, **kw)
        return dataclasses.replace(rep, plan=_moved(rep.plan))


def test_plan_function_verify_passes_and_rejects_a_corrupted_plan():
    args = _params()
    planned = repro_torch.plan_function(mlp, verify=True, planner=Planner(cache=PlanCache()))
    loss, _ = planned(*args)
    assert torch.isfinite(loss)
    bad = repro_torch.plan_function(mlp, verify=True, planner=CorruptingPlanner(cache=PlanCache()))
    with pytest.raises(PlanVerificationError, match="cache-set-mismatch"):
        bad(*args)


@pytest.mark.parametrize("value", ["1", "hlo"])
def test_verify_env_var_runs_at_the_front_door(monkeypatch, value):
    args = _params()
    monkeypatch.setenv("REPRO_VERIFY_PLANS", value)
    repro_torch.plan_function(mlp, planner=Planner(cache=PlanCache()))(*args)
    bad = repro_torch.plan_function(mlp, planner=CorruptingPlanner(cache=PlanCache()))
    with pytest.raises(PlanVerificationError):
        bad(*args)


def test_verify_env_var_runs_in_plan_unit_segments(monkeypatch):
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.launch import plan as lplan

    g = _chain_graph(8)
    res = _plan(g, method="exact_dp").result
    monkeypatch.setenv("REPRO_VERIFY_PLANS", "1")
    lplan._maybe_verify(g, res, budget=res.peak_memory)  # must not raise
    with pytest.raises(PlanVerificationError):
        lplan._maybe_verify(g, res, budget=res.peak_memory / 4)
    calls = []
    monkeypatch.setattr(lplan, "_maybe_verify", lambda *a: calls.append(a))
    sp, res = lplan.plan_unit_segments(reduced(get_config("stablelm-3b")),
                                       ShapeConfig("t", 64, 2, "train"), 1, model_shards=1,
                                       hbm_bytes=HBM)
    assert res.feasible and len(calls) == 1


def test_launch_plan_under_verification_passes(monkeypatch):
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.launch import plan as lplan

    monkeypatch.setenv("REPRO_VERIFY_PLANS", "1")
    cfg = reduced(get_config("stablelm-3b"))
    for budget in (None, 2e6):
        sp, res = lplan.plan_unit_segments(cfg, ShapeConfig("t", 64, 2, "train"), 1,
                                           model_shards=1, budget=budget, hbm_bytes=HBM)
        assert res.feasible


# ------------------------------------------------------------------------ CLI


def test_cli_traced_quickstart_ok(tmp_path):
    out = tmp_path / "report.json"
    assert lint(["--traced", "quickstart", "--json", str(out), "--device", "cpu"]) == 0
    data = json.loads(out.read_text())
    assert data["ok"] and data["targets"][0]["target"] == "quickstart"
    checkers = [r["checker"] for r in data["targets"][0]["reports"]]
    assert checkers == ["effects", "plan", "lowering"]


def test_cli_traced_factory_with_dropout_ok(tmp_path):
    out = tmp_path / "report.json"
    rc = lint(["--traced", "test_torch_analysis:_dropout_factory", "--json", str(out),
               "--device", "cpu"])
    assert rc == 0
    effects = json.loads(out.read_text())["targets"][0]["reports"][0]
    assert {f["code"] for f in effects["findings"]} == {"prng-taint", "must-store-pin"}


def test_cli_infeasible_budget_exits_2(capsys):
    from repro_torch.analysis.cli import _quickstart_factory

    fn, args = _quickstart_factory()
    g = TracedCarrier.trace(fn, args, analyze_effects=True).to_graph()
    needed = min_feasible_budget(g, "approx_dp")
    assert lint(["--traced", "quickstart", "--budget", "10", "--device", "cpu"]) == 2
    assert f"the exact minimal feasible budget is {needed:g}" in capsys.readouterr().out


def test_cli_lint_error_exits_1(monkeypatch, capsys):
    from repro_torch.analysis import verifier

    def failing(*a, **kw):
        r = analysis.Report(checker="plan")
        r.add("error", "peak-mismatch", "injected")
        return r

    monkeypatch.setattr(verifier, "check_plan", failing)
    assert lint(["--smoke", "--device", "cpu"]) == 1
    assert "peak-mismatch" in capsys.readouterr().out


def test_cli_hlo_writes_drift_records(tmp_path):
    drift = tmp_path / "drift.json"
    assert lint(["--hlo", "--drift-json", str(drift), "--device", "cpu"]) == 0
    (rec,) = json.loads(drift.read_text())["records"]
    assert rec["target"] == "quickstart"
    assert rec["heavy_planned"] - rec["heavy_vanilla"] == rec["heavy_recompute_planned"]
    assert "temp_bytes" not in rec  # the CPU allocator keeps no statistics


def test_cli_network_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="Benchmarks \\+ examples"):
        lint(["--network", "unet", "--device", "cpu"])


def test_cli_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        lint(["--traced", "quickstart"])
