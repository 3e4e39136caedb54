"""Storage strategies in the port's lowerings (``tests/test_strategies.py``
restated for torch, and held against JAX).

* The int8 codec (``repro_torch.optim.compression``) equals the
  reference's bit for bit on the same f32 and bf16 inputs.
* The port's joint memory-strategy plan (cached set and ``plan.strategy``)
  equals the JAX planner's on a graph without views.
* Offload-only plans are **bitwise** plain autograd on ``"fx"``,
  ``"interpreter"`` and ``"segment"``; quantized plans stay inside the
  reference's documented bound (5e-2 relative l2 on the grads, 5e-2
  relative on the loss), and the quantized ``"fx"`` twin agrees with the
  reference's quantized ``"jaxpr"`` twin (f32, rtol 1e-5); a plan that
  enables quantize but selects no node is bitwise the legacy twin.
* The interpreter's live-byte audit prices offloaded residuals at 0 device
  bytes and quantized ones at their int8 + scale bytes.
* The block-granularity interpreter rejects strategy plans, as the
  reference's does.
* The reduced LM (flash-attention custom op included) under offload and
  quantize plans on ``"fx"``: offload bitwise, quantize within the bound.
"""

import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import PlanCache as RPlanCache  # noqa: E402
from repro.core.graph import graph_digest as rgraph_digest  # noqa: E402
from repro.core import Planner as RPlanner  # noqa: E402
from repro.core.lowering import plan_function as rplan_function  # noqa: E402
from repro.core.strategies import StrategyConfig as RStrategyConfig  # noqa: E402
from repro.optim import compression as rcompression  # noqa: E402
from repro_torch.analysis import check_hlo  # noqa: E402
from repro_torch.core import PlanCache, Planner, make_plan  # noqa: E402
from repro_torch.core.blockgraph import Block, BlockGraph  # noqa: E402
from repro_torch.core.dp import min_feasible_budget_exact, solve  # noqa: E402
from repro_torch.core.graph import graph_digest  # noqa: E402
from repro_torch.core.lower_sets import all_lower_sets  # noqa: E402
from repro_torch.core.lowering import (  # noqa: E402
    TracedCarrier,
    get_lowering,
    plan_function,
    vanilla_traced_value_and_grad,
    vanilla_value_and_grad,
)
from repro_torch.core.lowering.carriers import BlockGraphCarrier  # noqa: E402
from repro_torch.core.lowering.interpreter import traced_planned_value_and_grad  # noqa: E402
from repro_torch.core.strategies import OFFLOAD, QUANTIZE, StrategyConfig  # noqa: E402
from repro_torch.optim import compression  # noqa: E402

from conftest import random_dag  # noqa: E402

# the reference test's slow bandwidths: taxes of the order of T ∈ {1, 10}
_BW = dict(offload_bytes_per_sec=4.0, quantize_bytes_per_sec=16.0)
ALL = ("store", "recompute", "offload", "quantize")
CFG = StrategyConfig(strategies=ALL, **_BW)
OFFLOAD_ONLY = dataclasses.replace(CFG, strategies=("store", "recompute", "offload"))
QUANTIZE_ONLY = dataclasses.replace(CFG, strategies=("store", "recompute", "quantize"))
RCFG = {cfg: RStrategyConfig(strategies=cfg.strategies, **_BW)
        for cfg in (CFG, OFFLOAD_ONLY, QUANTIZE_ONLY)}
#: the reference's documented bound (docs/architecture.md, "Strategy lattice")
QUANT_BOUND = 5e-2
RTOL = ATOL = 1e-5  # f32 against JAX, as in tests/test_torch_plan_function.py


def _np_args():
    rng = np.random.default_rng(0)
    params = [(rng.normal(size=(16, 16)) / 4.0).astype(np.float32) for _ in range(4)]
    return params, rng.normal(size=(8, 16)).astype(np.float32)


def net(params, x):
    h = x
    for w in params:
        h = torch.tanh(h @ w)
    return torch.mean(h ** 2)


def rnet(params, x):
    h = x
    for w in params:
        h = jnp.tanh(h @ w)
    return jnp.mean(h ** 2)


def snet(params, x):  # a net whose torch and JAX graphs are equal, digest included
    h = x
    for w in params:
        h = torch.tanh(h @ w)
    return torch.sum(h * h)


def rsnet(params, x):
    h = x
    for w in params:
        h = jnp.tanh(h @ w)
    return jnp.sum(h * h)


def _args():
    params, x = _np_args()
    return [torch.tensor(p) for p in params], torch.tensor(x)


def _rargs():
    params, x = _np_args()
    return [jnp.asarray(p) for p in params], jnp.asarray(x)


def _fresh(fn=net, **kw):
    kw = {"method": "exact_dp", "objective": "memory_centric", **kw}
    return plan_function(fn, kw.pop("budget", None), planner=Planner(cache=PlanCache()), **kw)


def _bitwise(got, want):
    (v, g), (v0, g0) = got, want
    return torch.equal(v, v0) and all(torch.equal(a, b) for a, b in zip(g, g0))


def _rel_l2(got, want):
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want))
    den = sum(float((b ** 2).sum()) for b in want)
    return (num / den) ** 0.5


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(), (7,), (3, 300), (2, 5, 129)])
def test_codec_bitwise_the_reference(shape, dtype):
    rng = np.random.default_rng(sum(shape) + 1)
    x = (rng.normal(size=shape) * rng.choice([1e-3, 1.0, 50.0], size=shape)).astype(np.float32)
    rx = jnp.asarray(x, getattr(jnp, dtype))
    px = torch.tensor(np.asarray(rx.astype(jnp.float32))).to(getattr(torch, dtype))
    rc, pc = rcompression.compress(rx), compression.compress(px)
    assert pc.shape == tuple(rc.shape) and pc.q.dtype == torch.int8
    np.testing.assert_array_equal(pc.q.numpy(), np.asarray(rc.q))
    np.testing.assert_array_equal(pc.scale.numpy(), np.asarray(rc.scale))
    np.testing.assert_array_equal(compression.decompress(pc).numpy(),
                                  np.asarray(rcompression.decompress(rc)))
    st = compression.straight_through_roundtrip(px)
    rst = rcompression.straight_through_roundtrip(rx)
    assert st.dtype == px.dtype
    np.testing.assert_array_equal(st.float().numpy(), np.asarray(rst.astype(jnp.float32)))
    # the roundtrip value is its decompression, bit for bit (see storage.py)
    assert torch.equal(st, compression.decompress(pc).to(px.dtype))


def test_straight_through_gradient_is_identity():
    x = torch.randn(3, 100, requires_grad=True)
    g = torch.randn(3, 100)
    (got,) = torch.autograd.grad(compression.straight_through_roundtrip(x), x, g)
    assert torch.equal(got, g)


# ---------------------------------------------------------------------------
# The plan equals the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [CFG, OFFLOAD_ONLY, QUANTIZE_ONLY],
                         ids=["joint", "offload", "quantize"])
@pytest.mark.parametrize("objective", ["time_centric", "memory_centric"])
def test_strategy_plan_equals_the_jax_planners(cfg, objective):
    low = _fresh(snet, strategies=cfg, objective=objective).lowered_for(*_args())
    rlow = rplan_function(rsnet, None, method="exact_dp", objective=objective,
                          strategies=RCFG[cfg], planner=RPlanner(cache=RPlanCache())
                          ).lowered_for(*_rargs())
    assert graph_digest(low.carrier.to_graph()) == rgraph_digest(rlow.carrier.to_graph())
    assert low.plan.strategy
    assert low.plan.cached == rlow.plan.cached
    assert low.plan.strategy == rlow.plan.strategy
    assert low.plan.peak_memory == rlow.plan.peak_memory
    assert low.plan.overhead == rlow.plan.overhead
    assert low.report.budget == rlow.report.budget


# ---------------------------------------------------------------------------
# Lowering semantics: offload exact, quantize bounded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["fx", "interpreter"])
def test_offload_plan_bit_identical_to_vanilla(backend):
    args = _args()
    ref = vanilla_traced_value_and_grad(TracedCarrier.trace(net, args))(*args)
    pf = _fresh(backend=backend, strategies=OFFLOAD_ONLY, verify=True)
    low = pf.lowered_for(*args)
    assert any(c == OFFLOAD for c in low.plan.strategy.values())
    assert _bitwise(pf(*args), ref)


@pytest.mark.parametrize("backend", ["fx", "interpreter"])
def test_quantized_plan_within_documented_bound(backend):
    args = _args()
    v0, g0 = vanilla_traced_value_and_grad(TracedCarrier.trace(net, args))(*args)
    pf = _fresh(backend=backend, strategies=QUANTIZE_ONLY, verify=True)
    low = pf.lowered_for(*args)
    assert any(c == QUANTIZE for c in low.plan.strategy.values())
    v, g = pf(*args)
    assert 0 < _rel_l2(g, g0) <= QUANT_BOUND
    assert abs(float(v - v0)) <= QUANT_BOUND * abs(float(v0))


@pytest.mark.parametrize("cfg", [QUANTIZE_ONLY, CFG], ids=["quantize", "joint"])
def test_quantized_fx_twin_matches_the_jaxpr_twin(cfg):
    """The quantized ``"fx"`` twin against the reference's quantized
    ``"jaxpr"`` twin on the same inputs (f32, rtol 1e-5): both let readers
    see the roundtrip and pass gradients straight through."""
    args = _args()
    pf = _fresh(backend="fx", strategies=cfg)
    rpf = rplan_function(rnet, None, backend="jaxpr", method="exact_dp",
                         objective="memory_centric", strategies=RCFG[cfg],
                         planner=RPlanner(cache=RPlanCache()))
    assert pf.lowered_for(*args).plan.strategy == rpf.lowered_for(*_rargs()).plan.strategy
    v, g = pf(*args)
    rv, rg = rpf(*_rargs())
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=RTOL)
    for a, b in zip(g, rg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cfg", [OFFLOAD_ONLY, QUANTIZE_ONLY], ids=["offload", "quantize"])
def test_census_conforms_on_strategy_plans(cfg):
    """The heavy-op census of a strategy plan's ``"fx"`` twin: an offloaded
    node's copy back is no rerun, a quantized node's op reruns as planned
    (on the CPU the drift gate only warns that no peak is kept)."""
    args = _args()
    low = _fresh(strategies=cfg).lowered_for(*args)
    rep = check_hlo(low.carrier, low.plan, args=args)
    assert rep.ok, str(rep.findings)
    assert {f.code for f in rep.findings} >= {"heavy-multiplicity-ok"}


@pytest.mark.parametrize("backend", ["fx", "interpreter"])
def test_zero_quantized_nodes_bit_identical(backend):
    """Quantize enabled but never selected (loose budget → all-store plan):
    the twin stays bitwise the legacy lowering at the same budget."""
    args = _args()
    legacy = _fresh(backend=backend, budget=1e18, objective="time_centric")
    pf = _fresh(backend=backend, budget=1e18, objective="time_centric",
                strategies=QUANTIZE_ONLY, verify=True)
    assert pf.lowered_for(*args).plan.strategy == {}  # store is tax-free
    assert _bitwise(pf(*args), legacy(*args))


def _strategy_plan(cfg):
    args = _args()
    carrier = TracedCarrier.trace(net, args)
    g = carrier.to_graph()
    fam = all_lower_sets(g)
    b = min_feasible_budget_exact(g, fam, strategies=cfg)
    res = solve(g, b, fam, objective="memory_centric", strategies=cfg)
    assert res.feasible and res.assignment
    plan = make_plan(g, res.sequence, assignment=res.assignment, strategies=cfg)
    return carrier, args, plan, make_plan(g, res.sequence)


def test_interpreter_audit_excludes_offloaded_bytes():
    """Offloaded residuals audit at zero device bytes: the same sequence
    measures strictly lower than all-store, step by step no higher, and
    within the strategy plan's analytic peak."""
    carrier, args, plan, plan_store = _strategy_plan(OFFLOAD_ONLY)
    assert any(c == OFFLOAD for c in plan.strategy.values())
    _, _, trace = traced_planned_value_and_grad(carrier, plan, track_live=True)(*args)
    _, _, trace_store = traced_planned_value_and_grad(carrier, plan_store,
                                                      track_live=True)(*args)
    peak = max(nb for _, nb in trace)
    assert peak <= plan.peak_memory * (1 + 1e-9)
    assert peak < max(nb for _, nb in trace_store)
    for (tag, nb), (tag2, nb2) in zip(trace, trace_store):
        assert tag == tag2 and nb <= nb2


def test_interpreter_quantized_bytes_accounting():
    carrier, args, plan, plan_store = _strategy_plan(QUANTIZE_ONLY)
    quantized = [v for v, c in plan.strategy.items() if c == QUANTIZE]
    assert quantized
    _, _, trace = traced_planned_value_and_grad(carrier, plan, track_live=True)(*args)
    _, _, trace_store = traced_planned_value_and_grad(carrier, plan_store,
                                                      track_live=True)(*args)
    assert max(nb for _, nb in trace) <= plan.peak_memory * (1 + 1e-9)
    # after the forward each quantized node holds its int8 payload and one
    # f32 scale per 256-element block (padded) in place of its f32 bytes
    g = carrier.to_graph()
    blocks = [-(-int(g.nodes[v].memory) // 4 // compression.BLOCK) for v in quantized]
    saved = sum(g.nodes[v].memory - b * (compression.BLOCK + 4)
                for v, b in zip(quantized, blocks))
    last_fwd = [i for i, (tag, _) in enumerate(trace) if tag.startswith("fwd")][-1]
    assert trace_store[last_fwd][1] - trace[last_fwd][1] == saved


# ---------------------------------------------------------------------------
# BlockGraphs
# ---------------------------------------------------------------------------

D = 8


def _lin_init(gen, *in_shapes):
    return {"w": torch.randn(D, D, generator=gen) * 0.3}


def _lin(p, *xs):
    h = xs[0]
    for x in xs[1:]:
        h = h + x
    return torch.tanh(h @ p["w"])


def _blockgraph():
    blocks = [Block("b0", _lin, ("x",), _lin_init)]
    for i in range(1, 6):
        ins = (f"b{i-1}",) + ((f"b{i-2}",) if i >= 2 else ())
        blocks.append(Block(f"b{i}", _lin, ins, _lin_init))
    bg = BlockGraph(blocks, ["x"], ["b5"])
    gen = torch.Generator().manual_seed(0)
    params = bg.init(gen, {"x": (4, D)})
    return bg, params, {"x": torch.randn(4, D, generator=gen)}, (lambda o: torch.sum(o * o))


@pytest.mark.parametrize("cfg,exact", [(OFFLOAD_ONLY, True), (QUANTIZE_ONLY, False)],
                         ids=["offload", "quantize"])
def test_segment_backend_realizes_strategies(cfg, exact):
    bg, params, inputs, loss_fn = _blockgraph()
    l0, g0 = vanilla_value_and_grad(bg, loss_fn)(params, inputs)
    pf = plan_function(bg, None, backend="segment", loss_fn=loss_fn, method="exact_dp",
                       objective="memory_centric", strategies=cfg,
                       planner=Planner(cache=PlanCache()))
    low = pf.lowered_for(params, inputs)
    assert low.plan.strategy and set(low.plan.strategy.values()) == {cfg.strategies[-1]}
    loss, grads = pf(params, inputs)
    got, want = [grads[k]["w"] for k in sorted(g0)], [g0[k]["w"] for k in sorted(g0)]
    if exact:
        assert torch.equal(loss, l0) and all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        assert 0 < _rel_l2(got, want) <= QUANT_BOUND
        assert abs(float(loss - l0)) <= QUANT_BOUND * abs(float(l0))


def test_blockgraph_interpreter_rejects_strategy_plans():
    g = random_dag(random.Random(0), 6)
    fam = all_lower_sets(g)
    b = min_feasible_budget_exact(g, fam, strategies=CFG)
    res = solve(g, b, fam, objective="memory_centric", strategies=CFG)
    plan = make_plan(g, res.sequence, assignment=res.assignment, strategies=CFG)
    assert plan.strategy
    fake = BlockGraphCarrier.__new__(BlockGraphCarrier)
    with pytest.raises(NotImplementedError, match="segment"):
        get_lowering("interpreter").lower(fake, plan)


# ---------------------------------------------------------------------------
# The reduced LM: the flash op's outputs offloaded or kept, views of
# quantized nodes replayed from their base
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm_case():
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train import functional_loss

    cfg = dataclasses.replace(reduced(get_config("stablelm-3b")), dtype="float32")
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    host = SyntheticLM(DataConfig(cfg.vocab_size, 32, 2)).batch(0)
    batch = {k: torch.as_tensor(v) for k, v in host.items()}
    fn, params = functional_loss(lambda m, b: m.loss(b), model)
    args = (params, batch)
    carrier = TracedCarrier.trace(fn, args)
    return fn, args, vanilla_traced_value_and_grad(carrier)(*args)


@pytest.mark.parametrize("cfg", [OFFLOAD_ONLY, QUANTIZE_ONLY, CFG],
                         ids=["offload", "quantize", "joint"])
def test_lm_strategy_plans_on_fx(lm_case, cfg):
    fn, args, (v0, g0) = lm_case
    strategies = dataclasses.replace(cfg, offload_bytes_per_sec=0.0,
                                     quantize_bytes_per_sec=0.0)  # the defaults
    pf = plan_function(fn, strategies=strategies, analyze_effects=True, verify=True,
                       planner=Planner(cache=PlanCache()))
    plan = pf.lowered_for(*args).plan
    codes = set(plan.strategy.values())
    assert codes and codes <= set(cfg.strategies)
    v, g = pf(*args)
    got, want = [g[k] for k in g0], list(g0.values())
    if QUANTIZE in codes:
        assert 0 < _rel_l2(got, want) <= QUANT_BOUND
        assert abs(float(v - v0)) <= QUANT_BOUND * abs(float(v0))
    else:
        assert torch.equal(v, v0) and all(torch.equal(a, b) for a, b in zip(got, want))
