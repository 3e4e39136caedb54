"""The port's front door, ``repro_torch.plan_function``
(``tests/test_plan_function.py`` restated for torch, and held against JAX).

A plain torch MLP under a **halved byte budget** trains with loss and
gradients **bitwise** equal to plain autograd on the CPU while actually
recomputing (overhead > 0); measured live bytes stay within the plan's
peak; a second call is a plan-cache hit.  The port's plan for the MLP is
the JAX planner's plan for the JAX graph, and its values agree with
``jax.value_and_grad`` on the same numpy inputs (f32, rtol 1e-5).  A small
attention function goes through the flash-attention custom op on the port's
side and the Pallas kernel (interpret mode) on the JAX side.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.core import PlanCache as RPlanCache  # noqa: E402
from repro.core import Planner as RPlanner  # noqa: E402
from repro.core.jaxpr_graph import trace as rtrace  # noqa: E402
from repro.kernels.ops import flash_attention as rflash  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core import PlanCache, Planner  # noqa: E402
from repro_torch.core.blockgraph import Block, BlockGraph  # noqa: E402
from repro_torch.core.fx_graph import trace  # noqa: E402
from repro_torch.core.liveness import vanilla_peak  # noqa: E402
from repro_torch.core.lowering import (  # noqa: E402
    InfeasibleBudgetError,
    TracedCarrier,
    vanilla_traced_value_and_grad,
)
from repro_torch.kernels.ops import flash_attention  # noqa: E402
from test_torch_lowering import (  # noqa: E402
    assert_bits,
    expected_recompute,
    extra_ops,
    plain_value_and_grad,
)

DN = (((1,), (0,)), ((), ()))
RTOL = ATOL = 1e-5  # f32 against JAX, as in tests/test_torch_model.py


def _np_mlp(width=16, depth=10):
    rng = np.random.default_rng(0)
    params = [(rng.standard_normal((width, width)) * 0.3).astype(np.float32)
              for _ in range(depth)]
    return params, rng.standard_normal((8, width)).astype(np.float32)


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


@pytest.fixture
def setup():
    np_params, np_x = _np_mlp()
    params, x = [torch.tensor(p) for p in np_params], torch.tensor(np_x)
    g = trace(mlp, params, x).graph
    budget = vanilla_peak(g, liveness=False) / 2  # the halved byte budget
    return params, x, g, budget


def test_halved_budget_bitwise_equal_to_vanilla(setup):
    params, x, g, budget = setup
    ref = plain_value_and_grad(mlp, params, x)
    planned = repro_torch.plan_function(mlp, budget, planner=Planner(cache=PlanCache()))
    loss, grads = planned(params, x)
    lowered = planned.lowered_for(params, x)
    assert lowered.backend == "fx"  # the trace-anything production path
    assert lowered.plan.peak_memory <= budget
    assert lowered.plan.overhead > 0  # the budget actually forces recompute
    assert_bits((loss, grads), ref)
    assert all(not p.requires_grad for p in params)  # the caller's tensors untouched


def test_training_steps_match_vanilla(setup):
    params, x, g, budget = setup
    planned = repro_torch.plan_function(mlp, budget, planner=Planner(cache=PlanCache()))
    p1 = p2 = params
    for _ in range(3):
        _, g1 = planned(p1, x)
        _, g2 = plain_value_and_grad(mlp, p2, x)
        p1 = [w - 0.05 * gw for w, gw in zip(p1, g1)]
        p2 = [w - 0.05 * gw for w, gw in zip(p2, g2)]
    assert_bits(p1, p2)
    assert_bits(planned(p1, x), plain_value_and_grad(mlp, p2, x))


def test_measured_live_bytes_within_plan_peak(setup):
    params, x, g, budget = setup
    audited = repro_torch.plan_function(mlp, budget, backend="interpreter", track_live=True,
                                        planner=Planner(cache=PlanCache()))
    loss, grads, live = audited(params, x)
    assert live
    assert max(b for _, b in live) <= audited.lowered_for(params, x).plan.peak_memory
    assert_bits((loss, grads), plain_value_and_grad(mlp, params, x))


def test_second_call_is_plan_cache_hit(setup):
    params, x, g, budget = setup
    planner = Planner(cache=PlanCache())
    first = repro_torch.plan_function(mlp, budget, planner=planner)
    first(params, x)
    cold = planner.cache.stats()
    second = repro_torch.plan_function(mlp, budget, planner=planner)  # fresh front door
    second(params, x)
    warm = planner.cache.stats()
    assert warm["hits"] > cold["hits"]
    assert warm["misses"] == cold["misses"]  # no re-solve
    assert second.lowered_for(params, x).plan == first.lowered_for(params, x).plan
    # within one PlannedFunction, the lowering is memoized per signature
    assert second.lowered_for(params, x) is second.lowered_for(params, x)


def test_budget_none_uses_exact_min_feasible(setup):
    params, x, g, budget = setup
    planner = Planner(cache=PlanCache())
    planned = repro_torch.plan_function(mlp, planner=planner)
    lowered = planned.lowered_for(params, x)
    mfb = planner.min_feasible_budget(planner.prepare(g), "approx_dp")
    assert lowered.report.budget == mfb
    assert lowered.plan.peak_memory <= mfb
    assert_bits(planned(params, x), plain_value_and_grad(mlp, params, x))


def test_infeasible_budget_raises_with_the_minimal_budget(setup):
    params, x, g, budget = setup
    planner = Planner(cache=PlanCache())
    planned = repro_torch.plan_function(mlp, 1.0, planner=planner)
    mfb = planner.min_feasible_budget(g, "approx_dp")
    with pytest.raises(InfeasibleBudgetError, match=f"minimal feasible budget is {mfb:g}"):
        planned(params, x)


def test_argnums_tuple(setup):
    params, x, g, budget = setup
    planned = repro_torch.plan_function(mlp, budget, argnums=(0, 1),
                                        planner=Planner(cache=PlanCache()))
    loss, (gp, gx) = planned(params, x)
    leaves = [p.clone().requires_grad_() for p in params]
    xl = x.clone().requires_grad_()
    ref_loss = mlp(leaves, xl)
    ref = torch.autograd.grad(ref_loss, leaves + [xl])
    assert_bits((loss, gp, gx), (ref_loss.detach(), list(ref[:-1]), ref[-1]))


def test_non_scalar_output_rejected():
    planned = repro_torch.plan_function(lambda x: x * 2.0)
    with pytest.raises(TypeError, match="scalar-output"):
        planned(torch.ones(3))


def test_changed_structure_retraces(setup):
    params, x, g, budget = setup
    planned = repro_torch.plan_function(mlp, planner=Planner(cache=PlanCache()))
    planned(params, x)
    more = params + [torch.eye(16)]  # deeper net: a second lowering, not an error
    assert_bits(planned(more, x), plain_value_and_grad(mlp, more, x))
    assert len(planned._memo) == 2


def _dropout_mlp(params, x):
    h = x
    for w in params:
        h = torch.nn.functional.dropout(torch.tanh(h @ w), 0.5, training=True)
    return torch.sum(h * h)


@pytest.mark.parametrize("fn,kw", [(mlp, dict(strategies=("offload", "quantize"))),
                                   (_dropout_mlp, dict())])
def test_what_is_not_ported_raises(fn, kw, setup, tmp_path):
    """On a DeviceMesh (a one-rank gloo group here) a strategy plan and a
    plan that recomputes random draws run, bitwise the meshless twin of the
    same plan; the dropout plan, which replays its masks, and an offload
    plan are bitwise plain autograd on the mesh, a plan that quantizes is
    within the reference's documented 5e-2 of it (``QUANT_BOUND``).  (The
    name is kept from when both raised; what still raises, a mesh axis no
    twin runs over, is held in ``tests/torch_dist_workers.py``.)"""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.fx_graph import op_name
    from repro_torch.core.prims import ATEN_PRNG

    params, x, _, _ = setup
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        planned = repro_torch.plan_function(fn, None, mesh=mesh,
                                            planner=Planner(cache=PlanCache()), **kw)
        low = planned.lowered_for(params, x)
        fxg, plan = low.carrier.fx, low.plan
        redrawn = [v for s in plan.segments for v in s.recompute
                   if op_name(fxg.nodes[v].target) in ATEN_PRNG]
        assert bool(plan.strategy) if kw else bool(redrawn)
        runs = []
        for twin in (planned, vanilla_traced_value_and_grad(low.carrier),
                     repro_torch.plan_function(fn, None, planner=Planner(cache=PlanCache()),
                                               **kw)):
            torch.manual_seed(3)
            loss, grads = twin(params, x)
            runs.append((getattr(loss, "full_tensor", lambda: loss)(),
                         [getattr(g, "full_tensor", lambda g=g: g)() for g in grads]))
        got, plain, meshless = runs
        assert_bits(got, meshless)
        if "quantize" in set((plan.strategy or {}).values()):
            QUANT_BOUND = 5e-2
            assert abs(float(got[0]) - float(plain[0])) <= QUANT_BOUND * abs(float(plain[0]))
            for g, w in zip(got[1], plain[1]):
                assert float((g - w).norm()) <= QUANT_BOUND * float(w.norm())
        else:
            assert_bits(got, plain)
    finally:
        dist.destroy_process_group()


def test_blockgraph_goes_through_the_segment_backend():
    def mk(name, src):
        return Block(name, lambda p, h: torch.tanh(h @ p["w"]), (src,),
                     lambda gen, shp: {"w": torch.randn(shp[-1], shp[-1], generator=gen) * 0.3})

    bg = BlockGraph([mk(f"b{i}", "x" if i == 0 else f"b{i-1}") for i in range(6)],
                    ["x"], ["b5"])
    gen = torch.Generator().manual_seed(0)
    params = bg.init(gen, {"x": (4, 16)})
    inputs = {"x": torch.randn(4, 16, generator=gen)}

    def loss(out):
        return torch.sum(out * out)

    pf = repro_torch.plan_function(bg, backend="segment", loss_fn=loss,
                                   planner=Planner(cache=PlanCache()))
    lowered = pf.lowered_for(params, inputs)
    assert lowered.backend == "segment" and lowered.plan.overhead > 0
    leaves = {k: {"w": v["w"].clone().requires_grad_()} for k, v in params.items()}
    ref_loss = loss(bg.apply(leaves, inputs))
    ref = torch.autograd.grad(ref_loss, [leaves[f"b{i}"]["w"] for i in range(6)])
    got_loss, got = pf(params, inputs)
    assert_bits((got_loss, [got[f"b{i}"]["w"] for i in range(6)]), (ref_loss.detach(), list(ref)))


# ---------------------------------------------------------------------------
# Against JAX: the same plan, the same values
# ---------------------------------------------------------------------------


def test_plan_equals_the_jax_planners_plan(setup):
    np_params, np_x = _np_mlp()
    jg = rtrace(jmlp, [jnp.asarray(p) for p in np_params], jnp.asarray(np_x)).graph
    params, x, g, budget = setup
    rplan = RPlanner(cache=RPlanCache()).plan(jg, budget, "approx_dp").plan
    planned = repro_torch.plan_function(mlp, budget, planner=Planner(cache=PlanCache()))
    plan = planned.lowered_for(params, x).plan
    assert plan.overhead == rplan.overhead > 0
    assert plan.peak_memory == rplan.peak_memory
    assert plan.cached == rplan.cached
    assert [(s.nodes, s.keep, s.recompute) for s in plan.segments] == \
        [(s.nodes, s.keep, s.recompute) for s in rplan.segments]


def test_values_match_jax(setup):
    np_params, np_x = _np_mlp()
    params, x, g, budget = setup
    planned = repro_torch.plan_function(mlp, budget, argnums=(0, 1),
                                        planner=Planner(cache=PlanCache()))
    loss, (gp, gx) = planned(params, x)
    rloss, (rgp, rgx) = jax.value_and_grad(jmlp, argnums=(0, 1))(
        [jnp.asarray(p) for p in np_params], jnp.asarray(np_x))
    np.testing.assert_allclose(loss.numpy(), np.asarray(rloss), rtol=RTOL)
    for a, b in zip(gp + [gx], list(rgp) + [rgx]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


B, S, H, KV, HD, DM, LAYERS = 2, 64, 4, 2, 16, 32, 3


def _np_attention():
    rng = np.random.default_rng(3)
    layers = [{name: (rng.standard_normal(shape) * 0.2).astype(np.float32) for name, shape in
               (("wq", (DM, H * HD)), ("wk", (DM, KV * HD)), ("wv", (DM, KV * HD)),
                ("wo", (H * HD, DM)))} for _ in range(LAYERS)]
    return layers, rng.standard_normal((B, S, DM)).astype(np.float32)


def attention_loss(layers, x):
    h = x
    for w in layers:
        q = (h @ w["wq"]).reshape(B, S, H, HD)
        k = (h @ w["wk"]).reshape(B, S, KV, HD)
        v = (h @ w["wv"]).reshape(B, S, KV, HD)
        ctx = flash_attention(q, k, v, causal=True)
        h = torch.tanh(ctx.reshape(B, S, H * HD) @ w["wo"]) + h
    return torch.sum(h * h) / (B * S)


def jattention_loss(layers, x):
    h = x
    for w in layers:
        q = (h @ w["wq"]).reshape(B, S, H, HD)
        k = (h @ w["wk"]).reshape(B, S, KV, HD)
        v = (h @ w["wv"]).reshape(B, S, KV, HD)
        ctx = rflash(q, k, v, causal=True, interpret=True)
        h = jnp.tanh(ctx.reshape(B, S, H * HD) @ w["wo"]) + h
    return jnp.sum(h * h) / (B * S)


def test_attention_matches_jax_and_recomputes_the_plan():
    """Three residual attention layers at the minimal feasible budget: the
    plan recomputes flash-attention nodes, and the counting mode sees each
    recomputed op once more than vanilla, the flash op included."""
    np_layers, np_x = _np_attention()
    layers = [{k: torch.tensor(v) for k, v in w.items()} for w in np_layers]
    x = torch.tensor(np_x)
    carrier = TracedCarrier.trace(attention_loss, (layers, x))
    g = carrier.to_graph()
    flash = {nd.idx for nd in g.nodes if nd.kind == "flash_attention"}
    assert len(flash) == LAYERS
    planned = repro_torch.plan_function(attention_loss, planner=Planner(cache=PlanCache()))
    plan = planned.lowered_for(layers, x).plan
    recomputed = flash & set().union(*(s.recompute for s in plan.segments))
    assert recomputed

    loss, grads = planned(layers, x)
    vanilla = vanilla_traced_value_and_grad(carrier)
    assert_bits((loss, grads), vanilla(layers, x))
    got = extra_ops(planned, vanilla, (layers, x))
    assert got == expected_recompute(carrier, plan, (layers, x))
    assert got["flash_attention"] == len(recomputed)

    rloss, rgrads = jax.value_and_grad(jattention_loss)(
        jax.tree_util.tree_map(jnp.asarray, np_layers), jnp.asarray(np_x))
    np.testing.assert_allclose(loss.numpy(), np.asarray(rloss), rtol=RTOL, atol=ATOL)
    for got_w, want_w in zip(grads, rgrads):
        for name in got_w:
            np.testing.assert_allclose(got_w[name].numpy(), np.asarray(want_w[name]),
                                       rtol=RTOL, atol=ATOL)
