"""Sharded planning in the port: per-device ``M_v``, per-device budgets and
DTensor twins (``tests/test_sharded_planning.py`` restated for torch, and
held against JAX).

Accounting, in one process on an ``{axis: size}`` dict mesh: the port's
per-device ``M_v`` lists, its plans at the same per-device budget and its
graph digests equal the reference's bitwise on the same numpy MLP (the
unsharded digests are equal there, so the sharded ones must be too);
distinct shardings hash apart and plan apart; conformance holds on the
sharded carrier.

Execution, on four gloo ranks on the CPU (one spawn,
``tests/torch_dist_workers.py``): the twins of the reference's four
concrete-mesh tests, which need a concrete 8-device mesh.  The planned
sharded twin is bitwise sharded vanilla autograd on ``"fx"``,
``"interpreter"`` and (a BlockGraph) ``"segment"`` and ``"policy"``; gradients keep the
inputs' placements; ``check_lowering`` holds on the concrete twin; the
global loss and gradients are within f32 rtol 1e-6 of the reference's
unsharded function on the global inputs (``assert_close``: an absolute
floor of rtol × the tensor's largest magnitude; the flash-attention
function within the port's attention tolerance, 1e-5); flash attention
in layouts no rule serves and a mesh axis no twin runs over (``stage``)
raise naming ROADMAP.md 'Multi-device', while a strategy plan and a
recomputed random draw run bitwise sharded vanilla (the keys
``strategy_raises`` and ``redraw_raises`` are kept from when they raised).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import PlanCache as RPlanCache  # noqa: E402
from repro.core import Planner as RPlanner  # noqa: E402
from repro.core.graph import graph_digest as rgraph_digest  # noqa: E402
from repro.core.jaxpr_graph import trace as rtrace  # noqa: E402
from repro.kernels.ops import flash_attention as rflash  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.analysis import check_lowering  # noqa: E402
from repro_torch.core import PlanCache, Planner  # noqa: E402
from repro_torch.core.fx_graph import trace  # noqa: E402
from repro_torch.core.graph import graph_digest  # noqa: E402
from repro_torch.core.liveness import vanilla_peak  # noqa: E402
from repro_torch.core.lowering import TracedCarrier  # noqa: E402
from repro_torch.core.lowering.fx import fx_value_and_grad  # noqa: E402
from torch_dist_workers import _attention, spawn  # noqa: E402

DN = (((1,), (0,)), ((), ()))
N_LAYERS, WIDTH = 6, 16


def assert_close(got, want, rtol):
    """Within ``rtol`` elementwise, with an absolute floor of ``rtol`` times
    the largest magnitude of ``want``: a gradient summed in another order
    (4 ranks' partial sums, another BLAS) differs by f32 rounding of its
    largest terms, which elements that nearly cancel cannot hide."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def jmlp(params, x):
    h = x
    for w in params:
        h = lax.tanh(lax.dot_general(h, w, DN))
    return jnp.sum(h * h)


def tmlp(params, x):
    h = x
    for w in params:
        h = torch.tanh(h @ w)
    return torch.sum(h * h)


def _np(batch=8, seed=0):
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((WIDTH, WIDTH)) * 0.3).astype(np.float32)
          for _ in range(N_LAYERS)]
    return ws, rng.standard_normal((batch, WIDTH)).astype(np.float32)


def _both(mesh=None, x_spec=("data", None), batch=8):
    """(reference graph, port graph) of the MLP, sharded on ``mesh``."""
    ws, x = _np(batch)
    rkw = tkw = {}
    if mesh is not None:
        rkw = dict(mesh=mesh, in_shardings=[P()] * N_LAYERS + [P(*x_spec)])
        tkw = dict(mesh=mesh, in_shardings=[()] * N_LAYERS + [x_spec])
    jg = rtrace(jmlp, [jnp.asarray(w) for w in ws], jnp.asarray(x), **rkw).graph
    tg = trace(tmlp, [torch.tensor(w) for w in ws], torch.tensor(x), **tkw).graph
    return jg, tg


def _torch_args(batch=8):
    ws, x = _np(batch)
    return [torch.tensor(w) for w in ws], torch.tensor(x)


# ---------------------------------------------------------------------------
# Accounting (dict mesh: no process group)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", [{"data": 8}, {"data": 4}, {"data": 2, "model": 2}])
def test_per_device_mv_is_global_over_shards(mesh):
    """Every batch-carrying node's output is split over the data axis, the
    scalar loss stays replicated: M_v = global/shards, bitwise the
    reference's list."""
    jg, tg = _both(mesh)
    _, plain = _both()
    k = mesh["data"]
    assert plain.n == tg.n
    for a, b in zip(plain.nodes, tg.nodes):
        assert b.memory == (a.memory if a.kind == "reduce_sum" else a.memory / k), a.name
    assert tg.mem_v == jg.mem_v


def test_mean_style_loss_with_literal_operands():
    """A mean loss: the constant divisor propagates as replicated, and the
    planned twin on the dict mesh computes the function."""

    def fn(params, x):
        h = x
        for w in params:
            h = torch.tanh(h @ w)
        return torch.mean(h * h)

    def jfn(params, x):
        h = x
        for w in params:
            h = jnp.tanh(lax.dot_general(h, w, DN))
        return jnp.mean(h * h)

    params, x = _torch_args()
    ws, xs = _np()
    sh = trace(fn, params, x, mesh={"data": 8}, in_shardings=[()] * N_LAYERS + [("data", None)])
    jg = rtrace(jfn, [jnp.asarray(w) for w in ws], jnp.asarray(xs), mesh={"data": 8},
                in_shardings=[P()] * N_LAYERS + [P("data", None)])
    assert sh.graph.n > 0
    assert [nd.memory for nd in sh.graph.nodes if nd.kind == "dot_general"] == \
        [nd.memory for nd in jg.graph.nodes if nd.kind == "dot_general"]
    pf = repro_torch.plan_function(fn, None, mesh={"data": 8},
                                   in_shardings=(None, ("data", None)),
                                   planner=Planner(cache=PlanCache()))
    loss, _ = pf(params, x)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jfn([jnp.asarray(w) for w in ws],
                                                             jnp.asarray(xs))), rtol=1e-6)


def test_unknown_op_falls_back_to_replicated():
    """Conservative fallback: an op without a rule whose output shape no
    operand has (the copy-and-reshape of a transposed input) replicates;
    per-device bytes are over-, never under-estimated, as the reference's
    reshape."""

    def fn(x):
        h = x.t().reshape(x.shape[0] * x.shape[1])
        return torch.sum(h * h)

    def jfn(x):
        h = lax.reshape(x, (x.shape[0] * x.shape[1],))
        return jnp.sum(h * h)

    x = torch.ones(8, 4)
    sh = trace(fn, x, mesh={"data": 8}, in_shardings=[("data", None)]).graph
    jg = rtrace(jfn, jnp.ones((8, 4)), mesh={"data": 8}, in_shardings=[P("data", None)]).graph
    muls = [nd for nd in sh.nodes if nd.kind == "mul"]
    rmul = next(nd for nd in jg.nodes if nd.kind == "mul")
    assert muls and muls[0].memory == rmul.memory == 8 * 4 * 4  # full global bytes
    copied = next(nd for nd in sh.nodes if nd.kind not in ("mul", "reduce_sum"))
    assert copied.memory == 8 * 4 * 4 / 8  # the transposed copy keeps its shard


def test_distinct_shardings_distinct_digests():
    """Sharded and unsharded traces (and shard counts) never collide in the
    plan cache, and each digest is the reference's."""
    digests, rdigests = [], []
    for mesh in (None, {"data": 8}, {"data": 4}, {"data": 8}):
        jg, tg = _both(mesh)
        digests.append(graph_digest(tg))
        rdigests.append(rgraph_digest(jg))
    assert len(set(digests[:3])) == 3
    assert digests[1] == digests[3]  # deterministic: same sharding, same key
    assert digests == rdigests


def test_sharded_and_unsharded_plans_cached_separately():
    params, x = _torch_args()
    planner = Planner(cache=PlanCache())
    budget = vanilla_peak(trace(tmlp, params, x).graph, liveness=False) / 2
    repro_torch.plan_function(tmlp, budget, planner=planner)(params, x)
    misses = planner.cache.stats()["misses"]
    repro_torch.plan_function(tmlp, budget, mesh={"data": 8},
                              in_shardings=(None, ("data", None)),
                              planner=planner)(params, x)
    assert planner.cache.stats()["misses"] > misses


def test_per_device_budget_semantics():
    """The planner's budget is per-device: far below the unsharded minimum
    it plans when 8 devices share the activations — the same minimal
    budgets and the same plan as the reference's, bitwise, and the twin on
    the dict mesh is bitwise plain autograd."""
    jg_plain, tg_plain = _both()
    jg, tg = _both({"data": 8})
    planner, rplanner = Planner(cache=PlanCache()), RPlanner(cache=RPlanCache())
    mfb_plain, mfb = planner.min_feasible_budget(tg_plain), planner.min_feasible_budget(tg)
    assert mfb < mfb_plain / 4
    assert (mfb_plain, mfb) == (rplanner.min_feasible_budget(jg_plain),
                                rplanner.min_feasible_budget(jg))
    plan, rplan = planner.plan(tg, mfb).plan, rplanner.plan(jg, mfb).plan
    assert plan.cached == rplan.cached and plan.peak_memory == rplan.peak_memory
    assert [(s.nodes, s.keep, s.recompute) for s in plan.segments] == \
        [(s.nodes, s.keep, s.recompute) for s in rplan.segments]
    params, x = _torch_args()
    pf = repro_torch.plan_function(tmlp, mfb, mesh={"data": 8},
                                   in_shardings=(None, ("data", None)), planner=planner)
    assert pf.lowered_for(params, x).plan.peak_memory <= mfb
    loss, grads = pf(params, x)
    p2 = [p.detach().requires_grad_() for p in params]
    ref = tmlp(p2, x)
    assert torch.equal(loss, ref.detach())
    assert all(torch.equal(a, b) for a, b in zip(grads, torch.autograd.grad(ref, p2)))


def test_check_lowering_conformant_on_sharded_carrier():
    """Conformance on the dict-mesh carrier: the twin saves the plan's
    cache set at per-device bytes; a stale lowering is caught."""
    params, x = _torch_args()
    carrier = TracedCarrier.trace(tmlp, (params, x), mesh={"data": 8},
                                  in_shardings=(None, ("data", None)))
    g = carrier.to_graph()
    planner = Planner(cache=PlanCache())
    rep = planner.plan(g, planner.min_feasible_budget(g))
    assert rep.plan is not None
    report = check_lowering(carrier, rep.plan)
    assert report.ok, str(report.findings)
    roomy = planner.plan(g, vanilla_peak(g, liveness=True)).plan
    if roomy.cached != rep.plan.cached:
        assert not check_lowering(carrier, roomy, lowered=fx_value_and_grad(carrier, rep.plan)).ok


def test_verifier_rederives_per_device_bytes():
    """``verify=True`` re-derives every M_v per device: the sharded plan
    passes, a graph edited to whole-tensor bytes does not."""
    import dataclasses

    from repro_torch.analysis import check_plan
    from repro_torch.core.graph import Graph

    params, x = _torch_args()
    pf = repro_torch.plan_function(tmlp, None, mesh={"data": 8},
                                   in_shardings=(None, ("data", None)), verify=True,
                                   planner=Planner(cache=PlanCache()))
    low = pf.lowered_for(params, x)
    fxg = low.carrier.fx
    assert check_plan(fxg.graph, low.plan, fx=fxg).ok
    whole = trace(tmlp, params, x).graph
    stale = dataclasses.replace(fxg, graph=Graph(whole.nodes, whole.edges))
    codes = {f.code for f in check_plan(stale.graph, low.plan, fx=stale).findings}
    assert "memory-mismatch" in codes


# ---------------------------------------------------------------------------
# Execution on four gloo ranks (the reference's concrete-mesh half)
# ---------------------------------------------------------------------------

BATCH = 16
N_BLOCKS = 5


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    rng = np.random.default_rng(0)
    inp = {f"w{i}": (rng.standard_normal((WIDTH, WIDTH)) * 0.3).astype(np.float32)
           for i in range(N_LAYERS)}
    inp["x"] = rng.standard_normal((BATCH, WIDTH)).astype(np.float32)
    inp.update({f"bw{i}": (rng.standard_normal((8, 8)) * 0.3).astype(np.float32)
                for i in range(N_BLOCKS)})
    inp["bx"] = rng.standard_normal((BATCH, 8)).astype(np.float32)
    inp.update({f"aw{i}": (rng.standard_normal((16, 16)) * 0.3).astype(np.float32)
                for i in range(3)})
    inp["ax"] = rng.standard_normal((8, 8, 16)).astype(np.float32)
    return inp, spawn("planning", 4, tmp_path_factory.mktemp("planning"), inp)


RANK_CHECKS = [
    "fx_recomputes", "fx_bitwise_vanilla", "fx_placements",
    "interpreter_recomputes", "interpreter_bitwise_vanilla", "interpreter_placements",
    "live_bytes_within_per_device_peak", "sharded_plan_differs",
    "gx_keeps_input_placements", "gx_bitwise_vanilla",
    "check_lowering_ok", "check_lowering_catches_drift", "segment_bitwise_vanilla",
    "attention_bitwise_vanilla", "model_axis_raises", "strategy_raises", "redraw_raises",
    "stage_axis_raises", "policy_bitwise_vanilla",
]


@pytest.mark.parametrize("check", RANK_CHECKS)
def test_sharded_twin_on_four_ranks(four_ranks, check):
    _, ranks = four_ranks
    assert all(bool(r[check]) for r in ranks), check


@pytest.mark.parametrize("backend", ["fx", "interpreter"])
def test_sharded_twin_matches_the_reference_unsharded(four_ranks, backend):
    """Global loss and grads of the 4-rank twin against ``jax.value_and_grad``
    of the reference's function on the global inputs (f32, rtol 1e-6); the
    per-device bytes of its trace are the reference's at ``{data: 4}``."""
    inp, ranks = four_ranks
    ws = [jnp.asarray(inp[f"w{i}"]) for i in range(N_LAYERS)]
    rloss, rgrads = jax.value_and_grad(jmlp)(ws, jnp.asarray(inp["x"]))
    for r in ranks:
        assert_close(r[f"{backend}_loss"], rloss, 1e-6)
        for i in range(N_LAYERS):
            assert_close(r[f"{backend}_g{i}"], rgrads[i], 1e-6)
    jg = rtrace(jmlp, ws, jnp.asarray(inp["x"]), mesh={"data": 4},
                in_shardings=[P()] * N_LAYERS + [P("data", None)]).graph
    assert list(ranks[0]["per_device_mv"]) == jg.mem_v


def test_blockgraph_segment_backend_sharded(four_ranks):
    """A BlockGraph whose blocks pin ``("batch", None)``: per-device block
    bytes on the 4-rank mesh, and loss and grads against the reference's
    unsharded function (rtol 1e-6)."""
    inp, ranks = four_ranks
    ws = [jnp.asarray(inp[f"bw{i}"]) for i in range(N_BLOCKS)]

    def jfn(ws, x):
        h = x
        for w in ws:
            h = jnp.tanh(lax.dot_general(h, w, DN))
        return jnp.sum(h * h)

    rloss, rgrads = jax.value_and_grad(jfn)(ws, jnp.asarray(inp["bx"]))
    for r in ranks:
        assert list(r["segment_per_device_mv"]) == [BATCH * 8 * 4 / 4] * N_BLOCKS
        assert_close(r["segment_loss"], rloss, 1e-6)
        for i in range(N_BLOCKS):
            assert_close(r[f"segment_g{i}"], rgrads[i], 1e-6)


def test_flash_attention_twin_matches_the_reference(four_ranks):
    """The flash-attention op under its DTensor sharding rule (batch over
    4 ranks): loss and grads against the reference's Pallas kernel in
    interpret mode on the global inputs (rtol 1e-5, as the port's other
    attention tests), and against the port's own unsharded run."""
    inp, ranks = four_ranks
    ws = [jnp.asarray(inp[f"aw{i}"]) for i in range(3)]

    def jfn(ws, x):
        B, S, D = x.shape
        x = x + 0.01 * jnp.arange(S, dtype=x.dtype)[None, :, None]
        q, k, v = ((x @ w).reshape(B, S, 2, D // 2) for w in ws)
        out = rflash(q, k, v, causal=True)
        return jnp.sum(out * out)

    rloss, rgrads = jax.value_and_grad(jfn)(ws, jnp.asarray(inp["ax"]))
    tws = [torch.tensor(inp[f"aw{i}"]).requires_grad_() for i in range(3)]
    tloss = _attention(tws, torch.tensor(inp["ax"]))
    tgrads = torch.autograd.grad(tloss, tws)
    for r in ranks:
        assert_close(r["attention_loss"], rloss, 1e-5)
        assert_close(r["attention_loss"], tloss.detach().numpy(), 1e-6)
        for i in range(3):
            assert_close(r[f"attention_g{i}"], rgrads[i], 1e-5)
            assert_close(r[f"attention_g{i}"], tgrads[i].numpy(), 1e-6)


def test_reference_accounting_agrees_at_the_twins_mesh():
    """The reference's own sharded plan at the 4-rank mesh's per-device
    budget is the plan the ranks planned (the same graph, bitwise)."""
    jg, tg = _both({"data": 4}, batch=BATCH)
    budget = vanilla_peak(tg, liveness=False) / 2
    plan = Planner(cache=PlanCache()).plan(tg, budget).plan
    rplan = RPlanner(cache=RPlanCache()).plan(jg, budget).plan
    assert plan.overhead == rplan.overhead > 0 and plan.cached == rplan.cached
