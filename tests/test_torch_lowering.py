"""Backend equivalence for the port's lowerings (``tests/test_lowering.py``
restated for torch).

Every registered lowering of a plan computes the same function: on random
small nets, the interpreter, the per-segment checkpoint backend and the
``"fx"`` backend return loss and gradients **bitwise** equal to plain
autograd on the CPU.  The interpreter's live-byte audit stays within the
plan's analytic peak and the no-liveness event simulation, and a counting
dispatch mode shows that ``"fx"`` recomputes the plan's nodes and no more.
"""

import collections
import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.analysis.census import CountOps, unpacked_recompute  # noqa: E402
from repro_torch.core import PlanCache, Planner, simulate  # noqa: E402
from repro_torch.core.blockgraph import Block, BlockGraph  # noqa: E402
from repro_torch.core.lowering import (  # noqa: E402
    available_backends,
    get_lowering,
    plan_function,
    vanilla_traced_value_and_grad,
    vanilla_value_and_grad,
)
from repro_torch.core.lowering.carriers import BlockGraphCarrier, TracedCarrier  # noqa: E402

D = 8
SEEDS = [(0, 4), (3, 5), (17, 6), (123, 7), (4242, 9)]


def assert_bits(got, ref, what=""):
    for a, b in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(ref)):
        assert torch.equal(a, b), what


def plain_value_and_grad(fn, params, *rest):
    """Loss and grads w.r.t. the first argument by plain autograd."""
    leaves = [p.detach().requires_grad_() for p in params]
    loss = fn(leaves, *rest)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def extra_ops(planned, vanilla, args):
    """Ops the planned twin dispatches beyond the vanilla run, by kind."""
    planned(*args)  # trace and plan outside the count
    with CountOps() as p:
        planned(*args)
    with CountOps() as v:
        vanilla(*args)
    diff = p.counts.copy()
    diff.subtract(v.counts)
    return {k: n for k, n in diff.items() if n}


def expected_recompute(carrier, plan, args):
    """The plan's recomputed nodes, by kind, in the checkpoint regions the
    backward unpacks (``analysis.census.unpacked_recompute``)."""
    g = carrier.to_graph()
    return dict(collections.Counter(
        g.nodes[v].kind for v in unpacked_recompute(carrier, plan, args)))


# ---------------------------------------------------------------------------
# Random small nets (chain + random skip connections)
# ---------------------------------------------------------------------------


def _lin_init(gen, *in_shapes):
    return {"w": torch.randn(D, D, generator=gen) * 0.3}


def _lin(p, *xs):
    h = xs[0]
    for x in xs[1:]:
        h = h + x  # skip merge
    return torch.tanh(h @ p["w"])


def rand_blockgraph(seed: int, n_blocks: int) -> BlockGraph:
    r = random.Random(seed)
    blocks = [Block("b0", _lin, ("x",), _lin_init)]
    for i in range(1, n_blocks):
        ins = [f"b{i-1}"]
        if i >= 2 and r.random() < 0.5:
            ins.append(f"b{r.randrange(i - 1)}")  # skip connection
        blocks.append(Block(f"b{i}", _lin, tuple(ins), _lin_init))
    return BlockGraph(blocks, ["x"], [f"b{n_blocks-1}"])


def rand_traced(seed: int, depth: int):
    r = random.Random(seed)
    skip_at = r.randrange(depth) if depth > 2 and r.random() < 0.7 else None

    def fn(params, x):
        h, skip = x, x
        for i, w in enumerate(params):
            h = torch.tanh(h @ w)
            if i == skip_at:
                skip = h
        if skip_at is not None:
            h = h + skip
        return torch.sum(h * h)

    gen = torch.Generator().manual_seed(seed)
    params = [torch.randn(D, D, generator=gen) * 0.3 for _ in range(depth)]
    return fn, (params, torch.randn(4, D, generator=gen))


def _blockgraph_case(seed, n_blocks):
    bg = rand_blockgraph(seed, n_blocks)
    gen = torch.Generator().manual_seed(seed)
    params = bg.init(gen, {"x": (4, D)})
    inputs = {"x": torch.randn(4, D, generator=gen)}
    return bg, params, inputs, (lambda out: torch.sum(out * out))


# ---------------------------------------------------------------------------
# All backends == vanilla, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["interpreter", "segment", "policy"])
@pytest.mark.parametrize("seed,n_blocks", SEEDS)
def test_blockgraph_backends_bitwise(seed, n_blocks, backend):
    bg, params, inputs, loss_fn = _blockgraph_case(seed, n_blocks)
    ref = vanilla_value_and_grad(bg, loss_fn)(params, inputs)
    planner = Planner(cache=PlanCache())
    g = bg.to_graph(params, inputs)
    budget = planner.min_feasible_budget(g, "approx_dp") * 1.2  # forces remat
    pf = plan_function(bg, budget, backend=backend, loss_fn=loss_fn, planner=planner)
    loss, grads = pf(params, inputs)
    assert pf.lowered_for(params, inputs).plan.overhead > 0
    assert_bits(loss, ref[0], f"{backend}: loss")
    assert_bits(grads, ref[1], f"{backend}: grads")


@pytest.mark.parametrize("backend", ["fx", "interpreter"])
@pytest.mark.parametrize("seed,depth", SEEDS)
def test_traced_backends_bitwise(seed, depth, backend):
    fn, args = rand_traced(seed, depth)
    ref_loss, ref_grads = plain_value_and_grad(fn, *args)
    planner = Planner(cache=PlanCache())
    g = TracedCarrier.trace(fn, args).to_graph()
    budget = planner.min_feasible_budget(g, "approx_dp") * 1.2
    pf = plan_function(fn, budget, backend=backend, planner=planner)
    loss, grads = pf(*args)
    assert pf.lowered_for(*args).plan.overhead > 0
    assert_bits(loss, ref_loss, f"{backend}: loss")
    assert_bits(grads, ref_grads, f"{backend}: grads")


@pytest.mark.parametrize("seed,n_blocks", SEEDS)
def test_blockgraph_interpreter_recomputes_exactly_the_plan(seed, n_blocks):
    """Each block runs once in the forward and once in the backward's VJP
    sweep; only the plan's V_i \\ U_k run a third time.  Cached blocks of a
    segment are read from the caches, never recomputed, and so are the
    graph's outputs, which the forward holds for the loss (as the
    reference's interpreter does)."""
    bg, params, inputs, loss_fn = _blockgraph_case(seed, n_blocks)
    calls = collections.Counter()

    def counted(b):
        def apply(p, *xs):
            calls[b.name] += 1
            return b.apply(p, *xs)
        return Block(b.name, apply, b.inputs, b.init)

    bg = BlockGraph([counted(b) for b in bg.blocks], bg.graph_inputs, bg.outputs)
    pf = plan_function(bg, backend="interpreter", loss_fn=loss_fn,
                       planner=Planner(cache=PlanCache()))
    plan = pf.lowered_for(params, inputs).plan  # traces and plans
    assert any(s.keep for s in plan.segments[:-1])
    calls.clear()
    pf(params, inputs)
    recompute = {bg.blocks[v].name for s in plan.segments for v in s.recompute}
    recompute -= set(bg.outputs)
    assert recompute
    assert calls == {b.name: 2 + (b.name in recompute) for b in bg.blocks}


@pytest.mark.parametrize("seed,depth", SEEDS)
def test_fx_recomputes_exactly_the_plan(seed, depth):
    fn, args = rand_traced(seed, depth)
    planner = Planner(cache=PlanCache())
    carrier = TracedCarrier.trace(fn, args)
    g = carrier.to_graph()
    pf = plan_function(fn, planner.min_feasible_budget(g, "approx_dp"), planner=planner)
    plan = pf.lowered_for(*args).plan
    got = extra_ops(pf, vanilla_traced_value_and_grad(carrier), args)
    planned = collections.Counter(g.nodes[v].kind for s in plan.segments for v in s.recompute)
    assert sum(planned.values()) > 0
    assert got == expected_recompute(carrier, plan, args)
    assert all(planned[k] >= n for k, n in got.items())  # never more than the plan


# ---------------------------------------------------------------------------
# Interpreter live-byte audit vs the plan's analytic peak + core.liveness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,depth", SEEDS)
def test_interpreter_live_trace_within_plan_peak(seed, depth):
    fn, args = rand_traced(seed, depth)
    pf = plan_function(fn, backend="interpreter", track_live=True,
                       planner=Planner(cache=PlanCache()))
    _, _, live = pf(*args)  # budget=None: exact minimal feasible budget
    lowered = pf.lowered_for(*args)
    peak_live = max(b for _, b in live)
    assert peak_live <= lowered.plan.peak_memory
    g = lowered.carrier.to_graph()
    seq = lowered.report.result.sequence
    assert peak_live <= simulate(g, seq, liveness=False).peak_memory


def test_blockgraph_interpreter_live_trace_within_plan_peak():
    bg, params, inputs, loss_fn = _blockgraph_case(7, 6)
    pf = plan_function(bg, backend="interpreter", loss_fn=loss_fn, track_live=True,
                       planner=Planner(cache=PlanCache()))
    _, _, live = pf(params, inputs)
    assert max(b for _, b in live) <= pf.lowered_for(params, inputs).plan.peak_memory


# ---------------------------------------------------------------------------
# Registry behavior
# ---------------------------------------------------------------------------


def test_registry_and_auto_dispatch():
    assert set(available_backends()) >= {"interpreter", "segment", "fx"}
    fn, args = rand_traced(3, 4)
    carrier = TracedCarrier.trace(fn, args)
    assert available_backends(carrier) == ["fx", "interpreter"]
    assert carrier.default_backend == "fx"
    bg, params, inputs, loss_fn = _blockgraph_case(3, 4)
    bc = BlockGraphCarrier(bg, loss_fn, params, inputs)
    assert available_backends(bc) == ["interpreter", "policy", "segment"]
    assert bc.default_backend == "policy"
    pf = plan_function(bg, loss_fn=loss_fn, planner=Planner(cache=PlanCache()))
    assert pf.lowered_for(params, inputs).backend == "policy"
    assert get_lowering("policy").supports(bc) and not get_lowering("policy").supports(carrier)

    with pytest.raises(ValueError, match="unknown lowering backend"):
        get_lowering("jaxpr")  # the port's twin of the reference's "jaxpr" is "fx"
    with pytest.raises(ValueError, match="does not support"):
        plan_function(fn, backend="segment").lowered_for(*args)
    with pytest.raises(ValueError, match="does not support"):
        plan_function(fn, backend="policy").lowered_for(*args)


@pytest.mark.parametrize("backend", ["fx", "segment"])
def test_track_live_is_interpreter_only(backend):
    fn, args = rand_traced(5, 4)
    bg, params, inputs, loss_fn = _blockgraph_case(5, 4)
    pf = (plan_function(fn, backend=backend, track_live=True) if backend == "fx" else
          plan_function(bg, backend=backend, loss_fn=loss_fn, track_live=True))
    with pytest.raises(ValueError, match="interpreter-only"):
        pf.lowered_for(*(args if backend == "fx" else (params, inputs)))
