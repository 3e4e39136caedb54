"""The port's ``"policy"`` backend (``repro_torch.core.lowering.policy``),
the BlockGraph default, against the reference's ``"policy"`` backend and
the port's own twins on the CPU.

On random BlockGraphs (chains with skip connections, as in
``tests/test_lowering.py``) and ``plan_explorer``'s ``bg-demo``:

* the plan is the reference's, and loss and grads agree with the
  reference's ``"policy"`` twin on the same numpy params (f32, rtol 1e-5);
* loss and grads are bitwise the port's plain autograd and its
  ``"segment"`` twin;
* what the policy saves across the forward is exactly the outputs of U_k's
  blocks, block for block (each segment runs as a region, so an outer
  ``saved_tensors_hooks`` sees nothing of the forward), and the backward
  reruns every block's internals but no cached block's output op;
* the bytes held at the end of the forward (the storages of the ops it
  ran that are still alive) are no more than ``"segment"``'s on the same
  plan.
"""

import collections
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import PlanCache as RPlanCache  # noqa: E402
from repro.core import Planner as RPlanner  # noqa: E402
from repro.core.blockgraph import Block as RBlock  # noqa: E402
from repro.core.blockgraph import BlockGraph as RBlockGraph  # noqa: E402
from repro.core.lowering import plan_function as rplan_function  # noqa: E402
from torch.multiprocessing.reductions import StorageWeakRef  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.analysis.census import CountOps  # noqa: E402
from repro_torch.core import PlanCache, Planner  # noqa: E402
from repro_torch.core.lowering import (  # noqa: E402
    apply_with_policy,
    get_lowering,
    plan_function,
    plan_policy,
    vanilla_value_and_grad,
)
from repro_torch.core.lowering.carriers import BlockGraphCarrier  # noqa: E402
from repro_torch.core.lowering.fx import _Keep  # noqa: E402
from repro_torch.core.lowering.segment import apply_segmented  # noqa: E402
from repro_torch.examples.plan_explorer import _bg_demo_factory  # noqa: E402
from test_torch_lowering import SEEDS, _blockgraph_case, assert_bits  # noqa: E402

RTOL = 1e-5  # f32 against JAX, as in tests/test_torch_model.py
CASES = [f"rand-{s}-{n}" for s, n in SEEDS] + ["bg-demo"]


def _case(name):
    """(BlockGraph, params, inputs, loss, a budget that makes the plan
    recompute)."""
    if name == "bg-demo":
        bg, (params, inputs), loss_fn = _bg_demo_factory()
    else:
        _, seed, n = name.split("-")
        bg, params, inputs, loss_fn = _blockgraph_case(int(seed), int(n))
    g = bg.to_graph(params, inputs)
    budget = Planner(cache=PlanCache()).min_feasible_budget(g, "approx_dp") * 1.2
    return bg, params, inputs, loss_fn, budget


def _lowered(name, backend="policy"):
    bg, params, inputs, loss_fn, budget = _case(name)
    pf = plan_function(bg, budget, backend=backend, loss_fn=loss_fn,
                       planner=Planner(cache=PlanCache()))
    return bg, params, inputs, loss_fn, pf, pf.lowered_for(params, inputs)


def _reference_twin(bg, params, inputs, budget):
    """The same graph as a reference BlockGraph on the same numpy params,
    lowered by the reference's ``"policy"`` backend."""

    def lin(p, *xs):
        h = xs[0]
        for x in xs[1:]:
            h = h + x
        return jnp.tanh(h @ p["w"])

    rbg = RBlockGraph([RBlock(b.name, lin, tuple(b.inputs)) for b in bg.blocks],
                      list(bg.graph_inputs), list(bg.outputs))
    rparams = {k: {"w": jnp.asarray(v["w"].numpy())} for k, v in params.items()}
    rinputs = {k: jnp.asarray(v.numpy()) for k, v in inputs.items()}
    pf = rplan_function(rbg, budget, backend="policy",
                        loss_fn=lambda out: jnp.sum(out * out),
                        planner=RPlanner(cache=RPlanCache()))
    return pf, rparams, rinputs


@pytest.mark.parametrize("name", CASES)
def test_policy_matches_the_references_policy(name):
    bg, params, inputs, loss_fn, pf, low = _lowered(name)
    assert low.backend == "policy" and low.plan.overhead > 0
    rpf, rparams, rinputs = _reference_twin(bg, params, inputs, _case(name)[-1])
    rlow = rpf.lowered_for(rparams, rinputs)
    assert rlow.backend == "policy"
    assert low.plan.cached == rlow.plan.cached
    assert [s.nodes for s in low.plan.segments] == [s.nodes for s in rlow.plan.segments]
    loss, grads = pf(params, inputs)
    rloss, rgrads = rpf(rparams, rinputs)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=RTOL)
    for k in params:
        want = np.asarray(rgrads[k]["w"])
        np.testing.assert_allclose(grads[k]["w"].numpy(), want, rtol=RTOL,
                                   atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("name", CASES)
def test_policy_is_bitwise_plain_autograd_and_segment(name):
    bg, params, inputs, loss_fn, pf, low = _lowered(name)
    got = pf(params, inputs)
    assert_bits(got, vanilla_value_and_grad(bg, loss_fn)(params, inputs), "plain autograd")
    seg = get_lowering("segment").lower(low.carrier, low.plan)
    assert_bits(got, seg(params, inputs), "segment")


@pytest.mark.parametrize("name", CASES)
def test_policy_saves_exactly_the_cached_blocks_outputs(name):
    """Block for block: the policy keeps one tensor per cached block, equal
    to that block's output in a plain forward, and nothing else; an outer
    ``saved_tensors_hooks`` records what autograd saves across the forward
    besides: the regions' inputs (torch's checkpoint saves them), which
    are parameters, graph inputs and those same cached outputs, since no
    segment runs plainly; the backward reruns each block's matmul (its
    internals) and the ``tanh`` (output op) of the uncached blocks only,
    where ``"segment"`` reruns every block's ``tanh`` too."""
    bg, params, inputs, loss_fn, pf, low = _lowered(name)
    plan = low.plan
    names = [b.name for b in bg.blocks]
    cached = [names[v] for s in plan.segments for v in sorted(s.nodes) if v in plan.cached]
    assert set(cached) == set(plan_policy(plan, names)[0])
    leaves = {k: {"w": v["w"].detach().requires_grad_()} for k, v in params.items()}
    plain: dict = {}
    values = dict(inputs)
    for b in bg.blocks:  # a plain forward, block by block
        values[b.name] = plain[b.name] = b.apply(leaves[b.name],
                                                 *[values[i] for i in b.inputs])
    kept, packed = [], []
    settle = _Keep.settle

    def recorded(mode, outputs):  # what the policy keeps after each cached block
        got = settle(mode, outputs)
        if got:
            kept.append(got)
        return got

    _Keep.settle = recorded
    try:
        with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(t) or t,
                                                      lambda t: t):
            out = apply_with_policy(bg, leaves, inputs, plan)
    finally:
        _Keep.settle = settle
    assert len(kept) == len(cached)
    for n, got in zip(cached, kept):
        assert len(got) == 1 and torch.equal(got[0], plain[n]), n
    allowed = {t.data_ptr() for t in (*inputs.values(), *(k for (k,) in kept),
                                      *(p["w"] for p in leaves.values()))}
    assert all(t.data_ptr() in allowed for t in packed)
    loss_fn(out).backward()

    def rerun(backend):
        twin = get_lowering(backend).lower(low.carrier, plan)
        twin(params, inputs)
        with CountOps() as c:
            twin(params, inputs)
        with CountOps() as v:
            vanilla_value_and_grad(bg, loss_fn)(params, inputs)
        diff = collections.Counter(c.counts)
        diff.subtract(v.counts)
        return {k: n for k, n in diff.items() if n}

    n = len(bg.blocks)
    mm, tanh = "dot_general", "tanh"  # the reference's kinds of aten's mm and tanh
    assert {k: v for k, v in rerun("policy").items() if k in (mm, tanh)} == {
        mm: n, **({tanh: n - len(cached)} if n > len(cached) else {})}
    assert {k: v for k, v in rerun("segment").items() if k in (mm, tanh)} == {mm: n, tanh: n}


class _Allocations(TorchDispatchMode):
    """Weak references to the storage of every op output while active;
    :meth:`live` is the bytes of those still alive."""

    def __init__(self):
        super().__init__()
        self.refs = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.refs[st.data_ptr()] = (StorageWeakRef(st), st.nbytes())
        return out

    def live(self) -> int:
        gc.collect()
        return sum(n for ref, n in self.refs.values() if not ref.expired())


@pytest.mark.parametrize("name", CASES)
def test_policy_holds_no_more_than_segment_after_the_forward(name):
    """The bytes the forward allocated that are still alive when it
    returns (what autograd holds for the backward, and the output): under
    ``"policy"`` no more than under ``"segment"`` on the same plan, and
    exactly the outputs of U_k's blocks and the graph's output."""
    bg, params, inputs, loss_fn, pf, low = _lowered(name)
    leaves = {k: {"w": v["w"].detach().requires_grad_()} for k, v in params.items()}
    held = {}
    for fwd in (apply_with_policy, apply_segmented):
        with _Allocations() as mode:
            out = fwd(bg, leaves, inputs, low.plan)
        held[fwd] = mode.live()
        del out
    g = bg.to_graph(params, inputs)
    want = sum(g.mem_v[v] for v in low.plan.cached | {g.n - 1})
    assert held[apply_with_policy] == want <= held[apply_segmented]


def test_policy_rejects_what_the_reference_rejects():
    bg, params, inputs, loss_fn, budget = _case("rand-3-5")
    carrier = BlockGraphCarrier(bg, loss_fn, params, inputs)
    plan = Planner(cache=PlanCache()).plan(carrier.to_graph(), budget).plan
    policy = get_lowering("policy")
    with pytest.raises(ValueError, match="interpreter-only"):
        policy.lower(carrier, plan, track_live=True)
    with pytest.raises(ValueError, match="donate=True"):
        policy.lower(carrier, plan, donate=True)
    import dataclasses

    offload = dataclasses.replace(plan, strategy={v: "offload" for v in plan.cached})
    with pytest.raises(NotImplementedError, match="does not realize storage strategies"):
        policy.lower(carrier, offload)
    assert plan_policy(offload, [b.name for b in bg.blocks]) == (
        (), tuple(sorted(bg.blocks[v].name for v in plan.cached)))
