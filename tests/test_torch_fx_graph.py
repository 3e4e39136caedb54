"""The port's graph carrier (``repro_torch.core.fx_graph``) against the
reference's jaxpr carrier.

The same numpy inputs go through a JAX function traced by
``repro.core.jaxpr_graph.trace`` and its torch twin traced by the port with
``make_fx``: the graphs must have the same nodes (kinds, ``T_v``, ``M_v``)
and an equal ``graph_digest``, under both cost models, so both packages
share plans.  The flash-attention op is one node; views and ``getitem``
fold into their base (a divergence from the reference, ROADMAP.md §3).
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.core.graph import graph_digest as rdigest  # noqa: E402
from repro.core.jaxpr_graph import trace as rtrace  # noqa: E402
from repro_torch.core.fx_graph import trace  # noqa: E402
from repro_torch.core.graph import graph_digest  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.ops import flash_attention, flash_attention_op  # noqa: E402

DN = (((1,), (0,)), ((), ()))
COST_MODELS = ["paper", "flops"]


def _mlp_pair():
    """The README quickstart MLP, in JAX and in torch."""

    def jfn(params, x):
        h = x
        for w in params:
            h = lax.tanh(lax.dot_general(h, w, DN))
        return jnp.sum(h * h)

    def tfn(params, x):
        h = x
        for w in params:
            h = torch.tanh(h @ w)
        return torch.sum(h * h)

    rng = np.random.default_rng(0)
    params = [(rng.standard_normal((32, 32)) * 0.3).astype(np.float32) for _ in range(10)]
    x = rng.standard_normal((8, 32)).astype(np.float32)
    return jfn, tfn, (params, x)


def _rand_pair(seed: int, depth: int, d: int = 8):
    """``tests/test_lowering.py``'s random lax net and its torch twin."""
    r = random.Random(seed)
    skip_at = r.randrange(depth) if depth > 2 and r.random() < 0.7 else None

    def jfn(params, x):
        h, skip = x, x
        for i, w in enumerate(params):
            h = lax.tanh(lax.dot_general(h, w, DN))
            if i == skip_at:
                skip = h
        if skip_at is not None:
            h = lax.add(h, skip)
        return jnp.sum(h * h)

    def tfn(params, x):
        h, skip = x, x
        for i, w in enumerate(params):
            h = torch.tanh(h @ w)
            if i == skip_at:
                skip = h
        if skip_at is not None:
            h = h + skip
        return torch.sum(h * h)

    rng = np.random.default_rng(seed)
    params = [(rng.standard_normal((d, d)) * 0.3).astype(np.float32) for _ in range(depth)]
    x = rng.standard_normal((4, d)).astype(np.float32)
    return jfn, tfn, (params, x)


def _both(jfn, tfn, np_args, cost_model):
    jargs = jax.tree_util.tree_map(jnp.asarray, np_args)
    targs = jax.tree_util.tree_map(torch.tensor, np_args)
    return (rtrace(jfn, *jargs, cost_model=cost_model).graph,
            trace(tfn, *targs, cost_model=cost_model).graph)


def _assert_same_graph(jg, tg):
    assert tg.n == jg.n
    for a, b in zip(jg.nodes, tg.nodes):
        assert (b.kind, b.time, b.memory) == (a.kind, a.time, a.memory)
    assert tg.edges == jg.edges
    assert graph_digest(tg) == rdigest(jg)


@pytest.mark.parametrize("cost_model", COST_MODELS)
def test_quickstart_mlp_matches_the_jaxpr_graph(cost_model):
    jfn, tfn, args = _mlp_pair()
    jg, tg = _both(jfn, tfn, args, cost_model)
    assert tg.n == 22
    assert [nd.kind for nd in tg.nodes] == ["dot_general", "tanh"] * 10 + ["mul", "reduce_sum"]
    assert tg.nodes[0].time == (10.0 if cost_model == "paper" else 2.0 * 8 * 32 * 32)
    assert tg.nodes[0].memory == 8 * 32 * 4 and tg.nodes[-1].memory == 4
    _assert_same_graph(jg, tg)


@pytest.mark.parametrize("cost_model", COST_MODELS)
@pytest.mark.parametrize("seed,depth", [(0, 4), (3, 5), (7, 6), (11, 8), (42, 9)])
def test_random_nets_match_the_jaxpr_graph(seed, depth, cost_model):
    jfn, tfn, args = _rand_pair(seed, depth)
    _assert_same_graph(*_both(jfn, tfn, args, cost_model))


def _attention_fn(causal=True):
    def fn(w, x):
        B, S, _ = x.shape
        q = (x @ w["wq"]).reshape(B, S, 4, 16)
        k = (x @ w["wk"]).reshape(B, S, 2, 16)
        v = (x @ w["wv"]).reshape(B, S, 2, 16)
        ctx = flash_attention(q, k, v, causal=causal)
        return torch.tanh(ctx.reshape(B, S, 64) @ w["wo"]).square().sum()

    g = torch.Generator().manual_seed(0)
    w = {name: torch.randn(shape, generator=g) * 0.1 for name, shape in
         (("wq", (32, 64)), ("wk", (32, 32)), ("wv", (32, 32)), ("wo", (64, 32)))}
    return fn, (w, torch.randn(2, 64, 32, generator=g))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_is_one_opaque_node(causal):
    fn, args = _attention_fn(causal)
    fxg = trace(fn, *args, cost_model="flops")
    flash = [nd for nd in fxg.graph.nodes if nd.kind == "flash_attention"]
    assert len(flash) == 1
    v = flash[0].idx
    # out (B, S, H, D) and lse (B, H, S) in f32, read through getitem
    assert flash[0].memory == 2 * 64 * 4 * 16 * 4 + 2 * 4 * 64 * 4
    full = 4 * 2 * 4 * 64 * 64 * 16
    assert flash[0].time == (full // 2 if causal else full)
    assert [fxg.graph.nodes[p].kind for p in fxg.graph.pred[v]] == ["dot_general"] * 3
    kinds = [nd.kind for nd in fxg.graph.nodes]
    assert not any(k in kinds for k in ("bmm", "logsumexp", "masked_fill", "softmax"))
    for nd in fxg.graph.nodes:
        assert fxg.owner[fxg.nodes[nd.idx]] == nd.idx


def test_views_and_getitem_fold_into_their_base():
    def fn(w, x):
        h = (x @ w).reshape(4, 2, 8).transpose(0, 1)  # views of the mm
        a, b = h.chunk(2, dim=0)  # a multi-output view op, read by getitem
        m = torch.max(a * b, dim=-1)  # a multi-output allocating op
        return (m.values.sum() + m.indices.float().sum() + x.t().sum())

    w, x = torch.randn(8, 16), torch.randn(4, 8)
    fxg = trace(fn, w, x)
    g = fxg.graph
    kinds = [nd.kind for nd in g.nodes]
    assert kinds == ["dot_general", "mul", "max", "reduce_sum", "convert_element_type",
                     "reduce_sum", "add", "reduce_sum", "add"]
    mm, mul, mx = 0, 1, 2
    assert g.pred[mul] == [mm]  # through reshape, transpose, chunk and getitem
    assert g.nodes[mx].memory == 1 * 4 * 4 + 1 * 4 * 8  # values f32 + indices i64
    assert g.pred[3] == [mx] and g.pred[4] == [mx]  # each getitem reads the one node
    assert g.pred[7] == []  # x.t() is a view of an input: no node, no edge
    folded = [n for n, v in fxg.owner.items() if v == mm]
    assert len(folded) == 6  # mm, view, transpose, split, and two getitems


def _qkv(requires_grad=True):
    g = torch.Generator().manual_seed(1)
    return [torch.randn(2, 32, n, 16, generator=g).requires_grad_(requires_grad)
            for n in (4, 2, 2)]


def test_flash_attention_op_passes_opcheck():
    """Schema, fake implementation (shapes, strides, dtypes), autograd
    registration and AOT dispatch of the custom op, on the CPU."""
    result = torch.library.opcheck(flash_attention_op, (*_qkv(), True))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_op_grads_include_lse(causal):
    """out and lse both differentiable: lse's cotangent enters the dq and
    dk/dv kernels through delta; held against the plain forward
    differentiated by autograd (f32)."""
    q, k, v = _qkv()
    w = torch.randn(2, 4, 32, generator=torch.Generator().manual_seed(2))
    out, lse = flash_attention_op(q, k, v, causal)
    got = torch.autograd.grad(out.square().sum() + (lse * w).sum(), (q, k, v))
    leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    o_ref, lse_ref = ref.attention_with_lse_ref(*leaves, causal=causal)
    want = torch.autograd.grad(o_ref.square().sum() + (lse_ref * w).sum(), leaves)
    torch.testing.assert_close(out, o_ref.transpose(1, 2), rtol=0, atol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b.transpose(1, 2), rtol=1e-5, atol=1e-5)
