"""The port's MoE layer (``repro_torch.models.moe``) against the reference.

Reduced granite-moe-3b-a800m and qwen3-moe-30b-a3b MoE configs, the
reference's ``moe_init`` weights and one numpy input from a seed: the
routing (gates, expert ids, positions, kept routes), the output, both aux
losses and the gradients of all of them agree in f32 to 1e-5, the output
in bf16 to 2e-2.  With the capacity factor cut to 0.5 the capacity binds
and both packages drop the same routes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import reduced as rreduced  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro_torch.configs import get_config as pget_config  # noqa: E402
from repro_torch.configs import reduced as preduced  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402

ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S = 2, 16


def setup(arch, capacity_factor=None, seed=0):
    """Both packages' MoE configs, d_model, numpy weights and a numpy input."""
    rcfg, pcfg = rreduced(rget_config(arch)), preduced(pget_config(arch))
    rm, pm = rcfg.moe, pcfg.moe
    if capacity_factor is not None:
        rm = dataclasses.replace(rm, capacity_factor=capacity_factor)
        pm = dataclasses.replace(pm, capacity_factor=capacity_factor)
    d = rcfg.d_model
    tree = jax.tree_util.tree_map(np.asarray,
                                  rmoe.moe_init(jax.random.PRNGKey(seed), d, rm))
    x = np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)
    return rm, pm, tree, x


def to_torch(tree):
    return {k: to_torch(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def close(got, want, dtype="float32", what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype], err_msg=what)


@pytest.mark.parametrize("capacity_factor", [None, 0.5], ids=["roomy", "binding"])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_and_packing_match_reference(arch, capacity_factor):
    rm, pm, tree, x = setup(arch, capacity_factor)
    T, E = B * S, rm.num_experts
    cap = max(8, int(rm.capacity_factor * T * rm.top_k / E))
    assert pmoe.capacity(pm, T) == cap
    xt = x.reshape(T, -1)
    rg, rids, rlogits = rmoe._route(jnp.asarray(tree["router"]), jnp.asarray(xt), rm)
    rdisp, reid, rpos, rkeep = rmoe._pack(jnp.asarray(xt), rg, rids, E, cap, jnp.float32)
    pg, pids, plogits, _ = pmoe._route(torch.tensor(tree["router"]), torch.tensor(xt), pm)
    pdisp, peid, ppos, pkeep = pmoe._pack(torch.tensor(xt), pids, E, cap)
    assert np.array_equal(pids.numpy(), np.asarray(rids))
    close(pg, rg, what="gates")
    close(plogits, rlogits, what="logits")
    for name, got, want in (("eid", peid, reid), ("pos_c", ppos, rpos), ("keep", pkeep, rkeep)):
        assert np.array_equal(got.numpy(), np.asarray(want)), name
    close(pdisp, rdisp, what="dispatch")
    dropped = int((~pkeep).sum())
    if capacity_factor is None:
        assert dropped == 0
    else:  # the capacity binds: the same routes dropped in both packages
        assert cap == 8 and dropped > 0


@pytest.mark.parametrize("capacity_factor", [None, 0.5], ids=["roomy", "binding"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_aux_and_grads_match_reference(arch, capacity_factor):
    """Output, lb_loss and z_loss, and the grads of a scalar made of all
    three with respect to the weights and the input, in f32."""
    rm, pm, tree, x = setup(arch, capacity_factor)
    cot = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def rloss(p, xx):
        y, aux = rmoe.moe_apply(p, xx, rm, return_aux=True)
        return jnp.sum(y * cot) + aux["lb_loss"] + aux["z_loss"], (y, aux)

    (rl, (ry, raux)), (rgp, rgx) = jax.value_and_grad(rloss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))

    p = to_torch(tree)
    leaves = [p["router"], *p["experts"].values()]
    tx = torch.tensor(x, requires_grad=True)
    for t in leaves:
        t.requires_grad_()
    py, paux = pmoe.moe_apply(p, tx, pm, return_aux=True)
    pl = (py * torch.tensor(cot)).sum() + paux["lb_loss"] + paux["z_loss"]
    grads = torch.autograd.grad(pl, [*leaves, tx])

    close(py.detach(), ry, what="y")
    for k in ("lb_loss", "z_loss"):
        close(paux[k].detach(), raux[k], what=k)
    close(pl.detach(), rl, what="loss")
    want = [rgp["router"], *(rgp["experts"][k] for k in p["experts"]), rgx]
    for name, g, w in zip(["router", *p["experts"], "x"], grads, want):
        close(g, w, what=f"grad {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_bf16_matches_reference(arch):
    rm, pm, tree, x = setup(arch, seed=3)
    want = rmoe.moe_apply(jax.tree_util.tree_map(jnp.asarray, tree),
                          jnp.asarray(x, jnp.bfloat16), rm)
    got = pmoe.moe_apply(to_torch(tree), torch.tensor(x).bfloat16(), pm)
    assert got.dtype == torch.bfloat16
    close(got.float(), want.astype(jnp.float32), "bfloat16", "y")


def test_moe_init_tree_matches_reference_shapes():
    rm, pm, tree, _ = setup(ARCHS[0])
    d = tree["router"].shape[0]
    got = pmoe.moe_init(d, pm, generator=torch.Generator().manual_seed(0))
    spec = jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
                                  got)
    assert spec == jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), tree)


def test_dropped_routes_are_zero_rows_and_grads_are_order_free():
    """Dropped routes add exact zeros at slot C-1 and get zero cotangents:
    two runs give bitwise equal outputs and grads."""
    _, pm, tree, x = setup(ARCHS[0], capacity_factor=0.5)
    p = to_torch(tree)
    runs = []
    for _ in range(2):
        tx = torch.tensor(x, requires_grad=True)
        y = pmoe.moe_apply(p, tx, pm)
        runs.append((y.detach(), torch.autograd.grad(y.square().sum(), tx)[0]))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    xt = torch.tensor(x).reshape(B * S, -1)
    _, ids, _, _ = pmoe._route(p["router"], xt, pm)
    disp, eid, pos_c, keep = pmoe._pack(xt, ids, pm.num_experts, 8)
    for e in range(pm.num_experts):  # each expert's kept routes fill its slots in token order
        rows = (eid == e) & keep
        assert torch.equal(pos_c[rows], torch.arange(int(rows.sum())))
        assert torch.equal(disp[e, :int(rows.sum())], xt.repeat_interleave(pm.top_k, 0)[rows])
