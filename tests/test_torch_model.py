"""The port's dense LM against the reference on the same weights.

Reduced stablelm-3b (4 units, d_model 64): the reference's ``LM.init``
weights go through ``weights.params_from_jax`` into the port; logits, loss
and gradients are compared in f32 (the port runs the flash-attention plain
versions on the CPU, the reference its dense attention), the loss in bf16,
and segment-remat gradients inside the port are bitwise equal to unplanned
ones.
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
from repro.data import DataConfig, SyntheticLM  # noqa: E402
from repro.models.transformer import LM as RLM  # noqa: E402
from repro_torch.configs import get_config as pget_config  # noqa: E402
from repro_torch.configs import reduced as preduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.mesh import REFERENCE_HBM_BYTES  # noqa: E402
from repro_torch.launch.plan import plan_unit_segments  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_jax  # noqa: E402

ARCH = "stablelm-3b"
UNITS, SEQ, BATCH = 4, 64, 2


def configs(dtype):
    r = dataclasses.replace(rreduced(rget_config(ARCH), n_layers=UNITS), dtype=dtype)
    p = dataclasses.replace(preduced(pget_config(ARCH), n_layers=UNITS), dtype=dtype)
    return r, p


def setup(dtype):
    """Reference model + numpy weights, the port model on those weights,
    and one batch from the reference's data pipeline."""
    rcfg, pcfg = configs(dtype)
    rlm = RLM(rcfg)
    np_tree = jax.tree_util.tree_map(np.asarray, rlm.init(jax.random.PRNGKey(0)))
    plm = build_model(pcfg, device="cpu")
    plm.load_state_dict(params_from_jax(np_tree), strict=True)
    batch = SyntheticLM(DataConfig(rcfg.vocab_size, SEQ, BATCH)).batch(0)
    return rlm, np_tree, plm, batch


def torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def test_params_from_jax_round_trips_every_leaf():
    _, np_tree, plm, _ = setup("float32")
    back = params_to_jax(plm.state_dict())
    want = jax.tree_util.tree_leaves_with_path(np_tree)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[path].dtype == leaf.dtype and np.array_equal(got[path], leaf), path


def test_f32_logits_loss_and_grads_match_reference():
    rlm, np_tree, plm, batch = setup("float32")
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    logits = rlm.forward(jparams, jbatch["tokens"])
    loss, grads = jax.value_and_grad(rlm.loss)(jparams, jbatch)

    tb = torch_batch(batch)
    plogits = plm(tb["tokens"])
    np.testing.assert_allclose(plogits.detach().numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-5)
    ploss = plm.loss(tb)
    np.testing.assert_allclose(ploss.item(), float(loss), rtol=1e-4, atol=1e-5)
    names = [n for n, _ in plm.named_parameters()]
    pgrads = torch.autograd.grad(ploss, list(plm.parameters()))
    got = params_to_jax(dict(zip(names, pgrads)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("path", ["kernel", "dense"])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (4, 1)])
def test_attention_matches_reference(H, KV, path):
    """Self-attention with RoPE in f32 against the reference's XLA path on
    the same weights: the port's ``attention`` (flash attention) and, as a
    second path, its projections around ``dense_attention``."""
    from repro.models.attention import attention as rattention
    from repro_torch.models import attention as pattn

    B, S, d, dh = 2, 48, 32, 16
    r = np.random.default_rng(5)
    shapes = {"wq": (d, H * dh), "wk": (d, KV * dh), "wv": (d, KV * dh), "wo": (H * dh, d)}
    p = {k: (r.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
         for k, s in shapes.items()}
    x = r.standard_normal((B, S, d)).astype(np.float32)
    kw = dict(n_heads=H, n_kv_heads=KV, d_head=dh, rope_theta=10000.0)
    want = rattention({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                      backend="xla", **kw)
    tp, tx = {k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x)
    if path == "kernel":
        got = pattn.attention(tp, tx, **kw)
    else:
        q, k, v = pattn.qkv_proj(tp, tx, H, KV, dh, torch.arange(S)[None, :], 10000.0)
        got = pattn.dense_attention(q, k, v).reshape(B, S, H * dh) @ tp["wo"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_bf16_loss_matches_reference():
    rlm, np_tree, plm, batch = setup("bfloat16")
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    loss = rlm.loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    ploss = plm.loss(torch_batch(batch))
    np.testing.assert_allclose(ploss.item(), float(loss), rtol=2e-2, atol=2e-2)


def test_segment_remat_grads_are_bitwise_unplanned():
    _, _, plm, batch = setup("float32")
    pcfg = configs("float32")[1]
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    _, full = plan_unit_segments(pcfg, shape, 1, model_shards=1,
                                 hbm_bytes=REFERENCE_HBM_BYTES)
    sp, res = plan_unit_segments(pcfg, shape, 1, model_shards=1,
                                 budget=0.5 * full.peak_memory,
                                 hbm_bytes=REFERENCE_HBM_BYTES)
    assert res.feasible and any(sp.remat), sp
    tb = torch_batch(batch)
    params = list(plm.parameters())

    def run(sizes, remat):
        loss = plm.loss(tb, segment_sizes=sizes, segment_remat=remat)
        return loss.detach(), torch.autograd.grad(loss, params)

    l0, g0 = run((UNITS,), (False,))
    l1, g1 = run(sp.sizes, sp.remat)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
