"""The port's xLSTM family (``repro_torch.models.ssm`` mLSTM/sLSTM, the
``MLSTM``/``SLSTM`` blocks, reduced xlstm-1.3b) against the reference.

Numpy inputs from a seed go through the reference's jnp functions and
their ports: ``linear_scan`` (the doubling scan standing in for
``jax.lax.associative_scan``) at S = 100, not a power of two, with forget
gates near 0, near 1 and drawn from the sLSTM's own range, against the
reference's scan and an f64 loop; ``slstm_apply``/``mlstm_apply`` and their
grads, their steps and states; the whole LM on the reference's weights
(``weights.params_from_jax``): the loss and grads in f32, the loss in bf16,
three ``decode_step``s with every cache leaf, teacher forcing (the
reference's test), the engine's tokens, ``plan_function`` bitwise in the
plan's order, and both launchers on the CPU.  f32 to 1e-5, bf16 to 2e-2,
each absolute limit relative to the tensor's largest value (``close``);
the scan's sums run in another association order than JAX's, so they
agree to f32 rounding, not bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as rssm  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core import PlanCache, Planner  # noqa: E402
from repro_torch.core.lowering import TracedCarrier, vanilla_traced_value_and_grad  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import ssm as pssm  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402
from repro_torch.train import functional_loss  # noqa: E402
from repro_torch.weights import params_to_jax  # noqa: E402
from test_torch_families import (  # noqa: E402
    BATCH, assert_trees_close, batch_of, close, configs, setup)

ARCH = "xlstm-1.3b"
S_SCAN = 100  # not a power of two
N_LAYERS = 4  # 2 units of 1 mLSTM + 1 sLSTM block


def _combine(a, b):  # the reference's sLSTM combine
    return (a[0] * b[0], a[1] * b[0] + b[1])


@pytest.mark.parametrize("regime", ["near_zero", "near_one", "slstm_range"])
def test_linear_scan_matches_the_associative_scan(regime):
    r = np.random.default_rng({"near_zero": 1, "near_one": 2, "slstm_range": 3}[regime])
    shape = (2, S_SCAN, 5)
    if regime == "near_zero":
        f = r.uniform(0.0, 1e-3, shape)
    elif regime == "near_one":
        f = 1.0 - r.uniform(0.0, 1e-3, shape)
    else:  # sigmoid(x + 1), the sLSTM forget gate: ~0.73, a product of 1e-140 by S = 1024
        f = 1.0 / (1.0 + np.exp(-(r.standard_normal(shape) + 1.0)))
    u = r.standard_normal(shape)
    f32, u32 = f.astype(np.float32), u.astype(np.float32)
    _, want = jax.lax.associative_scan(_combine, (jnp.asarray(f32), jnp.asarray(u32)), axis=1)
    got = pssm.linear_scan(torch.tensor(f32), torch.tensor(u32))
    close(got, want, what=f"scan, f {regime}")
    c, exact = np.zeros((2, 5)), []
    for t in range(S_SCAN):  # the recurrence itself, in f64
        c = f[:, t] * c + u[:, t]
        exact.append(c)
    close(got, np.stack(exact, 1), what=f"scan against the f64 loop, f {regime}")


def test_linear_scan_with_an_underflowing_gate_product():
    """The forget-gate product over 1024 steps of sigmoid(1) is ~1e-140,
    zero in f32; the scan divides by nothing, so it stays exact."""
    f = torch.full((1, 1024, 3), float(1 / (1 + np.exp(-1.0))))
    u = torch.ones(1, 1024, 3)
    got = pssm.linear_scan(f, u)
    fixed_point = 1.0 / (1.0 - f[0, 0, 0].item())  # c = f c + 1
    assert torch.isfinite(got).all()
    close(got[:, -1], np.full((1, 3), fixed_point, np.float32), what="fixed point")


def xlstm_params(kind, seed=0):
    rcfg, pcfg = configs(ARCH)
    key = jax.random.PRNGKey(seed)
    tree = (rssm.mlstm_init(key, rcfg.d_model, rcfg.n_heads) if kind == "mlstm"
            else rssm.slstm_init(key, rcfg.d_model))
    return rcfg, pcfg, jax.tree_util.tree_map(np.asarray, tree)


def to_torch(tree, grad=False):
    return {k: to_torch(v, grad) if isinstance(v, dict)
            else torch.tensor(v, requires_grad=grad) for k, v in tree.items()}


def _apply(kind, lib, p, x, cfg):
    if kind == "mlstm":
        return lib.mlstm_apply(p, x, cfg.n_heads, cfg.ssm.chunk)
    return lib.slstm_apply(p, x)


@pytest.mark.parametrize("kind,S", [("mlstm", 8), ("mlstm", 32), ("slstm", 32),
                                    ("slstm", S_SCAN)])
def test_block_apply_and_grads_match_reference(kind, S):
    """mLSTM at one chunk and four (chunk 8); sLSTM at 32 and at 100."""
    rcfg, pcfg, tree = xlstm_params(kind)
    x = np.random.default_rng(S).standard_normal((BATCH, S, rcfg.d_model)).astype(np.float32)
    cot = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def rfn(p, xx):
        y = _apply(kind, rssm, p, xx, rcfg)
        return jnp.sum(y * cot), y

    (_, ry), (rgp, rgx) = jax.value_and_grad(rfn, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    p = to_torch(tree, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    py = _apply(kind, pssm, p, tx, pcfg)
    leaves = jax.tree_util.tree_leaves(p)
    pgrads = torch.autograd.grad((py * torch.tensor(cot)).sum(), [*leaves, tx])
    close(py, ry, what="y")
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(rgp)]
    for name, g, w in zip(paths + ["x"], pgrads, jax.tree_util.tree_leaves(rgp) + [rgx]):
        close(g, w, what=f"grad {name}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_apply_bf16_matches_reference(kind):
    rcfg, pcfg, tree = xlstm_params(kind, seed=2)
    x = np.random.default_rng(3).standard_normal((BATCH, 16, rcfg.d_model)).astype(np.float32)
    want = _apply(kind, rssm, jax.tree_util.tree_map(jnp.asarray, tree),
                  jnp.asarray(x, jnp.bfloat16), rcfg)
    got = _apply(kind, pssm, to_torch(tree), torch.tensor(x).bfloat16(), pcfg)
    assert got.dtype == torch.bfloat16
    close(got, want.astype(jnp.float32), "bfloat16", "y")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_step_matches_reference_and_the_full_sequence(kind):
    """Three steps from random states against the reference (outputs and
    states); steps from the zero state reproduce the full-sequence apply."""
    rcfg, pcfg, tree = xlstm_params(kind, seed=1)
    d, H = rcfg.d_model, rcfg.n_heads
    r = np.random.default_rng(7)
    init = (rssm.mlstm_init_state(BATCH, d, H) if kind == "mlstm"
            else rssm.slstm_init_state(BATCH, d))
    rstate = {k: jnp.asarray(r.random(v.shape).astype(np.float32)) for k, v in init.items()}
    pstate = {k: torch.tensor(np.asarray(v)) for k, v in rstate.items()}

    def step(lib, p, x, state, cfg):
        if kind == "mlstm":
            return lib.mlstm_step(p, x, state, cfg.n_heads)
        return lib.slstm_step(p, x, state)

    rp, pp = jax.tree_util.tree_map(jnp.asarray, tree), to_torch(tree)
    for t in range(3):
        x = r.standard_normal((BATCH, 1, d)).astype(np.float32)
        ry, rstate = step(rssm, rp, jnp.asarray(x), rstate, rcfg)
        py, pstate = step(pssm, pp, torch.tensor(x), pstate, pcfg)
        close(py, ry, what=f"y step {t}")
        for k in rstate:
            close(pstate[k], rstate[k], what=f"{k} step {t}")

    S = 16
    x = torch.tensor(r.standard_normal((1, S, d)).astype(np.float32))
    full = _apply(kind, pssm, pp, x, pcfg)
    state = (pssm.mlstm_init_state(1, d, H) if kind == "mlstm"
             else pssm.slstm_init_state(1, d))
    assert {k: v.dtype for k, v in state.items()} == {k: torch.float32 for k in init}
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: (1, *v.shape[1:]) for k, v in init.items()}
    steps = []
    for t in range(S):
        y, state = step(pssm, pp, x[:, t:t + 1], state, pcfg)
        steps.append(y)
    close(torch.cat(steps, 1), full.numpy(), what="steps vs full sequence")


# ------------------------------------------------------------------ the LM


def test_params_round_trip_and_block_names():
    _, np_tree, plm = setup(ARCH, n_layers=N_LAYERS)
    back = params_to_jax(plm.state_dict())
    want = jax.tree_util.tree_leaves_with_path(np_tree)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[path].dtype == leaf.dtype and np.array_equal(got[path], leaf), path
    assert plm.pattern == ["mlstm", "slstm"] and plm.n_units == 2
    assert plm.layers[0].block_names == ["b0_mlstm", "b1_slstm"]


def test_f32_loss_and_grads_match_reference():
    rlm, np_tree, plm = setup(ARCH, n_layers=N_LAYERS)
    batch = batch_of(plm.cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    loss, grads = jax.value_and_grad(rlm.loss)(jparams, {k: jnp.asarray(v)
                                                         for k, v in batch.items()})
    ploss = plm.loss({k: torch.tensor(v) for k, v in batch.items()})
    close(ploss, loss, what="loss")
    names = [n for n, _ in plm.named_parameters()]
    pgrads = params_to_jax(dict(zip(names, torch.autograd.grad(ploss, list(plm.parameters())))))
    # rtol 1e-4 on the grads, as tests/test_torch_families.py holds them
    assert_trees_close(pgrads, grads, "grads", rtol=1e-4)


def test_bf16_loss_matches_reference():
    rlm, np_tree, plm = setup(ARCH, "bfloat16", n_layers=N_LAYERS)
    batch = batch_of(plm.cfg, seed=1)
    loss = rlm.loss(jax.tree_util.tree_map(jnp.asarray, np_tree),
                    {k: jnp.asarray(v) for k, v in batch.items()})
    close(plm.loss({k: torch.tensor(v) for k, v in batch.items()}), loss, "bfloat16", "loss")


def test_segment_remat_grads_are_bitwise_unplanned():
    _, _, plm = setup(ARCH, n_layers=N_LAYERS)
    tb = {k: torch.tensor(v) for k, v in batch_of(plm.cfg).items()}
    params = list(plm.parameters())

    def run(sizes, remat):
        loss = plm.loss(tb, segment_sizes=sizes, segment_remat=remat)
        return loss.detach(), torch.autograd.grad(loss, params)

    l0, g0 = run((2,), (False,))
    l1, g1 = run((1, 1), (True, False))
    assert torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_decode_step_matches_reference():
    """Three decode steps, rows at different positions: logits and every
    cache leaf (mLSTM ``C``/``n``, sLSTM ``c``/``n``, f32) against the
    reference's."""
    rlm, np_tree, plm = setup(ARCH, n_layers=N_LAYERS)
    rparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    rcaches, pcaches = rlm.init_caches(BATCH, 16), plm.init_caches(BATCH, 16)
    assert_trees_close(pcaches, rcaches, "init")
    assert all(t.dtype == torch.float32 for c in pcaches.values() for t in c.values())
    toks = np.random.default_rng(7).integers(0, plm.cfg.vocab_size, (3, BATCH, 1))
    start = np.array([0, 5], np.int32)
    for t in range(3):
        rlogits, rcaches = rlm.decode_step(rparams, jnp.asarray(toks[t], jnp.int32),
                                           rcaches, jnp.asarray(start + t))
        plogits, out = plm.decode_step(torch.tensor(toks[t]), pcaches,
                                       torch.tensor(start + t, dtype=torch.int64))
        assert out is pcaches
        close(plogits, rlogits, what=f"logits step {t}")
        assert_trees_close(pcaches, rcaches, f"caches step {t}")


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 6e-2), ("float32", 1e-4)])
def test_decode_matches_forward_teacher_forcing(dtype, tol):
    """``tests/test_models_smoke.py``'s teacher-forcing test for xlstm, at
    its size (2 layers, 8 tokens) and its bf16 limit."""
    _, _, plm = setup(ARCH, dtype, n_layers=2)
    T = 8
    toks = torch.tensor(np.random.default_rng(5).integers(0, plm.cfg.vocab_size, (1, T)))
    with torch.no_grad():
        full = plm(toks)
    caches = plm.init_caches(1, T + 1)
    steps = [plm.decode_step(toks[:, t:t + 1], caches, torch.tensor([t]))[0][:, 0]
             for t in range(T)]
    np.testing.assert_allclose(torch.stack(steps, 1).float().numpy(), full.numpy(),
                               rtol=tol, atol=tol)


def test_engine_matches_reference_and_resets_recurrent_state():
    """Both engines on the same weights and requests in f32, greedy (slots
    reused, one prompt past ``max_seq``): the same tokens; a reused slot's
    mLSTM and sLSTM states start from zero."""
    rlm, np_tree, plm = setup(ARCH, n_layers=N_LAYERS)
    rparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    r = np.random.default_rng(11)
    prompts = [r.integers(1, 256, size=n).tolist() for n in (3, 7, 20, 2, 5)]
    outs = []
    for eng in (REngine(rlm, rparams, max_slots=2, max_seq=16, rng_seed=4),
                Engine(plm, max_slots=2, max_seq=16, rng_seed=4)):
        for prompt in prompts:
            eng.submit(prompt, max_new_tokens=6)
        outs.append([(q.uid, q.output) for q in eng.run()])
    assert outs[1] == outs[0]
    eng = Engine(plm, max_slots=1, max_seq=32)
    for prompt in ([9, 9, 9], [1, 2, 3, 4, 5], [9, 9, 9]):
        eng.submit(prompt, max_new_tokens=5)
    done = sorted(eng.run(), key=lambda q: q.uid)
    assert done[0].output == done[2].output


@pytest.mark.parametrize("backend", ["fx", "interpreter"])
def test_plan_function_is_bitwise_vanilla_in_the_plans_order(backend):
    """At the minimal budget: the loss bitwise plain autograd's; the grads
    bitwise plain autograd's run in the plan's node order (the plan reorders
    the graph, so a tensor read by several nodes sums its grads in another
    order than the trace's, ROADMAP.md §3).  No attention: no flash node."""
    _, _, plm = setup(ARCH, n_layers=2)
    tb = {k: torch.tensor(v) for k, v in batch_of(plm.cfg).items()}
    fn, params = functional_loss(lambda m, b: m.loss(b, (1,), (False,)), plm)
    planned = repro_torch.plan_function(fn, planner=Planner(cache=PlanCache()),
                                        backend=backend)
    lowered = planned.lowered_for(params, tb)
    plan = lowered.plan
    assert set().union(*(s.recompute for s in plan.segments))  # it recomputes
    g = lowered.carrier.to_graph()
    assert not any(v.kind == "flash_attention" for v in g.nodes)
    carrier = TracedCarrier.trace(fn, (params, tb))
    l0, _ = vanilla_traced_value_and_grad(carrier)(params, tb)
    l1, g1 = planned(params, tb)
    l2, g2 = vanilla_traced_value_and_grad(carrier, plan)(params, tb)
    assert torch.equal(l0, l1) and torch.equal(l0, l2)
    assert [k for k in g2 if not torch.equal(g1[k], g2[k])] == []


def test_launchers_run_on_the_cpu():
    out = train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
                      "--seq", "32", "--device", "cpu"])
    assert out["step"] == 2 and all(np.isfinite(out["losses"]))
    served = serve.main(["--arch", ARCH, "--requests", "3", "--slots", "2", "--max-seq",
                         "48", "--new-tokens", "4", "--device", "cpu"])
    assert len(served["completed"]) == 3
    assert all(len(q.output) == 4 for q in served["completed"])


def test_full_width_unit_on_the_meta_device():
    """The full config's unit: 7 mLSTM blocks and 1 sLSTM block, heads of
    512, and the model's parameter count beside the analytic one."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = get_config(ARCH)
    model = LM(cfg, device="meta", generator=torch.Generator())
    unit = model.layers[0]
    assert model.n_units == 6
    assert unit.block_names == [f"b{i}_mlstm" for i in range(7)] + ["b7_slstm"]
    assert unit.b0_mlstm.mlstm.wq.shape == (2048, 2048)
    assert unit.b0_mlstm.mlstm.w_gates.shape == (2048, 8)
    assert unit.b7_slstm.slstm.w_zifo.shape == (2048, 8192)
    # the analytic count charges each sLSTM block a second norm (2d, not d)
    n = sum(p.numel() for p in model.parameters())
    assert cfg.num_params() == 1_037_404_160 == n + 6 * 2048
