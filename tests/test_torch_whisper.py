"""The port's whisper encoder-decoder (``repro_torch.models.whisper``, reduced
whisper-small: 2 encoder and 2 decoder layers, d_model 64, 8 frames)
against the reference.

Numpy inputs from a seed: ``layernorm`` (population variance) and
``gelu_mlp`` (tanh GELU) against the reference's; the model on the
reference's ``WhisperModel.init`` weights moved with
``weights.params_from_jax`` (the stacked ``encoder``/``decoder`` trees
round-trip): ``encode`` and ``decode_train``, the loss and its grads in
f32, the loss in bf16; ``init_caches`` and three ``decode_step``s with
every cache leaf; step-by-step decode against ``decode_train``; the
engine with ``frames`` gives the reference engine's tokens and a reused
slot keeps its cross K/V while its self KV is zeroed; ``plan_function``
on the loss is bitwise plain autograd in the plan's order, on a graph that
is not a chain (the encoder output feeds every decoder layer's cross K and
V); the cross-attention is a flash node; the serving launcher draws frames
and the training launcher refuses the arch.  f32 to 1e-5 (grads rtol
1e-4), bf16 to 2e-2, each absolute limit relative to the tensor's largest
value (``close``).
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
from repro.models import layers as rlayers  # noqa: E402
from repro.models.whisper import WhisperModel as RWhisper  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import PlanCache, Planner  # noqa: E402
from repro_torch.core.lowering import TracedCarrier, vanilla_traced_value_and_grad  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import WhisperModel, build_model, layers  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402
from repro_torch.train import functional_loss  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_jax  # noqa: E402
from test_torch_families import (  # noqa: E402
    BATCH, assert_trees_close, batch_of, close)

ARCH = "whisper-small"
_SETUPS = {}


def setup(dtype="float32"):
    """Reference model, its numpy weights, and the port's model on them."""
    if dtype not in _SETUPS:
        rcfg = dataclasses.replace(rreduced(rget_config(ARCH)), dtype=dtype)
        pcfg = dataclasses.replace(reduced(get_config(ARCH)), dtype=dtype)
        rm = RWhisper(rcfg)
        np_tree = jax.tree_util.tree_map(np.asarray, rm.init(jax.random.PRNGKey(0)))
        pm = build_model(pcfg, device="cpu")
        pm.load_state_dict(params_from_jax(np_tree), strict=True)
        _SETUPS[dtype] = rm, np_tree, pm
    return _SETUPS[dtype]


def frames_of(cfg, batch=BATCH, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend_seq, cfg.d_model)).astype(np.float32)


def whisper_batch(cfg, seed=0):
    return dict(batch_of(cfg, seed), frames=frames_of(cfg, seed=seed + 3))


def jtree(np_tree):
    return jax.tree_util.tree_map(jnp.asarray, np_tree)


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_and_gelu_mlp_match_reference(dtype):
    r = np.random.default_rng(1)
    x = (3.0 * r.standard_normal((2, 5, 64)) + 1.0).astype(np.float32)
    scale, bias = r.standard_normal(64).astype(np.float32), r.standard_normal(64).astype(
        np.float32)
    w_up = (r.standard_normal((64, 128)) / 8).astype(np.float32)
    w_down = (r.standard_normal((128, 64)) / 11).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want_ln = rlayers.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                jnp.asarray(x, jdt))
    got_ln = layers.layernorm(torch.tensor(scale), torch.tensor(bias), torch.tensor(x).to(tdt))
    want_mlp = rlayers.gelu_mlp({"w_up": jnp.asarray(w_up), "w_down": jnp.asarray(w_down)},
                                jnp.asarray(x, jdt))
    got_mlp = layers.gelu_mlp(torch.tensor(w_up), torch.tensor(w_down),
                              torch.tensor(x).to(tdt))
    assert got_ln.dtype == got_mlp.dtype == tdt
    close(got_ln, want_ln.astype(jnp.float32), dtype, "layernorm")
    close(got_mlp, want_mlp.astype(jnp.float32), dtype, "gelu_mlp")


# ------------------------------------------------------------------ model


def test_build_and_params_round_trip_every_leaf():
    _, np_tree, pm = setup()
    assert isinstance(pm, WhisperModel)
    back = params_to_jax(pm.state_dict())
    want = jax.tree_util.tree_leaves_with_path(np_tree)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[path].dtype == leaf.dtype and np.array_equal(got[path], leaf), path
    state = pm.state_dict()
    L = pm.cfg.n_layers
    assert np_tree["encoder"]["attn"]["wq"].shape == (L, *state["encoder.0.attn.wq"].shape)
    assert np_tree["decoder"]["cross_attn"]["wk"].shape == (
        L, *state[f"decoder.{L - 1}.cross_attn.wk"].shape)
    assert state["dec_pos"].shape == np_tree["dec_pos"].shape == (65_536, pm.cfg.d_model)


def test_encode_and_decode_train_match_reference():
    rm, np_tree, pm = setup()
    batch = whisper_batch(pm.cfg)
    p = jtree(np_tree)
    renc = rm.encode(p, jnp.asarray(batch["frames"]))
    rlogits = rm.decode_train(p, jnp.asarray(batch["tokens"]), renc)
    with torch.no_grad():
        penc = pm.encode(torch.tensor(batch["frames"]))
        plogits = pm.decode_train(torch.tensor(batch["tokens"]), penc)
    close(penc, renc, what="encoder output")
    close(plogits, rlogits, what="logits")


def test_f32_loss_and_grads_match_reference():
    rm, np_tree, pm = setup()
    batch = whisper_batch(pm.cfg)
    loss, grads = jax.value_and_grad(rm.loss)(jtree(np_tree),
                                             {k: jnp.asarray(v) for k, v in batch.items()})
    ploss = pm.loss({k: torch.tensor(v) for k, v in batch.items()})
    close(ploss, loss, what="loss")
    names = [n for n, _ in pm.named_parameters()]
    pgrads = params_to_jax(dict(zip(names, torch.autograd.grad(ploss, list(pm.parameters())))))
    assert_trees_close(pgrads, grads, "grads", rtol=1e-4)


def test_bf16_loss_matches_reference():
    rm, np_tree, pm = setup("bfloat16")
    batch = whisper_batch(pm.cfg, seed=1)
    loss = rm.loss(jtree(np_tree), {k: jnp.asarray(v) for k, v in batch.items()})
    close(pm.loss({k: torch.tensor(v) for k, v in batch.items()}), loss, "bfloat16", "loss")


def test_segment_remat_grads_are_bitwise_unplanned():
    """The default segmentation (one segment a layer here, all
    rematerialized) and a plan without remat: the same bits."""
    _, _, pm = setup()
    tb = {k: torch.tensor(v) for k, v in whisper_batch(pm.cfg).items()}
    params = list(pm.parameters())

    def run(*plan):
        loss = pm.loss(tb, *plan)
        return loss.detach(), torch.autograd.grad(loss, params)

    l0, g0 = run((2,), (False,))
    l1, g1 = run()
    l2, g2 = run((1, 1), (True, False))
    assert torch.equal(l0, l1) and torch.equal(l0, l2)
    assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(g0, g1, g2))


def test_init_caches_and_decode_step_match_reference():
    """The cross K/V of the encoded clips and zero self caches, then three
    decode steps, rows at different positions: logits and every cache leaf."""
    rm, np_tree, pm = setup()
    p = jtree(np_tree)
    frames = frames_of(pm.cfg)
    rcaches = rm.init_caches(p, jnp.asarray(frames), 16)
    pcaches = pm.init_caches(torch.tensor(frames), 16)
    assert_trees_close(pcaches, rcaches, "init")
    toks = np.random.default_rng(7).integers(0, pm.cfg.vocab_size, (3, BATCH, 1))
    start = np.array([0, 5], np.int32)
    for t in range(3):
        rlogits, rcaches = rm.decode_step(p, jnp.asarray(toks[t], jnp.int32), rcaches,
                                          jnp.asarray(start + t))
        plogits, out = pm.decode_step(torch.tensor(toks[t]), pcaches,
                                      torch.tensor(start + t, dtype=torch.int64))
        assert out is pcaches
        close(plogits, rlogits, what=f"logits step {t}")
        assert_trees_close(pcaches, rcaches, f"caches step {t}")


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 6e-2), ("float32", 1e-4)])
def test_decode_matches_decode_train(dtype, tol):
    """Step-by-step decode against ``decode_train`` on the same encoder
    output, at the reference teacher-forcing test's size and limits."""
    _, _, pm = setup(dtype)
    T = 8
    toks = torch.tensor(np.random.default_rng(5).integers(0, pm.cfg.vocab_size, (1, T)))
    frames = torch.tensor(frames_of(pm.cfg, batch=1))
    with torch.no_grad():
        full = pm.decode_train(toks, pm.encode(frames))
    caches = pm.init_caches(frames, T + 1)
    steps = [pm.decode_step(toks[:, t:t + 1], caches, torch.tensor([t]))[0][:, 0]
             for t in range(T)]
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------------ engine


def test_engine_with_frames_matches_reference():
    """Both engines on the same weights, frames and requests in f32,
    greedy: 2 slots, 5 requests (slots reused), one prompt past
    ``max_seq``: the same tokens in the same order."""
    rm, np_tree, pm = setup()
    frames = frames_of(pm.cfg, seed=9)
    r = np.random.default_rng(11)
    prompts = [r.integers(1, 256, size=n).tolist() for n in (3, 7, 20, 2, 5)]
    outs = []
    for eng in (REngine(rm, jtree(np_tree), max_slots=2, max_seq=16, rng_seed=4,
                        frames=jnp.asarray(frames)),
                Engine(pm, max_slots=2, max_seq=16, rng_seed=4, frames=frames)):
        for prompt in prompts:
            eng.submit(prompt, max_new_tokens=6)
        outs.append([(q.uid, q.output) for q in eng.run()])
    assert outs[1] == outs[0]


def test_reused_slot_keeps_cross_and_zeroes_self():
    _, _, pm = setup()
    with pytest.raises(ValueError, match="needs `frames`"):
        Engine(pm, max_slots=2, max_seq=16)
    eng = Engine(pm, max_slots=2, max_seq=32, frames=frames_of(pm.cfg))
    cross = {k: t.clone() for k, t in eng.caches["cross"].items()}
    eng.submit([3, 4, 5], max_new_tokens=2)
    eng.submit([6, 7], max_new_tokens=2)
    eng.run()
    self_kv = eng.caches["self"]
    assert all(bool(t[:, s].any()) for t in self_kv.values() for s in (0, 1))
    eng._reset_slot(1)
    assert all(not t[:, 1].any() and bool(t[:, 0].any()) for t in self_kv.values())
    assert all(torch.equal(eng.caches["cross"][k], cross[k]) for k in cross)
    # the same prompt on the same clip, before and after other traffic
    eng = Engine(pm, max_slots=1, max_seq=32, frames=frames_of(pm.cfg, batch=1))
    for prompt in ([9, 9, 9], [1, 2, 3, 4, 5], [9, 9, 9]):
        eng.submit(prompt, max_new_tokens=5)
    done = sorted(eng.run(), key=lambda q: q.uid)
    assert done[0].output == done[2].output


# --------------------------------------------------------------- front door


def _traced_loss():
    _, _, pm = setup()
    tb = {k: torch.tensor(v) for k, v in whisper_batch(pm.cfg).items()}
    n = pm.n_units
    fn, params = functional_loss(lambda m, b: m.loss(b, (n,), (False,)), pm)
    return pm, fn, params, tb


@pytest.mark.parametrize("backend", ["fx", "interpreter"])
def test_plan_function_is_bitwise_vanilla_in_the_plans_order(backend):
    """At the minimal budget the plan recomputes; the loss is bitwise plain
    autograd's, and the grads bitwise plain autograd's run in the plan's
    node order (the graph is not a chain, ROADMAP.md §3)."""
    _, fn, params, tb = _traced_loss()
    planned = repro_torch.plan_function(fn, planner=Planner(cache=PlanCache()),
                                        backend=backend)
    plan = planned.lowered_for(params, tb).plan
    assert set().union(*(s.recompute for s in plan.segments))
    carrier = TracedCarrier.trace(fn, (params, tb))
    l0, _ = vanilla_traced_value_and_grad(carrier)(params, tb)
    l1, g1 = planned(params, tb)
    l2, g2 = vanilla_traced_value_and_grad(carrier, plan)(params, tb)
    assert torch.equal(l0, l1) and torch.equal(l0, l2)
    assert [k for k in g2 if not torch.equal(g1[k], g2[k])] == []


def test_trace_is_non_chain_with_flash_cross_attention():
    """Three flash nodes a layer pair (encoder, decoder self, decoder
    cross); the encoder output is read by each decoder layer's cross K and
    V projections (2L readers), so the graph is not a chain."""
    pm, fn, params, tb = _traced_loss()
    g = TracedCarrier.trace(fn, (params, tb)).to_graph()
    L = pm.cfg.n_layers
    flash = [v.idx for v in g.nodes if v.kind == "flash_attention"]
    assert len(flash) == 3 * L
    matmuls_reading = [sum(g.nodes[w].kind == "dot_general" for w in g.succ[v])
                       for v in range(g.n)]
    # self-attention inputs feed 3 projections (q, k, v), the others 1
    (enc_out,) = [v for v in range(g.n) if matmuls_reading[v] == 2 * L]
    assert max(matmuls_reading) == 2 * L
    assert min(g.succ[enc_out]) > max(flash[:L])  # read after the whole encoder


# --------------------------------------------------------------- launchers


def test_serve_launcher_draws_frames_and_train_launcher_refuses():
    served = serve.main(["--arch", ARCH, "--requests", "3", "--slots", "2", "--max-seq",
                         "48", "--new-tokens", "4", "--device", "cpu"])
    eng = served["engine"]
    assert eng.caches["cross"]["xk"].shape[:3] == (eng.model.cfg.n_layers, 2,
                                                   eng.model.cfg.frontend_seq)
    assert len(served["completed"]) == 3
    assert all(len(q.output) == 4 for q in served["completed"])
    with pytest.raises(ValueError, match="no frames"):
        train.main(["--arch", ARCH, "--reduced", "--steps", "1", "--device", "cpu"])
