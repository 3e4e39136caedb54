"""The port's serving path against the reference: KV-cache decode, the slot
engine and the serving launcher.

Reduced configs on the CPU, the reference's ``LM.init`` weights moved into
the port with ``weights.params_from_jax``, caches moved as numpy.  In f32
``decode_attention`` (outputs and both caches, also at a position past the
cache's end, where the write is clamped to its last row) and three steps of
``LM.decode_step`` (logits and caches) agree with the reference to 1e-5;
the port's ``Engine`` gives the reference ``Engine``'s tokens, token for
token, greedy and sampled.  ``tests/test_models_smoke.py``'s decode tests,
``tests/test_data_serving.py``'s engine tests and
``tests/test_system.py::test_train_then_serve`` are restated for the port.
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
from repro.launch import serve as rserve  # noqa: E402
from repro.models.attention import decode_attention as rdecode_attention  # noqa: E402
from repro.models import build_model as rbuild_model  # noqa: E402
from repro.models.transformer import LM as RLM  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, reduced  # noqa: E402
from repro_torch.core import PlanCache, Planner, get_default_planner  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import REFERENCE_HBM_BYTES  # noqa: E402
from repro_torch.launch.plan import plan_unit_segments  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import decode_attention  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

RTOL = ATOL = 1e-5  # f32 against the reference
DENSE = ["stablelm-3b", "qwen2.5-14b"]  # qwen: GQA 4 heads over 1 kv head, qkv bias
B = 2


def configs(arch, dtype="float32", n_layers=3):
    r = dataclasses.replace(rreduced(rget_config(arch), n_layers=n_layers), dtype=dtype)
    p = dataclasses.replace(reduced(get_config(arch), n_layers=n_layers), dtype=dtype)
    return r, p


def setup(arch, dtype="float32", n_layers=3, seed=0):
    """Reference model and params, and the port's model on those weights."""
    rcfg, pcfg = configs(arch, dtype, n_layers)
    rlm = RLM(rcfg)
    np_tree = jax.tree_util.tree_map(np.asarray, rlm.init(jax.random.PRNGKey(seed)))
    plm = build_model(pcfg, device="cpu")
    plm.load_state_dict(params_from_jax(np_tree), strict=True)
    return rlm, jax.tree_util.tree_map(jnp.asarray, np_tree), plm


def to_numpy(tree):
    return {k: to_numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    got, want = to_numpy(got), to_numpy(want)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_close(got[k], want[k], rtol, atol)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


# ------------------------------------------------------------------ decode


@pytest.mark.parametrize("positions", [[0, 5, 11], [12, 19, 3]],
                         ids=["inside", "past_end"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_attention_matches_reference(arch, positions):
    """One decode step on random caches, in f32.  With S 12, positions 12
    and 19 lie past the cache's end: both packages write them to row 11,
    while RoPE and the mask see the position itself."""
    cfg = reduced(get_config(arch))
    H, KV, D, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    Bq, S = len(positions), 12
    r = np.random.default_rng(3)
    shapes = {"wq": (d, H * D), "wk": (d, KV * D), "wv": (d, KV * D), "wo": (H * D, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(H * D,), bk=(KV * D,), bv=(KV * D,))
    p = {k: (r.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
         for k, s in shapes.items()}
    x = r.standard_normal((Bq, 1, d)).astype(np.float32)
    ck = r.standard_normal((Bq, S, KV, D)).astype(np.float32)
    cv = r.standard_normal((Bq, S, KV, D)).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    kw = dict(n_heads=H, n_kv_heads=KV, d_head=D, rope_theta=cfg.rope_theta)

    want = rdecode_attention({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                             jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos), **kw)
    tk, tv = torch.tensor(ck), torch.tensor(cv)
    got = decode_attention({k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x),
                           tk, tv, torch.tensor(pos, dtype=torch.int64), **kw)
    assert got[1] is tk and got[2] is tv  # written in place
    for name, g, w in zip(("out", "cache_k", "cache_v"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    written = np.minimum(pos, S - 1)
    assert not np.allclose(tk.numpy()[np.arange(Bq), written], ck[np.arange(Bq), written])


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_reference(arch):
    """Three decode steps of reduced 3-unit models in f32, rows at different
    positions: logits and caches within 1e-5 of the reference's."""
    rlm, rparams, plm = setup(arch)
    S, start = 16, np.array([0, 5], np.int32)
    rcaches = rlm.init_caches(B, S)
    pcaches = plm.init_caches(B, S)
    assert_trees_close(pcaches, rcaches, 0, 0)
    toks = np.random.default_rng(7).integers(0, plm.cfg.vocab_size, (3, B, 1))
    for t in range(3):
        pos = start + t
        rlogits, rcaches = rlm.decode_step(rparams, jnp.asarray(toks[t], jnp.int32),
                                           rcaches, jnp.asarray(pos))
        plogits, out_caches = plm.decode_step(torch.tensor(toks[t]), pcaches,
                                              torch.tensor(pos, dtype=torch.int64))
        assert out_caches is pcaches
        assert plogits.shape == (B, 1, plm.cfg.vocab_size) and plogits.dtype == torch.float32
        np.testing.assert_allclose(plogits.numpy(), np.asarray(rlogits), rtol=RTOL, atol=ATOL)
        assert_trees_close(pcaches, rcaches)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step_smoke(arch):
    """``tests/test_models_smoke.py::test_decode_step_smoke`` for the port:
    every arch decodes one step with finite logits and the reference's
    cache tree (whisper's from frames through its encoder)."""
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu")
    rcfg = rreduced(rget_config(arch))
    if cfg.encoder_decoder:
        rmodel = rbuild_model(rcfg)
        frames = np.zeros((B, cfg.frontend_seq, cfg.d_model), np.float32)
        caches = model.init_caches(torch.tensor(frames), 32)
        want = jax.eval_shape(lambda: rmodel.init_caches(
            rmodel.init(jax.random.PRNGKey(0)), jnp.asarray(frames), 32))
    else:
        caches = model.init_caches(B, 32)
        want = jax.eval_shape(lambda: RLM(rcfg).init_caches(B, 32))
    spec = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), caches)
    assert spec == jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), want)
    logits, new_caches = model.decode_step(torch.zeros(B, 1, dtype=torch.int64), caches,
                                           torch.zeros(B, dtype=torch.int64))
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert new_caches is caches


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 6e-2), ("float32", 1e-4)])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward_teacher_forcing(arch, dtype, tol):
    """Step-by-step decode reproduces the full-sequence forward (the plain
    flash-attention version on the CPU): 6e-2 in bf16, as the reference's
    test, and 1e-4 in f32."""
    _, _, plm = setup(arch, dtype, n_layers=2)
    T = 8
    toks = torch.tensor(np.random.default_rng(5).integers(0, plm.cfg.vocab_size, (1, T)))
    with torch.no_grad():
        full = plm(toks)
    caches = plm.init_caches(1, T + 1)
    steps = [plm.decode_step(toks[:, t:t + 1], caches, torch.tensor([t]))[0][:, 0]
             for t in range(T)]
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def engine_setup():
    return setup("stablelm-3b", n_layers=2)


def test_all_requests_complete(engine_setup):
    _, _, model = engine_setup
    eng = Engine(model, max_slots=3, max_seq=64)
    uids = [eng.submit([1, 2, 3], max_new_tokens=4) for _ in range(7)]
    done = eng.run()
    assert sorted(r.uid for r in done) == sorted(uids)
    assert all(len(r.output) == 4 and r.done for r in done)
    assert len(eng.step_seconds) == 18  # 3 waves of 2 prefill + 4 sampling steps


def test_greedy_decode_deterministic(engine_setup):
    _, _, model = engine_setup
    outs = []
    for _ in range(2):
        eng = Engine(model, max_slots=2, max_seq=64)
        eng.submit([5, 6, 7, 8], max_new_tokens=6)
        outs.append(eng.run()[0].output)
    assert outs[0] == outs[1]


def test_slot_reuse_isolated(engine_setup):
    """The same prompt served before and after other traffic gives the same
    greedy output: the slot's caches are zeroed on reuse."""
    _, _, model = engine_setup
    eng = Engine(model, max_slots=1, max_seq=64)
    eng.submit([9, 9, 9], max_new_tokens=5)
    eng.submit([1, 2, 3, 4, 5], max_new_tokens=5)
    eng.submit([9, 9, 9], max_new_tokens=5)
    done = sorted(eng.run(), key=lambda r: r.uid)
    assert done[0].output == done[2].output


def test_eos_terminates(engine_setup):
    _, _, model = engine_setup
    eng = Engine(model, max_slots=1, max_seq=64)
    eng.submit([1, 2], max_new_tokens=8)
    first = eng.run()[0].output[0]
    eng2 = Engine(model, max_slots=1, max_seq=64)
    eng2.submit([1, 2], max_new_tokens=8, eos_id=first)
    assert eng2.run()[0].output == [first]


def test_engine_prewarm_makes_first_planned_step_warm(engine_setup):
    """Boot-time pre-warm: the first planned call at an expected signature
    re-runs no DP, and a second pre-warm reports it warm."""
    _, _, model = engine_setup
    shape = SHAPES["decode_32k"]
    planner = get_default_planner()
    eng = Engine(model, max_slots=1, max_seq=32, prewarm_shapes=[shape])
    before = planner.cache.stats()["misses"]
    sp, res = plan_unit_segments(model.cfg, shape, dp_shards=1, model_shards=1,
                                 budget=1e18, hbm_bytes=REFERENCE_HBM_BYTES)
    assert res.feasible
    assert planner.cache.stats()["misses"] == before
    assert eng.prewarm_plans([shape]) == {shape.name: True}


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_matches_reference(engine_setup, temperature):
    """The port's and the reference's engines on the same weights and
    requests in f32 (3 slots, 7 requests, one prompt of 20 tokens against
    ``max_seq`` 16, one eos): the same tokens, token for token, completed in
    the same order."""
    rlm, rparams, model = engine_setup
    r = np.random.default_rng(11)
    prompts = [r.integers(1, 256, size=n).tolist() for n in (3, 7, 20, 2, 5, 4, 9)]
    outs = []
    for eng in (REngine(rlm, rparams, max_slots=3, max_seq=16, rng_seed=4),
                Engine(model, max_slots=3, max_seq=16, rng_seed=4)):
        for i, prompt in enumerate(prompts):
            eng.submit(prompt, max_new_tokens=6, temperature=temperature,
                       eos_id=17 if i == 4 else None)
        outs.append([(q.uid, q.output) for q in eng.run()])
    want, got = outs
    assert got == want
    assert dict(got)[2] and len(dict(got)[2]) == 1  # the long prompt filled its cache


def test_engine_raises_for_what_is_not_ported(engine_setup):
    """Sharded decode is ported (``tests/test_torch_sharded_decode.py``);
    what it cannot serve on raises ``ValueError``, as ``Trainer(mesh=)``
    does: an ``{axis: size}`` dict (it prices bytes, it holds no ranks),
    and shardings without a mesh."""
    _, _, model = engine_setup
    for kw, match in ((dict(mesh={"data": 2, "model": 2}), "DeviceMesh"),
                      (dict(step_shardings=(None, None, None, None)), "needs mesh=")):
        with pytest.raises(ValueError, match=match):
            Engine(model, max_slots=1, max_seq=8, **kw)


def test_engine_loads_a_given_state_dict(engine_setup):
    """``params`` is a state dict loaded into the model: an engine given
    another model's weights serves that model's tokens."""
    _, _, model = engine_setup
    other = build_model(model.cfg, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    outs = []
    for m, params in ((model, None), (other, model.state_dict())):
        eng = Engine(m, params, max_slots=1, max_seq=32)
        eng.submit([4, 5, 6], max_new_tokens=5)
        outs.append(eng.run()[0].output)
    assert outs[0] == outs[1]


def test_plan_scoring_gives_plan_functions_twin(engine_setup):
    """``plan_scoring`` is ``plan_function`` with the wall-clock objective:
    the same loss and grads as a twin planned directly, with the chosen
    plan's replayed seconds on its report."""
    _, _, model = engine_setup
    eng = Engine(model, max_slots=1, max_seq=8)
    rng = np.random.default_rng(0)
    params = [torch.tensor(rng.standard_normal((8, 8)).astype(np.float32) * 0.3)
              for _ in range(4)]
    x = torch.tensor(rng.standard_normal((4, 8)).astype(np.float32))

    def fn(params, x):
        h = x
        for w in params:
            h = torch.tanh(h @ w)
        return (h * h).sum()

    twin = eng.plan_scoring(fn, None, planner=Planner(cache=PlanCache()),
                            method="exact_dp")
    assert isinstance(twin, repro_torch.PlannedFunction)
    report = twin.lowered_for(params, x).report
    assert report.replayed_seconds is not None and report.replayed_seconds > 0.0
    direct = repro_torch.plan_function(fn, None, planner=Planner(cache=PlanCache()),
                                       method="exact_dp", objective="wallclock")
    (l0, g0), (l1, g1) = twin(params, x), direct(params, x)
    assert torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert direct.lowered_for(params, x).report.replayed_seconds == report.replayed_seconds
    # without a mesh the engine's twin is the meshless one; on a mesh
    # (tests/test_torch_sharded_decode.py) it is plan_function(mesh=, in_shardings=)'s
    assert eng.mesh is None


def test_train_then_serve():
    """``tests/test_system.py::test_train_then_serve`` with the port's Trainer."""
    cfg = reduced(get_config("stablelm-3b"))
    model = build_model(cfg, device="cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4))
    tr = Trainer(lambda m, b: m.loss(b), model, TrainConfig(
        total_steps=5, log_every=0,
        optimizer=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5)), device="cpu")
    tr.run(iter(data))
    eng = Engine(tr.model, max_slots=2, max_seq=64)
    eng.submit([1, 2, 3], max_new_tokens=4)
    done = eng.run()
    assert len(done) == 1 and len(done[0].output) == 4


# -------------------------------------------------------------- launcher


def test_serve_launcher_on_the_cpu():
    """The launcher at reduced size submits the reference launcher's
    prompts and completes every request with its tokens."""
    argv = ["--arch", "stablelm-3b", "--requests", "4", "--slots", "2", "--max-seq", "64",
            "--new-tokens", "8"]
    out = serve.main(argv + ["--device", "cpu"])
    done = sorted(out["completed"], key=lambda q: q.uid)
    want = sorted(rserve.main(argv), key=lambda q: q.uid)
    assert [q.prompt for q in done] == [q.prompt for q in want]
    assert all(len(q.output) == 8 for q in done)
    assert out["steps"] == len(out["step_seconds"]) > 0 and out["seconds"] > 0


def test_serve_launcher_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1"])
