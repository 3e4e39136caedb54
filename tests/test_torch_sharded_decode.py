"""Sharded decode and scoring (``Engine(mesh=, step_shardings=)``,
``Engine.plan_scoring(in_shardings=)``) held against the reference's
unsharded engine.

Four gloo ranks on the CPU, ``{data: 2, model: 2}`` (one spawn,
``tests/torch_dist_workers.py`` case ``sharded_decode``), f32, each family
reduced (granite with its own 1 KV head, which the model axis does not
divide: its caches split their sequence over ``model``) on the same
weights in both (the port's init from a seed, ``weights.params_to_jax``),
the step shardings from ``launch.steps.build_decode_step`` (its
``decode_shardings``):

* every request's greedy tokens equal the reference ``Engine``'s on the
  same weights, prompts (and whisper's frames), token for token, and every
  engine step's (slots, V) logits match within rtol 1e-5, with an
  absolute floor of rtol × the step's largest |logit|; the parameters are
  sharded and every cache leaf keeps its data rank's rows;
* a one-slot engine under ``"ws"`` (weight-stationary decode: the
  residual's features over ``data``, which one slot leaves free) gives the
  reference's tokens and logits under the same limits, its activations'
  partial sums all-reduced over ``data``;
* a one-slot engine (``global_batch`` 1: the long-context layout) splits
  its caches' sequence over ``data`` and gives the reference's tokens;
* ``plan_scoring(in_shardings=)`` is bitwise ``plan_function(mesh=,
  in_shardings=, objective="wallclock")`` called directly, and within rtol
  1e-6 of the reference's unsharded function;
* ``launch.steps.decode_shardings`` gives the reference ``build_decode_step``'s
  input shardings, and ``logits_sharding`` its logits', for every config and
  decode cell on the production mesh (one process, no devices).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import SHAPES as RSHAPES  # noqa: E402
from repro.configs import get_config as rget_config  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.configs import reduced as rreduced  # noqa: E402
from repro.models import build_model as rbuild_model  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
from repro_torch.configs import ARCH_IDS as ALL_ARCHS  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.steps import decode_shardings, logits_sharding  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.weights import _stacked_key, params_from_jax, params_to_jax  # noqa: E402
from torch_dist_workers import spawn  # noqa: E402

ARCHS = ["stablelm-3b", "granite-moe-3b-a800m", "zamba2-2.7b", "xlstm-1.3b", "whisper-small"]
WORLD, SLOTS, MAX_SEQ, NEW = 4, 4, 16, 4
PROMPTS = [[5, 9, 2], [17, 3, 8, 11, 4], [7, 1], [30, 6, 6, 2, 9, 12, 3], [4, 4, 4, 8],
           [2, 250, 3, 19, 5, 1]]
RTOL = 1e-5


def _rconfig(arch):
    return dataclasses.replace(rreduced(rget_config(arch)), dtype="float32")


def _reference(arch, tree, n_slots, prompts, frames=None):
    """The reference engine's tokens per request and logits per step."""
    model = rbuild_model(_rconfig(arch))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    eng = REngine(model, params, max_slots=n_slots, max_seq=MAX_SEQ,
                  frames=None if frames is None else jnp.asarray(frames))
    logits, step = [], eng._step

    def recorded(*args):
        res = step(*args)
        logits.append(np.asarray(res[0][:, -1, :]))
        return res

    eng._step = recorded
    for prompt in prompts:
        eng.submit(prompt, max_new_tokens=NEW)
    done = eng.run()
    tokens = [t for q in sorted(done, key=lambda q: q.uid) for t in [q.uid, *q.output, -1]]
    return np.array(tokens), np.stack(logits)


def _close(got, want, rtol, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def _mlp(params, x):
    h = x
    for w in params:
        h = jnp.tanh(h @ w)
    return jnp.sum(h * h)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    rng = np.random.default_rng(0)
    trees, inp = {}, {}
    for i, arch in enumerate(ARCHS):
        # the port's init from seed i, in the reference's tree (the
        # reference's own init takes seconds a family in eager JAX)
        cfg = _rconfig(arch)
        pcfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                                   n_kv_heads=cfg.n_kv_heads)
        trees[arch] = params_to_jax(build_model(
            pcfg, device="cpu", generator=torch.Generator().manual_seed(i)).state_dict())
        inp.update({f"{arch}:p:{k}": v.numpy() for k, v in params_from_jax(trees[arch]).items()})
        if cfg.encoder_decoder:
            inp[f"{arch}:frames"] = rng.standard_normal(
                (SLOTS, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    width = max(len(p) for p in PROMPTS)
    inp.update(archs=np.array(ARCHS), slots=np.array(SLOTS), max_seq=np.array(MAX_SEQ),
               new_tokens=np.array(NEW),
               prompts=np.array([p + [-1] * (width - len(p)) for p in PROMPTS]))
    for i in range(3):
        inp[f"w{i}"] = (0.4 * rng.standard_normal((8, 8))).astype(np.float32)
    inp["x"] = rng.standard_normal((4, 8)).astype(np.float32)
    refs = {}

    def references():  # the reference engines run while the ranks do
        for arch in ARCHS:
            refs[arch] = _reference(arch, trees[arch], SLOTS, PROMPTS, inp.get(f"{arch}:frames"))
        refs["long"] = _reference("stablelm-3b", trees["stablelm-3b"], 1, PROMPTS[:2])

    ranks = spawn("sharded_decode", WORLD, tmp_path_factory.mktemp("sharded_decode"), inp,
                  meanwhile=references)
    return refs, inp, ranks


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_engine_gives_the_references_tokens_and_logits(four_ranks, arch):
    refs, _, ranks = four_ranks
    tokens, logits = refs[arch]
    for r in ranks:
        assert r[f"{arch}:tokens"].tolist() == tokens.tolist()
        assert r[f"{arch}:logits"].shape == logits.shape
        for i, (got, want) in enumerate(zip(r[f"{arch}:logits"], logits)):
            _close(got, want, RTOL, f"{arch} step {i}")
        assert int(r[f"{arch}:params_sharded"]) > 0
        assert bool(r[f"{arch}:cache_rows_split"])


def test_one_slot_engine_splits_the_sequence_over_data(four_ranks):
    refs, _, ranks = four_ranks
    tokens, logits = refs["long"]
    for r in ranks:
        assert bool(r["long:cache_seq_split"])
        assert r["long:tokens"].tolist() == tokens.tolist()
        for i, (got, want) in enumerate(zip(r["long:logits"], logits)):
            _close(got, want, RTOL, f"long step {i}")


def test_weight_stationary_engine_gives_the_references_logits(four_ranks):
    refs, _, ranks = four_ranks
    tokens, logits = refs["long"]
    for r in ranks:
        assert str(r["ws:rules_model"]) == "data"
        assert r["ws:tokens"].tolist() == tokens.tolist()
        for i, (got, want) in enumerate(zip(r["ws:logits"], logits)):
            _close(got, want, RTOL, f"ws step {i}")
        # the features' partial sums: more all-reduces over data than the
        # long-context engine's softmax reductions alone
        assert int(r["ws:comm:data:all_reduce:calls"]) > int(
            r.get("long:comm:data:all_reduce:calls", 0))


def test_plan_scoring_is_plan_functions_sharded_twin(four_ranks):
    _, inp, ranks = four_ranks
    params = [jnp.asarray(inp[f"w{i}"]) for i in range(3)]
    loss, grads = jax.value_and_grad(_mlp)(params, jnp.asarray(inp["x"]))
    for r in ranks:
        assert bool(r["scoring_bitwise"])
        _close(r["scoring_loss"], loss, 1e-6, "loss")
        for i, g in enumerate(grads):
            _close(r[f"scoring_g{i}"], g, 1e-6, f"g{i}")


class _Mesh(AbstractMesh):
    """An abstract mesh with the ``devices`` shape the reference reads."""

    @property
    def devices(self):
        return np.empty(self.axis_sizes, dtype=object)


def _canon(spec):
    out = []
    for e in tuple(spec):
        if isinstance(e, (tuple, list)):
            e = None if not e else (e[0] if len(e) == 1 else tuple(e))
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _ref_leaves(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp): _canon(v.spec)
            for kp, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_shardings_are_the_reference_decode_steps(arch, shape_name):
    """``decode_shardings`` on ``{data: 16, model: 16}`` against the reference
    ``build_decode_step``'s ``in_shardings`` (built on an abstract mesh: no
    device), spec for spec: each parameter (the port's names, a stacked
    leaf's spec without its unit axis; whisper's layers, which the
    reference's rule does not read as stacked, by the per-layer rule),
    the tokens, each cache leaf, the positions; and ``logits_sharding``
    against its logits' sharding."""
    sizes = {"data": 16, "model": 16}
    rmesh = _Mesh(tuple(sizes.values()), tuple(sizes))
    cfg, shape = get_config(arch), SHAPES[shape_name]
    _, (r_params, r_caches, r_tokens, r_positions), (r_logits, _), _ = \
        rsteps.build_decode_step(rget_config(arch), RSHAPES[shape_name], rmesh)
    params, tokens, caches, positions = decode_shardings(cfg, shape, sizes)
    want = _ref_leaves(r_params)
    per_layer = specs.param_shardings(cfg, sizes, dict(specs._meta_model(cfg).named_parameters()))
    for name, spec in params.items():
        top = _stacked_key(name)
        if top in ("encoder", "decoder"):
            # the reference's rule reads whisper's stacks as unstacked
            # (splitting the layer axis or d_model): the per-layer rule
            assert spec == per_layer[name], name
        elif top:
            idx, rest = name[len(top) + 1:].split(".", 1)
            ref = want[f"{top}/{rest.replace('.', '/')}"]
            assert _canon((None, *spec)) == ref, name
        else:
            assert _canon(spec) == want[name.replace(".", "/")], name
    assert _canon(tokens) == _canon(r_tokens.spec)
    assert _canon(positions) == _canon(r_positions.spec)
    got = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                got[prefix + k] = _canon(v)

    walk(caches)
    assert got == _ref_leaves(r_caches)
    assert _canon(logits_sharding(cfg, shape.global_batch, sizes)) == _canon(r_logits.spec)
