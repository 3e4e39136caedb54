"""The int8 codec, storage strategies and recomputed draws on a DeviceMesh,
and ``hierarchical_psum``, held against the reference.

Four gloo ranks on the CPU (one spawn, ``tests/torch_dist_workers.py`` case
``mesh_codec``), ``{data: 2, model: 2}``:

* the codec on a DTensor (``optim.compression.compress_shard``) is bitwise
  the global codec restricted to each rank's elements, for ``Shard(0)``,
  ``Shard(1)``, shards whose runs straddle 256-element blocks, both dims
  sharded, both mesh dims on one tensor dim, and a replicated tensor; each
  rank's int8 payload is bitwise the reference's ``compress`` of the
  global values; an aligned layout sends nothing, any other one all-reduce
  of 4·ceil(N/256) bytes (``max``) for each mesh dim that shards it; the
  error-feedback round-trip and the straight-through value are the global
  ones, a ``Partial`` tensor's too;
* ``Trainer(compress_grads=True)`` with FSDP and with tensor-parallel
  specs: at step 1 each rank's codec output is bitwise the global codec on
  the gathered gradient and error feedback, the error feedback keeps the
  parameters' placements, and 3 steps' losses are within rtol 1e-5 of the
  meshless compressed Trainer on the global batch (the bound
  ``test_four_rank_compressed_trainer_matches_the_global_batch`` holds on
  the data axis: an int8 rounding can flip on a 1-ulp gradient gap, so the
  bitwise check is the codec's own, on the same gradient values);
* the reduced LM's tensor-parallel loss under an offload plan is bitwise
  the mesh's vanilla on ``"fx"`` and ``"interpreter"``; under a quantizing
  plan every payload is bitwise the global codec, and some against the
  reference's ``compress`` here;
* a dropout MLP's default plan recomputes its ``bernoulli`` draws and is
  bitwise the mesh's plain autograd through the traced nodes, each drawn
  once (``vanilla_traced_value_and_grad(carrier, plan)``), on both traced
  backends (the CPU mesh takes no DTensor RNG tracker: each rank draws its
  local shard from its own CPU generator, which the replay restores;
  eager ``F.dropout`` on a sharded DTensor dispatches ``native_dropout``,
  which draws in another order than the traced ``bernoulli``);
* ``hierarchical_psum`` on ``{pod: 2, data: 2}`` is bitwise the reference's
  under nested ``jax.vmap`` (pod outside, data inside) on the same inputs,
  with one reduce-scatter over data, two all-reduces over pod (int32
  payload and f32 scales) and one all-gather over data, their bytes from
  the shapes; with no pod axis it is the plain sum over data.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import compression as rcomp  # noqa: E402
from repro_torch.data import DataConfig, global_batch_for_test  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
from test_torch_distributed_train import _port_model  # noqa: E402
from test_torch_model_axis import _small  # noqa: E402
from torch_dist_workers import CODEC_CASES, spawn  # noqa: E402

STEPS, SEQ, BATCH, WORLD = 3, 32, 8, 4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)
DROP_WIDTH, DROP_DEPTH = 16, 4
PSUM_SHAPE = (512, 3)


def _inputs():
    rng = np.random.default_rng(24)
    inp = {}
    for name, shape, _, _ in CODEC_CASES:
        inp[f"codec:{name}"] = rng.standard_normal(shape).astype(np.float32)
        inp[f"codec:{name}:e"] = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
    for w in (64, 256):
        np_tree = _small(w)[-1]
        inp.update({f"p{w}:" + k: v.numpy() for k, v in params_from_jax(np_tree).items()})
    inp.update(steps=np.array(STEPS), seq=np.array(SEQ), batch=np.array(BATCH))
    inp["drop:n"] = np.array(DROP_DEPTH)
    for i in range(DROP_DEPTH):
        inp[f"drop:w{i}"] = (rng.standard_normal((DROP_WIDTH, DROP_WIDTH)) * 0.3
                             ).astype(np.float32)
    inp["drop:x"] = rng.standard_normal((8, DROP_WIDTH)).astype(np.float32)
    for r in range(WORLD):
        inp[f"psum:x{r}"] = rng.standard_normal(PSUM_SHAPE).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    inp = _inputs()
    meshless = {}

    def references():  # the meshless compressed Trainer on the global batch
        _, pcfg, _, np_tree = _small(256)
        data = DataConfig(vocab_size=pcfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
                          num_hosts=2)
        tr = Trainer(lambda m, b: m.loss(b), _port_model(pcfg, np_tree),
                     TrainConfig(total_steps=STEPS, log_every=0, compress_grads=True,
                                 optimizer=adamw.AdamWConfig(**OPT)), device="cpu")
        meshless["losses"] = tr.run(global_batch_for_test(data, i)
                                    for i in range(STEPS))["losses"]

    ranks = spawn("mesh_codec", WORLD, tmp_path_factory.mktemp("mesh_codec"), inp,
                  meanwhile=references)
    return inp, ranks, meshless


def _reference_q_at(full, offset, q_local):
    """The reference's ``compress`` of ``full``, its payload at the box of
    ``q_local``'s shape starting at ``offset``."""
    c = rcomp.compress(jnp.asarray(full))
    n = full.size
    q = np.asarray(c.q).reshape(-1)[:n].reshape(full.shape)
    return q[tuple(slice(o, o + k) for o, k in zip(offset, q_local.shape))]


@pytest.mark.parametrize("case", [c[0] for c in CODEC_CASES])
def test_dtensor_codec_is_bitwise_the_global_codec(four_ranks, case):
    inp, ranks, _ = four_ranks
    name, shape, placements, aligned = next(c for c in CODEC_CASES if c[0] == case)
    n_blocks = -(-int(np.prod(shape)) // 256)
    sharding_dims = len({i for i, p in enumerate(placements) if p != "R"})
    for r in ranks:
        assert bool(r[f"codec:{case}:bitwise"]) and bool(r[f"codec:{case}:feedback_bitwise"])
        assert bool(r[f"codec:{case}:aligned"]) == aligned
        want = 0 if aligned else 4 * n_blocks * sharding_dims
        assert int(r[f"codec:{case}:bytes"]) == want
        assert int(r[f"codec:{case}:calls"]) == (0 if aligned else sharding_dims)
        q = r[f"codec:{case}:q"]
        np.testing.assert_array_equal(
            q, _reference_q_at(inp[f"codec:{case}"], r[f"codec:{case}:offset"], q))


def test_partial_dtensor_is_reduced_before_the_codec(four_ranks):
    assert all(bool(r["codec:partial_bitwise"]) for r in four_ranks[1])


@pytest.mark.parametrize("layout", ["fsdp", "tp"])
def test_compressed_trainer_on_sharded_parameters(four_ranks, layout):
    _, ranks, meshless = four_ranks
    for r in ranks:
        assert int(r[f"compress_{layout}:sharded_leaves"]) > 0
        assert bool(r[f"compress_{layout}:step1_codec_bitwise"])
        assert bool(r[f"compress_{layout}:feedback_placements"])
        np.testing.assert_allclose(r[f"compress_{layout}:losses"], meshless["losses"],
                                   rtol=1e-5)


@pytest.mark.parametrize("backend", ["fx", "interpreter"])
def test_offload_plan_is_bitwise_the_meshs_vanilla(four_ranks, backend):
    for r in four_ranks[1]:
        assert int(r[f"offload_{backend}:nodes"]) > 0
        assert bool(r[f"offload_{backend}:bitwise_vanilla"])


def test_quantize_plan_payloads_are_the_global_codecs(four_ranks):
    """Every quantized residual's payload on every rank is bitwise the
    global codec's at its elements (checked inside the ranks), the first
    three against the reference's ``compress`` here; the plan's loss and
    grads stay within the reference's documented 5e-2 of vanilla."""
    for r in four_ranks[1]:
        assert int(r["quantize:nodes"]) > 0 and int(r["quantize:captured"]) > 0
        assert bool(r["quantize:payloads_bitwise"])
        for i in range(min(3, int(r["quantize:captured"]))):
            q = r[f"quantize:{i}:q"]
            np.testing.assert_array_equal(
                q, _reference_q_at(r[f"quantize:{i}:full"], r[f"quantize:{i}:offset"], q))
        assert abs(float(r["quantize:loss"]) - float(r["quantize:vanilla_loss"])) <= (
            5e-2 * abs(float(r["quantize:vanilla_loss"])))
        assert float(r["quantize:grad_rel_l2"]) <= 5e-2


@pytest.mark.parametrize("backend", ["fx", "interpreter"])
def test_recomputed_draws_are_bitwise_the_meshs_plain_autograd(four_ranks, backend):
    for r in four_ranks[1]:
        assert int(r[f"dropout_{backend}:redrawn"]) > 0
        assert bool(r[f"dropout_{backend}:bitwise_vanilla"])


def test_hierarchical_psum_is_the_references(four_ranks):
    inp, ranks, _ = four_ranks
    xs = np.stack([inp[f"psum:x{r}"] for r in range(WORLD)]).reshape(2, 2, *PSUM_SHAPE)
    f = jax.vmap(jax.vmap(rcomp.hierarchical_psum, axis_name="data"), axis_name="pod")
    want = np.asarray(f(jnp.asarray(xs))).reshape(WORLD, *PSUM_SHAPE)
    exact = xs.reshape(WORLD, *PSUM_SHAPE).sum(0)
    n_local = PSUM_SHAPE[0] // 2 * PSUM_SHAPE[1]
    n_blocks = -(-n_local // 256)
    for rank, r in enumerate(ranks):  # rank = pod * 2 + data
        np.testing.assert_array_equal(r["psum:y"], want[rank])
        assert not np.array_equal(r["psum:y"], exact)  # the mean scale is crude
        comm = {k[len("psum:comm:"):]: int(v) for k, v in r.items()
                if k.startswith("psum:comm:")}
        assert comm == {
            "data:reduce_scatter_tensor:calls": 1,
            "data:reduce_scatter_tensor:payload": int(np.prod(PSUM_SHAPE)) * 4,
            "pod:all_reduce:calls": 2,
            "pod:all_reduce:payload": n_blocks * 256 * 4 + n_blocks * 4,
            "data:all_gather_into_tensor:calls": 1,
            "data:all_gather_into_tensor:payload": n_local * 4,
        }
        # {data: 2, model: 2}: rank = data * 2 + model, summed over data
        np.testing.assert_array_equal(r["psum:nopod_y"],
                                      inp[f"psum:x{rank % 2}"] + inp[f"psum:x{rank % 2 + 2}"])
