"""Model-axis (tensor-parallel) and FSDP execution of the dense LM on
DTensors, held against the reference.

Four gloo ranks on the CPU, ``{data: 2, model: 2}`` (one spawn,
``tests/torch_dist_workers.py`` case ``model_axis``), the reduced
stablelm-3b in f32 on the reference's weights (the Trainers at d_model
256, wide enough that ``fsdp_extend``'s 65,536-element floor shards the
matrices):

* the loss and every gradient on head-, ffn- and vocab-sharded parameters
  match the reference's **unsharded** function on the global batch (rtol
  1e-6, with an absolute floor of rtol × the tensor's largest magnitude:
  the ranks sum in another order), gradients in their parameters'
  placements;
* the planned twins (``"fx"``, ``"interpreter"``) are bitwise sharded
  vanilla, and each traced node's local bytes equal its priced ``M_v`` on
  every rank (the sharding constraints are nodes of the trace);
* the flash ops receive H/2 local heads, every tensor they get splits its
  heads over ``model``, and a forward and backward at that layout sends no
  collective;
* the FSDP Trainer (``sharding.named_sharding_tree(..., fsdp=True)``) matches the
  meshless Trainer on the global batch over 3 steps (the same tolerance),
  its planned twin is bitwise it, ``remesh(shardings=)`` is bitwise a
  Trainer built there, and a checkpoint restart is bitwise (full arrays on
  disk);
* ``compress_grads`` on the FSDP layout runs 3 steps within the codec's
  noise (rtol 1e-2) of the plain FSDP Trainer, its error feedback in the
  parameters' placements (``tests/test_torch_mesh_codec.py`` holds the
  codec bitwise and the losses to the meshless compressed Trainer);
* GQA whose KV heads the model axis does not divide (q's heads split, k's
  and v's whole): the flash kernels get each rank's q heads over as many
  local copies of its own KV head (MHA), the forward sends nothing and the
  backward all-reduces the dk and dv sums, (B_l, S, KV, D) each, over
  ``model``; values and grads
  within rtol 1e-6 (with the floor) of the reference's dense attention;
* every other family (zamba2, xlstm, whisper, granite, reduced: granite
  with its own 1 KV head; a global batch of 4 × 8) gives the reference's
  unsharded loss (rtol 1e-6 with the floor) and gradients on its
  ``specs`` layout: xlstm's and granite's
  within rtol 1e-6 with the floor; whisper's and zamba2's within the
  bounds their unsharded port is held to (``tests/test_torch_whisper.py``:
  rtol 1e-4; ``tests/test_torch_families.py``: zamba2 against an f64 run
  of the port), since neither family's unsharded f32 port comes within
  rtol 1e-6 of the reference (measured 1.1e-6 and 1.5e-5 of the largest
  gradient); and a Trainer step on
  ``Trainer(mesh=, in_shardings=specs.param_shardings(...))`` holds exactly
  ``specs.state_bytes_per_device`` a rank;
* the dry run's ``trace_cell`` on a fake ``{data: 2, model: 2}`` group
  (one process, destroyed after) counts rank 0's collectives of the
  tensor-parallel Trainer's first step and of granite's, op for op and
  byte for byte, as the real ranks' counter does.

One process: the constraints enter a trace only on a mesh that splits more
than the batch, so every other path is unchanged.
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
from repro.models import build_model as rbuild_model  # noqa: E402
from repro.models.transformer import LM as RLM  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.lowering import TracedCarrier  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM, global_batch_for_test  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import TrainConfig, Trainer, functional_loss  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_jax  # noqa: E402
from torch_dist_workers import spawn  # noqa: E402

ARCH = "stablelm-3b"
STEPS, SEQ, BATCH, WORLD = 3, 32, 8, 4
FAMILIES = ["zamba2-2.7b", "xlstm-1.3b", "whisper-small", "granite-moe-3b-a800m"]
FAMILY_BATCH, FAMILY_SEQ = 4, 8
RTOL = 1e-6
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)


def _small(d_model=64):
    rcfg = dataclasses.replace(rreduced(rget_config(ARCH), d_model=d_model), dtype="float32")
    pcfg = dataclasses.replace(reduced(get_config(ARCH), d_model=d_model), dtype="float32")
    rlm = RLM(rcfg)
    np_tree = jax.tree_util.tree_map(np.asarray, rlm.init(jax.random.PRNGKey(0)))
    return rcfg, pcfg, rlm, np_tree


def close(got, want, what=""):
    """rtol 1e-6 with the absolute floor rtol × max|want|."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=RTOL,
                               atol=RTOL * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _family(arch):
    """The reduced f32 reference config (granite with its own 1 KV head,
    which the model axis does not divide), its model, weights and a global
    batch of 4 × 8."""
    cfg = dataclasses.replace(rreduced(rget_config(arch)), dtype="float32")
    model = rbuild_model(cfg)
    # the weights of the port's init from seed 7, in the reference's tree
    # (the reference's own init takes seconds a family in eager JAX)
    pcfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                               n_kv_heads=cfg.n_kv_heads)
    tree = params_to_jax(build_model(pcfg, device="cpu",
                                     generator=torch.Generator().manual_seed(7)).state_dict())
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (FAMILY_BATCH, FAMILY_SEQ)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (FAMILY_BATCH, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return cfg, model, tree, batch


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    rcfg, pcfg, rlm, np_tree = _small()
    wide = _small(256)
    inp = {f"p{w}:" + k: v.numpy() for w, tree in ((64, np_tree), (256, wide[-1]))
           for k, v in params_from_jax(tree).items()}
    inp.update(steps=np.array(STEPS), seq=np.array(SEQ), batch=np.array(BATCH),
               family_archs=np.array(FAMILIES))
    families = {arch: _family(arch) for arch in FAMILIES}
    for arch, (_, _, tree, batch) in families.items():
        inp.update({f"{arch}:p:{k}": v.numpy() for k, v in params_from_jax(tree).items()})
        inp.update({f"{arch}:b:{k}": v for k, v in batch.items()})
    def references():  # each family's reference loss and grads, while the ranks run
        for arch, (cfg, model, tree, batch) in list(families.items()):
            loss, grads = jax.jit(jax.value_and_grad(model.loss))(
                jax.tree_util.tree_map(jnp.asarray, tree),
                {k: jnp.asarray(v) for k, v in batch.items()})
            want = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
            truth = _f64_truth(cfg, tree, batch) if arch == "zamba2-2.7b" else None
            families[arch] = (cfg, model, tree, batch, (float(loss), want, truth))

    ranks = spawn("model_axis", WORLD, tmp_path_factory.mktemp("model_axis"), inp,
                  meanwhile=references)
    data = DataConfig(vocab_size=rcfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
                      num_hosts=2)
    batches = [global_batch_for_test(data, i) for i in range(STEPS)]
    return rcfg, pcfg, rlm, np_tree, batches, ranks, wide, families


def test_loss_and_grads_match_the_reference_unsharded(four_ranks):
    rcfg, pcfg, rlm, np_tree, batches, ranks, wide, _ = four_ranks
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    loss, grads = jax.value_and_grad(rlm.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batches[0].items()})
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    for r in ranks:
        close(r["loss"], loss, "loss")
        assert {k[len("g:model."):] for k in r if k.startswith("g:")} == set(want)
        for k, g in want.items():
            close(r["g:model." + k], g.numpy(), k)


@pytest.mark.parametrize("backend", ["fx", "interpreter"])
def test_planned_twins_are_bitwise_sharded_vanilla(four_ranks, backend):
    for r in four_ranks[-3]:
        assert bool(r[f"{backend}_recomputes"]) and bool(r[f"{backend}_bitwise_vanilla"])
        assert bool(r[f"{backend}_grads_in_param_placements"])
        assert np.array_equal(r[f"{backend}_loss"], four_ranks[-3][0][f"{backend}_loss"])


def test_priced_bytes_equal_the_local_shards(four_ranks):
    """Each traced node's local bytes on every rank equal its priced
    per-device ``M_v``: the constraints' specs (the sequence-parallel
    residual, the vocab-sharded logits) and the propagation rules follow
    DTensor's layouts node by node."""
    for r in four_ranks[-3]:
        assert int(r["constraint_nodes"]) > 0
        local, priced = r["local_bytes"], r["priced_mem_v"]
        assert np.array_equal(local, priced), [
            (int(i), int(local[i]), int(priced[i])) for i in np.flatnonzero(local != priced)]


def test_flash_ops_run_on_local_head_shards(four_ranks):
    """Each rank's kernels get q with H/2 = 2 local heads of 4; every
    tensor the flash ops receive splits its heads over ``model``, so
    DTensor gathers nothing inside attention, and a forward and backward
    at that layout sends no collective."""
    for r in four_ranks[-3]:
        assert bool(r["flash_local_heads"]), r["flash_local_q"]
        assert bool(r["flash_heads_layout"])
        assert float(r["attention_collectives"]) == 0.0


def test_fsdp_trainer_matches_the_meshless_trainer(four_ranks):
    rcfg, pcfg, rlm, np_tree, batches, ranks, wide, _ = four_ranks
    _, wcfg, _, wtree = wide
    model = build_model(wcfg, device="cpu")
    model.load_state_dict(params_from_jax(wtree), strict=True)
    tr = Trainer(lambda m, b: m.loss(b), model,
                 TrainConfig(total_steps=STEPS, log_every=0,
                             optimizer=adamw.AdamWConfig(**OPT)), device="cpu")
    out = tr.run(iter(batches))
    for r in ranks:
        assert int(r["fsdp_leaves"]) > 0 and bool(r["fsdp_params_sharded"])
        close(r["fsdp_losses"], out["losses"], "losses")
        close(r["fsdp_grad_norms"], out["grad_norms"], "grad norms")
        # each rank holds about a quarter of the parameters' f32 bytes
        whole = sum(p.numel() * 4 for p in model.parameters())
        assert whole / 4 <= int(r["fsdp_local_param_bytes"]) < whole / 2


def test_tensor_parallel_trainer_sends_the_shapes_collectives(four_ranks):
    """The tensor-parallel Trainer's first step (d_model 256, 2 units, B_l
    4 sequences of 32 a rank) sends what its shapes give, byte for byte
    (``chip_smoke.expected_collectives`` holds the card's run to the same
    count): over data, every gradient's model shard in f32 (the
    embedding's too: each rank looks up its vocab slice) and the loss;
    over model, (4L+2)·A activation
    partial sums, the vocab-sharded loss's three (B_l, S−1) f32
    reductions, (2L−1)·D f32 norm-scale gradients and one f32 per
    model-sharded leaf for the clip's norm all-reduced, and 4L·A/m of
    sequence shards gathered (A = B_l·S·D elements in the activation
    dtype)."""
    *_, ranks, wide, _ = four_ranks
    cfg = wide[1]
    L, D, m = cfg.n_layers, cfg.d_model, 2
    Bl, S = BATCH // 2, SEQ
    A = Bl * S * D
    act = torch.finfo(cfg.activation_dtype).bits // 8  # f32 here, bf16 on the card
    for r in ranks:
        want = {
            "data:all_reduce": int(r["tp_local_param_bytes"]) + 4,
            "model:all_reduce": (4 * L + 2) * A * act + 3 * Bl * (S - 1) * 4
            + (2 * L - 1) * D * 4 + int(r["tp_model_sharded_leaves"]) * 4,
            "model:all_gather_into_tensor": 4 * L * (A // m) * act,
        }
        got = {k[len("tp_comm:"):]: int(v) for k, v in r.items() if k.startswith("tp_comm:")}
        assert got == want


def test_fsdp_trainer_counts_each_axis_collectives(four_ranks):
    """The first step's collectives split by mesh axis: the model axis
    reduces and gathers activations, the data axis reduce-scatters the
    FSDP gradients (and gathers the FSDP weights)."""
    for r in four_ranks[-3]:
        for op in ("all_reduce", "all_gather_into_tensor"):
            assert float(r[f"comm:model:{op}"]) > 0, op
        assert float(r["comm:data:reduce_scatter_tensor"]) > 0


@pytest.mark.parametrize("check", ["fsdp_planned_bitwise", "remesh_none_bitwise",
                                   "remesh_tp_bitwise"])
def test_fsdp_planned_and_remeshed_trainers_are_bitwise(four_ranks, check):
    assert all(bool(r[check]) for r in four_ranks[-3]), check


def test_sharded_checkpoint_restart_is_bitwise(four_ranks):
    ranks = four_ranks[-3]
    assert bool(ranks[0]["ckpt_full_shapes"])
    for r in ranks:
        assert bool(r["ckpt_restored"]) and bool(r["ckpt_resumed_bitwise"])


@pytest.mark.parametrize("check", ["compress_raises"])
def test_what_is_not_ported_on_the_model_axis_raises(four_ranks, check):
    assert all(bool(r[check]) for r in four_ranks[-3]), check


def test_gqa_flash_ops_run_on_each_ranks_own_kv_head(four_ranks):
    """q (2, 8, 4, 16) split over ``data`` and ``model``, k = v (2, 8, 1,
    16) whole over ``model``: each rank's kernels get its 2 q heads over 2
    copies of its KV head; a forward and backward all-reduce only dk's and
    dv's (1, 8, 1, 16) f32 sums over ``model``, the gradient keeps k's
    layout, and the values are the reference's dense attention's."""
    from repro.models.attention import dense_attention

    q = torch.randn(2, 8, 4, 16, generator=torch.Generator().manual_seed(1)).numpy()
    kv = torch.randn(2, 8, 1, 16, generator=torch.Generator().manual_seed(2)).numpy()

    def f(q_, kv_):
        return jnp.sum(jnp.square(dense_attention(q_, kv_, kv_)))

    out = dense_attention(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv))
    dq, dkv = jax.grad(f, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(kv))
    for r in four_ranks[-3]:
        assert {tuple(s) for s in r["gqa_local_q"]} == {(1, 2, 8, 16)}
        assert {tuple(s) for s in r["gqa_local_k"]} == {(1, 2, 8, 16)}
        comm = {k[len("gqa_comm:"):]: int(v) for k, v in r.items() if k.startswith("gqa_comm:")}
        assert comm == {"model:all_reduce:calls": 2,
                        "model:all_reduce:payload": 2 * 1 * 8 * 1 * 16 * 4}
        assert str(r["gqa_kv_placements"]) == "[Shard(dim=0), Replicate()]"
        close(r["gqa_out"], out, "out")
        close(r["gqa_dq"], dq, "dq")
        close(r["gqa_dkv"], dkv, "dkv")


@pytest.mark.parametrize("case", ["dense", "granite-moe-3b-a800m"])
def test_fake_group_counts_the_real_ranks_collectives(four_ranks, case):
    """``launch.dryrun.trace_cell`` on a fake ``{data: 2, model: 2}`` group,
    rank 0's fake shards: the same step's collectives by axis, calls and
    payload bytes, as the four real ranks' counter read (the
    tensor-parallel Trainer's first step at d_model 256; granite's Trainer
    step with its one KV head)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import REFERENCE_HBM_BYTES, fake_group, make_fake_mesh

    *_, ranks, wide, families = four_ranks
    if case == "dense":
        cfg, shape, prefix = wide[1], ShapeConfig("train", SEQ, BATCH, "train"), "tp_"
    else:
        cfg = dataclasses.replace(reduced(get_config(case)), dtype="float32")
        shape, prefix = ShapeConfig("train", FAMILY_SEQ, FAMILY_BATCH, "train"), f"{case}:"
    with fake_group(WORLD):
        rec = trace_cell(cfg, shape, make_fake_mesh((2, 2), ("data", "model")),
                         hbm_bytes=REFERENCE_HBM_BYTES, totals=False,
                         segment_sizes=(cfg.n_layers,), n_micro=1)
    got = {(axis, op): (int(v["calls"]), int(v["payload_bytes"]))
           for axis, ops in rec["collectives_by_axis"].items() for op, v in ops.items()}
    r = ranks[0]
    want = {}
    for k, v in r.items():
        if k.startswith(prefix + "calls:"):
            axis, op = k[len(prefix + "calls:"):].split(":")
            want[(axis, op)] = (int(v), int(r[f"{prefix}comm:{axis}:{op}"]))
    assert want and got == want


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_loss_and_grads_match_the_reference_unsharded(four_ranks, arch):
    """The loss and every gradient of each family on its ``specs`` layout
    (heads, ffn, experts and vocab over ``model``) and a data rank's half
    of the batch, against the reference's unsharded function on the
    global batch (rtol 1e-6 with the absolute floor)."""
    *_, ranks, _, families = four_ranks
    loss, want, truth = families[arch][-1]
    for r in ranks:
        close(r[f"{arch}:loss"], loss, f"{arch} loss")
        assert {k[len(f"{arch}:g:"):] for k in r if k.startswith(f"{arch}:g:")} == set(want)
        for k, g in want.items():
            got, g = r[f"{arch}:g:{k}"], g.numpy()
            if truth is not None:
                # zamba2's SSD grads sum terms that cancel: even unsharded
                # the port's f32 grads differ from the reference's beyond
                # any fixed rtol, so both are held against an f64 run of the
                # port, as tests/test_torch_families.py holds the unsharded
                # port: the sharded leaf within 2 × the reference's distance
                # + 600 units of eps32 × max|leaf|
                unit = float(np.finfo(np.float32).eps) * max(float(np.abs(truth[k]).max()),
                                                             1e-30)
                port = float(np.abs(got - truth[k]).max()) / unit
                ref = float(np.abs(g - truth[k]).max()) / unit
                assert ref <= 1000 and port <= 2 * ref + 600, (k, port, ref)
            elif arch == "whisper-small":
                # the unsharded port's own tolerance against the reference
                # (tests/test_torch_whisper.py: its cross-attention runs on
                # the flash kernels where the reference's is dense)
                np.testing.assert_allclose(got, g, rtol=1e-4,
                                           atol=1e-5 * max(1.0, float(np.abs(g).max())),
                                           err_msg=k)
            else:
                close(got, g, f"{arch} {k}")


def _f64_truth(cfg, tree, batch):
    """The port's unsharded grads in f64 on the same weights."""
    from test_torch_families import _f64_grads

    pcfg = dataclasses.replace(reduced(get_config(cfg.name)), dtype="float32")
    plm = build_model(pcfg, device="cpu")
    plm.load_state_dict(params_from_jax(tree), strict=True)
    return {k: v.numpy() for k, v in _f64_grads(plm, batch).items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_trains_on_the_model_axis_in_its_specs_layout(four_ranks, arch):
    """A Trainer step on ``Trainer(mesh=, in_shardings=specs.param_shardings
    (...))``: its loss is the unsharded one, each rank holds exactly
    ``specs.state_bytes_per_device`` of parameters and AdamW moments, some
    leaves split over ``model``, and the flash kernels (granite's GQA
    attention, whisper's encoder, decoder and cross-attention) get half the
    heads (granite's k and v too: its one KV head repeated to each rank's q
    heads)."""
    *_, ranks, _, families = four_ranks
    cfg, loss = families[arch][0], families[arch][-1][0]
    for r in ranks:
        close(r[f"{arch}:trainer_loss"], loss, f"{arch} trainer loss")
        assert int(r[f"{arch}:state_bytes"]) == int(r[f"{arch}:specs_state_bytes"])
        assert int(r[f"{arch}:model_sharded_leaves"]) > 0
        heads = r[f"{arch}:flash_local_heads"].tolist()
        assert heads == ([cfg.n_heads // 2] if arch in ("granite-moe-3b-a800m", "whisper-small",
                                                       "zamba2-2.7b") else []), heads
        if arch == "granite-moe-3b-a800m":  # its KV head, repeated locally
            assert r[f"{arch}:flash_local_kv_heads"].tolist() == heads


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh, constraints", [
    (None, 0), ({"data": 4}, 0), ({"data": 4, "model": 1}, 0), ({"data": 2, "model": 2}, 26)])
def test_constraints_are_traced_only_on_a_model_axis(mesh, constraints):
    """The reference's ``shard`` sites become ``repro_torch::shard`` nodes
    only when the traced mesh splits more than the batch (2 units of 10:
    the sequence gathered before the attention's and the MLP's matmuls, q,
    k, v, the attention's context and output, the MLP's hidden and output
    and the unit boundary; 1 after the embedding, 2 at the head, 3 in the
    loss);
    elsewhere the trace, and so every plan, is the one without them."""
    _, pcfg, _, np_tree = _small()
    model = build_model(pcfg, device="cpu")
    fn, params = functional_loss(lambda m, b: m.loss(b), model)
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(DataConfig(
        vocab_size=pcfg.vocab_size, seq_len=SEQ, global_batch=BATCH)).batch(0).items()}
    kw = {} if mesh is None else dict(mesh=mesh, in_shardings=(None, ("data", None)))
    carrier = TracedCarrier.trace(fn, (params, batch), **kw)
    kinds = [n.kind for n in carrier.to_graph().nodes]
    assert kinds.count("sharding_constraint") == constraints
    if not constraints:
        plain = TracedCarrier.trace(fn, (params, batch))
        assert kinds == [n.kind for n in plain.to_graph().nodes]


def test_vocab_sharded_loss_formula_is_the_reference_loss():
    """The log-partition on the vocab shards (max, sum of exponentials,
    the gathered gold logit) is the reference's ``softmax_xent`` to rtol
    1e-6 on one process, where DTensor is not needed to run it."""
    from repro.models.layers import softmax_xent as rxent
    from repro_torch.models import layers
    from repro_torch.parallel import sharding as sh

    rng = np.random.default_rng(0)
    logits = (4 * rng.standard_normal((2, 7, 33))).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    with sh.tracing_on({"data": 1, "model": 2}):
        assert sh.model_parallel(torch.zeros(1))
        got = layers.softmax_xent(torch.tensor(logits), torch.tensor(labels))
    close(got.numpy(), rxent(jnp.asarray(logits), jnp.asarray(labels)), "loss")


def test_vocab_lookups_are_traced_with_no_vocab_wide_one_hot():
    """On a model axis the embedding's rows and the loss's gold logits are
    one ``repro_torch::vocab_embed`` and one ``repro_torch::vocab_pick``
    node of the trace, priced at the tokens' batch shards, and no node
    compares the tokens or labels with the whole vocabulary."""
    _, pcfg, _, _ = _small()
    model = build_model(pcfg, device="cpu")
    fn, params = functional_loss(lambda m, b: m.loss(b), model)
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(DataConfig(
        vocab_size=pcfg.vocab_size, seq_len=SEQ, global_batch=BATCH)).batch(0).items()}
    sizes = {"data": 2, "model": 2}
    carrier = TracedCarrier.trace(fn, (params, batch), mesh=sizes,
                                  in_shardings=(None, ("data", None)))
    kinds = [n.kind for n in carrier.to_graph().nodes]
    assert kinds.count("repro_torch::vocab_embed") == 1
    assert kinds.count("repro_torch::vocab_pick") == 1
    for node in carrier.fx.gm.graph.nodes:
        val = node.meta.get("val")
        assert not (isinstance(val, torch.Tensor) and val.dtype == torch.bool
                    and val.shape[-1:] == (pcfg.vocab_size,)), node
    # per device: the local (B/2, S, D) rows, a partial sum over the vocab shards
    embed = next(n for n in carrier.to_graph().nodes if n.kind == "repro_torch::vocab_embed")
    assert embed.memory == BATCH // 2 * SEQ * pcfg.d_model * 4


def test_vocab_ops_plain_values_and_grads_are_embedding_and_gather():
    """Off a DTensor (a trace's replay on one process) the two lookups
    are ``F.embedding`` and a gather, in value and gradient, bitwise."""
    from repro_torch.parallel import vocab

    rng = np.random.default_rng(3)
    table = torch.tensor(rng.standard_normal((11, 5)).astype(np.float32), requires_grad=True)
    logits = torch.tensor(rng.standard_normal((2, 7, 11)).astype(np.float32),
                          requires_grad=True)
    idx = torch.tensor(rng.integers(0, 11, (2, 7)))
    g_rows = torch.tensor(rng.standard_normal((2, 7, 5)).astype(np.float32))
    g_gold = torch.tensor(rng.standard_normal((2, 7)).astype(np.float32))
    for got, want, g, wrt in (
            (vocab.embed_rows(table, idx), torch.nn.functional.embedding(idx, table), g_rows,
             table),
            (vocab.pick(logits, idx), logits.gather(-1, idx[..., None])[..., 0], g_gold,
             logits)):
        assert torch.equal(got, want)
        assert torch.equal(torch.autograd.grad(got, wrt, g)[0],
                           torch.autograd.grad(want, wrt, g)[0])


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_traces_its_constraints_on_a_model_axis(arch):
    """On the fx carrier over a ``{data: 2, model: 2}`` dict mesh each
    family's loss traces with the reference's constraints as nodes: the
    MoE keeps its dense path with the dispatch buffer and the experts'
    output pinned to ``("experts", "expert_cap", None)`` (two a unit),
    Mamba2's x-branch over ``ffn``, mLSTM's q, k, v over ``heads``,
    whisper's residual sequence-parallel at each layer's end; the graph
    is priced at the ranks' shards, below the global bytes."""
    cfg, _, tree, batch = _family(arch)
    pcfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                               n_kv_heads=cfg.n_kv_heads)
    model = build_model(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(tree), strict=True)
    fn, params = functional_loss(lambda m, b: m.loss(b), model)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    sharded = TracedCarrier.trace(fn, (params, tb), mesh={"data": 2, "model": 2},
                                  in_shardings=(None, ("data", None)))
    plain = TracedCarrier.trace(fn, (params, tb))
    logical = [n.args[1] for n in sharded.fx.gm.graph.nodes
               if "repro_torch.shard" in str(n.target)]
    want = {"granite-moe-3b-a800m": ("experts,expert_cap,", 2 * pcfg.n_layers),
            # each Mamba2 block's x-branch, each unit's shared MLP hidden
            "zamba2-2.7b": ("batch,,ffn",
                            pcfg.n_layers + pcfg.n_layers // max(1, pcfg.hybrid_shared_attn_every)),
            "xlstm-1.3b": ("batch,,heads,", 3 * pcfg.n_layers // 2),
            "whisper-small": ("batch,seq_act,", 2 * pcfg.n_layers)}[arch]
    assert logical.count(want[0]) == want[1], logical
    assert sum(sharded.to_graph().mem_v) < sum(plain.to_graph().mem_v)


def test_expert_parallel_trainer_sends_the_shapes_all_to_alls(four_ranks):
    """granite's Trainer step on ``{data: 2, model: 2}``: its 4 experts
    divide the model axis and its 8 tokens a rank's sequence, so each MoE
    layer exchanges its (E, C_loc, D) f32 buffer twice forward and twice
    backward over ``model``, T_loc = 2 × 4 tokens, C_loc = max(8,
    ceil(cf·T_loc·K/E)); ``chip_smoke.expected_collectives`` counts the
    card's run the same way."""
    *_, ranks, _, families = four_ranks
    cfg = families["granite-moe-3b-a800m"][0]
    E, K, cf = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.capacity_factor
    t_loc = (FAMILY_BATCH // 2) * (FAMILY_SEQ // 2)
    c_loc = max(8, int(np.ceil(cf * t_loc * K / E)))
    want = 4 * cfg.n_layers * E * c_loc * cfg.d_model * 4
    for r in ranks:
        assert int(r["granite-moe-3b-a800m:comm:model:all_to_all_single"]) == want
        assert "xlstm-1.3b:comm:model:all_to_all_single" not in r
