"""The data-parallel Trainer, gradient compression, ``remesh`` and the
``torchrun`` launcher, held against the reference.

One process: ``quantize_roundtrip_with_feedback`` is bitwise the
reference's on f32; ``Trainer(compress_grads=True)`` follows the reference
Trainer's compressed run (``tests/test_train_loop.py::
test_gradient_compression_error_feedback_converges``'s setup) to rtol
1e-5; ``remesh`` from no mesh onto a ``(1, 1)`` mesh of a one-rank gloo
group (the reference's ``test_remesh_rejits``) continues bitwise as a
Trainer built on that mesh; what still is not ported raises.

Four gloo ranks on the CPU (one spawn, ``tests/torch_dist_workers.py``):
the reduced LM's Trainer on ``{data: 4}``, each rank on its slice of the
global batch, matches the meshless port Trainer and the reference Trainer
on the global batch (3 steps, f32, rtol 1e-5); the planned step is bitwise
the plain one; the collective counter sees one all-reduce of every
gradient (the parameters' f32 bytes) and one of the loss per step; each
node's local bytes on a rank are within its priced per-device ``M_v``; the
launcher runs under the group, rank 0 checkpoints, and a rerun resumes
bitwise on every rank.
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
from repro.models.transformer import LM as RLM  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.optim import compression as rcomp  # noqa: E402
from repro.train import TrainConfig as RTrainConfig  # noqa: E402
from repro.train import Trainer as RTrainer  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM, global_batch_for_test  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw, compression  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
from torch_dist_workers import spawn  # noqa: E402

ARCH = "stablelm-3b"
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)


def _small():
    """Reduced stablelm-3b in f32 on both sides, on the reference's weights."""
    rcfg = dataclasses.replace(rreduced(rget_config(ARCH)), dtype="float32")
    pcfg = dataclasses.replace(reduced(get_config(ARCH)), dtype="float32")
    rlm = RLM(rcfg)
    np_tree = jax.tree_util.tree_map(np.asarray, rlm.init(jax.random.PRNGKey(0)))
    return rcfg, pcfg, rlm, np_tree


def _port_model(pcfg, np_tree):
    m = build_model(pcfg, device="cpu")
    m.load_state_dict(params_from_jax(np_tree), strict=True)
    return m


def _reference_run(rlm, np_tree, batches, **kw):
    """The reference Trainer's jitted step, driven step by step."""
    opt = radamw.AdamWConfig(**kw.pop("opt", OPT))
    tr = RTrainer(rlm.loss, jax.tree_util.tree_map(jnp.asarray, np_tree),
                  RTrainConfig(total_steps=len(batches), log_every=0, optimizer=opt, **kw),
                  donate=False)
    p, o, e = tr.params, tr.opt_state, tr.err_fb
    losses, norms = [], []
    for b in batches:
        p, o, e, m = tr._train_step(p, o, e, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shapes", [[(8,), (3, 300)], [(256,), (4, 64)], [(1000,)]])
def test_quantize_roundtrip_with_feedback_is_bitwise_the_reference(shapes):
    rng = np.random.default_rng(5)
    grads = [[(3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
             for _ in range(3)]
    rerr = rcomp.init_error_feedback([jnp.zeros(s) for s in shapes])
    perr = compression.init_error_feedback([torch.zeros(s) for s in shapes])
    assert all(e.dtype == torch.float32 and tuple(e.shape) == s for e, s in zip(perr, shapes))
    for g in grads:
        rg, rerr = rcomp.quantize_roundtrip_with_feedback([jnp.asarray(x) for x in g], rerr)
        pg, perr = compression.quantize_roundtrip_with_feedback([torch.tensor(x) for x in g],
                                                                perr)
        for a, b in zip(pg + perr, list(rg) + list(rerr)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compressed_trainer_follows_the_reference():
    """The reference's compression setup (reduced LM, seq 32, batch 4, 10
    steps at lr 1e-3): the port's compressed losses equal the reference's
    compressed losses to rtol 1e-5, and stay near the uncompressed run."""
    rcfg, pcfg, rlm, np_tree = _small()
    data = DataConfig(vocab_size=rcfg.vocab_size, seq_len=32, global_batch=4)
    batches = [SyntheticLM(data).batch(i) for i in range(10)]
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    rlosses, _ = _reference_run(rlm, np_tree, batches, opt=opt, compress_grads=True)
    out = {}
    for compress in (False, True):
        tr = Trainer(lambda m, b: m.loss(b), _port_model(pcfg, np_tree),
                     TrainConfig(total_steps=10, log_every=0, compress_grads=compress,
                                 optimizer=adamw.AdamWConfig(**opt)), device="cpu")
        out[compress] = tr.run(iter(batches))["losses"]
    np.testing.assert_allclose(out[True], rlosses, rtol=1e-5)
    assert abs(out[True][-1] - out[False][-1]) < 0.1


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group (a ``FileStore`` in ``tmp_path``) and its
    ``(1, 1)`` mesh; the group is torn down after the test."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_remesh_rejits(one_rank):
    """Two steps without a mesh, ``remesh`` onto the (1, 1) mesh, one more:
    parameters become DTensors, and the step after the remesh is bitwise
    that of a Trainer built on the mesh."""
    from torch.distributed.tensor import DTensor

    _, pcfg, _, np_tree = _small()
    data = SyntheticLM(DataConfig(vocab_size=pcfg.vocab_size, seq_len=32, global_batch=4))
    opt = adamw.AdamWConfig(**OPT)

    def trainer(mesh=None, **kw):
        return Trainer(lambda m, b: m.loss(b), _port_model(pcfg, np_tree),
                       TrainConfig(total_steps=2, log_every=0, optimizer=opt, **kw),
                       device="cpu", mesh=mesh)

    for kw in (dict(), dict(compress_grads=True), dict(plan_budget=1e12)):
        moved, built = trainer(**kw), trainer(one_rank, **kw)
        first = moved.run(iter(data))
        assert first["step"] == 2
        moved.remesh(one_rank)
        assert all(isinstance(p, DTensor) for p in moved.params)
        assert all(isinstance(m, DTensor) for m in moved.opt_state.mu)
        out = moved.run(iter([]))
        assert out["step"] == 2  # already at total: the rebuilt step is not run
        built.run(iter(data))
        for tr in (moved, built):
            tr.cfg = dataclasses.replace(tr.cfg, total_steps=3)
        a, b = moved.run(iter([data.batch(2)])), built.run(iter([data.batch(2)]))
        assert a["losses"] == b["losses"] and a["grad_norms"] == b["grad_norms"], kw
        assert all(torch.equal(p.to_local(), q.to_local())
                   for p, q in zip(moved.params, built.params)), kw
        assert moved.comm_stats == {}  # a one-rank mesh sends nothing


def test_remesh_changes_the_planned_steps_digest(one_rank):
    """A planned step re-plans on remesh: the (1, 1) mesh prices whole
    tensors (one device), so the trace keeps the meshless bytes, while a
    dict mesh of 4 data shards prices per-device bytes and a new digest."""
    import repro_torch
    from repro_torch.core.graph import graph_digest
    from repro_torch.train.loop import functional_loss

    _, pcfg, _, np_tree = _small()
    model = _port_model(pcfg, np_tree)
    fn, params = functional_loss(lambda m, b: m.loss(b), model)
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(DataConfig(
        vocab_size=pcfg.vocab_size, seq_len=32, global_batch=4)).batch(0).items()}

    def digest(**kw):
        pf = repro_torch.plan_function(fn, 1e12, **kw)
        return graph_digest(pf.lowered_for(params, batch).carrier.to_graph())

    plain = digest()
    four = digest(mesh={"data": 4, "model": 1}, in_shardings=(None, ("data", None)))
    assert four != plain
    assert digest(mesh={"data": 4, "model": 1}, in_shardings=(None, ("data", None))) == four


@pytest.mark.parametrize("device, world, local, cards, want", [
    ("cpu", 4, 4, 0, "gloo"),
    ("cuda", 1, 1, 1, "nccl"),
    ("cuda", 16, 8, 8, "nccl"),  # two nodes of eight cards
    ("cuda", 2, 2, 1, "gloo"),  # two ranks sharing one node's card
    ("cuda", 4, None, 8, "nccl"),
    ("cuda", 16, 16, 8, "gloo"),
    ("cuda", 4, 2, 1, ValueError),  # ranks sharing cards across nodes
    ("cuda", 16, None, 8, ValueError),  # no LOCAL_WORLD_SIZE: layout unknown
])
def test_pick_backend_takes_gloo_only_for_ranks_sharing_a_nodes_cards(
        device, world, local, cards, want):
    """NCCL whenever each of this node's ranks has a card (a multi-node
    world larger than one node's cards included), gloo on the CPU and for a
    single node's ranks sharing its cards, and an error rather than host
    reductions in any other layout."""
    from repro_torch.launch.mesh import pick_backend

    if want is ValueError:
        with pytest.raises(ValueError):
            pick_backend(device, world, local, cards)
    else:
        assert pick_backend(device, world, local, cards) == want


def test_trainer_raises_for_what_is_not_ported_on_a_mesh():
    """A mesh axis no twin runs over (a pipeline's stages) raises; a dict
    mesh, the model axis included, cannot run a step."""
    _, pcfg, _, np_tree = _small()
    cfg = TrainConfig(total_steps=1, log_every=0)
    with pytest.raises(NotImplementedError, match="mesh axis 'stage'.*Multi-device"):
        Trainer(lambda m, b: m.loss(b), _port_model(pcfg, np_tree), cfg, device="cpu",
                mesh={"data": 2, "stage": 2})
    with pytest.raises(ValueError, match="DeviceMesh"):
        Trainer(lambda m, b: m.loss(b), _port_model(pcfg, np_tree), cfg, device="cpu",
                mesh={"data": 2, "model": 2})
    with pytest.raises(ValueError, match="DeviceMesh"):
        Trainer(lambda m, b: m.loss(b), _port_model(pcfg, np_tree), cfg, device="cpu",
                mesh={"data": 2, "model": 1})


def test_replay_takes_the_counters_bytes():
    """``hlo_comm_bytes`` sums a collective counter's payload bytes, and
    ``replay(comm_bytes=)`` prices them in place of the ring model."""
    from repro_torch.core.graph import Graph, Node
    from repro_torch.core.replay import hlo_comm_bytes, replay
    from repro_torch.core.schedule import make_plan

    stats = {"all_reduce": {"calls": 3, "payload_bytes": 1200, "wire_bytes": 1800.0},
             "all_gather_into_tensor": {"calls": 1, "payload_bytes": 800, "wire_bytes": 600.0}}
    assert hlo_comm_bytes(stats) == 2000.0
    g = Graph([Node(i, f"v{i}", 1.0, 4.0) for i in range(3)], [(0, 1), (1, 2)])
    plan = make_plan(g, [frozenset({0, 1}), frozenset({0, 1, 2})])
    quiet = replay(g, plan, comm_bytes=0.0).seconds
    loud = replay(g, plan, comm_bytes=hlo_comm_bytes(stats),
                  interconnect_bytes_per_sec=1e3).seconds
    assert loud > quiet


# ---------------------------------------------------------------------------
# Four gloo ranks
# ---------------------------------------------------------------------------

STEPS, SEQ, BATCH, WORLD = 3, 32, 8, 4


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    rcfg, pcfg, rlm, np_tree = _small()
    inp = {"p:" + k: v.numpy() for k, v in params_from_jax(np_tree).items()}
    inp.update(steps=np.array(STEPS), seq=np.array(SEQ), batch=np.array(BATCH))
    ranks = spawn("train", WORLD, tmp_path_factory.mktemp("train"), inp)
    data = DataConfig(vocab_size=rcfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
                      num_hosts=WORLD)
    batches = [global_batch_for_test(data, i) for i in range(STEPS)]
    return rcfg, pcfg, rlm, np_tree, batches, ranks


def test_four_rank_trainer_matches_the_global_batch(four_ranks):
    """Each rank's losses and grad norms equal the meshless port Trainer's
    and the reference Trainer's on the global batch (rtol 1e-5)."""
    rcfg, pcfg, rlm, np_tree, batches, ranks = four_ranks
    rlosses, rnorms = _reference_run(rlm, np_tree, batches)
    tr = Trainer(lambda m, b: m.loss(b), _port_model(pcfg, np_tree),
                 TrainConfig(total_steps=STEPS, log_every=0,
                             optimizer=adamw.AdamWConfig(**OPT)), device="cpu")
    out = tr.run(iter(batches))
    for r in ranks:
        np.testing.assert_allclose(r["losses"], out["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norms"], out["grad_norms"], rtol=1e-5)
        np.testing.assert_allclose(r["losses"], rlosses, rtol=1e-5)
        np.testing.assert_allclose(r["grad_norms"], rnorms, rtol=1e-5)
    assert all(np.array_equal(r["losses"], ranks[0]["losses"]) for r in ranks)


@pytest.mark.parametrize("check", ["planned_recomputes", "planned_bitwise"])
def test_four_rank_planned_step_is_bitwise_the_plain_one(four_ranks, check):
    assert all(bool(r[check]) for r in four_ranks[-1]), check


def test_four_rank_collectives_are_one_all_reduce_per_gradient(four_ranks):
    """The first step's collectives: one all-reduce per parameter gradient
    (their payload is the parameters' f32 bytes) and one of the loss (4
    bytes); a ring sends 2(n−1)/n of that per rank."""
    for r in four_ranks[-1]:
        assert int(r["all_reduce_calls"]) == int(r["n_params"]) + 1
        assert int(r["all_reduce_payload"]) == int(r["param_bytes"]) + 4
        assert float(r["all_reduce_wire"]) == 2 * (WORLD - 1) / WORLD * float(
            r["all_reduce_payload"])


def test_four_rank_compressed_trainer_matches_the_global_batch(four_ranks):
    """Compressed gradients on the mesh follow the meshless compressed port
    Trainer on the global batch (the codec runs on the all-reduced, hence
    global, gradients; rtol 1e-5)."""
    rcfg, pcfg, rlm, np_tree, batches, ranks = four_ranks
    tr = Trainer(lambda m, b: m.loss(b), _port_model(pcfg, np_tree),
                 TrainConfig(total_steps=STEPS, log_every=0, compress_grads=True,
                             optimizer=adamw.AdamWConfig(**OPT)), device="cpu")
    out = tr.run(iter(batches))
    for r in ranks:
        np.testing.assert_allclose(r["compressed_losses"], out["losses"], rtol=1e-5)


def test_four_rank_launcher_runs_under_the_group(four_ranks):
    """The launcher with ``WORLD_SIZE`` set joins the group, plans on the
    mesh's axis sizes and steps each rank's slice; its first step
    all-reduces every gradient once (the reduced bf16 config keeps f32
    master parameters)."""
    *_, ranks = four_ranks
    cfg = reduced(get_config(ARCH))
    model = build_model(cfg, device="cpu")
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    for r in ranks:
        assert len(r["launcher_losses"]) == 3 and np.isfinite(r["launcher_losses"]).all()
        assert int(r["launcher_all_reduce_payload"]) == param_bytes + 4
    assert all(np.array_equal(r["launcher_losses"], ranks[0]["launcher_losses"]) for r in ranks)


def test_four_rank_priced_bytes_cover_the_local_shards(four_ranks):
    """The reduced LM traced on ``{data: 4}`` and run node by node on
    DTensors: on every rank each graph node's local bytes are within its
    priced per-device ``M_v`` (the spec rules never under-estimate), and
    here equal to it: the reshape, embedding and slice rules follow the
    batch's shards as DTensor does."""
    for r in four_ranks[-1]:
        local, priced = r["local_bytes"], r["priced_mem_v"]
        over = np.flatnonzero(local > priced)
        assert over.size == 0, [(int(i), int(local[i]), int(priced[i])) for i in over[:10]]
        assert np.array_equal(local, priced), np.flatnonzero(local != priced)


def test_four_rank_live_bytes_stay_within_the_plan_peak(four_ranks):
    """The interpreter's live-byte audit of the planned reduced LM on the
    mesh counts local shards, within the plan's per-device peak."""
    for r in four_ranks[-1]:
        assert 0 < int(r["live_peak"]) <= int(r["plan_peak"])


def test_four_rank_launcher_resumes_from_rank_zeros_checkpoints(four_ranks):
    """Under the group only rank 0 writes checkpoints, each committed before
    any rank returns (no torn ``.tmp`` directory); with steps 2 and 3 gone,
    the same command resumes from step 1 on every rank and repeats the
    first run's steps 2 and 3 bitwise (parameters and AdamW moments
    restored)."""
    for r in four_ranks[-1]:
        assert list(r["ckpt_dirs"]) == [f"step_{s:09d}" for s in (1, 2, 3)]
        assert int(r["ckpt_latest"]) == 3
        assert np.array_equal(r["resumed_losses"], r["launcher_losses"][1:])
        assert np.array_equal(r["resumed_grad_norms"], r["launcher_grad_norms"][1:])
