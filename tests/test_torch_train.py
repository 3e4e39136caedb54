"""The port's data pipeline, AdamW, Trainer and launcher against the reference.

Batches of the synthetic pipeline are bitwise the reference's; one AdamW
update on random trees agrees to 1e-6; three Trainer steps of reduced
stablelm-3b in f32, from the same init and data, give the reference's losses
and grad-norms to rtol 1e-4; the NaN guard skips a poisoned step; and the
launcher runs on the CPU with the reference launcher's plan.
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
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.data import DataConfig as RDataConfig  # noqa: E402
from repro.data import SyntheticLM as RSyntheticLM  # noqa: E402
from repro.data import global_batch_for_test as rglobal_batch  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.steps import segment_plan as rsegment_plan  # noqa: E402
from repro.models.transformer import LM as RLM  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.train import TrainConfig as RTrainConfig  # noqa: E402
from repro.train import Trainer as RTrainer  # noqa: E402
from repro_torch.configs import get_config as pget_config  # noqa: E402
from repro_torch.configs import reduced as preduced  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM, global_batch_for_test  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

ARCH = "stablelm-3b"
SEQ, BATCH, STEPS = 32, 4, 3


@pytest.mark.parametrize("vocab,seq,batch,hosts", [
    (256, 32, 4, 1), (50304, 64, 2, 1), (1000, 48, 6, 3),
])
def test_synthetic_batches_are_bitwise_the_reference(vocab, seq, batch, hosts):
    for host in range(hosts):
        kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch,
                  num_hosts=hosts, host_id=host)
        ref, port = RSyntheticLM(RDataConfig(**kw)), SyntheticLM(DataConfig(**kw))
        for step in (0, 1, 7):
            want, got = ref.batch(step), port.batch(step)
            assert want.keys() == got.keys()
            for key in want:
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, num_hosts=hosts)
    want = rglobal_batch(RDataConfig(**kw), 2)
    got = global_batch_for_test(DataConfig(**kw), 2)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("clip_norm,weight_decay", [(1.0, 0.1), (None, 0.0), (1e3, 0.1)])
def test_adamw_update_matches_reference(clip_norm, weight_decay):
    """Three updates on a random tree of 1-D and 2-D leaves: params and both
    moments agree with the reference to 1e-6."""
    rng = np.random.default_rng(11)
    shapes = [(8,), (8, 16), (3, 4, 5), (32,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
             for _ in range(3)]
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=clip_norm,
               weight_decay=weight_decay)

    rcfg = radamw.AdamWConfig(**cfg)
    rp = [jnp.asarray(p) for p in params]
    rstate = radamw.init(rp)
    pcfg = adamw.AdamWConfig(**cfg)
    pp = [torch.tensor(p) for p in params]
    pstate = adamw.init(pp)
    for g in grads:
        rp, rstate, rm = radamw.update(rcfg, [jnp.asarray(x) for x in g], rstate, rp)
        pm = adamw.update(pcfg, [torch.tensor(x) for x in g], pstate, pp)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(pm["lr"], float(rm["lr"]), rtol=1e-6)
    assert pstate.step == int(rstate.step)
    for got, want in ((pp, rp), (pstate.mu, rstate.mu), (pstate.nu, rstate.nu)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def _small():
    """Reduced stablelm-3b in f32 on both sides, on the reference's weights."""
    rcfg = dataclasses.replace(rreduced(rget_config(ARCH)), dtype="float32")
    pcfg = dataclasses.replace(preduced(pget_config(ARCH)), dtype="float32")
    rlm = RLM(rcfg)
    np_tree = jax.tree_util.tree_map(np.asarray, rlm.init(jax.random.PRNGKey(0)))
    plm = build_model(pcfg, device="cpu")
    plm.load_state_dict(params_from_jax(np_tree), strict=True)
    return rcfg, rlm, np_tree, plm


def _opt():
    return dict(lr=1e-3, warmup_steps=2, total_steps=8)


def test_trainer_three_steps_match_reference():
    rcfg, rlm, np_tree, plm = _small()
    data = DataConfig(vocab_size=rcfg.vocab_size, seq_len=SEQ, global_batch=BATCH)

    # the reference Trainer's jitted step, driven step by step for its metrics
    rtr = RTrainer(rlm.loss, jax.tree_util.tree_map(jnp.asarray, np_tree),
                   RTrainConfig(total_steps=STEPS, log_every=0,
                                optimizer=radamw.AdamWConfig(**_opt())),
                   donate=False)
    p, o = rtr.params, rtr.opt_state
    rlosses, rnorms = [], []
    for step in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in RSyntheticLM(RDataConfig(
            vocab_size=rcfg.vocab_size, seq_len=SEQ, global_batch=BATCH)).batch(step).items()}
        p, o, _, m = rtr._train_step(p, o, None, batch)
        assert bool(m["ok"])
        rlosses.append(float(m["loss"]))
        rnorms.append(float(m["grad_norm"]))

    ptr = Trainer(lambda m, b: m.loss(b), plm,
                  TrainConfig(total_steps=STEPS, log_every=0,
                              optimizer=adamw.AdamWConfig(**_opt())),
                  device="cpu")
    out = ptr.run(iter(SyntheticLM(data)))
    assert out["step"] == STEPS and out["skipped"] == 0
    np.testing.assert_allclose(out["losses"], rlosses, rtol=1e-4)
    np.testing.assert_allclose(out["grad_norms"], rnorms, rtol=1e-4)


def test_nan_guard_skips_the_step():
    """A non-finite loss leaves parameters and optimizer state untouched and
    counts a skip; the finite steps around it still update."""
    rcfg, _, _, plm = _small()
    calls = []

    def poisoned(m, batch):
        calls.append(None)
        loss = m.loss(batch)
        return loss * float("nan") if len(calls) == 2 else loss

    tr = Trainer(poisoned, plm, TrainConfig(total_steps=1, log_every=0,
                                            optimizer=adamw.AdamWConfig(**_opt())),
                 device="cpu")
    data = iter(SyntheticLM(DataConfig(rcfg.vocab_size, SEQ, BATCH)))
    tr.run(data)
    before = [p.detach().clone() for p in tr.params]
    mu = [m.clone() for m in tr.opt_state.mu]
    tr.cfg = dataclasses.replace(tr.cfg, total_steps=2)
    out = tr.run(data)
    assert out["skipped"] == 1 and tr.opt_state.step == 1
    assert not np.isfinite(out["losses"][-1])
    for a, b in zip(tr.params, before):
        assert torch.equal(a, b)
    for a, b in zip(tr.opt_state.mu, mu):
        assert torch.equal(a, b)
    tr.cfg = dataclasses.replace(tr.cfg, total_steps=3)
    out = tr.run(data)
    assert out["skipped"] == 1 and tr.opt_state.step == 2
    assert any(not torch.equal(a, b) for a, b in zip(tr.params, before))
    for p in tr.params:
        assert torch.isfinite(p).all()


def test_trainer_raises_for_what_is_not_ported():
    """``compress_grads``, ``mesh=`` and the model axis are ported
    (``tests/test_torch_distributed_train.py``,
    ``tests/test_torch_model_axis.py``); a mesh axis beyond pod, data and
    model (a pipeline's stages) is not."""
    _, _, _, plm = _small()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Trainer(lambda m, b: m.loss(b), plm, TrainConfig(compress_grads=True), device="cpu",
                mesh={"data": 1, "stage": 2})


def test_launcher_runs_on_cpu_with_the_reference_plan():
    out = ptrain.main(["--reduced", "--steps", "3", "--device", "cpu"])
    assert out["step"] == 3 and out["skipped"] == 0
    assert all(np.isfinite(out["losses"]))
    rsp, rres = rsegment_plan(rreduced(rget_config(ARCH)), RShape("cli", 256, 8, "train"),
                              make_host_mesh())
    sp, res = out["plan"], out["plan_result"]
    assert dataclasses.asdict(sp) == dataclasses.asdict(rsp)
    assert res.sequence == rres.sequence
    assert (res.overhead, res.peak_memory, res.feasible) == (
        rres.overhead, rres.peak_memory, rres.feasible)
