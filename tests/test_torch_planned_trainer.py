"""The slice as a whole: the port's ``Trainer(plan_budget=...)`` on the
reduced stablelm-3b LM (2 units, f32, batch 2 × seq 64) on the CPU.

Each planned step takes its loss and gradients from
``repro_torch.plan_function`` over ``functional_call`` of the model.  Three
steps give losses and parameters **bitwise** equal to the port's Trainer
without a budget; they agree with the reference ``Trainer(plan_budget=...)``
on the same weights and batches to rtol 1e-4 (the tolerance of
``tests/test_torch_train.py``).  Each side plans at a budget of its own: the
reference traces the layer stack as one ``scan`` node, so the two graphs,
and the two plans, differ; only values are compared.  The second step
neither re-traces nor re-plans.
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
from repro.data import DataConfig as RDataConfig  # noqa: E402
from repro.data import SyntheticLM as RSyntheticLM  # noqa: E402
from repro.models.transformer import LM as RLM  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.train import TrainConfig as RTrainConfig  # noqa: E402
from repro.train import Trainer as RTrainer  # noqa: E402
from repro_torch.configs import get_config as pget_config  # noqa: E402
from repro_torch.configs import reduced as preduced  # noqa: E402
from repro_torch.core import get_default_planner, vanilla_peak  # noqa: E402
from repro_torch.core.lowering import TracedCarrier  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import TrainConfig, Trainer, functional_loss  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

ARCH = "stablelm-3b"
SEQ, BATCH, STEPS = 64, 2, 3
#: the reference's own budget: above its minimal feasible budget (682,550 B
#: for its scan-level graph at this size)
REFERENCE_BUDGET = 7e5
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)


def loss_fn(model, batch):
    return model.loss(batch)


@pytest.fixture(scope="module")
def weights():
    rcfg = dataclasses.replace(rreduced(rget_config(ARCH)), dtype="float32")
    rlm = RLM(rcfg)
    np_tree = jax.tree_util.tree_map(np.asarray, rlm.init(jax.random.PRNGKey(0)))
    return rcfg, rlm, np_tree


def _port_trainer(np_tree, budget):
    pcfg = dataclasses.replace(preduced(pget_config(ARCH)), dtype="float32")
    model = build_model(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(np_tree), strict=True)
    cfg = TrainConfig(total_steps=STEPS, log_every=0, plan_budget=budget,
                      optimizer=adamw.AdamWConfig(**OPT))
    return Trainer(loss_fn, model, cfg, device="cpu")


def _data(vocab):
    return DataConfig(vocab_size=vocab, seq_len=SEQ, global_batch=BATCH)


def _half_vanilla_budget(tr, vocab):
    """Half the all-cached peak of the port's own traced step graph."""
    batch = tr._to_device(SyntheticLM(_data(vocab)).batch(0))
    fn, params = functional_loss(loss_fn, tr.model)
    g = TracedCarrier.trace(fn, (params, batch)).to_graph()
    return vanilla_peak(g, liveness=False) / 2


def test_planned_trainer_matches_unplanned_and_reference(weights):
    rcfg, rlm, np_tree = weights
    plain = _port_trainer(np_tree, None)
    budget = _half_vanilla_budget(plain, rcfg.vocab_size)
    planned = _port_trainer(np_tree, budget)
    assert planned.planned is not None and plain.planned is None

    out_plain = plain.run(iter(SyntheticLM(_data(rcfg.vocab_size))))
    data = iter(SyntheticLM(_data(rcfg.vocab_size)))
    planned.cfg = dataclasses.replace(planned.cfg, total_steps=1)
    out1 = planned.run(data)
    misses = get_default_planner().cache.stats()["misses"]
    planned.cfg = dataclasses.replace(planned.cfg, total_steps=STEPS)
    out2 = planned.run(data)
    assert get_default_planner().cache.stats()["misses"] == misses  # no re-plan
    assert len(planned.planned._memo) == 1  # no re-trace
    batch = planned._to_device(SyntheticLM(_data(rcfg.vocab_size)).batch(0))
    lowered = planned.planned.lowered_for(functional_loss(loss_fn, planned.model)[1], batch)
    assert lowered.backend == "fx" and lowered.plan.overhead > 0
    assert lowered.plan.peak_memory <= budget

    losses = out1["losses"] + out2["losses"]
    norms = out1["grad_norms"] + out2["grad_norms"]
    assert losses == out_plain["losses"] and norms == out_plain["grad_norms"]
    for a, b in zip(planned.params, plain.params):
        assert torch.equal(a, b)

    rtr = RTrainer(rlm.loss, jax.tree_util.tree_map(jnp.asarray, np_tree),
                   RTrainConfig(total_steps=STEPS, log_every=0, plan_budget=REFERENCE_BUDGET,
                                optimizer=radamw.AdamWConfig(**OPT)),
                   donate=False)
    p, o = rtr.params, rtr.opt_state
    rlosses, rnorms = [], []
    rdata = RSyntheticLM(RDataConfig(vocab_size=rcfg.vocab_size, seq_len=SEQ,
                                     global_batch=BATCH))
    for step in range(STEPS):
        rbatch = {k: jnp.asarray(v) for k, v in rdata.batch(step).items()}
        p, o, _, m = rtr._train_step(p, o, None, rbatch)
        assert bool(m["ok"])
        rlosses.append(float(m["loss"]))
        rnorms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(losses, rlosses, rtol=1e-4)
    np.testing.assert_allclose(norms, rnorms, rtol=1e-4)
