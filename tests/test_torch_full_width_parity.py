"""The port's Trainer against the reference's at full stablelm-3b width.

Opt-in: it runs only with ``REPRO_FULL_WIDTH_PARITY=1`` and is not part of
the tier-1 run.  It takes minutes and about 15 GB of host memory at 2
units, more at 4:

    REPRO_FULL_WIDTH_PARITY=1 PYTHONPATH=src JAX_PLATFORMS=cpu \\
        python -m pytest -q -s tests/test_torch_full_width_parity.py

Both Trainers run stablelm-3b at full width (d_model 2560, 32 heads,
d_ff 6912, vocab 50304) with depth cut to 2 units (and to 4, where the
port's launcher on its own init rises by 1.5 at step 2 on the card,
``tests/test_torch_launcher_depth.py``), batch 2 × seq 1024, on
the CPU, for 3 steps with the training launcher's schedule
(``launch/train.py``: lr 3e-4, warmup ``max(2, steps // 10)`` = 2,
``total_steps`` 3) and its seed (the reference's ``PRNGKey(0)`` weights,
loaded into the port; the synthetic pipeline's batches 0-2).  Losses and
grad norms must agree to rtol 1e-3 with f32 activations, and to the
repo's bf16 tolerance, 2e-2, with the launcher's bf16 activations (f32
master weights on both sides).  The losses are printed, so the run also
shows whether the reference's loss rises after step 1 at this width as the
port's launcher does on the card.
"""

import dataclasses
import gc
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    os.environ.get("REPRO_FULL_WIDTH_PARITY") != "1",
    reason="opt-in: set REPRO_FULL_WIDTH_PARITY=1 (minutes, ~15 GB of host memory)")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as rget_config  # noqa: E402
from repro.data import DataConfig as RDataConfig  # noqa: E402
from repro.data import SyntheticLM as RSyntheticLM  # noqa: E402
from repro.models.transformer import LM as RLM  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.train import TrainConfig as RTrainConfig  # noqa: E402
from repro.train import Trainer as RTrainer  # noqa: E402
from repro_torch.configs import get_config as pget_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

ARCH = "stablelm-3b"
BATCH, SEQ, STEPS = 2, 1024, 3
#: the launcher's schedule at --steps 3
OPT = dict(lr=3e-4, warmup_steps=max(2, STEPS // 10), total_steps=STEPS)


@pytest.mark.parametrize("units,dtype,rtol", [(2, "float32", 1e-3), (2, "bfloat16", 2e-2),
                                               (4, "bfloat16", 2e-2)])
def test_full_width_trainers_agree_over_three_steps(units, dtype, rtol):
    rcfg = dataclasses.replace(rget_config(ARCH), n_layers=units, dtype=dtype)
    pcfg = dataclasses.replace(pget_config(ARCH), n_layers=units, dtype=dtype)
    rlm = RLM(rcfg)
    np_tree = jax.tree_util.tree_map(np.asarray, rlm.init(jax.random.PRNGKey(0)))

    rtr = RTrainer(rlm.loss, jax.tree_util.tree_map(jnp.asarray, np_tree),
                   RTrainConfig(total_steps=STEPS, log_every=0,
                                optimizer=radamw.AdamWConfig(**OPT)),
                   donate=False)
    p, o = rtr.params, rtr.opt_state
    rlosses, rnorms, rlrs = [], [], []
    stream = RSyntheticLM(RDataConfig(vocab_size=rcfg.vocab_size, seq_len=SEQ,
                                      global_batch=BATCH))
    for step in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in stream.batch(step).items()}
        p, o, _, m = rtr._train_step(p, o, None, batch)
        assert bool(m["ok"])
        rlosses.append(float(m["loss"]))
        rnorms.append(float(m["grad_norm"]))
        rlrs.append(float(m["lr"]))
    del rtr, p, o, m, batch
    gc.collect()

    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)  # this test runs alone
    try:
        out = _port_run(pcfg, np_tree)
    finally:
        torch.set_num_threads(threads)
    print(f"\n{units} units {dtype}: reference losses {rlosses} grad norms {rnorms} lr {rlrs}")
    print(f"{units} units {dtype}: port      losses {out['losses']} grad norms "
          f"{out['grad_norms']}")
    assert out["step"] == STEPS and out["skipped"] == 0
    np.testing.assert_allclose(out["losses"], rlosses, rtol=rtol)
    np.testing.assert_allclose(out["grad_norms"], rnorms, rtol=rtol)


def _port_run(pcfg, np_tree):
    plm = build_model(pcfg, device="cpu")
    plm.load_state_dict(params_from_jax(np_tree), strict=True)
    ptr = Trainer(lambda m, b: m.loss(b), plm,
                  TrainConfig(total_steps=STEPS, log_every=0,
                              optimizer=adamw.AdamWConfig(**OPT)),
                  device="cpu")
    return ptr.run(iter(SyntheticLM(DataConfig(pcfg.vocab_size, SEQ, BATCH))))
