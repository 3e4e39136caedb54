"""Faults planted under the timed path, to show that the comparison
catches them (``perfbench/tests/test_correctness.py`` on the CPU, and
``perfbench/readings.py`` at a cell's size on the card).  Each is a context
manager that patches the program while it is open.

* ``unchanged``: the step returns its state unchanged (AdamW skipped);
* ``half_batch``: half of the batch left out, the mean taken over the
  rest (the first half of every row's positions);
* ``altered``: the step's answer altered where it is produced (the loss
  the model returns, and so its gradients, 1% high).

A training cell on one card has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def unchanged():
    from repro_torch.optim import adamw
    from repro_torch.train.loop import Trainer

    def skip(self, grads, gnorm):
        return adamw.lr_schedule(self.cfg.optimizer, self.opt_state.step + 1)

    return _patched(Trainer, "_update", skip)


def half_batch():
    from repro_torch.train.loop import Trainer

    whole = Trainer.train_step

    def half(self, batch):
        S = batch["tokens"].shape[1]
        return whole(self, {k: v[:, :S // 2] for k, v in batch.items()})

    return _patched(Trainer, "train_step", half)


def altered():
    from repro_torch.models.transformer import LM

    true_loss = LM.loss

    def loss(self, *a, **kw):
        return true_loss(self, *a, **kw) * 1.01

    return _patched(LM, "loss", loss)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}
