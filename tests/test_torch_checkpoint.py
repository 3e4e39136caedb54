"""The port's checkpoint store and checkpoint/restart in the Trainer
(``tests/test_checkpoint.py`` and ``tests/test_train_loop.py``'s restart
test restated for torch, and held against JAX).

* The store's commit protocol, retention, torn-write recovery and async
  writer behave as the reference's.
* The on-disk format is the reference's: a tree saved by either package
  restores in the other, bf16 and integer leaves included, **bitwise**.
* ``Trainer`` with ``ckpt_dir``: 8 steps against 4 + restore + 4 on the
  reduced LM in f32 on the CPU give **bitwise** the same losses,
  parameters and AdamW moments; a restored Trainer holds the last saved
  parameters.  The launcher's ``--ckpt-dir``/``--ckpt-every`` resumes a
  run where it stopped.
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.checkpointing import restore as rrestore  # noqa: E402
from repro.checkpointing import save as rsave  # noqa: E402
from repro_torch.checkpointing import (  # noqa: E402
    AsyncCheckpointer,
    latest_step,
    restore,
    retain,
    save,
)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402


@pytest.fixture
def tree():
    return {
        "a": torch.arange(12.0).reshape(3, 4),
        "nested": {"b": torch.ones((2, 2), dtype=torch.bfloat16), "c": torch.tensor(7)},
    }


def _assert_trees_equal(got, want):
    gl, wl = torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_roundtrip(tree):
    with tempfile.TemporaryDirectory() as d:
        save(d, 3, tree)
        assert latest_step(d) == 3
        out = restore(d, 3, tree)
        _assert_trees_equal(out, tree)
        assert out["nested"]["b"].dtype == torch.bfloat16


def test_torn_checkpoint_ignored(tree):
    with tempfile.TemporaryDirectory() as d:
        save(d, 1, tree)
        torn = os.path.join(d, "step_000000002")  # a step-2 without COMMITTED
        os.makedirs(torn)
        with open(os.path.join(torn, "MANIFEST.json"), "w") as f:
            f.write("{}")
        assert latest_step(d) == 1


def test_retention(tree):
    with tempfile.TemporaryDirectory() as d:
        for s in range(5):
            save(d, s, tree)
        retain(d, keep=2)
        assert sorted(os.listdir(d)) == ["step_000000003", "step_000000004"]


def test_missing_leaf_raises(tree):
    with tempfile.TemporaryDirectory() as d:
        save(d, 0, {"a": tree["a"]})
        with pytest.raises(KeyError):
            restore(d, 0, tree)


def test_async_checkpointer(tree):
    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d, keep=2)
        for s in (1, 2, 3):
            ck.save_async(s, tree)
        ck.close()
        assert latest_step(d) == 3
        assert sorted(os.listdir(d)) == ["step_000000002", "step_000000003"]
        _assert_trees_equal(restore(d, 3, tree), tree)


def test_async_save_copies_before_it_returns(tree):
    """The port's AdamW updates in place: a tree changed right after
    ``save_async`` returns is saved as it was at the call."""
    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d)
        want = {"a": tree["a"].clone()}
        live = {"a": tree["a"]}
        ck.save_async(1, live)
        live["a"].add_(1.0)
        ck.close()
        _assert_trees_equal(restore(d, 1, want), want)


def test_overwrite_same_step(tree):
    with tempfile.TemporaryDirectory() as d:
        save(d, 1, tree)
        t2 = {**tree, "a": tree["a"] * 2}
        save(d, 1, t2)
        assert torch.equal(restore(d, 1, tree)["a"], t2["a"])


# ---------------------------------------------------------------------------
# The reference's format
# ---------------------------------------------------------------------------


def _np_tree():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(3, 5)).astype(np.float32),
            "layers": [rng.normal(size=(4,)).astype(np.float32) for _ in range(2)],
            "half": rng.normal(size=(2, 3)).astype(np.float32),
            "step": np.int64(42)}


def test_reference_saves_port_restores():
    t = _np_tree()
    jtree = {"w": jnp.asarray(t["w"]), "layers": [jnp.asarray(x) for x in t["layers"]],
             "half": jnp.asarray(t["half"], jnp.bfloat16), "step": jnp.asarray(t["step"])}
    like = {"w": 0, "layers": [0, 0], "half": 0, "step": 0}
    with tempfile.TemporaryDirectory() as d:
        rsave(d, 5, jtree)
        assert latest_step(d) == 5
        got = restore(d, 5, like)
    assert torch.equal(got["w"], torch.tensor(t["w"]))
    for a, b in zip(got["layers"], t["layers"]):
        assert torch.equal(a, torch.tensor(b))
    assert got["half"].dtype == torch.bfloat16
    want_half = np.asarray(jtree["half"].astype(jnp.float32))
    assert torch.equal(got["half"].float(), torch.tensor(want_half))
    assert int(got["step"]) == 42


def test_port_saves_reference_restores():
    t = _np_tree()
    ptree = {"w": torch.tensor(t["w"]), "layers": [torch.tensor(x) for x in t["layers"]],
             "half": torch.tensor(t["half"]).to(torch.bfloat16), "step": 42}
    like = {"w": 0, "layers": [0, 0], "half": 0, "step": 0}
    with tempfile.TemporaryDirectory() as d:
        save(d, 6, ptree)
        got = rrestore(d, 6, like)
        for name in os.listdir(os.path.join(d, "step_000000006")):
            assert name in ("MANIFEST.json", "COMMITTED", "w.npy", "layers_0.npy",
                            "layers_1.npy", "half.npy", "step.npy")
    np.testing.assert_array_equal(got["w"], t["w"])
    for a, b in zip(got["layers"], t["layers"]):
        np.testing.assert_array_equal(a, b)
    assert str(got["half"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(got["half"], np.float32),
                                  ptree["half"].float().numpy())
    assert int(got["step"]) == 42 and got["step"].dtype == np.int64


# ---------------------------------------------------------------------------
# Checkpoint/restart in the Trainer
# ---------------------------------------------------------------------------

OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)


def _trainer(ckpt_dir, total_steps, ckpt_every=4):
    cfg = dataclasses.replace(reduced(get_config("stablelm-3b")), dtype="float32")
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tc = TrainConfig(total_steps=total_steps, log_every=0, ckpt_dir=ckpt_dir,
                     ckpt_every=ckpt_every, optimizer=OPT)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4))
    return Trainer(lambda m, b: m.loss(b), model, tc, device="cpu"), data


def _state(tr):
    st = tr.opt_state
    return [t.clone() for t in tr.params + st.mu + st.nu], st.step


def test_restart_resumes_bitwise():
    """8 uninterrupted steps against 4, a restart from their checkpoint in a
    fresh Trainer, and 4 more on the next batches (``test_train_loop.py``'s
    restart test, made stronger: losses and moments too)."""
    whole, data = _trainer(None, 8)
    out = whole.run(iter(data))
    with tempfile.TemporaryDirectory() as d:
        first, _ = _trainer(d, 4)
        head = first.run(iter(data))
        first.close()
        assert latest_step(d) == 4
        second, _ = _trainer(d, 8)
        assert second.maybe_restore() and second.step == 4
        assert second.opt_state.step == 4
        tail = second.run(data.batch(i) for i in range(4, 8))
        second.close()
    assert head["losses"] + tail["losses"] == out["losses"]
    (got, got_step), (want, want_step) = _state(second), _state(whole)
    assert got_step == want_step == 8
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_checkpoint_restart_resumes_exactly():
    """``tests/test_train_loop.py::test_checkpoint_restart_resumes_exactly``:
    a Trainer restored from a run's directory holds its final parameters."""
    with tempfile.TemporaryDirectory() as d:
        tr, data = _trainer(d, 8, ckpt_every=4)
        tr.run(iter(data))
        tr.close()
        p_end = [p.clone() for p in tr.params]
        assert sorted(os.listdir(d)) == ["step_000000004", "step_000000008"]
        tr2, _ = _trainer(d, 8)
        assert tr2.maybe_restore()
        assert tr2.step == 8
        assert all(torch.equal(a, b) for a, b in zip(tr2.params, p_end))
        tr2.close()


def test_no_checkpoint_to_restore():
    with tempfile.TemporaryDirectory() as d:
        tr, _ = _trainer(d, 2)
        assert not tr.maybe_restore() and tr.step == 0
        tr.close()
    tr, _ = _trainer(None, 2)
    assert not tr.maybe_restore()


def test_launcher_resumes_from_its_checkpoint():
    from repro_torch.launch import train as ptrain

    argv = ["--reduced", "--batch", "2", "--seq", "32", "--device", "cpu"]
    whole = ptrain.main(argv + ["--steps", "4"])
    with tempfile.TemporaryDirectory() as d:
        ck = ["--ckpt-dir", d, "--ckpt-every", "2"]
        head = ptrain.main(argv + ["--steps", "2"] + ck)
        assert latest_step(d) == 2
        tail = ptrain.main(argv + ["--steps", "4"] + ck)
        assert tail["step"] == 4 and latest_step(d) == 4
    # the first two steps ran under the 2-step schedule; at warmup 2 the
    # learning rates of steps 1-2 equal the 4-step run's, so all agree
    assert head["losses"] + tail["losses"] == whole["losses"]
