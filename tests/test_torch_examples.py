"""The torch twins of the four examples (``repro_torch.examples``) against
the reference's ``examples/*.py`` on the CPU.

* ``quickstart``: the same graph (22 nodes), budget, plan (segments,
  analytic peak, overhead) and live-byte audit; the loss on the reference
  example's own arrays to rtol 1e-5 (f32 matmuls in another order).
* ``plan_explorer``: ``--traced demo``, ``--traced bg-demo`` and ``--arch
  stablelm-3b`` print the reference's lines, the solve timings aside and
  the traced backend named by its twin (``"fx"`` for ``"jaxpr"``; the
  BlockGraph's ``"policy"`` is the reference's own name); ``--network``
  raises, naming ROADMAP.md 'Benchmarks + examples'.
* ``train_lm``: the reference's plan line, and after 2 steps (batch 2 ×
  32) on the reference example's initial weights its final loss within
  the bf16 tolerance of the port's tests (2e-2 × max(1, |loss|)).
* ``serve_lm``: on the reference example's weights the greedy requests
  decode the reference's tokens (bf16: their first tokens, and at least
  0.8 of all their tokens).
* Each example runs on CUDA unless given ``--device cpu``, and raises
  without a card.
"""

import contextlib
import importlib.util
import io
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro_torch.examples import plan_explorer, quickstart, serve_lm, train_lm  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
CPU = torch.device("cpu")


def _reference(name: str):
    """Import ``examples/<name>.py`` as a module, capturing what it prints."""
    spec = importlib.util.spec_from_file_location(f"reference_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        spec.loader.exec_module(mod)
    return mod, out.getvalue()


def _printed(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args, **kw)
    return res, out.getvalue()


def test_quickstart_prints_the_reference_plan_on_its_arrays():
    ref, text = _reference("quickstart")
    params = [np.asarray(w) for w in ref.params]
    lines = []
    got = quickstart.run(params, np.asarray(ref.x), CPU, log=lines.append)
    want = [ln for ln in text.splitlines() if not ln.startswith("loss ")]
    mine = [ln for ln in lines if not ln.startswith("loss ")]
    assert mine == [ln.replace("'jaxpr'", "'fx'") for ln in want]
    assert got["nodes"] == ref.g.n and got["segments"] == len(ref.lowered.plan.segments)
    np.testing.assert_allclose(got["loss"], float(ref.loss), rtol=1e-5)


@pytest.mark.parametrize("argv", [["--traced", "demo"], ["--traced", "bg-demo"],
                                  ["--arch", "stablelm-3b"]])
def test_plan_explorer_prints_the_reference_frontier(argv, monkeypatch):
    ref, _ = _reference("plan_explorer")
    monkeypatch.setattr("sys.argv", ["plan_explorer.py", *argv])
    _, want = _printed(ref.main)
    _, got = _printed(plan_explorer.main, [*argv, "--device", "cpu"])

    def lines(text):
        return [ln for ln in text.splitlines() if not ln.startswith("solve_grid:")]

    assert lines(got) == [ln.replace("'jaxpr'", "'fx'") for ln in lines(want)]


def test_plan_explorer_network_raises():
    with pytest.raises(NotImplementedError, match="Benchmarks \\+ examples"):
        plan_explorer.main(["--network", "unet", "--device", "cpu"])


def test_train_lm_plans_and_trains_as_the_reference(tmp_path):
    from repro.models import build_model as rbuild_model

    ref, _ = _reference("train_lm")
    argv = ["--steps", "2", "--batch", "2", "--seq", "32", "--ckpt-dir", ""]
    _, want = _printed(ref.main, argv)
    np_tree = jax.tree_util.tree_map(
        np.asarray, rbuild_model(ref.config_100m()).init(jax.random.PRNGKey(0)))
    out, got = _printed(train_lm.main, [*argv, "--device", "cpu"],
                        weights=params_from_jax(np_tree))
    want_lines, got_lines = want.splitlines(), got.splitlines()
    assert got_lines[:2] == want_lines[:2]  # the model and the plan
    want_loss = float(re.search(r"final loss (\S+)", want).group(1))
    assert out["step"] == 2 and out["skipped"] == 0
    assert abs(out["final_loss"] - want_loss) <= 2e-2 * max(1.0, abs(want_loss))


def test_serve_lm_greedy_requests_decode_the_reference_tokens():
    from repro.configs import get_config as rget_config
    from repro.configs import reduced as rreduced
    from repro.models import build_model as rbuild_model

    ref, _ = _reference("serve_lm")
    _, want = _printed(ref.main)
    cfg = rreduced(rget_config("qwen2.5-14b"), n_layers=4, d_model=128)
    np_tree = jax.tree_util.tree_map(np.asarray, rbuild_model(cfg).init(jax.random.PRNGKey(0)))
    out, _ = _printed(serve_lm.main, ["--device", "cpu"], weights=params_from_jax(np_tree))
    ref_out = {int(m.group(1)): [int(t) for t in re.findall(r"\d+", m.group(2))]
               for m in re.finditer(r"req (\d+): prompt\[\d+ toks\] → \[(.*)\]", want)}
    greedy = [uid for uid, (_, _, temp) in enumerate(serve_lm.workload()) if temp == 0.0]
    assert len(ref_out) == len(out["outputs"]) == 6
    assert all(len(out["outputs"][u]) == len(ref_out[u]) for u in ref_out)
    # bf16 weights and activations: a near tie may flip a later token and
    # the continuation with it, so the first tokens agree and the greedy
    # tokens agree at least 0.8 of the time (the bf16 decode bound of
    # chip_smoke.py's teacher forcing)
    assert all(out["outputs"][u][0] == ref_out[u][0] for u in greedy)
    same = [a == b for u in greedy for a, b in zip(out["outputs"][u], ref_out[u])]
    assert np.mean(same) >= 0.8, same


@pytest.mark.parametrize("example", [quickstart, train_lm, serve_lm, plan_explorer])
def test_examples_default_to_cuda(example, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    argv = ["--traced", "demo"] if example is plan_explorer else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(argv)
