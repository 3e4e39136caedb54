"""The paper's seven benchmark networks in the port
(``repro_torch.configs.paper_networks``) against the reference's
``benchmarks/networks.py``, and ``plan_lint`` / ``plan_explorer`` over them.

* Every graph bitwise the reference's: ``graph_digest``, node count, edges,
  ``T_v``, ``M_v`` and kinds; ``SETTINGS``, ``NETWORKS`` and
  ``PAPER_NODE_COUNTS`` as the reference has them (densenet161 and pspnet
  build 478 and 196 nodes against Table 1's 568 and 385, in both).
* The executable twin's loss and gradients against the reference's twin
  under ``jax.value_and_grad``, on the same numpy weights and input, f32:
  rtol 1e-5 with an absolute limit of 1e-5 × the leaf's largest value, on
  vgg19 (a chain), unet (skips) and googlenet (branches: the mean of
  several inputs).
* Each node of the twin one autograd op whose gradients are bitwise those
  of its ops (the mean of several inputs, ``tanh``, the scale, ``mm``)
  under plain autograd.
* The twin under the exact minimal budget's plan (the ``"policy"``
  backend, one block a node) bitwise plain autograd in the plan's order,
  its backward rerunning the values of exactly the plan's V \\ U_k.
* ``plan_lint --network`` with ``--device cpu``: exit 0 and the reference
  CLI's ``--json`` findings (timings dropped) on unet and vgg19; an
  infeasible ``--budget`` exits 2 with the reference's line; ``--hlo
  --network vgg19`` writes one drift record; ``--smoke`` lints the seven
  networks and the quickstart.
* ``plan_explorer --network unet`` prints the reference's frontier, the
  solve timings aside.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

rnet = pytest.importorskip("benchmarks.networks")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis.cli import main as rlint  # noqa: E402
from repro.core.graph import graph_digest as rdigest  # noqa: E402
from repro_torch.analysis.census import CountOps  # noqa: E402
from repro_torch.analysis.cli import main as lint  # noqa: E402
from repro_torch.configs import paper_networks as pnet  # noqa: E402
from repro_torch.core import get_default_planner  # noqa: E402
from repro_torch.core.graph import graph_digest  # noqa: E402
from repro_torch.examples import plan_explorer  # noqa: E402

ALL = sorted(rnet.NETWORKS)
#: networks small enough to plan and run in a few seconds here
SMALL = ["vgg19", "unet", "googlenet", "resnet50", "pspnet"]
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args)
    return res, out.getvalue()


def _twin_inputs(g, batch=4, width=16, seed=0):
    rng = np.random.default_rng(seed)
    params = {str(v): (rng.standard_normal((width, width)) * width ** -0.5).astype(np.float32)
              for v in range(g.n) if g.nodes[v].kind == "conv"}
    return params, rng.standard_normal((batch, width)).astype(np.float32)


def _torch(params, x):
    return {k: torch.tensor(v) for k, v in params.items()}, torch.tensor(x)


# ----------------------------------------------------------------- graphs


def test_the_module_is_the_references():
    assert pnet.SETTINGS == rnet.SETTINGS
    assert pnet.PAPER_NODE_COUNTS == rnet.PAPER_NODE_COUNTS
    assert list(pnet.NETWORKS) == list(rnet.NETWORKS)
    counts = {name: pnet.NETWORKS[name]().n for name in ("densenet161", "pspnet")}
    assert counts == {"densenet161": 478, "pspnet": 196}  # not Table 1's: copied as built


@pytest.mark.parametrize("name", ALL)
def test_graph_is_bitwise_the_references(name):
    g, r = pnet.NETWORKS[name](), rnet.NETWORKS[name]()
    assert graph_digest(g) == rdigest(r)
    assert g.n == r.n and sorted(g.edges) == sorted(r.edges)
    for a, b in zip(g.nodes, r.nodes):
        assert (a.idx, a.name, a.time, a.memory, a.kind) == (b.idx, b.name, b.time, b.memory,
                                                             b.kind)


# ------------------------------------------------------------------- twin


@pytest.mark.parametrize("name", ["vgg19", "unet", "googlenet"])
def test_twin_matches_the_references_twin(name):
    g = pnet.NETWORKS[name]()
    params, x = _twin_inputs(g)
    rfwd, _, rbytes = rnet.executable_twin(rnet.NETWORKS[name]())
    loss, grads = jax.value_and_grad(rfwd)({k: jnp.asarray(v) for k, v in params.items()},
                                           jnp.asarray(x))
    fwd, (ex_params, ex_x), byte_graph = pnet.executable_twin(g)
    assert ex_params.keys() == params.keys() and ex_x.shape == x.shape
    assert graph_digest(byte_graph) == rdigest(rbytes)
    P, X = _torch(params, x)
    ploss, pgrads = pnet.twin_value_and_grad(g)(P, X)
    assert torch.equal(ploss, fwd(P, X))  # the BlockGraph is the index-order twin
    np.testing.assert_allclose(float(ploss), float(loss), rtol=1e-5)
    assert pgrads.keys() == grads.keys()
    for k, want in grads.items():
        want = np.asarray(want)
        np.testing.assert_allclose(pgrads[k].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=k)


def _chain_loss(g, params, x):
    """The twin's arithmetic as plain torch ops (what each node op saves
    aside)."""
    vals = {}
    for v in range(g.n):
        c, preds = 1.0 + 0.003 * v, g.pred[v]
        h = (x * c if not preds else vals[preds[0]] if len(preds) == 1
             else torch.stack([vals[p] for p in preds]).mean(0))
        vals[v] = h @ params[str(v)] if g.nodes[v].kind == "conv" else torch.tanh(h) * c
    out = 0.0
    for v in range(g.n):
        if not g.succ[v]:
            out = out + (vals[v] * vals[v]).sum()
    return out


@pytest.mark.parametrize("name", ["vgg19", "googlenet", "pspnet"])
def test_node_ops_are_bitwise_their_ops_under_plain_autograd(name):
    g = pnet.NETWORKS[name]()
    P, X = _torch(*_twin_inputs(g, seed=2))
    loss, grads = pnet.twin_value_and_grad(g)(P, X)
    leaves = {k: t.clone().requires_grad_() for k, t in P.items()}
    want = _chain_loss(g, leaves, X)
    want_grads = torch.autograd.grad(want, list(leaves.values()))
    assert torch.equal(loss, want.detach())
    assert all(torch.equal(grads[k], w) for k, w in zip(leaves, want_grads))


@pytest.mark.parametrize("name", SMALL)
def test_planned_twin_is_bitwise_plain_autograd(name):
    g = pnet.NETWORKS[name]()
    plan = get_default_planner().plan(g, None).plan  # the exact minimal budget
    P, X = _torch(*_twin_inputs(g, seed=1))
    planned = pnet.twin_value_and_grad(g, plan)
    with CountOps(planned.node_now) as ops:
        loss, grads = planned(P, X)
    want_loss, want = pnet.twin_value_and_grad(g, order=pnet.plan_order(plan))(P, X)
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(grads[k], want[k]) for k in want)
    # the backward makes again the values of exactly V \ U_k
    assert set(ops.rerun) == set(range(g.n)) - plan.cached


# -------------------------------------------------------------------- CLI


def _findings(path):
    data = json.loads(Path(path).read_text())
    for t in data["targets"]:
        t.pop("seconds")
    return data


@pytest.mark.parametrize("name", ["unet", "vgg19"])
def test_plan_lint_network_is_the_references(name, tmp_path):
    mine, ref = tmp_path / "mine.json", tmp_path / "ref.json"
    assert lint(["--network", name, "--json", str(mine), "--device", "cpu"]) == 0
    assert rlint(["--network", name, "--json", str(ref)]) == 0
    assert _findings(mine) == _findings(ref)


def test_plan_lint_infeasible_budget_prints_the_references_minimum(capsys):
    argv = ["--network", "unet", "--budget", "1e9"]
    assert rlint(argv) == 2
    want = [ln for ln in capsys.readouterr().out.splitlines() if "infeasible-budget" in ln]
    assert lint([*argv, "--device", "cpu"]) == 2
    got = [ln for ln in capsys.readouterr().out.splitlines() if "infeasible-budget" in ln]
    assert got == want and "the exact minimal feasible budget is" in got[0]


def test_plan_lint_hlo_network_writes_its_drift_record(tmp_path):
    drift = tmp_path / "drift.json"
    assert lint(["--hlo", "--network", "vgg19", "--drift-json", str(drift),
                 "--json", str(tmp_path / "lint.json"), "--device", "cpu"]) == 0
    (rec,) = json.loads(drift.read_text())["records"]
    assert rec["target"] == "vgg19" and rec["nodes"] == pnet.vgg19().n
    assert rec["heavy_measured"] <= rec["heavy_expected"]
    assert "temp_bytes" not in rec  # the CPU allocator keeps no statistics
    (target,) = json.loads((tmp_path / "lint.json").read_text())["targets"]
    codes = {f["code"] for r in target["reports"] for f in r["findings"]}
    assert "memory-analysis-unavailable" in codes


def test_plan_lint_smoke_lints_every_network_and_the_quickstart(tmp_path):
    out = tmp_path / "lint.json"
    assert lint(["--smoke", "--json", str(out), "--device", "cpu"]) == 0
    targets = [t["target"] for t in json.loads(out.read_text())["targets"]]
    assert targets == [*ALL, "quickstart"]


# ---------------------------------------------------------- plan explorer


def test_plan_explorer_network_prints_the_reference_frontier(monkeypatch):
    spec = importlib.util.spec_from_file_location("reference_example_plan_explorer",
                                                  EXAMPLES / "plan_explorer.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    monkeypatch.setattr("sys.argv", ["plan_explorer.py", "--network", "unet"])
    _, want = _printed(ref.main)
    _, got = _printed(plan_explorer.main, ["--network", "unet", "--device", "cpu"])

    def lines(text):
        return [ln for ln in text.splitlines() if not ln.startswith("solve_grid:")]

    assert lines(got)[0] == "network unet:"
    assert lines(got) == lines(want)
