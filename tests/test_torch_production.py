"""The production meshes: ``launch.steps``' builders, ``launch.mesh``'s fake
production meshes, the dry run's records and the train-step knobs, held
against the reference (one process; a fake group is started and destroyed
inside each test that needs one).

* ``build_step``'s in- and out-shardings for every (arch × shape) cell the
  reference does not skip, on ``{data: 16, model: 16}`` and ``{pod: 2,
  data: 16, model: 16}``, under opts ``()``, ``("dp_only",)`` and
  ``("dp_attn",)`` (train) and ``("ws",)`` (decode), spec for spec against
  the reference's ``build_step`` on an abstract mesh (no device): each
  parameter by the port's name (a stacked leaf's spec without its unit
  axis; whisper's layers, which the reference's rule does not read as
  stacked, by the per-layer rule), AdamW's state, the batch, the caches,
  the tokens and positions, the logits and metrics;
* the fake production meshes (256 and 512 ranks) and the dry run's record
  of a reduced cell on a fake ``{data: 2, model: 2}`` group: rank 0's
  argument bytes are its shards', and the CLI's exit status;
* ``fx_totals`` of the reduced stablelm prefill cell: the matmuls' FLOPs
  equal the reference's ``jaxpr_totals`` of its dot_generals exactly; the
  flash op counts the causal half of the (S, S) products, which the
  reference's dense attention on the CPU multiplies whole (ROADMAP §3);
* ``"mp"``: one Trainer step on a bf16 compute copy against the
  reference's ``build_train_step(opts=("mp",))`` (loss, grad norm, the
  updated parameters) and its gradients, at the bf16 tolerance 2e-2 with
  an absolute floor of 2e-2 × the tensor's largest magnitude;
* ``"rs"``: the collective counter shows the FSDP gradients reduce-
  scattered onto their shards, and no all-reduce of them.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import SHAPES as RSHAPES  # noqa: E402
from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import reduced as rreduced  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.parallel import sharding as rsh  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, get_config, reduced  # noqa: E402
from repro_torch.launch import dryrun, specs, steps  # noqa: E402
from repro_torch.launch.mesh import (REFERENCE_HBM_BYTES, fake_group, make_fake_mesh,  # noqa: E402
                                     make_production_mesh, mesh_num_devices)
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.weights import _stacked_key, params_from_jax  # noqa: E402

MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}
TOL = 2e-2


class _Mesh(AbstractMesh):
    """An abstract mesh with the ``devices`` shape the reference reads."""

    @property
    def devices(self):
        return np.empty(self.axis_sizes, dtype=object)


def _canon(spec):
    out = []
    for e in tuple(spec):
        if isinstance(e, (tuple, list)):
            e = None if not e else (e[0] if len(e) == 1 else tuple(e))
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _ref_leaves(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp): _canon(v.spec)
            for kp, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = _canon(v)
    return out


def _same_params(cfg, sizes, port, ref, opts=()):
    """Each port-named parameter spec against its reference leaf's: a
    stacked leaf's without its unit axis, which only ``"dp_only"``'s
    second FSDP extension splits (over ``model``, on a stack of vectors:
    a port layer is one module, whole on its ranks; ROADMAP §3)."""
    want = _ref_leaves(ref)
    per_layer = specs.param_shardings(cfg, sizes, dict(specs._meta_model(cfg).named_parameters()))
    assert len(port) == len(per_layer)
    for name, spec in port.items():
        top = _stacked_key(name)
        if top in ("encoder", "decoder"):
            assert spec == per_layer[name], name
        elif top:
            rest = name[len(top) + 1:].split(".", 1)[1]
            ref_spec = want[f"{top}/{rest.replace('.', '/')}"] + (None,)
            assert ref_spec[0] in ((None, "model") if "dp_only" in opts else (None,)), name
            assert _canon(spec) == _canon(ref_spec[1:]), name
        else:
            assert _canon(spec) == want[name.replace(".", "/")], name


@pytest.fixture(scope="module", autouse=True)
def cached_reference_trees():
    """The reference's parameter and cache trees (shape stand-ins, which
    its builders never change) built once a config for this module."""
    import functools

    saved = rspecs.params_specs, rspecs.cache_specs
    rspecs.params_specs = functools.lru_cache(maxsize=None)(saved[0])
    rspecs.cache_specs = functools.lru_cache(maxsize=None)(saved[1])
    yield
    rspecs.params_specs, rspecs.cache_specs = saved


@pytest.fixture(autouse=True)
def default_rules():
    """Both packages' rules tables start and end each test at the default
    (a builder sets them module-wide, as the reference's do)."""
    sh.set_rules(sh.DEFAULT_RULES)
    rsh.set_rules(rsh.DEFAULT_RULES)
    yield
    sh.set_rules(sh.DEFAULT_RULES)
    rsh.set_rules(rsh.DEFAULT_RULES)


def _cells():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            if dryrun.skip_reason(cfg, shape) is not None:
                continue
            options = {"train": [(), ("dp_only",), ("dp_attn",)], "prefill": [()],
                       "decode": [(), ("ws",)]}[shape.kind]
            for mesh in MESHES:
                for opts in options:
                    yield pytest.param(arch, name, mesh, opts,
                                       id=f"{arch}-{name}-{mesh}-{'+'.join(opts) or 'base'}")


@pytest.mark.parametrize("arch, shape_name, mesh_name, opts", list(_cells()))
def test_build_step_shardings_are_the_reference_builders(arch, shape_name, mesh_name, opts):
    sizes = MESHES[mesh_name]
    rmesh = _Mesh(tuple(sizes.values()), tuple(sizes))
    cfg, shape = get_config(arch), SHAPES[shape_name]
    rcfg, rshape = rget_config(arch), RSHAPES[shape_name]
    # a given segmentation skips the plan: the shardings do not read it
    kw = {"segment_sizes": (cfg.n_layers,)} if shape.kind == "train" else {}
    _, r_in, r_out, _ = rsteps.build_step(rcfg, rshape, rmesh, opts=opts, **kw)
    _, p_in, p_out, example = steps.build_step(cfg, shape, sizes, opts=opts, **kw)
    assert sh.get_rules() == dict(rsh.get_rules())
    _same_params(cfg, sizes, p_in[0], r_in[0], opts)
    if shape.kind == "train":
        _same_params(cfg, sizes, p_in[1]["mu"], r_in[1].mu, opts)
        _same_params(cfg, sizes, p_in[1]["nu"], r_in[1].nu, opts)
        assert _canon(p_in[1]["step"]) == _canon(r_in[1].step.spec) == ()
        assert _port_leaves(p_in[2]) == _ref_leaves(r_in[2])
        _same_params(cfg, sizes, p_out[0], r_out[0], opts)
        assert _port_leaves(p_out[2]) == _ref_leaves(r_out[2])
        assert set(example[0]) == set(p_in[0]) and set(example[2]) == set(p_in[2])
    elif shape.kind == "prefill":
        assert _port_leaves(p_in[1]) == _ref_leaves(r_in[1])
        assert _canon(p_out) == _canon(r_out.spec)
    else:
        assert _port_leaves(p_in[1]) == _ref_leaves(r_in[1])
        assert _canon(p_in[2]) == _canon(r_in[2].spec)
        assert _canon(p_in[3]) == _canon(r_in[3].spec)
        assert _canon(p_out[0]) == _canon(r_out[0].spec)
        assert _port_leaves(p_out[1]) == _ref_leaves(r_out[1])
        assert example[2].shape == (shape.global_batch, 1)


def test_ws_keeps_the_used_axis_rule():
    """Under ``"ws"`` the logical ``model`` axis maps to ``data``: a
    residual whose batch takes ``data`` keeps its features whole (an axis
    a tensor already uses is dropped), one whose batch does not divide
    splits them, as the reference's ``resolve_spec``."""
    steps.build_decode_step(get_config("stablelm-3b"), SHAPES["decode_32k"],
                            MESHES["single"], opts=("ws",))
    rsteps.build_decode_step(rget_config("stablelm-3b"), RSHAPES["decode_32k"],
                             _Mesh((16, 16), ("data", "model")), opts=("ws",))
    for shape in ((128, 1, 2560), (1, 1, 2560)):
        got = sh.resolve_spec(("batch", None, "model"), MESHES["single"], shape=shape)
        want = rsh.resolve_spec(("batch", None, "model"), MESHES["single"], shape=shape)
        assert _canon(got) == _canon(want)
    assert sh.resolve_spec(("batch", None, "model"), MESHES["single"],
                           shape=(1, 1, 2560)) == (None, None, "data")


# ---------------------------------------------------------------------------
# The fake production meshes and the dry run's record
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi", [False, True])
def test_production_meshes_over_a_fake_group(multi):
    world = 512 if multi else 256
    with fake_group(world):
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh_num_devices(mesh) == world
        assert tuple(mesh.mesh_dim_names) == (("pod",) if multi else ()) + ("data", "model")
        assert mesh.get_group("model").size() == 16
    assert not torch.distributed.is_initialized()


def test_skipped_cells_carry_the_references_reasons():
    cells = {(a, s): dryrun.run_cell(a, s, "single", trace=False)
             for a in ARCH_IDS for s in ("long_500k",)}
    skipped = {k: r["reason"] for k, r in cells.items() if r["status"] == "skipped"}
    assert skipped[("stablelm-3b", "long_500k")] == dryrun.SKIP_LONG
    assert skipped[("whisper-small", "long_500k")] == dryrun.SKIP_LONG
    assert ("zamba2-2.7b", "long_500k") not in skipped
    assert ("xlstm-1.3b", "long_500k") not in skipped


def _small(arch="stablelm-3b", **kw):
    return dataclasses.replace(reduced(get_config(arch), **kw), dtype="float32")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_trace_cell_records_rank_zeros_shards(kind):
    """On a fake ``{data: 2, model: 2}`` group the reduced LM's cell runs
    on fake shards: the argument bytes are rank 0's (a quarter or half of
    each parameter's f32 bytes, the batch's rows), the step allocates, and
    its collectives are counted by axis."""
    cfg = _small(d_model=256)
    shape = ShapeConfig(kind, 32, 8, kind)
    kw = {"segment_sizes": (cfg.n_layers,), "n_micro": 1} if kind == "train" else {}
    with fake_group(4):
        mesh = make_fake_mesh((2, 2), ("data", "model"))
        rec = dryrun.trace_cell(cfg, shape, mesh, hbm_bytes=REFERENCE_HBM_BYTES, **kw)
    assert rec["temp_size_in_bytes"] > 0 and rec["jaxpr_flops_global"] > 0
    placed = steps.build_step(cfg, shape, {"data": 2, "model": 2}, **kw)[1][0]
    model = specs._meta_model(cfg)
    elem = 4 if kind == "train" else torch.finfo(cfg.activation_dtype).bits // 8
    local = sum(sh.local_bytes(tuple(p.shape), placed[n], {"data": 2, "model": 2}, elem)
                for n, p in model.named_parameters())
    if kind == "train":
        assert rec["alias_size_in_bytes"] == 3 * local  # parameters and both moments
        assert rec["argument_size_in_bytes"] == 3 * local + 2 * (8 // 2) * 32 * 4
    else:
        assert rec["argument_size_in_bytes"] > local
    assert set(rec["collectives_by_axis"]) <= {"data", "model"}
    assert rec["collectives"]["total_bytes_per_chip"] > 0


def test_dryrun_cli_prints_a_record_per_cell(capsys):
    """The CLI over cells the reference skips prints their records and
    exits 0; an unknown arch is an error record and exit 1."""
    import json

    assert dryrun.main(["--arch", "stablelm-3b,qwen2.5-14b", "--shape", "long_500k",
                        "--mesh", "both"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(r["arch"], r["mesh"], r["status"]) for r in lines] == [
        ("stablelm-3b", "single", "skipped"), ("stablelm-3b", "multi", "skipped"),
        ("qwen2.5-14b", "single", "skipped"), ("qwen2.5-14b", "multi", "skipped")]
    assert dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k"]) == 1
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["status"] == "error"


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------


def _dot_flops(jaxpr):
    """The reference's ``eqn_flops_for`` over its dot_general equations,
    inner jaxprs included (a scan's body times its length, as
    ``jaxpr_totals`` counts it)."""
    from repro.core.jaxpr_graph import _INNER_JAXPR_KEYS, eqn_flops_for

    total = 0.0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            total += eqn_flops_for(eqn)
        inner = 0.0
        for key in _INNER_JAXPR_KEYS:
            sub = eqn.params.get(key)
            for s in (sub if isinstance(sub, (list, tuple)) else [sub] if sub is not None else []):
                inner += _dot_flops(s.jaxpr if hasattr(s, "jaxpr") else s)
        total += inner * (max(1, eqn.params.get("length", 1))
                          if eqn.primitive.name == "scan" else 1)
    return total


def test_fx_totals_match_the_references_jaxpr_totals_on_prefill():
    """The reduced stablelm prefill cell (B 2, S 64) on one device: the
    port's matmul FLOPs equal the reference's dot_general FLOPs, with the
    flash op's causal half doubled (the reference's dense attention on the
    CPU multiplies the whole (S, S) products)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro.core.jaxpr_graph import jaxpr_totals
    from repro.models import build_model as rbuild_model
    from repro_torch.core.fx_graph import fx_totals, node_flops, op_name

    rcfg = rreduced(rget_config("stablelm-3b"))
    cfg = reduced(get_config("stablelm-3b"))
    shape = ShapeConfig("prefill", 64, 2, "prefill")
    rmodel = rbuild_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tokens = jnp.zeros((2, 64), jnp.int32)
    closed = jax.make_jaxpr(lambda p, t: rmodel.forward(p, t))(rparams, tokens)
    want = _dot_flops(closed.jaxpr)
    fn = steps.build_prefill_step(cfg, shape, {"data": 1, "model": 1})[0]
    tot = dryrun._global_totals(cfg, shape, fn, (), "cpu")
    model = specs._meta_model(cfg)
    params = {n: torch.zeros(p.shape, dtype=cfg.activation_dtype)
              for n, p in params_from_jax(jax.tree_util.tree_map(np.asarray, rparams)).items()}

    def run(params, tokens):
        with torch.no_grad():
            return fn(dryrun._Swapped(model, params), {"tokens": tokens})

    gm = make_fx(run, tracing_mode="fake")(params, torch.zeros(2, 64, dtype=torch.int32))
    mm = sum(node_flops(n) for n in gm.graph.nodes
             if n.op == "call_function" and op_name(n.target) in ("mm", "bmm", "addmm"))
    flash = sum(node_flops(n) for n in gm.graph.nodes
                if n.op == "call_function" and op_name(n.target) == "repro_torch::flash_attention")
    assert flash > 0
    assert mm + 2 * flash == want
    assert fx_totals(gm)["flops"] == tot["flops"]
    assert tot["heavy_flops"] == mm + flash
    assert jaxpr_totals(closed)["flops"] >= want


# ---------------------------------------------------------------------------
# The train-step knobs
# ---------------------------------------------------------------------------


def _close(got, want, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=TOL,
                               atol=TOL * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def test_mixed_precision_step_matches_the_references_mp_step():
    from repro.models import build_model as rbuild_model
    from repro.optim import adamw as radamw
    from repro_torch.models import build_model

    rcfg = rreduced(rget_config("stablelm-3b"))
    cfg = reduced(get_config("stablelm-3b"))
    shape = ShapeConfig("train", 32, 4, "train")
    rm = rbuild_model(rcfg)
    rmodel_params = jax.tree_util.tree_map(np.asarray, rm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    fn, *_ = rsteps.build_train_step(rcfg, RSHAPES["train_4k"], _Mesh((1, 1), ("data", "model")),
                                     segment_sizes=(rcfg.n_layers,), opts=("mp",))
    jp = jax.tree_util.tree_map(jnp.asarray, rmodel_params)
    new_p, _, metrics = fn(jp, radamw.init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    rgrads = jax.grad(lambda p, b: rm.loss(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, p), b))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})

    step = steps.build_train_step(cfg, shape, {"data": 1, "model": 1},
                                  segment_sizes=(cfg.n_layers,), opts=("mp",))[0]
    assert step.mixed_precision
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(rmodel_params), strict=True)
    tr = step.trainer(model)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, grads, gnorm = tr._grads(tb)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, rgrads))
    for name, g in zip(tr.names, grads):
        assert g.dtype == torch.float32
        _close(g.numpy(), want[name].numpy(), name)
    _close(float(loss), float(metrics["loss"]), "loss")
    _close(float(gnorm), float(metrics["grad_norm"]), "grad norm")
    tr2 = step.trainer(build_model(cfg, device="cpu"))
    tr2.model.load_state_dict(params_from_jax(rmodel_params), strict=True)
    out = step(tr2, tb)
    _close(float(out["loss"]), float(metrics["loss"]), "step loss")
    got = {n: p.detach().numpy() for n, p in zip(tr2.names, tr2.params)}
    for name, p in params_from_jax(jax.tree_util.tree_map(np.asarray, new_p)).items():
        _close(got[name], p.numpy(), name)


def test_rs_reduce_scatters_each_fsdp_gradient():
    """``"rs"`` is what the Trainer does: on a fake ``{data: 2}`` group with
    the large parameters FSDP-sharded, the step's 2-D collectives are one
    reduce-scatter per sharded parameter, of its whole f32 gradient, and no
    all-reduce of a parameter's gradient (the others carry activations,
    the norm scales' gradients and the clip's scalars)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.census import CountCollectives
    from repro_torch.models import build_model

    class Shapes(CountCollectives):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(getattr(t, "__name__", "") == "DTensor" for t in types):
                return NotImplemented
            op = str(func).split(".")[1] if "_c10d_functional" in str(func) else None
            if op in ("all_reduce", "reduce_scatter_tensor"):
                self.calls.append((op, tuple(args[0].shape)))
            return super().__torch_dispatch__(func, types, args, kwargs)

    cfg = _small(d_model=256)
    shape = ShapeConfig("train", 32, 4, "train")
    step = steps.build_train_step(cfg, shape, {"data": 2, "model": 1},
                                  segment_sizes=(cfg.n_layers,), opts=("rs",))[0]
    with fake_group(2):
        mesh = make_fake_mesh((2,), ("data",))
        with FakeTensorMode(allow_non_fake_inputs=True):
            model = build_model(cfg, device="cpu")
            step.mesh = mesh
            step.param_shardings = sh.named_sharding_tree(dict(model.named_parameters()), mesh,
                                                          fsdp=True)
            step.batch_shardings = None
            tr = step.trainer(model)
            batch = {k: torch.zeros(2, 32, dtype=torch.int32) for k in ("tokens", "labels")}
            with Shapes() as counted:
                step(tr, batch)
    # the embedding table's gradient is scattered from the activations'
    # gradient, which is reduce-scattered over its features already
    sharded = [p for n, p in zip(tr.names, tr.params)
               if not p.placements[0].is_replicate() and n != "embedding.embed"]
    assert sharded and all(p.dim() == 2 for p in sharded)
    scattered = [s for op, s in counted.calls if op == "reduce_scatter_tensor" and len(s) == 2]
    assert len(scattered) == len(sharded)
    assert sorted(int(np.prod(s)) for s in scattered) == sorted(p.numel() for p in sharded)
    assert not [s for op, s in counted.calls if op == "all_reduce" and len(s) == 2]


@pytest.mark.parametrize("units, remat, batch", [(1, (False,), 2), (2, (True, False), 2),
                                                 (3, (False, True, True), 3)])
def test_production_collectives_count_the_cells_step(monkeypatch, units, remat, batch):
    """``chip_smoke.production_collectives``, the count from the shapes that
    phase production holds the card's eight ranks to, equals the
    collectives of the same step (qwen3-moe-30b-a3b at full width, f32, on
    ``{data: 1, model: 8}``, the plan's rematerialized units) that
    ``trace_cell`` counts on a fake group of 8 ranks: calls and payload
    bytes by kind, exactly."""
    import importlib.util
    from pathlib import Path

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import build_model

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "PRODUCTION_UNITS", units)
    monkeypatch.setattr(cs, "PRODUCTION_REMAT", remat)
    monkeypatch.setattr(cs, "PRODUCTION_BATCH", batch)
    cfg = dataclasses.replace(get_config(cs.PRODUCTION_ARCH), n_layers=units, dtype="float32")
    shape = ShapeConfig("production", cs.PRODUCTION_SEQ, batch, "train")
    with fake_group(8):
        mesh = make_fake_mesh((1, 8), ("data", "model"))
        rec = dryrun.trace_cell(cfg, shape, mesh, totals=False, n_micro=1, **cs.production_plan())
        step = steps.build_train_step(cfg, shape, mesh, n_micro=1, **cs.production_plan())[0]
        with FakeTensorMode(allow_non_fake_inputs=True):
            tr = step.trainer(build_model(cfg, device="cpu"))
        leaves = sum(1 for p in tr.params if not p.placements[1].is_replicate())
    got = {axis: {op: [v["calls"], v["payload_bytes"]] for op, v in ops.items()}
           for axis, ops in rec["collectives_by_axis"].items()}
    assert got == cs.production_collectives(cfg, leaves)


def test_live_bytes_counts_only_what_a_rank_allocates():
    """``LiveBytes`` counts each new storage once, from the op that makes it
    until it is freed: a view or a ``meta`` tensor (shapes only, such as
    one made for its strides) allocates nothing."""
    live = dryrun.LiveBytes()
    with live:
        a = torch.zeros(1000)
        torch.empty(10**9, device="meta")
        b = a.view(10, 100).add_(1)
        c = torch.ones(500)
        del c
    assert live.peak == 4000 + 2000 and live.live == 4000
    assert b.shape == (10, 100)
