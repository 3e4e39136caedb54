"""The model families of the port against the reference.

Every reference config builds.  Reduced granite-moe-3b-a800m,
qwen3-moe-30b-a3b, zamba2-2.7b, xlstm-1.3b and phi-3-vision-4.2b (text
only) on the CPU, on the reference's ``init`` weights moved with
``weights.params_from_jax``: the parameter trees round-trip (the hybrid's
unstacked top-level ``shared_attn``, the rank-3 expert leaves, whisper's
stacked ``encoder``/``decoder``); the loss
agrees in f32 to 1e-5 and its grads to rtol 1e-4 (each absolute limit
relative to the tensor's largest value), the loss in bf16 to 2e-2; three ``decode_step``s agree with the
reference's (logits and every cache leaf); step-by-step decode reproduces
the forward (the reference's teacher-forcing test for zamba2, and granite
on a prefix whose capacity drops no route); the port's ``Engine`` gives
the reference engine's tokens, slot reuse included, and zeroes a reused
slot's recurrent state; ``plan_function`` on both losses is bitwise plain
autograd at the minimal budget (run in the plan's order: see
``test_plan_function_is_bitwise_vanilla_at_the_minimal_budget``), with only
the flash nodes pinned by the
effect pass (the router is pure); the hybrid's trace is non-chain (the
embedding feeds every unit's shared block) and holds every chunk's SSD ops
(the per-chunk checkpoint is transparent to ``make_fx``); segment remat is
bitwise; the launch planner's inputs and plans equal the reference
launcher's; both launchers run with ``--reduced --device cpu``.
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
from repro.core import dp as rdp  # noqa: E402
from repro.core.lower_sets import all_lower_sets  # noqa: E402
from repro.data import DataConfig, SyntheticLM  # noqa: E402
from repro.launch import plan as rplan  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.steps import segment_plan as rsegment_plan  # noqa: E402
from repro.models import build_model as rbuild_model  # noqa: E402
from repro.models.transformer import LM as RLM  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig as PShape  # noqa: E402
from repro_torch.core import PlanCache, Planner  # noqa: E402
from repro_torch.core.lowering import TracedCarrier, vanilla_traced_value_and_grad  # noqa: E402
from repro_torch.launch import plan as pplan  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.mesh import REFERENCE_HBM_BYTES  # noqa: E402
from repro_torch.launch.steps import segment_plan as psegment_plan  # noqa: E402
from repro_torch.models import WhisperModel, build_model, moe  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402
from repro_torch.train import functional_loss  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_jax  # noqa: E402

MOE, HYBRID = "granite-moe-3b-a800m", "zamba2-2.7b"
ARCHS = [MOE, "qwen3-moe-30b-a3b", HYBRID, "xlstm-1.3b", "phi-3-vision-4.2b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SEQ, BATCH = 32, 2
N_LAYERS = 4  # zamba2: 2 units of 2 Mamba2 blocks + the shared block


def close(got, want, dtype="float32", what="", rtol=None):
    """|got - want| ≤ rtol·|want| + tol·max(1, max |want|), rtol = tol unless
    given (see tests/test_torch_ssm.py: sums in another order differ by f32
    rounding of their largest terms)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=TOL[dtype] if rtol is None else rtol,
                               atol=TOL[dtype] * scale, err_msg=what)


def configs(arch, dtype="float32", n_layers=N_LAYERS):
    r = dataclasses.replace(rreduced(rget_config(arch), n_layers=n_layers), dtype=dtype)
    p = dataclasses.replace(reduced(get_config(arch), n_layers=n_layers), dtype=dtype)
    return r, p


_SETUPS = {}


def setup(arch, dtype="float32", n_layers=N_LAYERS):
    """Reference model, its numpy weights, and the port's model on them
    (built once per arch and dtype)."""
    key = (arch, dtype, n_layers)
    if key not in _SETUPS:
        rcfg, pcfg = configs(arch, dtype, n_layers)
        rlm = rbuild_model(rcfg)
        np_tree = jax.tree_util.tree_map(np.asarray, rlm.init(jax.random.PRNGKey(0)))
        plm = build_model(pcfg, device="cpu")
        plm.load_state_dict(params_from_jax(np_tree), strict=True)
        _SETUPS[key] = rlm, np_tree, plm
    return _SETUPS[key]


def batch_of(cfg, seed=0):
    return SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH)).batch(seed)


def to_numpy(tree):
    return {k: to_numpy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def assert_trees_close(got, want, what="", rtol=None):
    got, want = to_numpy(got), to_numpy(want)
    assert got.keys() == want.keys(), what
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_close(got[k], want[k], f"{what}.{k}", rtol)
        else:
            close(got[k], want[k], what=f"{what}.{k}", rtol=rtol)


# ------------------------------------------------------------------ build


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_model_builds_the_ported_families(arch):
    cfg = get_config(arch)
    model = build_model(reduced(cfg), device="cpu")
    ref = rbuild_model(rreduced(rget_config(arch)))
    if cfg.encoder_decoder:
        assert isinstance(model, WhisperModel) and type(ref).__name__ == "WhisperModel"
        assert len(model.encoder) == len(model.decoder) == ref.cfg.n_layers
    else:
        assert model.pattern == RLM(rreduced(rget_config(arch))).pattern == ref.pattern


@pytest.mark.parametrize("arch", [MOE, HYBRID, "whisper-small"])
def test_params_round_trip_every_leaf(arch):
    _, np_tree, plm = setup(arch)
    back = params_to_jax(plm.state_dict())
    want = jax.tree_util.tree_leaves_with_path(np_tree)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[path].dtype == leaf.dtype and np.array_equal(got[path], leaf), path
    state = plm.state_dict()
    if arch == HYBRID:  # one shared param set, not stacked per unit
        assert state["shared_attn.in_proj.w"].shape == np_tree["shared_attn"]["in_proj"]["w"].shape
        assert "layers.0.b0_mamba.mamba.A_log" in state
    elif arch == "whisper-small":  # two stacks, one module a layer on each side
        L = N_LAYERS
        assert np_tree["encoder"]["mlp"]["w_up"].shape == (L, *state["encoder.0.mlp.w_up"].shape)
        assert np_tree["decoder"]["ln_x"]["bias"].shape == (L, *state[
            f"decoder.{L - 1}.ln_x.bias"].shape)
        assert state["enc_pos"].shape == np_tree["enc_pos"].shape
    else:
        w = state["layers.1.b0_attn_moe.moe.experts.w_gate"]
        assert w.dim() == 3 and np_tree["layers"]["b0_attn_moe"]["moe"]["experts"][
            "w_gate"].shape == (plm.n_units, *w.shape)


# ------------------------------------------------------- loss and grads


def _reference_loss_and_grads(rlm, np_tree, batch):
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    return jax.value_and_grad(rlm.loss)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_loss_and_grads_match_reference(arch):
    rlm, np_tree, plm = setup(arch)
    batch = batch_of(plm.cfg)
    loss, grads = _reference_loss_and_grads(rlm, np_tree, batch)
    ploss = plm.loss({k: torch.tensor(v) for k, v in batch.items()})
    close(ploss, loss, what="loss")
    names = [n for n, _ in plm.named_parameters()]
    pgrads = params_to_jax(dict(zip(names, torch.autograd.grad(ploss, list(plm.parameters())))))
    if arch != HYBRID:
        # rtol 1e-4, as tests/test_torch_model.py holds the dense LM's grads
        assert_trees_close(pgrads, grads, "grads", rtol=1e-4)
        return
    # zamba2's grads sum many terms that cancel, so the two packages' f32
    # roundings differ by more than any fixed rtol shows on every host.
    # Both are held against the truth instead, an f64 run of the port on the
    # same weights, in units of eps32 × max|leaf| of each leaf:
    # - the reference lies within REF_UNITS of it on every leaf, so a port
    #   whose f64 run is wrong fails here, on the reference's side;
    # - each leaf of the port lies within 2 × that leaf's reference distance
    #   + PORT_UNITS of it.
    # On an Intel Xeon host the reference's worst was 137-275 units (A_log)
    # and the port's worst excess over 2 × reference 431 (b1 dt_bias; the
    # port's worst alone 479, out_proj.w).  The gap is the order in which
    # the f32 products with a 64-long contraction sum: see
    # test_f32_grads_gap_is_the_order_of_the_gemm_sums.
    REF_UNITS, PORT_UNITS = 1000.0, 600.0
    dist = _distances_to_f64(plm, batch, pgrads, grads)
    ref_over = {k: r for k, (_, r) in dist.items() if r > REF_UNITS}
    assert not ref_over, ref_over
    port_over = {k: (p, r) for k, (p, r) in dist.items() if p > 2 * r + PORT_UNITS}
    assert not port_over, port_over


def _distances_to_f64(plm, batch, pgrads, grads):
    """{leaf: (port's, reference's distance)} from the port's f64 grads, in
    units of eps32 × the leaf's largest value."""
    truth = to_numpy(params_to_jax(_f64_grads(plm, batch)))
    eps = float(np.finfo(np.float32).eps)

    def flat(tree, prefix=""):
        for k, v in tree.items():
            yield from (flat(v, f"{prefix}{k}.") if isinstance(v, dict)
                        else [(prefix + k, np.asarray(v, np.float64))])

    port, ref, true = (dict(flat(to_numpy(t))) for t in (pgrads, grads, truth))
    return {k: (float(np.abs(port[k] - t).max()) / u, float(np.abs(ref[k] - t).max()) / u)
            for k, t in true.items() for u in [eps * max(float(np.abs(t).max()), 1e-30)]}


def _gemm_in_four_strided_sums(a, b):
    """``a @ b`` as XLA's CPU dot sums a 64-long contraction: four partial
    products over k ≡ 0, 1, 2, 3 (mod 4), added pairwise."""
    p = [torch.matmul(a[..., r::4], b[..., r::4, :]) for r in range(4)]
    return (p[0] + p[1]) + (p[2] + p[3])


def test_f32_grads_gap_is_the_order_of_the_gemm_sums():
    """Where zamba2's f32 grads lose the bits the reference keeps (ROADMAP
    §3): not in the SSD scan (tests/test_torch_ssm.py holds it as close to
    f64 as the reference's) but in the f32 products whose contraction is 64
    long (d_model's projections, and every weight grad, summing B·S = 64
    rows).  Torch's CPU GEMM sums k in one chain of FMAs; XLA's CPU dot
    sums it in four strided partial sums added pairwise, bitwise
    ``_gemm_in_four_strided_sums``.  The reduced model then amplifies the
    difference through a cancellation (the SSD output against the D skip
    at the first position, before the output norm).  With the port's
    64-long products summed in the reference's order, and nothing else
    changed, every leaf of the port lies within 2 × the reference's
    distance + 100 units (measured: 58.2 at worst, against 431 as the port
    sums them; the port's worst leaf 93.4 units, the reference's 136.8)."""
    r = np.random.default_rng(3)
    a = r.standard_normal((64, 64)).astype(np.float32)
    b = (r.standard_normal((64, 290)) * 0.125).astype(np.float32)  # in_proj's shape
    want = np.asarray(jnp.matmul(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(_gemm_in_four_strided_sums(torch.tensor(a), torch.tensor(b)).numpy(),
                          want)
    assert not np.array_equal((torch.tensor(a) @ torch.tensor(b)).numpy(), want)

    from torch.utils._python_dispatch import TorchDispatchMode

    class ReferenceGemmOrder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if (func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)
                    and args[0].dtype == torch.float32 and args[0].shape[-1] == 64):
                return _gemm_in_four_strided_sums(*args)
            return func(*args, **(kwargs or {}))

    rlm, np_tree, plm = setup(HYBRID)
    batch = batch_of(plm.cfg)
    _, grads = _reference_loss_and_grads(rlm, np_tree, batch)
    with ReferenceGemmOrder():
        ploss = plm.loss({k: torch.tensor(v) for k, v in batch.items()})
        names = [n for n, _ in plm.named_parameters()]
        pgrads = params_to_jax(dict(zip(names, torch.autograd.grad(ploss,
                                                                   list(plm.parameters())))))
    dist = _distances_to_f64(plm, batch, pgrads, grads)
    over = {k: (p, rr) for k, (p, rr) in dist.items() if p > 2 * rr + 100.0}
    assert not over, over


def _f64_grads(plm, batch):
    """The port's grads in f64 on ``plm``'s weights: every ``.float()``
    and every f32 zeros the model makes are taken as f64 while it runs."""
    cfg = dataclasses.replace(plm.cfg, dtype="float64")
    m64 = build_model(cfg, device="cpu").double()
    m64.load_state_dict({k: v.double() for k, v in plm.state_dict().items()})
    f32, new_zeros, zeros = torch.Tensor.float, torch.Tensor.new_zeros, torch.zeros

    def wide(kw):
        if kw.get("dtype") is torch.float32:
            kw["dtype"] = torch.float64
        return kw

    torch.Tensor.float = lambda t: t.double() if t.is_floating_point() else f32(t)
    torch.Tensor.new_zeros = lambda t, *a, **kw: new_zeros(t, *a, **wide(kw))
    torch.zeros = lambda *a, **kw: zeros(*a, **wide(kw))
    try:
        loss = m64.loss({k: torch.tensor(v) for k, v in batch.items()})
        names = [n for n, _ in m64.named_parameters()]
        return dict(zip(names, torch.autograd.grad(loss, list(m64.parameters()))))
    finally:
        torch.Tensor.float, torch.Tensor.new_zeros, torch.zeros = f32, new_zeros, zeros


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_reference(arch):
    rlm, np_tree, plm = setup(arch, "bfloat16")
    batch = batch_of(plm.cfg, seed=1)
    loss = rlm.loss(jax.tree_util.tree_map(jnp.asarray, np_tree),
                    {k: jnp.asarray(v) for k, v in batch.items()})
    close(plm.loss({k: torch.tensor(v) for k, v in batch.items()}), loss, "bfloat16", "loss")


@pytest.mark.parametrize("arch", [MOE, HYBRID])
def test_segment_remat_grads_are_bitwise_unplanned(arch):
    """Two segments, the first rematerialized (for the hybrid the segment
    checkpoint nests the per-chunk ones): the same bits as no remat."""
    _, _, plm = setup(arch)
    tb = {k: torch.tensor(v) for k, v in batch_of(plm.cfg).items()}
    params = list(plm.parameters())

    def run(sizes, remat):
        loss = plm.loss(tb, segment_sizes=sizes, segment_remat=remat)
        return loss.detach(), torch.autograd.grad(loss, params)

    n = plm.n_units
    l0, g0 = run((n,), (False,))
    l1, g1 = run((1, n - 1), (True, False))
    assert torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(g0, g1))


# ------------------------------------------------------------------ decode


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """Three decode steps, rows at different positions: logits and every
    cache leaf (KV, Mamba2 ssm and conv states) against the reference's."""
    rlm, np_tree, plm = setup(arch)
    rparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    S, start = 16, np.array([0, 5], np.int32)
    rcaches, pcaches = rlm.init_caches(BATCH, S), plm.init_caches(BATCH, S)
    assert_trees_close(pcaches, rcaches, "init")
    toks = np.random.default_rng(7).integers(0, plm.cfg.vocab_size, (3, BATCH, 1))
    for t in range(3):
        pos = start + t
        rlogits, rcaches = rlm.decode_step(rparams, jnp.asarray(toks[t], jnp.int32),
                                           rcaches, jnp.asarray(pos))
        plogits, out = plm.decode_step(torch.tensor(toks[t]), pcaches,
                                       torch.tensor(pos, dtype=torch.int64))
        assert out is pcaches
        close(plogits, rlogits, what=f"logits step {t}")
        assert_trees_close(pcaches, rcaches, f"caches step {t}")


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 6e-2), ("float32", 1e-4)])
@pytest.mark.parametrize("arch", [MOE, HYBRID])
def test_decode_matches_forward_teacher_forcing(arch, dtype, tol):
    """``tests/test_models_smoke.py``'s teacher-forcing test for the port, at
    its size and bf16 limit (at 4 layers the reference's own gap is 0.080):
    zamba2 (the reference's case) and granite on an 8-token prefix, whose
    capacity (8) no expert's load can exceed, so the forward drops no route
    (the reference leaves MoE out: a longer prefix drops routes in the
    forward that decode never drops)."""
    _, _, plm = setup(arch, dtype, n_layers=2)  # the reference test's size
    T = 8
    if plm.cfg.moe is not None:
        assert moe.capacity(plm.cfg.moe, T) >= T
    toks = torch.tensor(np.random.default_rng(5).integers(0, plm.cfg.vocab_size, (1, T)))
    with torch.no_grad():
        full = plm(toks)
    caches = plm.init_caches(1, T + 1)
    steps = [plm.decode_step(toks[:, t:t + 1], caches, torch.tensor([t]))[0][:, 0]
             for t in range(T)]
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), rtol=tol, atol=tol)


# ------------------------------------------------------------------ engine


@pytest.mark.parametrize("arch", [MOE, HYBRID])
def test_engine_matches_reference(arch):
    """Both engines on the same weights and requests in f32, greedy: 3
    slots, 7 requests (slots reused with recurrent state), one prompt of 20
    tokens against ``max_seq`` 16: the same tokens in the same order."""
    rlm, np_tree, plm = setup(arch)
    rparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    r = np.random.default_rng(11)
    prompts = [r.integers(1, 256, size=n).tolist() for n in (3, 7, 20, 2, 5, 4, 9)]
    outs = []
    for eng in (REngine(rlm, rparams, max_slots=3, max_seq=16, rng_seed=4),
                Engine(plm, max_slots=3, max_seq=16, rng_seed=4)):
        for prompt in prompts:
            eng.submit(prompt, max_new_tokens=6)
        outs.append([(q.uid, q.output) for q in eng.run()])
    assert outs[1] == outs[0]


def test_reused_slot_starts_from_a_zero_recurrent_state():
    """The same prompt served before and after other traffic in one slot
    gives the same tokens; admission zeroes the slot in every cache leaf
    (the Mamba2 states included) and leaves the other slots alone."""
    _, _, plm = setup(HYBRID)
    eng = Engine(plm, max_slots=1, max_seq=32)
    for prompt in ([9, 9, 9], [1, 2, 3, 4, 5], [9, 9, 9]):
        eng.submit(prompt, max_new_tokens=5)
    done = sorted(eng.run(), key=lambda q: q.uid)
    assert done[0].output == done[2].output

    eng = Engine(plm, max_slots=2, max_seq=32)
    eng.submit([3, 4, 5], max_new_tokens=2)
    eng.submit([6, 7], max_new_tokens=2)
    eng.run()
    leaves = jax.tree_util.tree_leaves(eng.caches)
    assert len(leaves) == 2 * len(plm.layers[0].block_names) + 2
    assert all(bool(t[:, s].any()) for t in leaves for s in (0, 1) if t.dtype == torch.float32)
    eng._reset_slot(1)
    assert all(not t[:, 1].any() and bool(t[:, 0].any()) for t in leaves)


# --------------------------------------------------------------- front door


def _traced_loss(arch):
    _, _, plm = setup(arch, n_layers=2)
    tb = {k: torch.tensor(v) for k, v in batch_of(plm.cfg).items()}
    n = plm.n_units
    fn, params = functional_loss(lambda m, b: m.loss(b, (n,), (False,)), plm)
    return plm, fn, params, tb


def _bitwise(g0, g1):
    assert g0.keys() == g1.keys()
    return [k for k in g0 if not torch.equal(g0[k], g1[k])]


@pytest.mark.parametrize("backend", ["fx", "interpreter"])
@pytest.mark.parametrize("arch", [MOE, HYBRID])
def test_plan_function_is_bitwise_vanilla_at_the_minimal_budget(arch, backend):
    """Loss bitwise plain autograd's, and grads bitwise plain autograd's run
    in the plan's node order.  The MoE plan keeps the trace's order, so its
    grads are also bitwise plain autograd's; the hybrid's plan runs nodes in
    another topological order (its graph is non-chain), and autograd then
    sums the grads of tensors read by several nodes in another order: its
    grads differ from plain autograd's by an ulp or so, whether the plan
    recomputes or not (ROADMAP.md §3).  Which leaves differ depends on the
    host's rounding, so each leaf is held within 4 × eps32 × its largest
    magnitude of plain autograd's (the worst measured: 1.01)."""
    _, fn, params, tb = _traced_loss(arch)
    planned = repro_torch.plan_function(fn, planner=Planner(cache=PlanCache()),
                                        backend=backend)
    plan = planned.lowered_for(params, tb).plan
    assert set().union(*(s.recompute for s in plan.segments))  # it recomputes
    carrier = TracedCarrier.trace(fn, (params, tb))
    l0, g0 = vanilla_traced_value_and_grad(carrier)(params, tb)
    l1, g1 = planned(params, tb)
    l2, g2 = vanilla_traced_value_and_grad(carrier, plan)(params, tb)
    assert torch.equal(l0, l1) and torch.equal(l0, l2)
    assert _bitwise(g2, g1) == []
    reordered = _bitwise(g0, g2)
    if arch == MOE:
        assert reordered == []
    else:
        eps = torch.finfo(torch.float32).eps
        far = {k: float((g0[k] - g2[k]).abs().max()) / (eps * float(g0[k].abs().max()))
               for k in reordered}
        assert all(v <= 4 for v in far.values()), far


@pytest.mark.parametrize("arch", [MOE, HYBRID])
def test_effect_pass_pins_only_the_flash_nodes(arch):
    """No PRNG and no opaque op in the router or the SSD scan: the only
    tainted nodes are the flash-attention ones, which pin themselves."""
    _, fn, params, tb = _traced_loss(arch)
    carrier = TracedCarrier.trace(fn, (params, tb), analyze_effects=True)
    ea = carrier.effects
    flash = {e.index for e in ea.effects if e.primitive == "repro_torch::flash_attention"}
    kinds = {e.primitive for e in ea.effects}
    assert flash and ea.tainted == ea.pins == flash
    if arch == MOE:
        assert {"topk", "cumsum", "index_put", "index"} <= kinds
    else:
        assert {"softplus", "cumsum", "tril", "cat"} <= kinds
    assert analysis.check_graph(carrier).ok
    # the reference's twin primitives name the graph's kinds
    twins = {"top_k", "scatter-add", "gather"} if arch == MOE else {"select_n"}
    assert twins | {"cumsum", "concatenate"} <= {v.kind for v in carrier.to_graph().nodes}


def test_hybrid_trace_is_non_chain_and_holds_every_chunk():
    """The embedding output feeds the first Mamba2 block and every unit's
    shared block (the skip edges of ``concat(h, h0)``); the per-chunk
    checkpoint leaves each chunk's ops in the graph: two ``cumsum`` nodes a
    chunk (its decay's and the segsum's)."""
    plm, fn, params, tb = _traced_loss(HYBRID)
    g = TracedCarrier.trace(fn, (params, tb)).to_graph()
    (emb,) = [v.idx for v in g.nodes if v.kind == "embedding"]
    cats = [w for w in g.succ[emb] if g.nodes[w].kind == "concatenate"]
    assert len(cats) == plm.n_units and len(g.succ[emb]) > len(cats)
    n_mamba = plm.n_units * len(plm.layers[0].block_names)
    chunks = SEQ // plm.cfg.ssm.chunk
    assert sum(v.kind == "cumsum" for v in g.nodes) == 2 * chunks * n_mamba
    assert not any("checkpoint" in v.kind for v in g.nodes)


def test_model_checkpoints_are_left_out_while_the_carrier_traces(monkeypatch):
    """Divergence (ROADMAP.md §3): the reference's trace keeps its
    ``jax.checkpoint``s; the port's per-chunk and per-segment checkpoints
    are left out while ``make_fx`` traces (functionalization cannot trace
    one on every torch version), so the traced graph is the same with or
    without segment remat, and the plan decides what to recompute.  In
    eager mode they run."""
    from repro_torch.core import fx_graph
    from repro_torch.models import layers

    plm, fn, params, tb = _traced_loss(HYBRID)
    n = plm.n_units

    def refuse(*a, **kw):
        raise AssertionError("torch.utils.checkpoint called while tracing")

    monkeypatch.setattr(layers, "checkpoint", refuse)
    remat_fn, _ = functional_loss(lambda m, b: m.loss(b, (n,), (True,)), plm)
    g0 = TracedCarrier.trace(fn, (params, tb)).to_graph()
    g1 = TracedCarrier.trace(remat_fn, (params, tb)).to_graph()
    assert [v.kind for v in g1.nodes] == [v.kind for v in g0.nodes] and g1.edges == g0.edges
    assert not fx_graph.tracing()
    with pytest.raises(AssertionError, match="while tracing"):
        plm.loss(tb)  # eager: the per-chunk checkpoints run


# --------------------------------------------------------------- launchers


@pytest.mark.parametrize("arch", [MOE, HYBRID])
def test_launch_plan_matches_reference(arch):
    """Chain inputs, unit-segment plans from the minimal budget to the
    reference's per-device memory, and the launcher's plan at full width,
    batch 2 × seq 1024 on one device: bitwise the reference's."""
    rcfg, pcfg = rget_config(arch), get_config(arch)
    rs, ps = RShape("cli", 1024, 2, "train"), PShape("cli", 1024, 2, "train")
    rpi = rplan.plan_inputs(rcfg, rs, 1, model_shards=1)
    ppi = pplan.plan_inputs(pcfg, ps, 1, model_shards=1, hbm_bytes=REFERENCE_HBM_BYTES)
    assert dataclasses.asdict(ppi) == dataclasses.asdict(rpi)
    g = rplan._dp_chain_graph(rpi)
    b_min = rdp.min_feasible_budget_exact(g, all_lower_sets(g))
    for budget in (b_min, 2.0 * b_min, rpi.budget):
        r = rplan.plan_unit_segments(rcfg, rs, 1, model_shards=1, budget=budget)
        p = pplan.plan_unit_segments(pcfg, ps, 1, model_shards=1, budget=budget,
                                     hbm_bytes=REFERENCE_HBM_BYTES)
        assert dataclasses.asdict(p[0]) == dataclasses.asdict(r[0])
        assert p[1].sequence == r[1].sequence and p[1].peak_memory == r[1].peak_memory
    r = rsegment_plan(rcfg, rs, make_host_mesh())
    p = psegment_plan(pcfg, ps, hbm_bytes=REFERENCE_HBM_BYTES)
    assert dataclasses.asdict(p[0]) == dataclasses.asdict(r[0])
    assert (p[1].sequence, p[1].overhead, p[1].peak_memory, p[1].feasible) == (
        r[1].sequence, r[1].overhead, r[1].peak_memory, r[1].feasible)


@pytest.mark.parametrize("arch", [MOE, HYBRID])
def test_launchers_run_on_the_cpu(arch):
    out = train.main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
                      "--seq", "32", "--device", "cpu"])
    assert out["step"] == 2 and all(np.isfinite(out["losses"]))
    served = serve.main(["--arch", arch, "--requests", "3", "--slots", "2", "--max-seq",
                         "48", "--new-tokens", "4", "--device", "cpu"])
    assert len(served["completed"]) == 3
    assert all(len(q.output) == 4 for q in served["completed"])
