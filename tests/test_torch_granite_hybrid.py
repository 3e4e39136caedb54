"""granite-4.0-h-small in the port against the benchmark's plain reference
(``perfbench/reference/granite_hybrid.py``), on the CPU in float32.

A reduced configuration holds every kind the model has: two units, a
``mamba_moe`` and an ``attn_moe``, 8 experts of which 2 are held, a shared
expert, and multipliers other than 1.  On seeded random weights the port's
loss and every leaf's gradient match the reference's; so do the pieces one
at a time: the conv over x, B and C with its bias, the chunked scan (the
port's and the reference's dual form against the step-by-step recurrence),
and attention without positions and with a scale.  The expert layer's
shares add up: the results that the layers holding experts {0, 1},
{2, 3}, ... give, with the shared expert counted once, sum to the uncut
layer's.  Tolerances: both sides compute in float32 but in different
orders (chunked against whole products, batched experts against one at a
time), so they agree to float32 rounding, a few ulps a product grown over
the few hundred operations between a weight and the loss.
"""

import copy
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness, weights  # noqa: E402
from perfbench.reference import F32Arith  # noqa: E402
from perfbench.reference import granite_hybrid as ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import plan as launch_plan  # noqa: E402
from repro_torch.launch.steps import segment_plan  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.models import ssm as pssm  # noqa: E402
from repro_torch.models.transformer import _tree  # noqa: E402

MM = F32Arith.mm
#: one row, as the benchmark's cell: the port routes a batch's tokens
#: together (one capacity over all rows), the reference a row at a time
ROWS, SEQ = 1, 96


def tiny_config() -> dict:
    """The configuration file cut to two units of width 64, every kind kept."""
    cfg = copy.deepcopy(harness.load_json(harness.BENCH / "configs" / "granite-4.0-h-small.json"))
    cfg["port"].update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=32,
                       vocab_size=256, dtype="float32", layer_pattern=["mamba_moe", "attn_moe"])
    cfg["port"]["moe"].update(num_experts=8, top_k=2, d_ff_expert=32, d_ff_shared=48,
                              experts_held=2)
    cfg["port"]["ssm"].update(d_state=16, chunk=16)
    return cfg


def port_model(cfg: dict, seed: int = 5):
    """The port's LM of ``cfg`` holding the weights the reference draws."""
    model = build_model(harness.port_config(cfg), device="cpu")
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, t in weights.generate(cfg, seed, "cpu"):
            params[name].copy_(t)
    return model


def batch(vocab: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, vocab, (ROWS, SEQ + 1), generator=g)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def reference_loss(cfg, P, b):
    """The mean next-token loss over the rows, as ``reference.follow``
    divides the rows' summed losses."""
    rows, S = b["tokens"].shape
    return sum(ref.row_loss(P, cfg, b["tokens"][r:r + 1], b["labels"][r:r + 1], MM)
               for r in range(rows)) / (rows * (S - 1))


def test_the_configuration_is_the_ports():
    f = harness.load_json(harness.BENCH / "configs" / "granite-4.0-h-small.json")
    cfg = harness.port_config(f)
    assert cfg == dataclasses.replace(get_config("granite-4.0-h-small"), n_layers=10,
                                      moe=dataclasses.replace(cfg.moe, experts_held=9))
    assert cfg.num_params() == f["params"] == 2_414_692_992
    assert cfg.num_active_params() == f["active_params"]
    assert sum(p.numel() for p in build_model(cfg, device="meta").parameters()) == f["params"]
    # one period of the source's layer types, each layer one unit
    kinds = {"mamba": "mamba_moe", "attention": "attn_moe"}
    assert ref.kinds(f) == list(cfg.layer_pattern) == [
        kinds[t] for t in f["layer_types"][:f["num_hidden_layers"]]]


@pytest.mark.parametrize("remat", [(False, False), (True, False)])
def test_loss_and_every_gradient_match_the_reference(remat):
    cfg = tiny_config()
    model = port_model(cfg)
    b = batch(cfg["port"]["vocab_size"])
    loss = model.loss(b, segment_sizes=(1, 1), segment_remat=remat)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    P = {n: t.requires_grad_(True) for n, t in weights.generate(cfg, 5, "cpu")}
    want = reference_loss(cfg, P, b)
    want_grads = torch.autograd.grad(want, [P[n] for n in names])
    # a mean of float32 log-partitions over 95 positions: a few ulps
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    for name, g, w in zip(names, grads, want_grads):
        # float32 on both sides: a leaf's gradient to 1e-5 of its largest entry
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5 * float(w.abs().max()),
                                   msg=lambda m, name=name: f"{name}: {m}")


def test_conv_over_xbc_with_bias_matches():
    g = torch.Generator().manual_seed(1)
    x, w, b = (torch.randn(1, 40, 48, generator=g), torch.randn(4, 48, generator=g),
               torch.randn(48, generator=g))
    # the same products summed in the same order: bitwise
    assert torch.equal(pssm._causal_conv(x, w) + b, ref.causal_conv(x, w, b))


def test_mamba2_mixer_matches_the_reference():
    cfg = tiny_config()
    model = port_model(cfg)
    block = model.layers[0].b0_mamba_moe
    P = dict(weights.generate(cfg, 5, "cpu"))
    pre = "layers.0.b0_mamba_moe.mamba."
    g = torch.Generator().manual_seed(2)
    h = torch.randn(1, SEQ, 64, generator=g)
    r = cfg["port"]["residual_multiplier"]
    got = pssm.mamba2_apply(_tree(block.mamba), h, block.ssm_cfg, r)
    x = ref.rmsnorm(h, P[pre + "norm.scale"], cfg["port"]["norm_eps"])
    want = h + r * ref.mamba(P, pre, x, cfg, MM)
    # float32 on both sides, the scan's sums in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# (544, 16): 34 chunks, the port's scan in groups of 16, 16 and 2
@pytest.mark.parametrize("S,chunk", [(64, 16), (48, 48), (96, 32), (544, 16)])
def test_chunked_scan_matches_the_sequential_recurrence(S, chunk):
    g = torch.Generator().manual_seed(S)
    H, P, N = 3, 8, 5
    x = torch.randn(S, H, P, generator=g, dtype=torch.float64)
    a = -torch.rand(S, H, generator=g, dtype=torch.float64)
    Bm, Cm = torch.randn(S, N, generator=g, dtype=torch.float64), torch.randn(
        S, N, generator=g, dtype=torch.float64)
    leaves = [t.requires_grad_(True) for t in (x, a, Bm, Cm)]
    want = ref.ssd_sequential(*leaves)
    cot = torch.randn(want.shape, generator=g, dtype=torch.float64)
    want_grads = torch.autograd.grad(want, leaves, cot)
    # the reference's dual form, in float64: to float64 rounding
    mine = ref.ssd(*leaves, chunk, torch.matmul)
    torch.testing.assert_close(mine, want, rtol=1e-10, atol=1e-10)
    for got, w in zip(torch.autograd.grad(mine, leaves, cot), want_grads):
        torch.testing.assert_close(got, w, rtol=1e-9, atol=1e-9)
    # the port's chunked scan computes in float32 whatever its inputs:
    # to float32 rounding of sums over a chunk
    f32 = [t.detach().float().requires_grad_(True) for t in (x, a, Bm, Cm)]
    y, _ = pssm.ssd_chunked(f32[0][None], f32[1][None], f32[2][None, :, None].expand(1, S, H, N),
                            f32[3][None, :, None].expand(1, S, H, N), chunk)
    torch.testing.assert_close(y[0].double(), want, rtol=1e-4, atol=1e-4)
    for got, w in zip(torch.autograd.grad(y[0], f32, cot.float()), want_grads):
        torch.testing.assert_close(got.double(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("threshold", [None, 16])  # the flash op's plain path; chunked
def test_attention_without_positions_and_with_a_scale_matches(threshold):
    cfg = tiny_config()
    p = cfg["port"]
    P = dict(weights.generate(cfg, 5, "cpu"))
    pre = "layers.1.b0_attn_moe.attn."
    x = torch.randn(1, SEQ, 64, generator=torch.Generator().manual_seed(3))
    got = pattn.attention({k: P[pre + k] for k in ("wq", "wk", "wv", "wo")}, x,
                          n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"], d_head=p["d_head"],
                          rope_theta=p["rope_theta"], scale=p["attention_multiplier"],
                          chunked_threshold=threshold)
    want = ref.attention(P, pre, x, cfg, MM)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # the scale reaches the scores: the default 1/sqrt(d_head) differs
    plain = pattn.attention({k: P[pre + k] for k in ("wq", "wk", "wv", "wo")}, x,
                            n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"],
                            d_head=p["d_head"], rope_theta=0.0, chunked_threshold=threshold)
    assert not torch.allclose(plain, want, rtol=1e-3, atol=1e-4)


def _share(p: dict, cfg, first: int, held: int):
    """The MoE's parameters and config as the device holding experts
    [first, first + held) sees them: the router's columns turned so that
    its experts come first (a route's place in its expert's queue does not
    depend on the experts' numbering), their weights held."""
    E = cfg.num_experts
    order = list(range(first, first + held)) + [e for e in range(E)
                                                if not first <= e < first + held]
    q = {"router": p["router"][:, order],
         "experts": {k: w[first:first + held] for k, w in p["experts"].items()},
         "shared": p["shared"]}
    return q, dataclasses.replace(cfg, experts_held=held)


def test_the_held_experts_shares_sum_to_the_uncut_layer():
    cfg = tiny_config()
    pcfg = harness.port_config(cfg)
    m = dataclasses.replace(pcfg.moe, experts_held=None)
    g = torch.Generator().manual_seed(4)
    whole = pmoe.moe_init(64, m, generator=g)
    x = torch.randn(ROWS, SEQ, 64, generator=g)
    full = pmoe.moe_apply(whole, x, m)
    shared = pmoe._shared(whole, x, torch.zeros_like(x))
    parts = []
    for first in range(0, m.num_experts, 2):
        q, qm = _share(whole, m, first, 2)
        parts.append(pmoe.moe_apply(q, x, qm))
    # the shared expert counted once; float32 sums in another order
    torch.testing.assert_close(sum(parts) - (len(parts) - 1) * shared, full,
                               rtol=1e-5, atol=1e-6)
    # the reference's layer, uncut and cut, alike
    rc = copy.deepcopy(cfg)
    rc["port"]["moe"]["experts_held"] = m.num_experts
    P = {"m.router": whole["router"], "m.shared.w_gate": whole["shared"]["w_gate"],
         "m.shared.w_up": whole["shared"]["w_up"], "m.shared.w_down": whole["shared"]["w_down"],
         **{f"m.experts.{k}": w for k, w in whole["experts"].items()}}
    want = ref.experts(P, "m.", x, rc, MM)
    torch.testing.assert_close(full, want, rtol=1e-5, atol=1e-6)
    rc["port"]["moe"]["experts_held"] = 2
    for first, part in zip(range(0, m.num_experts, 2), parts):
        q, _ = _share(whole, m, first, 2)
        Pq = dict(P, **{"m.router": q["router"]},
                  **{f"m.experts.{k}": w for k, w in q["experts"].items()})
        torch.testing.assert_close(part, ref.experts(Pq, "m.", x, rc, MM), rtol=1e-5, atol=1e-6)


def test_a_layer_holding_every_expert_is_the_uncut_layer():
    """``experts_held`` equal to the router's width changes no bit."""
    m = get_config("granite-moe-3b-a800m").moe
    g = torch.Generator().manual_seed(6)
    p = pmoe.moe_init(32, m, generator=g)
    x = torch.randn(2, 16, 32, generator=g)
    assert torch.equal(pmoe.moe_apply(p, x, dataclasses.replace(m, experts_held=m.num_experts)),
                       pmoe.moe_apply(p, x, m))


# ----------------------------------------------------------------- the planner

#: the chain inputs and plans of the two accepted cells (1 x 16,384 tokens at
#: 48 and 45 GiB) as the parent of the unlike-unit chain planned them
PINNED_PLANS = {
    "stablelm-3b": dict(
        gib=48, inputs=dict(n_units=32, bytes_boundary=83886080.0, bytes_interior=1602224128.0,
                            flops_unit=2598625607680.0, budget=17996285952.0),
        sizes=(2, 1, 1, 5, 1, 4, 1, 3, 1, 2, 1, 2, 2, 1, 1, 1, 1, 1, 1),
        remat=(0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 1, 0),
        overhead=733.0, peak=17960009728.0),
    "granite-moe-3b-a800m": dict(
        gib=45, inputs=dict(n_units=32, bytes_boundary=50331648.0, bytes_interior=1040187392.0,
                            flops_unit=826749222912.0, budget=7826835456.0),
        sizes=(1, 1, 1, 1, 5, 4, 1, 3, 1, 3, 3, 2, 1, 1, 1, 1, 1, 1),
        remat=(0, 1, 1, 1, 1, 1, 0, 1, 0, 1, 1, 1, 0, 1, 0, 1, 1, 0),
        overhead=855.0, peak=7784628224.0),
}
CELL_SHAPE = ShapeConfig("train-16k.remat", 16384, 1, "train")


@pytest.mark.parametrize("arch", sorted(PINNED_PLANS))
def test_the_accepted_cells_plan_as_before(arch):
    pin = PINNED_PLANS[arch]
    cfg, hbm = get_config(arch), pin["gib"] * 2**30
    pi = launch_plan.plan_inputs(cfg, CELL_SHAPE, 1, model_shards=1, hbm_bytes=hbm)
    assert type(pi) is launch_plan.PlanInputs
    assert dataclasses.asdict(pi) == pin["inputs"]
    g = launch_plan.chain_graph(pi)
    inputs = pin["inputs"]
    assert [(n.time, n.memory) for n in g.nodes] == [
        (inputs["flops_unit"], inputs["bytes_interior"]), (1.0, inputs["bytes_boundary"])] * 32
    assert set(g.edges) == {(i, i + 1) for i in range(63)}
    sp, res = segment_plan(cfg, CELL_SHAPE, hbm_bytes=hbm, device="cpu")
    assert (sp.sizes, tuple(map(int, sp.remat)), sp.n_micro) == (pin["sizes"], pin["remat"], 1)
    assert (res.overhead, res.peak_memory) == (pin["overhead"], pin["peak"])


def test_the_hybrid_chain_prices_each_unit_by_its_kind():
    cfg = harness.port_config(harness.load_json(harness.BENCH / "configs"
                                                / "granite-4.0-h-small.json"))
    pi = launch_plan.plan_inputs(cfg, CELL_SHAPE, 1, model_shards=1, hbm_bytes=60 * 2**30)
    assert isinstance(pi, launch_plan.MixedPlanInputs) and pi.n_units == 10
    units = pi.units()
    mamba, attn = units[0], units[5]
    assert all(u == mamba for i, u in enumerate(units) if i != 5)
    # the Mamba-2 unit multiplies by more weights and keeps more bytes
    assert mamba[0] > attn[0] and mamba[1] > attn[1]
    assert (pi.flops_unit, pi.bytes_interior) == (sum(f for f, _ in units) / 10, mamba[1])
    g = launch_plan.chain_graph(pi)
    assert [n.time for n in g.nodes[::2]] == [f for f, _ in units]
    assert [n.memory for n in g.nodes[::2]] == [b for _, b in units]
    for gib in (50, 60, 70):
        sp, res = segment_plan(cfg, CELL_SHAPE, hbm_bytes=gib * 2**30, device="cpu")
        assert res.feasible and sum(sp.sizes) == 10 and len(sp.remat) == len(sp.sizes)
        assert 0 < sum(s for s, r in zip(sp.sizes, sp.remat) if r) < 10
