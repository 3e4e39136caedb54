"""The MoE dispatch kernels (``repro_torch.kernels.moe_dispatch``) against the
plain version of ``models.moe``, on the card.

This file imports neither jax nor the reference, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_moe_dispatch_cuda.py

Without a card every case skips.  Each case runs ``moe_apply`` forward and
backward at a full-size shape twice on the kernels and once on the plain
version (the route forced off): the slot map is bitwise the plain
``_pack``'s assignment (a layer holding some of the router's experts too), the output and the gradients of x, the router and
the experts agree within the working dtype's rounding, the two kernel runs
are bitwise equal, and each kernel launched once.  A DTensor and a
collective's pending result take the kernels; so does a trace on the card
replayed by ``plan_function``'s twins.
"""

import dataclasses
import importlib

import pytest

torch = pytest.importorskip("torch")

md = importlib.import_module("repro_torch.kernels.moe_dispatch")
moe = importlib.import_module("repro_torch.models.moe")
configs = importlib.import_module("repro_torch.configs")

# case: (arch, tokens, dtype, skew, share of routes dropped: (at least, at most))
CASES = {
    # granite's training shape (T 16,384, K 8, E 40, cap 4,096), routes
    # crowded onto a few experts so that most drop, as the seed's weights do
    "granite_skewed": ("granite-moe-3b-a800m", 16384, "bfloat16", 6.0, (0.6, 1.0)),
    "granite_roomy": ("granite-moe-3b-a800m", 16384, "bfloat16", 0.0, (0.0, 0.05)),
    # qwen3-moe's 128 experts (cap 1,280) in f32, as its production ranks run
    "qwen3_e128": ("qwen3-moe-30b-a3b", 16384, "float32", 0.0, (0.0, 0.05)),
    # a decode step of 16 slots: cap 8
    "granite_decode": ("granite-moe-3b-a800m", 16, "bfloat16", 0.0, (0.0, 1.0)),
}
# the working dtype's rounding: bf16 sums of K rounded once may differ by a
# unit in the last place (2**-7 of the value) where f32 adds in another order
RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def setup(arch, tokens, dtype, skew, seed=0):
    """The arch's full-width MoE layer, its f32 weights, an input (1, T, D)
    in ``dtype`` and a cotangent, on the card."""
    cfg = configs.get_config(arch)
    g = torch.Generator().manual_seed(seed)
    p = moe.moe_init(cfg.d_model, cfg.moe, generator=g)
    p = {"router": p["router"].cuda(), "experts": {k: w.cuda() for k, w in p["experts"].items()}}
    x = torch.randn(1, tokens, cfg.d_model, generator=g)
    x = x + skew * torch.randn(cfg.d_model, generator=g)
    cot = torch.randn(1, tokens, cfg.d_model, generator=g)
    dt = getattr(torch, dtype)
    return cfg.moe, p, x.to("cuda", dt), cot.to("cuda", dt)


def run(p, x, cot, cfg):
    """y and the gradients of x, the router and the three expert weights."""
    leaves = [p["router"], *p["experts"].values()]
    x = x.detach().clone().requires_grad_()
    for t in leaves:
        t.requires_grad_()
    y = moe.moe_apply(p, x, cfg)
    grads = torch.autograd.grad(y, [x, *leaves], cot)
    torch.cuda.synchronize()
    return [y.detach(), *grads]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_the_plain_version(case, monkeypatch):
    needs_card()
    arch, tokens, dtype, skew, (lo, hi) = CASES[case]
    cfg, p, x, cot = setup(arch, tokens, dtype, skew)
    T, E, K = tokens, cfg.num_experts, cfg.top_k
    cap = moe.capacity(cfg, T)
    xt = x.reshape(T, -1)
    _, ids, _, _ = moe._route(p["router"], xt, cfg)
    _, eid, pos_c, keep = moe._pack(xt, ids, E, cap)
    dropped = float((~keep).float().mean())
    assert lo <= dropped <= hi, f"{case}: {dropped:.3f} of the routes dropped"

    sm = md.slot_map(ids, E, cap)
    torch.cuda.synchronize()
    assert torch.equal(sm.slot.long(), torch.where(keep, eid * cap + pos_c, -1))
    assert torch.equal(sm.counts.long(), torch.bincount(eid, minlength=E))
    kept = torch.nonzero(keep).reshape(-1)  # the kernel writes src at the kept slots only
    assert torch.equal(sm.src[sm.slot[kept].long()].long(), kept)
    again = md.slot_map(ids, E, cap)
    assert torch.equal(again.slot, sm.slot) and torch.equal(again.counts, sm.counts)
    assert torch.equal(again.src[sm.slot[kept].long()], sm.src[sm.slot[kept].long()])

    md.reset_launch_counts()
    got = run(p, x, cot, cfg)
    assert md.LAUNCHES == {name: 1 for name in md.KERNELS}, md.LAUNCHES
    assert all(torch.equal(a, b) for a, b in zip(run(p, x, cot, cfg), got)), \
        "two runs on the kernels differ"
    monkeypatch.setattr(md, "kernel_route", lambda t: False)
    md.reset_launch_counts()
    want = run(p, x, cot, cfg)
    assert not any(md.LAUNCHES.values())

    rtol = RTOL[dtype]
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=rtol, atol=rtol * 0.1)
    for name, a, b in zip(["x", "router", "w_gate", "w_up", "w_down"], got[1:], want[1:]):
        gap = float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))
        assert gap <= rtol, f"{case}: grad {name} {gap:.3e} from the plain version's"


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [0.0, 6.0])
def test_held_experts_take_the_slot_map(skew, monkeypatch):
    """granite-4.0-h's layer at its training shape (T 16,384, K 10 of 72,
    cap 2,844), holding experts 0-8: the slot map gives every route to an
    expert from 9 up no slot and counts it nowhere, bitwise the plain
    ``_pack``'s assignment with those routes masked; the layer's output and
    gradients on the (9, cap, D) buffer agree with the plain version's."""
    needs_card()
    cfg, p, x, cot = setup("granite-4.0-h-small", 16384, "bfloat16", skew)
    cfg = dataclasses.replace(cfg, experts_held=9)
    p["experts"] = {k: w[:9].contiguous() for k, w in p["experts"].items()}
    T, held = 16384, 9
    cap = moe.capacity(cfg, T)
    xt = x.reshape(T, -1)
    _, ids, _, _ = moe._route(p["router"], xt, cfg)
    assert int((ids >= held).sum()) > 0
    _, eid, pos_c, keep = moe._pack(xt, ids, held, cap, absent=True)
    sm = md.slot_map(ids, held, cap)
    torch.cuda.synchronize()
    assert torch.equal(sm.slot.long(), torch.where(keep, eid * cap + pos_c, -1))
    flat = ids.reshape(-1)
    assert torch.equal(sm.counts.long(), torch.bincount(flat[flat < held], minlength=held))
    kept = torch.nonzero(keep).reshape(-1)
    assert torch.equal(sm.src[sm.slot[kept].long()].long(), kept)

    md.reset_launch_counts()
    got = run(p, x, cot, cfg)
    assert md.LAUNCHES == {name: 1 for name in md.KERNELS}, md.LAUNCHES
    monkeypatch.setattr(md, "kernel_route", lambda t: False)
    want = run(p, x, cot, cfg)
    rtol = RTOL["bfloat16"]
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=rtol, atol=rtol * 0.1)
    for name, a, b in zip(["x", "router", "w_gate", "w_up", "w_down"], got[1:], want[1:]):
        gap = float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))
        assert gap <= rtol, f"held: grad {name} {gap:.3e} from the plain version's"


@pytest.mark.cuda
def test_a_collective_result_in_flight_takes_the_kernels():
    """An input that is a functional collective's result not yet waited for
    (torch's AsyncCollectiveTensor, as the mesh path's local shards and
    all-to-all outputs are) runs the kernels and gives what the plain tensor
    gives, bitwise, with its gradient."""
    needs_card()
    from torch.distributed._functional_collectives import AsyncCollectiveTensor

    cfg, p, x, cot = setup("granite-moe-3b-a800m", 2048, "bfloat16", 6.0)
    want = run(p, x, cot, cfg)
    md.reset_launch_counts()
    xa = AsyncCollectiveTensor(x.detach().clone().requires_grad_())
    y = moe.moe_apply(p, xa, cfg)
    got = [y.detach(), *torch.autograd.grad(y, [xa, p["router"], *p["experts"].values()], cot)]
    torch.cuda.synchronize()
    assert md.LAUNCHES == {name: 1 for name in md.KERNELS}, md.LAUNCHES
    for name, a, b in zip(["y", "x", "router", "w_gate", "w_up", "w_down"], got, want):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_the_kernels_refuse_what_they_cannot_take():
    """No fallback on the card: an unsupported dtype or too many experts
    raise, from the wrappers and from the layer."""
    needs_card()
    cfg, p, x, _ = setup("granite-moe-3b-a800m", 64, "float32", 0.0)
    xt = x.reshape(64, -1)
    _, ids, _, _ = moe._route(p["router"], xt, cfg)
    sm = md.slot_map(ids, cfg.num_experts, 16)
    with pytest.raises(TypeError, match="float16"):
        md.pack(xt.half(), sm)
    with pytest.raises(TypeError, match="float16"):
        moe.moe_apply(p, x.half(), cfg)
    with pytest.raises(ValueError, match="experts"):
        md.slot_map(ids, md.MAX_EXPERTS + 1, 16)
    wide = dataclasses.replace(cfg, num_experts=md.MAX_EXPERTS + 1, d_ff_expert=8)
    pw = moe.moe_init(x.shape[-1], wide, device="cuda")
    with pytest.raises(ValueError, match="experts"):
        moe.moe_apply(pw, x, wide)


@pytest.mark.cuda
def test_a_dtensor_on_the_card_takes_the_kernels(tmp_path):
    """A DTensor on the dense fallback (a one-rank mesh) runs the kernels
    through the ops' sharding rule, each once, and gives what the plain
    tensor on the kernels gives, bitwise."""
    needs_card()
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.core.lowering.base import on_mesh

    cfg, p, x, _ = setup("granite-moe-3b-a800m", 256, "bfloat16", 0.0)
    with torch.no_grad():
        want = moe.moe_apply(p, x, cfg)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        xd, router, *experts = (distribute_tensor(t, mesh, [Replicate()])
                                for t in (x, p["router"], *p["experts"].values()))
        md.reset_launch_counts()
        with on_mesh([xd]), torch.no_grad():
            got = moe.moe_apply({"router": router, "experts": dict(zip(p["experts"], experts))},
                                xd, cfg)
        assert md.LAUNCHES == {"moe_slots": 1, "moe_pack": 1, "moe_pack_bwd": 0,
                               "moe_combine": 1, "moe_combine_bwd": 0}, md.LAUNCHES
        assert torch.equal(got.full_tensor(), want)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_a_planned_trace_on_the_card_launches_the_kernels():
    """``plan_function`` traces the layer on the card into one node per op,
    and its planned twin, and plain autograd over the same trace, run the
    kernels: the slot map, the pack and the combine once a forward (again
    for each recomputed op node), the combine's backward once (the layer's
    input is not differentiated, so the pack has none).  The planned loss
    and gradients are the plain twin's bitwise (the plan keeps the trace's
    order), and eager autograd's within bf16 rounding."""
    needs_card()
    import repro_torch
    from repro_torch.core.lowering import vanilla_traced_value_and_grad

    cfg, p, x, _ = setup("granite-moe-3b-a800m", 2048, "bfloat16", 6.0)

    def loss(pp, xx):
        return moe.moe_apply(pp, xx, cfg).float().square().mean()

    leaves = [p["router"], *p["experts"].values()]
    for t in leaves:
        t.requires_grad_()
    eager = loss(p, x)
    eager_grads = torch.autograd.grad(eager, leaves)
    planned = repro_torch.plan_function(loss)
    lowered = planned.lowered_for(p, x)
    kinds = [nd.kind for nd in lowered.carrier.to_graph().nodes]
    assert [k for k in kinds if k.startswith("repro_torch::moe")] == [
        "repro_torch::moe_slots", "repro_torch::moe_pack", "repro_torch::moe_combine"]
    rec = set().union(*(s.recompute for s in lowered.plan.segments))
    rec_kinds = [kinds[i] for i in rec]
    runs = []
    for run, again in ((vanilla_traced_value_and_grad(lowered.carrier), 0), (planned, 1)):
        md.reset_launch_counts()
        value, grads = run(p, x)
        torch.cuda.synchronize()
        want = {name: 1 + again * rec_kinds.count(f"repro_torch::{name}")
                for name in ("moe_slots", "moe_pack", "moe_combine")}
        want.update(moe_pack_bwd=0, moe_combine_bwd=1)
        assert md.LAUNCHES == want, (md.LAUNCHES, rec_kinds)
        runs.append((value, [grads["router"], *grads["experts"].values()]))
    (v0, g0), (v1, g1) = runs
    assert torch.equal(v0, v1) and all(torch.equal(a, b) for a, b in zip(g0, g1))
    rtol = RTOL["bfloat16"]
    assert abs(float(v1 - eager)) <= rtol * abs(float(eager))
    for name, a, b in zip(["router", "w_gate", "w_up", "w_down"], g1, eager_grads):
        gap = float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))
        assert gap <= rtol, f"grad {name} {gap:.3e} from eager autograd's"
