"""The MoE dispatch's choice of route between the CUDA kernels
(``repro_torch.kernels.moe_dispatch``) and the plain version, and the
custom ops that carry the kernels, on the CPU.

A CPU tensor, a tensor of a ``make_fx`` trace on the CPU, a fake CPU tensor
and a CPU DTensor take the plain ``_pack``/``_combine`` of ``models.moe``,
and the kernels' wrappers are never called.  A trace of fake CUDA tensors
records the custom ops, one node each, and launches nothing; the effect
analysis finds them pure.  The ops' CPU kernels, their plain statements,
give ``_pack``'s and ``_combine``'s values and gradients through the ops'
own autograd formulas, on plain tensors, on DTensors (a sharding rule) and
on a collective's pending result.  The wrappers refuse what the kernels
cannot take (a CPU tensor; on fake CUDA tensors, a dtype, E and K), before
any launch and with no fallback.  The kernels themselves are held against
the plain version on the card (``tests/test_torch_moe_dispatch_cuda.py``).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import fx_graph  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]
D = 32
LAUNCHERS = ("slot_rows", "pack_rows", "pack_rows_bwd", "combine_rows", "combine_rows_bwd")
WRAPPERS = ("slot_map", "pack", "combine") + LAUNCHERS
OPS = ("moe_slots", "moe_pack", "moe_combine")


def setup(arch, tokens=64, skew=0.0, capacity_factor=None, seed=0):
    """The arch's MoE config (full E and K) at width D, its weights and an
    input (2, tokens/2, D); ``skew`` adds one shared direction to every
    token, which crowds the routes onto a few experts."""
    cfg = get_config(arch).moe
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    g = torch.Generator().manual_seed(seed)
    p = moe.moe_init(D, cfg, generator=g)
    x = torch.randn(2, tokens // 2, D, generator=g) + skew * torch.randn(D, generator=g)
    return cfg, p, x


def refusing(monkeypatch, names):
    def refuse(name):
        def call(*a, **kw):
            raise AssertionError(f"moe_dispatch.{name} was called")
        return call

    for name in names:
        monkeypatch.setattr(md, name, refuse(name))


@pytest.fixture
def no_kernels(monkeypatch):
    """Every kernel wrapper replaced by one that fails the test."""
    refusing(monkeypatch, WRAPPERS)


@pytest.fixture
def no_launches(monkeypatch):
    """Every launcher of a kernel (the ops' CUDA kernels) replaced by one
    that fails the test."""
    refusing(monkeypatch, LAUNCHERS)


def loss_and_grads(p, x, cfg):
    leaves = [p["router"], *p["experts"].values()]
    x = x.detach().requires_grad_()
    for t in leaves:
        t.requires_grad_()
    y = moe.moe_apply(p, x, cfg)
    return y.detach(), torch.autograd.grad(y.square().sum(), [*leaves, x])


@pytest.mark.parametrize("arch", ARCHS)
def test_a_cpu_tensor_takes_the_plain_version(arch, no_kernels):
    cfg, p, x = setup(arch, skew=2.0)
    xt = x.reshape(-1, D)
    assert not md.kernel_route(xt)
    _, ids, _, _ = moe._route(p["router"], xt, cfg)
    _, routes = moe._dispatch(xt, ids, cfg.num_experts, moe.capacity(cfg, xt.shape[0]))
    assert isinstance(routes, tuple) and len(routes) == 3  # (eid, pos_c, keep)
    y, grads = loss_and_grads(p, x, cfg)
    assert torch.isfinite(y).all() and all(torch.isfinite(g).all() for g in grads)


def test_a_collective_result_in_flight_is_eager():
    """A functional collective's output not yet waited for (what a DTensor's
    local shard or an all-to-all returns) is waited for by its own dispatch
    before an op runs: the op's kernel reads a plain tensor and gives what
    the plain tensor gives.  Its device chooses the route (here, plain)."""
    from torch.distributed._functional_collectives import AsyncCollectiveTensor

    cfg, p, x = setup(ARCHS[0])
    xt = x.reshape(-1, D)
    _, ids, _, _ = moe._route(p["router"], xt, cfg)
    E, cap = cfg.num_experts, moe.capacity(cfg, xt.shape[0])
    act = AsyncCollectiveTensor(ids)
    assert not md.kernel_route(act)
    got, want = md.moe_slots_op(act, E, cap), md.moe_slots_op(ids, E, cap)
    assert all(type(t) is torch.Tensor and torch.equal(a, t) for a, t in zip(want, got))


@pytest.mark.parametrize("context", ["trace", "fake"])
def test_traces_and_fake_tensors_take_the_plain_version(context, no_kernels):
    """Under ``trace_module`` (make_fx in fake mode) and under a fake mode
    of its own, a CPU tensor takes the plain version, which is traced."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, p, x = setup(ARCHS[0])
    seen = []

    def fn(pp, xx):
        seen.append(md.kernel_route(xx))
        return moe.moe_apply(pp, xx, cfg)

    if context == "trace":
        gm = fx_graph.trace_module(fn, p, x)
        targets = {str(n.target) for n in gm.graph.nodes}
        assert "aten.cumsum.default" in targets and "aten.index_put.default" in targets
    else:
        with FakeTensorMode(allow_non_fake_inputs=True):
            y = fn(p, x)
        assert type(y).__name__ == "FakeTensor"
    assert seen == [False]


def test_a_dtensor_takes_the_plain_version(tmp_path, no_kernels):
    """A CPU DTensor on the dense fallback (a one-rank mesh) takes the plain
    version, and the layer gives what it gives the plain tensor, bitwise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.core.lowering.base import on_mesh

    cfg, p, x = setup(ARCHS[0], skew=2.0)
    want = moe.moe_apply(p, x, cfg)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        xd, router, *experts = (distribute_tensor(t, mesh, [Replicate()])
                                for t in (x, p["router"], *p["experts"].values()))
        assert not md.kernel_route(xd.reshape(-1, D))
        with on_mesh([xd]):
            got = moe.moe_apply({"router": router,
                                 "experts": dict(zip(p["experts"], experts))}, xd, cfg)
        assert torch.equal(got.full_tensor(), want)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", ["cpu", "dtype", "experts", "top_k"])
def test_the_wrappers_refuse_what_the_kernels_cannot_take(case):
    """A CPU tensor, and on fake CUDA tensors an unsupported dtype, E or K:
    the refusal comes before any launch, and nothing falls back."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    T, K, E, cap = 16, 8, 40, 8
    if case == "cpu":
        with pytest.raises(ValueError, match="CUDA tensors"):
            md.slot_map(torch.zeros(T, K, dtype=torch.int64), E, cap)
        return
    with FakeTensorMode():
        i32 = dict(dtype=torch.int32, device="cuda")
        sm = md.SlotMap(torch.empty(T * K, **i32), torch.empty(E * cap, **i32),
                        torch.empty(E, **i32), cap)
        if case == "dtype":
            with pytest.raises(TypeError, match="float16"):
                md.pack(torch.empty(T, D, dtype=torch.float16, device="cuda"), sm)
        elif case == "experts":
            with pytest.raises(ValueError, match="experts"):
                md.slot_map(torch.zeros(T, K, dtype=torch.int64, device="cuda"),
                            md.MAX_EXPERTS + 1, cap)
        else:
            with pytest.raises(ValueError, match="top-k"):
                md.slot_map(torch.zeros(T, md.MAX_TOP_K + 1, dtype=torch.int64, device="cuda"),
                            E, cap)


def fake_cuda(p, x):
    """Fake CUDA twins of the weights and the input (no card needed)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return ({"router": torch.empty(p["router"].shape, device="cuda"),
                 "experts": {k: torch.empty(w.shape, device="cuda")
                             for k, w in p["experts"].items()}},
                torch.empty(x.shape, device="cuda"))


@pytest.mark.parametrize("arch", ARCHS)
def test_a_trace_on_the_card_records_one_node_an_op(arch, no_launches):
    """``trace_module`` on fake CUDA tensors records the slot map, the pack
    and the combine as one custom-op node each, with no cumsum and no
    index_put, and launches nothing; replaying the graph on the card runs
    the kernels.  The effect analysis classes the ops pure."""
    from repro_torch.analysis import effects

    cfg, p, x = setup(arch)
    gm = fx_graph.trace_module(lambda pp, xx: moe.moe_apply(pp, xx, cfg), *fake_cuda(p, x))
    targets = [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]
    assert [t for t in targets if t.startswith("repro_torch.")] == [
        f"repro_torch.{op}.default" for op in OPS]
    assert not any("cumsum" in t or "index_put" in t for t in targets)
    classes = {e.primitive: e.klass
               for e in effects.classify_eqns(fx_graph.from_graph_module(gm))}
    assert {classes[f"repro_torch::{op}"] for op in OPS} == {"pure"}


def plain_and_ops(cfg, p, x, dtype):
    """The dispatch of ``x`` with the plain ``_pack``/``_combine`` and with
    the ops' CPU kernels, on the same expert rows and gates: (assignment,
    buffer, y and the gradients of x, the rows and the gates) of each.
    With held experts (``cfg.experts_held``) the buffer holds those, and a
    route to another expert takes no slot."""
    xt = x.reshape(-1, D).to(dtype)
    T, E, K = xt.shape[0], cfg.held, cfg.top_k
    cap = moe.capacity(cfg, T)
    gates, ids, _, _ = moe._route(p["router"], xt, cfg)
    g = torch.Generator().manual_seed(1)
    out_e = torch.randn(E, cap, D, generator=g).to(dtype)
    dy = torch.randn(T, D, generator=g).to(dtype)
    runs = []
    for plain in (True, False):
        xr, er = xt.clone().requires_grad_(), out_e.clone().requires_grad_()
        gr = gates.detach().clone().requires_grad_()
        if plain:
            disp, eid, pos_c, keep = moe._pack(xr, ids, E, cap, absent=E < cfg.num_experts)
            assign = torch.where(keep, eid * cap + pos_c, -1)
            y = moe._combine(er, eid, pos_c, keep, gr, T, K)
        else:
            slot, src, counts = md.moe_slots_op(ids, E, cap)
            held = ids.reshape(-1)[ids.reshape(-1) < E]
            assert torch.equal(counts.long(), torch.bincount(held, minlength=E))
            kept = torch.nonzero(slot >= 0).reshape(-1)
            assert torch.equal(src[slot[kept].long()].long(), kept)
            assign = slot.long()
            disp = md.moe_pack_op(xr, slot, src, counts, cap)
            y = md.moe_combine_op(er, gr, slot, counts)[0]
        d_x = torch.autograd.grad(disp, xr, out_e)[0]
        runs.append([assign, disp.detach(), y.detach(), d_x,
                     *torch.autograd.grad(y, [er, gr], dy)])
    return runs


@pytest.mark.parametrize("skew", [0.0, 2.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_the_ops_cpu_kernels_are_the_plain_version(arch, skew):
    """In f32 the ops, through their autograd formulas, give the plain
    version's assignment, buffer, output and gradients bitwise; with
    ``skew`` most routes crowd onto a few experts and drop."""
    cfg, p, x = setup(arch, skew=skew)
    plain, ops = plain_and_ops(cfg, p, x, torch.float32)
    names = ["assignment", "buffer", "y", "d_x", "d_rows", "d_gates"]
    assert [n for n, a, b in zip(names, plain, ops) if not torch.equal(a, b)] == []


@pytest.mark.parametrize("skew", [0.0, 2.0])
@pytest.mark.parametrize("held", [1, 3, 8])
def test_held_experts_ops_cpu_kernels_are_the_plain_version(held, skew):
    """A layer holding ``held`` of granite-4.0-h's 72 experts: the slot map's
    plain statement gives a route to an expert from ``held`` up no slot and
    counts it nowhere, as ``_pack`` with ``absent`` masks it; assignment,
    buffer, output and gradients bitwise in f32."""
    cfg, p, x = setup("granite-4.0-h-small", skew=skew)
    cfg = dataclasses.replace(cfg, experts_held=held)
    plain, ops = plain_and_ops(cfg, p, x, torch.float32)
    names = ["assignment", "buffer", "y", "d_x", "d_rows", "d_gates"]
    assert [n for n, a, b in zip(names, plain, ops) if not torch.equal(a, b)] == []
    assert plain[1].shape[0] == held
    assign = plain[0]
    assert (assign >= 0).any() and (assign < held * moe.capacity(cfg, 64)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_the_ops_cpu_kernels_round_as_the_plain_version_in_bf16(arch):
    """In bf16 the assignment, the buffer and the gradients of x and the rows
    are the plain version's bitwise; y and the gates' gradient, sums
    rounded once, within one rounding of bf16."""
    cfg, p, x = setup(arch, skew=2.0)
    plain, ops = plain_and_ops(cfg, p, x, torch.bfloat16)
    for a, b in zip(plain[:2] + plain[3:5], ops[:2] + ops[3:5]):
        assert torch.equal(a, b)
    for a, b in (plain[2], ops[2]), (plain[5], ops[5]):
        torch.testing.assert_close(b.float(), a.float(), rtol=2.0**-7, atol=2.0**-7)


def test_the_ops_take_dtensors(tmp_path):
    """On DTensors (a one-rank mesh) the ops run through their sharding
    rule on replicated operands and give the plain tensors' values and
    gradients, bitwise, as replicated DTensors."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    cfg, p, x = setup(ARCHS[0], skew=2.0)
    xt = x.reshape(-1, D)
    E, cap = cfg.num_experts, moe.capacity(cfg, xt.shape[0])
    gates, ids, _, _ = moe._route(p["router"], xt, cfg)
    out_e = torch.randn(E, cap, D, generator=torch.Generator().manual_seed(1))

    def run(xx, ii, ee, gg):
        slot, src, counts = md.moe_slots_op(ii, E, cap)
        disp = md.moe_pack_op(xx, slot, src, counts, cap)
        return md.moe_combine_op(ee + disp, gg, slot, counts)[0]

    leaves = [xt, out_e, gates.detach()]
    plain = [t.clone().requires_grad_() for t in leaves]
    y = run(plain[0], ids, plain[1], plain[2])
    want = [y, *torch.autograd.grad(y.square().sum(), plain)]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        dl = [distribute_tensor(t.clone(), mesh, [Replicate()]).requires_grad_() for t in leaves]
        yd = run(dl[0], distribute_tensor(ids, mesh, [Replicate()]), dl[1], dl[2])
        got = [yd, *torch.autograd.grad(yd.square().sum(), dl)]
        assert tuple(yd.placements) == (Replicate(),)
        assert all(torch.equal(a.full_tensor(), b) for a, b in zip(got, want))
    finally:
        dist.destroy_process_group()
