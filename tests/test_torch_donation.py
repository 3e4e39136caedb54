"""Donation in the port's lowerings (``tests/test_donation.py`` restated for
torch, and held against JAX).

Torch has no jit donation: the ``"fx"`` and ``"segment"`` twins with
``donate=True`` drop their own references to values that cross segments
once no later segment reads them, and carry the reference's
``donate_argnums`` and per-segment ``donation_hints``.  The hints name
exactly the dead-at-window buffers (and equal the reference's on the same
graphs), donated twins change no values (**bitwise** on the CPU), the
interpreter rejects ``donate`` and its live-byte audit is untouched, and
the census and drift gate stay green on the donated twin.
"""

import gc
import random
import weakref

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import make_plan as rmake_plan  # noqa: E402
from repro.core.lowering.donation import donation_hints as rdonation_hints  # noqa: E402
from repro_torch.analysis import check_hlo  # noqa: E402
from repro_torch.core import PlanCache, Planner, dp, make_plan  # noqa: E402
from repro_torch.core.blockgraph import Block, BlockGraph  # noqa: E402
from repro_torch.core.lower_sets import all_lower_sets  # noqa: E402
from repro_torch.core.liveness import vanilla_peak  # noqa: E402
from repro_torch.core.lowering import (  # noqa: E402
    TracedCarrier,
    plan_function,
    vanilla_traced_value_and_grad,
    vanilla_value_and_grad,
)
from repro_torch.core.lowering.base import reject_donate  # noqa: E402
from repro_torch.core.lowering.donation import donatable_argnums, donation_hints  # noqa: E402
from repro_torch.core.lowering.fx import fx_value_and_grad  # noqa: E402

from conftest import random_dag  # noqa: E402
from test_torch_lowering import assert_bits  # noqa: E402

D = 8


def _mlp(depth=6):
    def fn(params, x):
        h = x
        for w in params:
            h = torch.tanh(h @ w)
        return torch.sum(h * h)

    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(D, D, generator=gen) * 0.3 for _ in range(depth)]
    return fn, (params, torch.randn(4, D, generator=gen))


def _halved_budget(fn, args):
    return vanilla_peak(TracedCarrier.trace(fn, args).to_graph(), liveness=False) / 2


def _planned(fn, args, **kw):
    pf = plan_function(fn, _halved_budget(fn, args), planner=Planner(cache=PlanCache()), **kw)
    return pf.lowered_for(*args)


# --------------------------------------------------------------- hint shape


def test_donation_hints_are_dead_at_window():
    rng = random.Random(0)
    for trial in range(20):
        g = random_dag(rng, rng.randint(2, 8))
        fam = all_lower_sets(g)
        B = dp.min_feasible_budget_exact(g, fam)
        res = dp.solve(g, B, fam)
        if not res.feasible:
            continue
        plan = make_plan(g, res.sequence)
        hints = donation_hints(g, plan)
        assert hints == rdonation_hints(g, rmake_plan(g, res.sequence)), trial
        cached_names = {g.nodes[v].name for v in plan.cached}
        assert set(hints) == {seg.index for seg in plan.segments}
        for seg in plan.segments:
            names = set(hints[seg.index])
            # exactly the cached residuals outside this window's lower set
            assert names == {g.nodes[v].name for v in plan.cached - seg.lower_set}, trial
            assert names <= cached_names
            assert not names & {g.nodes[v].name for v in seg.lower_set}
        # the last window holds every cached residual: nothing is dead
        assert hints[plan.segments[-1].index] == ()


def test_donatable_argnums_skip_differentiated():
    fn, args = _mlp(3)
    assert donatable_argnums(TracedCarrier.trace(fn, args)) == (1,)  # argnums=0
    assert donatable_argnums(TracedCarrier.trace(fn, args, argnums=(0, 1))) == ()
    # BlockGraph convention: f(params, inputs) — inputs donatable
    assert donatable_argnums(object()) == (1,)


# ----------------------------------------------------- values are unchanged


def test_donated_fx_grads_bit_identical():
    """The donated twin == the plain planned twin == plain autograd, bit
    for bit (donation releases references, it changes no value)."""
    fn, args = _mlp()
    plain = _planned(fn, args, backend="fx")
    donated = _planned(fn, args, backend="fx", donate=True)
    assert donated.plan.overhead > 0
    assert donated.run.donate_argnums == (1,)
    assert set(donated.run.donation_hints) == {seg.index for seg in donated.plan.segments}
    assert donated.run.donation_hints == donation_hints(donated.carrier.to_graph(),
                                                        donated.plan)
    out = donated.run(*args)
    assert_bits(out, plain.run(*args))
    assert_bits(out, vanilla_traced_value_and_grad(donated.carrier)(*args))


def test_donated_segment_backend_bit_identical():
    def lin_init(gen, *in_shapes):
        return {"w": torch.randn(D, D, generator=gen) * 0.3}

    def lin(p, *xs):
        h = xs[0]
        for x in xs[1:]:
            h = h + x
        return torch.tanh(h @ p["w"])

    blocks = [Block("b0", lin, ("x",), lin_init)]
    for i in range(1, 5):
        blocks.append(Block(f"b{i}", lin, (f"b{i-1}",), lin_init))
    bg = BlockGraph(blocks, ["x"], ["b4"])
    gen = torch.Generator().manual_seed(3)
    params = bg.init(gen, {"x": (4, D)})
    inputs = {"x": torch.randn(4, D, generator=gen)}
    loss_fn = lambda o: torch.sum(o * o)  # noqa: E731

    planner = Planner(cache=PlanCache())
    budget = planner.min_feasible_budget(bg.to_graph(params, inputs), "exact_dp")
    plain = plan_function(bg, budget, loss_fn=loss_fn, backend="segment",
                          planner=planner).lowered_for(params, inputs)
    donated = plan_function(bg, budget, loss_fn=loss_fn, backend="segment", donate=True,
                            planner=planner).lowered_for(params, inputs)
    assert donated.run.donate_argnums == (1,)
    out = donated.run(params, inputs)
    assert_bits(out, plain.run(params, inputs))
    assert_bits(out, vanilla_value_and_grad(bg, loss_fn)(params, inputs))


def test_donate_rejected_by_the_interpreter():
    fn, args = _mlp(3)
    pf = plan_function(fn, backend="interpreter", donate=True,
                       planner=Planner(cache=PlanCache()))
    with pytest.raises(ValueError, match="donate=True"):
        pf.lowered_for(*args)
    with pytest.raises(ValueError, match="'fx' or 'segment'"):
        reject_donate("interpreter")


def test_donated_forward_releases_what_no_later_segment_reads():
    """The plain twin holds every value that crosses segments to the end of
    the forward; the donated twin only until its last reading segment ran.
    Seen through a weak reference to a matmul's output that one later
    segment reads through an add (which saves nothing for the backward),
    taken when the last node runs."""
    def fn(w, x):
        h = x @ w
        a = torch.tanh(h + 1.0)
        return torch.sum(torch.tanh(a @ w) * a)

    gen = torch.Generator().manual_seed(0)
    args = (torch.randn(D, D, generator=gen), torch.randn(4, D, generator=gen))
    carrier = TracedCarrier.trace(fn, args)
    g = carrier.to_graph()
    fxg = carrier.fx
    first_mm = fxg.nodes[min(v for v in range(g.n) if g.nodes[v].kind == "dot_general")]
    # every node its own segment, nothing recomputed: every value crosses
    plan = make_plan(g, [frozenset(range(i + 1)) for i in range(g.n)])
    run_node = fxg.run_node
    alive = {}

    def spy(n, get, donate):
        out = run_node(n, get)
        if n is first_mm:
            alive["mm"] = weakref.ref(out)
        if n is fxg.output:
            gc.collect()
            alive[donate] = alive["mm"]() is not None
        return out

    for donate in (False, True):
        run = fx_value_and_grad(carrier, plan, donate=donate)
        fxg.run_node = lambda n, get, _d=donate: spy(n, get, _d)
        try:
            out = run(*args)
        finally:
            del fxg.run_node
        assert_bits(out, vanilla_traced_value_and_grad(carrier)(*args))
    assert alive == {"mm": alive["mm"], False: True, True: False}


# --------------------------------------------------- audit + drift unchanged


def test_interpreter_audit_unchanged_by_donation():
    """Donation is lowering-local: the same plan's interpreter live-byte
    trace is identical before and after a donated lowering ran."""
    fn, args = _mlp()
    planner = Planner(cache=PlanCache())
    budget = _halved_budget(fn, args)
    audit = plan_function(fn, budget, backend="interpreter", track_live=True, planner=planner)
    _, _, live_before = audit(*args)
    donated = plan_function(fn, budget, backend="fx", donate=True,
                            planner=planner).lowered_for(*args)
    donated.run(*args)
    _, _, live_after = audit(*args)
    assert live_before == live_after
    assert max(b for _, b in live_after) <= donated.plan.peak_memory


def test_drift_gate_green_on_donated_twin():
    """check_hlo with donate=True: the donated twin passes the same census
    and memory-drift gate as the plain lowering (on the CPU the gate warns
    that the allocator keeps no statistics)."""
    fn, args = _mlp(4)
    carrier = TracedCarrier.trace(fn, args)
    planner = Planner(cache=PlanCache())
    g = carrier.to_graph()
    rep = planner.plan(g, planner.min_feasible_budget(g))
    assert rep.plan is not None
    r = check_hlo(carrier, rep.plan, args=args, donate=True)
    assert r.ok, str(r.findings)
