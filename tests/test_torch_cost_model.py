"""The port's measured and compiled cost profiles (``tests/test_plan_cache.py``'s
cost-model tests and ``tests/test_hlo_analysis.py``'s compiled calibration
restated for torch, and held against JAX).

* ``profile_ops`` times the reference's three ops (the flash-attention
  custom op among them) on the CPU and keys the profile by device and torch
  version; ``load_or_profile`` measures once and reads the file after.
* ``calibrated_graph`` and ``compiled_calibrated_graph`` equal the
  reference's **bitwise** (times, digests) for the same profile numbers and
  segment costs; ``REPRO_MEASURED_COSTS=1`` plans the launcher's chain as
  the reference does under the same profile.
* ``analysis.costs.extract_segment_costs`` (``FlopCounterMode`` on fake
  tensors, bytes from the trace) counts a segment's matmul FLOPs exactly.
* ``plan_function(cost_model="compiled")`` re-plans on the re-priced graph
  and its grads are **bitwise** plain autograd.
"""

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_config as rget_config  # noqa: E402
from repro.core import cost_model as rcost  # noqa: E402
from repro.core.graph import graph_digest as rgraph_digest  # noqa: E402
from repro.launch import plan as rplan  # noqa: E402
from repro_torch.analysis.costs import extract_segment_costs  # noqa: E402
from repro_torch.configs import get_config as pget_config  # noqa: E402
from repro_torch.core import PlanCache, Planner, cost_model  # noqa: E402
from repro_torch.core.graph import graph_digest  # noqa: E402
from repro_torch.core.lowering import (  # noqa: E402
    TracedCarrier,
    plan_function,
    vanilla_traced_value_and_grad,
)
from repro_torch.launch import plan as pplan  # noqa: E402
from repro_torch.launch.mesh import REFERENCE_HBM_BYTES  # noqa: E402

from test_torch_launch_plan import ARCH, same_plan, shapes  # noqa: E402
from test_torch_lowering import assert_bits  # noqa: E402

RATES = dict(sec_per_flop_matmul=3.1e-15, sec_per_flop_attention=7.3e-15,
             sec_per_byte_elementwise=4.7e-13, backend="cuda-test", jax_version="x")


def _mlp(depth=6, width=16):
    def fn(params, x):
        h = x
        for w in params:
            h = torch.tanh(h @ w)
        return torch.sum(h * h)

    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(width, width, generator=gen) * 0.3 for _ in range(depth)]
    return fn, (params, torch.randn(8, width, generator=gen))


# ---------------------------------------------------------------------------
# Measuring and storing a profile
# ---------------------------------------------------------------------------


def test_profile_ops_on_the_cpu():
    prof = cost_model.profile_ops(matmul_dim=64, elem_elems=1 << 12, repeats=2,
                                  device="cpu")
    assert prof.backend == "cpu" and prof.jax_version == torch.__version__
    assert prof.source == "measured" and prof.profile_key() == f"cpu-{torch.__version__}-v1"
    for rate in (prof.sec_per_flop_matmul, prof.sec_per_flop_attention,
                 prof.sec_per_byte_elementwise):
        assert 0 < rate < 1e-3


def test_profile_ops_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cost_model.profile_ops()


def test_load_or_profile_disk_cached(tmp_path):
    calls = []

    def fake_profiler(device):
        calls.append(device)
        return dataclasses.replace(cost_model.DEFAULT_PROFILE, backend="cpu",
                                   jax_version=torch.__version__, source="measured")

    d = str(tmp_path)
    p1 = cost_model.load_or_profile(cache_dir=d, profiler=fake_profiler, device="cpu")
    p2 = cost_model.load_or_profile(cache_dir=d, profiler=fake_profiler, device="cpu")
    assert calls == [torch.device("cpu")]  # the second load came from disk
    assert p1 == p2
    path = os.path.join(d, "profiles", f"op_profile_cpu_{torch.__version__}_v1.json")
    raw = json.load(open(path))
    assert raw["version"] == 1 and raw["backend"] == "cpu"
    # a torn file is measured again, not trusted
    with open(path, "w") as f:
        f.write("{broken")
    assert cost_model.load_or_profile(cache_dir=d, profiler=fake_profiler,
                                      device="cpu") == p1
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# Applying a profile: bitwise the reference's
# ---------------------------------------------------------------------------


def _same_graph(p, r):
    assert p.time_v == r.time_v and p.mem_v == r.mem_v
    assert p.cost_source == r.cost_source
    assert graph_digest(p) == rgraph_digest(r)


@pytest.mark.parametrize("levels", [32, 64])
def test_calibrated_graph_bitwise_the_reference(levels):
    rs, ps = shapes(1024, 8)
    rpi = rplan.plan_inputs(rget_config(ARCH), rs, 1, model_shards=1)
    ppi = pplan.plan_inputs(pget_config(ARCH), ps, 1, model_shards=1,
                            hbm_bytes=REFERENCE_HBM_BYTES)
    got = cost_model.calibrated_graph(pplan.chain_graph(ppi), cost_model.OpProfile(**RATES),
                                      levels=levels)
    want = rcost.calibrated_graph(rplan.chain_graph(rpi), rcost.OpProfile(**RATES),
                                  levels=levels)
    _same_graph(got, want)


def test_compiled_calibrated_graph_bitwise_the_reference():
    fn, args = _mlp()
    g = TracedCarrier.trace(fn, args, cost_model="flops").to_graph()
    planner = Planner(cache=PlanCache())
    plan = planner.plan(g, planner.min_feasible_budget(g)).plan
    seg_costs = [{"flops": 1e6 * (i + 1), "bytes": 3e4 * (i + 2)}
                 for i in range(plan.num_segments)]
    profile = dataclasses.replace(cost_model.DEFAULT_PROFILE, source="compiled")
    got = cost_model.compiled_calibrated_graph(g, plan, seg_costs, profile)
    want = rcost.compiled_calibrated_graph(g, plan, seg_costs,
                                           dataclasses.replace(rcost.DEFAULT_PROFILE,
                                                               source="compiled"))
    _same_graph(got, want)
    assert got.cost_source.startswith("compiled:") and graph_digest(got) != graph_digest(g)
    # the default profile is the analytic one, sourced "compiled"
    _same_graph(cost_model.compiled_calibrated_graph(g, plan, seg_costs),
                rcost.compiled_calibrated_graph(g, plan, seg_costs))


def test_measured_chain_costs_plan_as_the_reference(monkeypatch):
    """``REPRO_MEASURED_COSTS=1``: the launcher's chain priced by the same
    profile numbers in both packages gives the same plan."""
    monkeypatch.setenv("REPRO_MEASURED_COSTS", "1")
    seen = []

    def port_profile(cache_dir=None, profiler=None, device="cuda"):
        seen.append(device)
        return cost_model.OpProfile(**RATES)

    monkeypatch.setattr(cost_model, "load_or_profile", port_profile)
    monkeypatch.setattr(rcost, "load_or_profile", lambda *a, **k: rcost.OpProfile(**RATES))
    rs, ps = shapes(1024, 8)
    r = rplan.plan_unit_segments(rget_config(ARCH), rs, 1, model_shards=1)
    p = pplan.plan_unit_segments(pget_config(ARCH), ps, 1, model_shards=1,
                                 hbm_bytes=REFERENCE_HBM_BYTES, device="cpu")
    same_plan(p, r)
    assert seen == ["cpu"]
    ppi = pplan.plan_inputs(pget_config(ARCH), ps, 1, model_shards=1,
                            hbm_bytes=REFERENCE_HBM_BYTES)
    measured = pplan._dp_chain_graph(ppi, device="cpu")
    assert measured.cost_source == f"profile:{cost_model.OpProfile(**RATES).profile_key()}"


def test_launcher_with_measured_costs_on_the_cpu(monkeypatch, tmp_path):
    from repro_torch.launch import train as ptrain

    from repro_torch.core.plan_cache import default_cache, set_default_cache_dir

    monkeypatch.setenv("REPRO_MEASURED_COSTS", "1")
    before = default_cache().cache_dir
    set_default_cache_dir(None)  # the launcher attaches its own store
    try:
        out = ptrain.main(["--reduced", "--steps", "2", "--batch", "2", "--seq", "32",
                           "--device", "cpu", "--plan-cache-dir", str(tmp_path)])
    finally:
        set_default_cache_dir(None)
        set_default_cache_dir(before)
    assert out["step"] == 2 and out["plan_result"].feasible
    assert os.listdir(tmp_path / "profiles") == [
        f"op_profile_cpu_{torch.__version__}_v1.json"]


# ---------------------------------------------------------------------------
# Compiled costs at the front door
# ---------------------------------------------------------------------------


def test_segment_costs_count_matmul_flops():
    fn, args = _mlp(depth=4)
    carrier = TracedCarrier.trace(fn, args, cost_model="flops")
    g = carrier.to_graph()
    planner = Planner(cache=PlanCache())
    plan = planner.plan(g, planner.min_feasible_budget(g)).plan
    costs = extract_segment_costs(carrier, plan)
    assert len(costs) == plan.num_segments
    for seg, c in zip(plan.segments, costs):
        mm = sum(g.nodes[v].time for v in seg.nodes if g.nodes[v].kind == "dot_general")
        assert c["flops"] == mm  # FlopCounterMode counts the matmuls: 2·8·16·16 each
        assert c["bytes"] >= sum(g.nodes[v].memory for v in seg.nodes)


def test_segment_costs_count_the_flash_op():
    from repro_torch.kernels.ops import flash_attention

    def fn(q, k, v):
        return flash_attention(q, k, v, causal=True).square().sum()

    gen = torch.Generator().manual_seed(0)
    args = [torch.randn(1, 16, 2, 8, generator=gen) for _ in range(3)]
    carrier = TracedCarrier.trace(fn, args, argnums=(0, 1, 2), cost_model="flops")
    g = carrier.to_graph()
    planner = Planner(cache=PlanCache())
    plan = planner.plan(g, planner.min_feasible_budget(g)).plan
    costs = extract_segment_costs(carrier, plan)
    flash = sum(nd.time for nd in g.nodes if nd.kind == "flash_attention")
    assert flash == 4 * 1 * 2 * 16 * 16 * 8 // 2
    assert sum(c["flops"] for c in costs) >= flash


def test_compiled_cost_model_grads_bitwise_vanilla():
    fn, args = _mlp()
    planner = Planner(cache=PlanCache())
    pf = plan_function(fn, cost_model="compiled", planner=planner)
    low = pf.lowered_for(*args)
    g = low.carrier.to_graph()
    assert low.carrier.cost_model == "flops"  # the pilot trace is FLOP priced
    assert low.report.plan is low.plan and low.plan.peak_memory <= low.report.budget
    assert_bits(pf(*args), vanilla_traced_value_and_grad(low.carrier)(*args))
    # the two phases by hand: the FLOP-priced pilot plan's segment costs
    # re-price the graph, and the plan is the DP's on that graph
    pilot = planner.plan(g, None, "approx_dp", "time_centric").plan
    profile = dataclasses.replace(cost_model.DEFAULT_PROFILE, backend="cpu",
                                  jax_version=torch.__version__, source="compiled")
    cg = cost_model.compiled_calibrated_graph(
        g, pilot, extract_segment_costs(low.carrier, pilot), profile)
    assert cg.cost_source == f"compiled:cpu-{torch.__version__}-v1-compiled"
    assert graph_digest(cg) != graph_digest(g)
    want = planner.plan(cg, None, "approx_dp", "time_centric").plan
    assert low.plan == want
