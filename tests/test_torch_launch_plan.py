"""The port's launch planning (``repro_torch.launch``) against the reference.

stablelm-3b at full width, with the reference's 16 GiB per-device memory
pinned through ``hbm_bytes``: chain inputs, unit-segment plans from the
minimal feasible budget to an ample one, the microbatching search and the
launcher's ``segment_plan`` must equal the reference bitwise.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.core import dp as rdp  # noqa: E402
from repro.core.lower_sets import all_lower_sets  # noqa: E402
from repro.launch import plan as rplan  # noqa: E402
from repro.launch.mesh import HBM_BYTES, make_host_mesh  # noqa: E402
from repro.launch.steps import segment_plan as rsegment_plan  # noqa: E402
from repro_torch.configs import get_config as pget_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig as PShape  # noqa: E402
from repro_torch.launch import plan as pplan  # noqa: E402
from repro_torch.launch.mesh import REFERENCE_HBM_BYTES  # noqa: E402
from repro_torch.launch.steps import segment_plan as psegment_plan  # noqa: E402

ARCH = "stablelm-3b"
# (seq, batch): the training path's shape, and the launcher's default
SHAPES = [(1024, 2), (256, 8)]
# (dp_shards, model_shards): one card, and the reference's default layout
LAYOUTS = [(1, 1), (16, 16)]


def shapes(seq, batch):
    return RShape("cli", seq, batch, "train"), PShape("cli", seq, batch, "train")


def same_plan(p, r):
    (psp, pres), (rsp, rres) = p, r
    assert dataclasses.asdict(psp) == dataclasses.asdict(rsp)
    assert pres.sequence == rres.sequence
    assert (pres.overhead, pres.peak_memory, pres.feasible) == (
        rres.overhead, rres.peak_memory, rres.feasible)


def test_reference_memory_is_pinned():
    assert REFERENCE_HBM_BYTES == HBM_BYTES


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("seq,batch", SHAPES)
def test_plan_inputs_and_unit_segments_bitwise(seq, batch, layout):
    dp_shards, model_shards = layout
    rcfg, pcfg = rget_config(ARCH), pget_config(ARCH)
    rs, ps = shapes(seq, batch)
    for n_micro in (1, 2):
        rpi = rplan.plan_inputs(rcfg, rs, dp_shards, model_shards=model_shards,
                                n_micro=n_micro)
        ppi = pplan.plan_inputs(pcfg, ps, dp_shards, model_shards=model_shards,
                                n_micro=n_micro, hbm_bytes=REFERENCE_HBM_BYTES)
        assert dataclasses.asdict(ppi) == dataclasses.asdict(rpi)
        g = rplan._dp_chain_graph(rpi)
        b_min = rdp.min_feasible_budget_exact(g, all_lower_sets(g))
        for budget in (b_min, 1.5 * b_min, 3.0 * b_min, rpi.budget):
            r = rplan.plan_unit_segments(rcfg, rs, dp_shards, model_shards=model_shards,
                                         n_micro=n_micro, budget=budget)
            p = pplan.plan_unit_segments(pcfg, ps, dp_shards, model_shards=model_shards,
                                         n_micro=n_micro, budget=budget,
                                         hbm_bytes=REFERENCE_HBM_BYTES)
            same_plan(p, r)
            assert r[1].feasible
    assert pplan.needs_fsdp(pcfg, model_shards, REFERENCE_HBM_BYTES) == \
        rplan.needs_fsdp(rcfg, model_shards)


@pytest.mark.parametrize("objective", ["time_centric", "memory_centric"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("seq,batch", SHAPES)
def test_microbatching_bitwise(seq, batch, layout, objective):
    dp_shards, model_shards = layout
    rs, ps = shapes(seq, batch)
    r = rplan.plan_with_microbatching(rget_config(ARCH), rs, dp_shards,
                                      model_shards=model_shards, objective=objective)
    p = pplan.plan_with_microbatching(pget_config(ARCH), ps, dp_shards,
                                      model_shards=model_shards, objective=objective,
                                      hbm_bytes=REFERENCE_HBM_BYTES)
    same_plan(p, r)


@pytest.mark.parametrize("seq,batch", SHAPES)
def test_segment_plan_matches_reference_launcher(seq, batch):
    """The launcher's plan on one device (the reference's host mesh here)."""
    rs, ps = shapes(seq, batch)
    r = rsegment_plan(rget_config(ARCH), rs, make_host_mesh())
    p = psegment_plan(pget_config(ARCH), ps, hbm_bytes=REFERENCE_HBM_BYTES)
    same_plan(p, r)


def test_card_memory_is_the_default_budget():
    """Without ``hbm_bytes`` the plan budgets the CUDA card's memory, and
    there is none here, so it raises instead of guessing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pplan.plan_inputs(pget_config(ARCH), PShape("cli", 1024, 2, "train"), 1,
                          model_shards=1)
