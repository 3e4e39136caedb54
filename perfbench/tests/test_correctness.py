"""The comparison that decides ``correct``, on tiny cells on the CPU: the
plain reference holds the port's ``Trainer.train_step`` within float32
limits; every fault a training cell on one card can have, planted under
the timed path, and the float8 control make ``correct`` false."""

import pytest
import torch

from perfbench import compare, faults, traffic
from perfbench.reference import Fp8Arith, follow
from perfbench.tests.tiny import run, tiny_cell

torch.set_num_threads(1)

CELLS = [("stablelm-3b", "float32"), ("granite-moe-3b-a800m", "float32"),
         ("stablelm-3b", "bfloat16")]


@pytest.mark.parametrize("config,dtype", CELLS)
def test_sound_run_is_correct(config, dtype):
    out = run(tiny_cell(config, dtype))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out["metrics"]) == ["tokens_per_s", "peak_mem_gib", "setup_s"]


@pytest.mark.parametrize("config,dtype", [c for c in CELLS if c[1] == "float32"])
def test_reference_follows_the_port_within_f32_limits(config, dtype):
    """float32 on both sides: losses within 1e-6 relative, each leaf's
    gradient and change norm within 1e-5 of the larger of its norm and the
    median leaf's (measured: 8e-8, 4e-7, 3e-6 at worst)."""
    found = run(tiny_cell(config, dtype), seed=6)["_found"]
    assert found["loss"]["value"] < 1e-6
    assert found["grad"]["value"] < 1e-5
    assert found["change"]["value"] < 1e-5


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("config,dtype", CELLS)
def test_planted_fault_makes_the_run_incorrect(fault, config, dtype):
    with faults.FAULTS[fault]():
        out = run(tiny_cell(config, dtype))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("config,dtype", [("stablelm-3b", "bfloat16"),
                                          ("granite-moe-3b-a800m", "float32")])
def test_float8_control_fails_the_limits(config, dtype):
    files = tiny_cell(config, dtype)
    gen = traffic.from_files(files["config"], files["mix"], 5)
    batches = [gen.batch(s) for s in range(files["mix"]["checked_steps"])]
    dev = torch.device("cpu")
    ref = follow(files["config"], files["mix"], 5, batches, dev)
    control = follow(files["config"], files["mix"], 5, batches, dev, arith=Fp8Arith)
    ok, checks = compare.judge(compare.numbers(control, ref), files["cell"]["limits"])
    assert not ok, checks


def test_nought_gradient_leaves_are_left_out_of_change():
    ref = {"losses": [1.0], "grad_norms": {"a": 1.0, "b": 2.0, "c": 1e-9},
           "change_norms": {"a": 1.0, "b": 1.0, "c": 1e-6}}
    prog = {"losses": [1.0], "grad_norms": dict(ref["grad_norms"]),
            "change_norms": {"a": 1.0, "b": 1.0, "c": 5e-6}}
    found = compare.numbers(prog, ref)
    assert found["change"]["value"] == 0.0 and found["change"]["left_out"] == 1
    prog["change_norms"]["b"] = 1.5
    assert compare.numbers(prog, ref)["change"]["value"] == pytest.approx(0.5)


def test_traced_run_reports_what_its_readers_find_on_the_cpu():
    metrics = ["mfu", "update_ms", "plan_s", "peak_over_budget", "attn_recompute_ratio",
               "matmul_ms", "flash_roofline", "idle_share"]
    out = run(tiny_cell("stablelm-3b", "float32"), trace=True, metrics=metrics)
    # no CUDA events, launches or allocator peak on the CPU: those readers
    # return nothing and their metrics are left out
    assert set(out["metrics"]) == {"mfu", "plan_s"}
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
