"""``perfbench/spans.py``: its three readings on made-up span records, and
its whole run on a tiny cell on the CPU, where the span pass finds the
program's spans and counters but no device time."""

import pytest

from perfbench import spans
from perfbench.tests.tiny import tiny_cell


def _row(device=0.0, bwd=0.0):
    return {"calls": 1, "host_ms": 1.0, "device_ms": device, "self_device_ms": device,
            "bwd_device_ms": bwd, "idle_ms": 0.0, "bwd_nodes": {}}


def _rec(rows, counters=None, steps=2):
    return {"steps": steps, "spans": {"(outside)": _row(), **rows},
            "counters": counters or {}}


def test_recompute_ms_reads_the_reruns_device_time_a_step():
    assert spans.recompute_ms(_rec({"remat.recompute": _row(300.0, bwd=7.0)})) == 150.0
    # a plan that recomputes nothing reads 0, a run without a span pass nothing
    assert spans.recompute_ms(_rec({"remat.segment": _row(80.0)})) == 0.0
    assert spans.recompute_ms(None) is None


def test_moe_dispatch_ms_sums_forward_rerun_and_backward_of_the_dispatch():
    rec = _rec({"moe.route": _row(10.0, 2.0), "moe.pack": _row(100.0, 20.0),
                "moe.experts": _row(1000.0, 2000.0), "moe.combine": _row(30.0, 40.0)})
    assert spans.moe_dispatch_ms(rec) == pytest.approx((12 + 120 + 70) / 2)
    assert spans.moe_dispatch_ms(_rec({"remat.recompute": _row(5.0)})) is None
    assert spans.moe_dispatch_ms(None) is None


def test_moe_slot_use_is_the_kept_share_of_the_slots():
    rec = _rec({}, {"moe.kept": 131_072, "moe.slots": 163_840, "moe.routes": 131_072})
    assert spans.moe_slot_use(rec) == pytest.approx(80.0)
    assert spans.moe_slot_use(_rec({})) is None
    assert spans.moe_slot_use(None) is None


@pytest.mark.parametrize("config", ["stablelm-3b", "granite-moe-3b-a800m"])
def test_span_run_on_the_cpu(config):
    files = tiny_cell(config, "float32")
    out = spans.run(files["cell"]["name"], 5, 0.05, device="cpu", loaded=files)
    remat = out["plan"]["remat"]
    table = out["spans"]
    steps = out["steps"]
    n_fwd = steps * out["plan"]["n_micro"]
    assert table["trainer.step"]["calls"] == steps
    assert table["remat.segment"]["calls"] == n_fwd * len(remat)
    assert table.get("remat.recompute", {"calls": 0})["calls"] == n_fwd * sum(remat)
    assert sum(remat) > 0
    # the CPU has no device time: the readings that need it read 0
    assert out["readings"]["recompute_ms"] == 0.0
    assert out["checks"]["kernel_ms"] == 0 and out["checks"]["owned_ms"] == 0
    assert out["plain_prefixed_ops"] == [] and out["checks"]["prefixed_kernels"] == []
    assert set(out["setup_counters"]) >= {"planner.plan_s", "planner.hits",
                                          "planner.misses", "planner.disk_hits"}
    assert out["span_wall_s"] > 0 and out["plain_wall_s"] > 0
    if config.startswith("granite"):
        # every unit's forward, and each recomputed unit's re-run
        sizes = out["plan"]["sizes"]
        moe_calls = n_fwd * (sum(sizes) + sum(s for s, r in zip(sizes, remat) if r))
        assert table["moe.pack"]["calls"] == moe_calls
        assert out["readings"]["moe_dispatch_ms"] == 0.0
        assert 0 < out["readings"]["moe_slot_use"] <= 100
        assert out["counters"]["moe.slots"] % moe_calls == 0
    else:
        assert out["readings"]["moe_dispatch_ms"] is None
        assert out["readings"]["moe_slot_use"] is None
