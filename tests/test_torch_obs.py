"""The port's spans and counters (``repro_torch.obs``) on the CPU.

Off, a step leaves no trace and no count; on, a tiny LM planned as two
segments of two units (the first rematerialized) opens each Trainer phase
once a step, each segment's forward once and the recomputed one's re-run
once; a tiny MoE opens its dispatch spans in every forward and re-run, and
``span_table`` hands the gather's and the ``index_put``'s backward to the
spans of their forward ops.  Recording changes no loss or gradient bit and
no ``make_fx`` trace.  granite-4.0-h's Mamba-2 mixers and shared expert
open their own spans and count chunks and absent routes.  ``span_table``'s invariants hold on hand-built
events.
"""

import contextlib
import copy
import dataclasses
import importlib
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.fx_graph import trace_module  # noqa: E402
from repro_torch.core.plan_cache import PlanCache  # noqa: E402
from repro_torch.core.planner import Planner  # noqa: E402
from repro_torch.launch import plan as launch_plan  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.steps import segment_plan  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.train import TrainConfig, Trainer, functional_loss  # noqa: E402

fa = importlib.import_module("repro_torch.kernels.flash_attention")
SIZES, REMAT = (2, 2), (True, False)
ROWS, SEQ, STEPS = 2, 32, 2
CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def _cfg(arch):
    cfg = reduced(get_config(arch), n_layers=4)
    if cfg.moe is not None:  # 4 experts, top-2, with dropped routes
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, capacity_factor=0.5))
    return cfg


def _loss(model, batch):
    return model.loss(batch, segment_sizes=SIZES, segment_remat=REMAT)


def _batch(cfg, step=0):
    g = torch.Generator().manual_seed(step)
    toks = torch.randint(0, cfg.vocab_size, (ROWS, SEQ), generator=g)
    return {"tokens": toks, "labels": toks}


def _trainer(arch, n_micro=1):
    cfg = _cfg(arch)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    return cfg, Trainer(_loss, model, TrainConfig(n_micro=n_micro), device="cpu")


def _profiled(tr, cfg, record=True):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.recording() if record else contextlib.nullcontext():
            for s in range(STEPS):
                tr.train_step(_batch(cfg, s))
    return prof


def _names(prof):
    return [e.name for e in prof.events() if e.name.startswith(obs.PREFIX)]


def test_recording_off_leaves_no_span_and_no_count():
    with obs.recording():
        pass  # clears the counters
    cfg, tr = _trainer("granite-moe-3b-a800m")
    prof = _profiled(tr, cfg, record=False)
    assert _names(prof) == []
    assert obs.counters() == {}
    assert obs.span("trainer.step", step=1) is obs.span("moe.pack") is obs.span("x")


@pytest.mark.parametrize("n_micro", [1, 2])
def test_trainer_and_segment_spans_a_step(n_micro):
    cfg, tr = _trainer("stablelm-3b", n_micro)
    prof = _profiled(tr, cfg)
    table = obs.span_table(prof)
    calls = {k: r["calls"] for k, r in table.items() if r["calls"]}
    fwd = STEPS * n_micro
    want = {"trainer.step": STEPS, "trainer.grads": STEPS, "trainer.nan_guard": STEPS,
            "trainer.update": STEPS, "remat.segment": 2 * fwd, "remat.recompute": fwd,
            "lm.head": fwd}
    if n_micro > 1:
        want["trainer.micro"] = fwd
    assert calls == want
    names = _names(prof)
    assert names.count("repro.remat.recompute[index=0,units=2,remat=True]") == fwd
    assert names.count("repro.remat.segment[index=1,units=2,remat=False]") == fwd
    assert [n for n in names if n.startswith("repro.trainer.step")] == [
        f"repro.trainer.step[step={s}]" for s in range(STEPS)]


def test_moe_spans_backward_nodes_and_counters(monkeypatch):
    kept = []
    pack = pmoe._pack

    def recount(*a):
        out = pack(*a)
        kept.append(int(out[3].sum()))
        return out

    monkeypatch.setattr(pmoe, "_pack", recount)
    cfg, tr = _trainer("granite-moe-3b-a800m")
    prof = _profiled(tr, cfg)
    table = obs.span_table(prof)
    counts = obs.counters()
    # every unit's forward, and the recomputed segment's two units again
    calls = STEPS * (4 + 2)
    for name in ("moe.route", "moe.pack", "moe.experts", "moe.combine"):
        assert table[name]["calls"] == calls, name
    assert "IndexBackward0" in table["moe.combine"]["bwd_nodes"]
    assert "IndexPutBackward0" in table["moe.pack"]["bwd_nodes"]
    assert "TopkBackward0" in table["moe.route"]["bwd_nodes"]
    T, E, K = ROWS * SEQ, cfg.moe.num_experts, cfg.moe.top_k
    assert len(kept) == calls
    assert counts["moe.kept"] == sum(kept) < T * K * calls  # some routes dropped
    assert counts["moe.slots"] == E * pmoe.capacity(cfg.moe, T) * calls
    assert counts["moe.routes"] == T * K * calls


HYBRID = "granite-4.0-h-small"


def test_hybrid_spans_and_counters_appear_while_recording_alone():
    """granite-4.0-h at 4 units (mamba_moe, attn_moe twice; 2 of 4 experts
    held, a shared expert), the first segment of two units recomputed:
    the Mamba-2 mixers' projection, conv and scan spans and the shared
    expert's open in every forward and re-run; ``ssm.chunks`` counts every
    chunk scanned, forwards and re-runs (the scan's own checkpoint re-runs
    each chunk in the backward), ``moe.absent`` the routes to experts held
    elsewhere.  Off, none of it."""
    cfg = _cfg(HYBRID)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, experts_held=2))
    torch.manual_seed(0)
    tr = Trainer(_loss, build_model(cfg, device="cpu"), TrainConfig(), device="cpu")
    assert cfg.layer_pattern == ("mamba_moe", "attn_moe") and cfg.moe.held < cfg.moe.num_experts
    with obs.recording():
        pass  # clears the counters
    assert _names(_profiled(tr, cfg, record=False)) == [] and obs.counters() == {}
    prof = _profiled(tr, cfg)
    table, counts = obs.span_table(prof), obs.counters()
    mamba = STEPS * (2 + 1)  # units 0 and 2, and unit 0 again in the re-run
    for name, calls in (("ssm.scan", mamba), ("ssm.conv", mamba), ("ssm.proj", 2 * mamba),
                        ("moe.shared", STEPS * (4 + 2))):
        assert table[name]["calls"] == calls, name
    chunks = SEQ // cfg.ssm.chunk
    # unit 0: forward, re-run, and each chunk's own re-run; unit 2: forward, re-run
    assert counts["ssm.chunks"] == STEPS * chunks * (3 + 2)
    routes = STEPS * (4 + 2) * ROWS * SEQ * cfg.moe.top_k
    assert counts["moe.routes"] == routes and 0 < counts["moe.absent"] < routes
    # a chunk's re-run in the backward belongs to the scan's backward ...
    assert table["ssm.scan"]["bwd_nodes"]
    # ... and a segment's re-run of the scan nests in remat.recompute, whose
    # device time holds its kernels
    events = list(prof.events())
    reruns = {id(e) for e in events if e.name.startswith("repro.remat.recompute")}

    def under_rerun(e):
        while e is not None:
            if id(e) in reruns:
                return True
            e = e.cpu_parent
        return False

    scans = [e for e in events if e.name == "repro.ssm.scan"]
    assert sum(map(under_rerun, scans)) == STEPS


def test_a_recompute_owns_its_ops_not_the_backward_node_around_it():
    cfg, tr = _trainer("granite-moe-3b-a800m")
    prof = _profiled(tr, cfg)
    events = list(prof.events())
    who = obs.owners(events)
    reruns = [e for e in events if e.name.startswith("repro.remat.recompute")]
    assert len(reruns) == STEPS
    for rerun in reruns:
        node = rerun.cpu_parent
        while not node.name.startswith(obs.BACKWARD):
            node = node.cpu_parent
        # the node that triggered the re-run maps to a forward span ...
        assert who[id(node)][1] == "bwd"
        assert who[id(node)][0] != "remat.recompute"
        # ... but every op of the re-run outside a nested span is the re-run's
        stack = list(rerun.cpu_children)
        while stack:
            e = stack.pop()
            if e.name.startswith(obs.PREFIX):
                assert who[id(e)] == (obs._base(e.name), "self")
                continue
            assert who[id(e)] == ("remat.recompute", "self"), e.name
            stack.extend(e.cpu_children)


@pytest.mark.parametrize("arch", ["stablelm-3b", "granite-moe-3b-a800m", HYBRID])
def test_recording_changes_no_loss_or_gradient_bit(arch):
    cfg = _cfg(arch)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    batch = _batch(cfg)
    got = []
    for record in (False, True, False):
        m = copy.deepcopy(model)
        params = [p for p in m.parameters() if p.requires_grad]
        with obs.recording() if record else contextlib.nullcontext():
            with profile(activities=[ProfilerActivity.CPU]):
                loss = _loss(m, batch)
                grads = torch.autograd.grad(loss, params)
        got.append([loss.detach()] + [g.detach() for g in grads])
    for off, on in zip(got[0], got[1]):
        assert torch.equal(off, on)
    for a, b in zip(got[0], got[2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["stablelm-3b", "granite-moe-3b-a800m", HYBRID])
def test_a_make_fx_trace_does_not_see_recording(arch):
    cfg = _cfg(arch)
    torch.manual_seed(0)
    fn, params = functional_loss(_loss, build_model(cfg, device="cpu"))
    batch = _batch(cfg)
    off = trace_module(fn, params, batch)
    with obs.recording():
        on = trace_module(fn, params, batch)
    assert len(on.graph.nodes) == len(off.graph.nodes)
    assert [n.target for n in on.graph.nodes] == [n.target for n in off.graph.nodes]
    assert obs.counters() == {}


def test_setup_counters_of_the_plan_and_a_kernel_build(tmp_path, monkeypatch):
    cfg = reduced(get_config("stablelm-3b"), n_layers=4)
    shape = ShapeConfig("t", 64, 2, "train")
    lib = tmp_path / "lib.so"
    monkeypatch.setattr(fa, "library_path", lambda: lib)
    monkeypatch.setattr(fa, "_compile", lambda path: path.write_bytes(b""))
    got = []
    # a cold process plans into an empty store, a warm one reads it back
    for _ in range(2):
        planner = Planner(cache=PlanCache(cache_dir=str(tmp_path / "plans")))
        for mod in (launch_plan, steps):
            monkeypatch.setattr(mod, "get_default_planner", lambda: planner)
        with obs.recording():
            segment_plan(cfg, shape, hbm_bytes=2e6, device="cpu")
            fa.build()
        got.append(obs.counters())
    cold, warm = got
    assert cold["kernels.built"] == 1 and cold["kernels.build_s"] >= 0
    assert "kernels.built" not in warm  # built: no compile
    assert cold["planner.plan_s"] > 0 and warm["planner.plan_s"] > 0
    assert cold["planner.misses"] >= 1 and cold["planner.hits"] == 0
    assert warm["planner.misses"] == 0
    assert warm["planner.disk_hits"] == warm["planner.hits"] >= 1


def test_record_function_lives_in_obs_alone():
    port = Path(obs.__file__).parent
    users = sorted(p.relative_to(port).as_posix() for p in port.rglob("*.py")
                   if "record_function" in p.read_text())
    assert users == ["obs.py"]


# --------------------------------------------------------- hand-built events


def _ev(name, start, end, thread=1, parent=None, kernels=(), seq=-1, fwd_thread=0):
    e = SimpleNamespace(name=name, thread=thread, sequence_nr=seq, fwd_thread=fwd_thread,
                        time_range=SimpleNamespace(start=start, end=end), cpu_parent=parent,
                        cpu_children=[], device_type=CPU, is_user_annotation=False,
                        kernels=[SimpleNamespace(name=k, duration=d) for k, d in kernels])
    if parent is not None:
        parent.cpu_children.append(e)
    return e


def _kernel(name, start, end, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=CUDA, is_user_annotation=annotation)


def _hand_built():
    """A step: grads (a segment whose mm is seq 7, a head), a backward node
    on another thread for seq 7 that triggers the segment's re-run, an
    update, and a copy outside any span; kernels in us."""
    step = _ev("repro.trainer.step[step=0]", 0, 1000)
    grads = _ev("repro.trainer.grads", 10, 600, parent=step)
    seg = _ev("repro.remat.segment[index=0,units=2,remat=True]", 20, 200, parent=grads)
    mm = _ev("aten::mm", 30, 60, parent=seg, kernels=[("gemm", 40)], seq=7)
    _ev("aten::linear", 31, 59, parent=mm, seq=7)
    add = _ev("aten::add", 70, 80, parent=seg, kernels=[("add", 5)], seq=8)
    # a runtime event in the launch that the profiler hands the same kernel
    _ev("Command Buffer Full", 71, 79, parent=add, kernels=[("add", 5)])
    head = _ev("repro.lm.head", 210, 300, parent=grads)
    _ev("aten::mm", 220, 240, parent=head, kernels=[("gemm", 30)], seq=9)
    node = _ev(BWD + "MmBackward0", 310, 500, thread=2, seq=7, fwd_thread=1)
    _ev("aten::mm", 320, 330, thread=2, parent=node, kernels=[("gemm", 50)])
    rerun = _ev("repro.remat.recompute[index=0,units=2,remat=True]", 340, 420, thread=2,
                parent=node)
    _ev("aten::mm", 350, 360, thread=2, parent=rerun, kernels=[("gemm", 40)], seq=30)
    add_node = _ev(BWD + "AddBackward0", 510, 520, thread=2, seq=8, fwd_thread=1)
    _ev("aten::mul", 511, 519, thread=2, parent=add_node, kernels=[("mul", 3)])
    # a profiler may hand a span its own device-side mirror as a kernel
    update = _ev("repro.trainer.update", 700, 900, parent=step,
                 kernels=[("repro.trainer.update", 200)])
    _ev("aten::_foreach_add_", 710, 720, parent=update, kernels=[("adam", 20)])
    copy_ = _ev("aten::copy_", 950, 960, kernels=[("memcpy", 2)])
    host = [step, grads, seg, mm, mm.cpu_children[0], add, add.cpu_children[0], head,
            head.cpu_children[0], node, node.cpu_children[0], rerun, rerun.cpu_children[0],
            add_node, add_node.cpu_children[0], update, update.cpu_children[0], copy_]
    device = [_kernel("gemm", 100, 140), _kernel("add", 140, 145), _kernel("gemm", 250, 280),
              _kernel("gemm", 330, 380), _kernel("gemm", 400, 440), _kernel("mul", 530, 533),
              _kernel("adam", 720, 740), _kernel("memcpy", 970, 972),
              _kernel("repro.trainer.update", 700, 900, annotation=True)]
    return host, device


BWD = obs.BACKWARD


def test_span_table_columns_on_hand_built_events():
    host, device = _hand_built()
    t = obs.table(host + device)
    assert t["remat.segment"]["device_ms"] == pytest.approx(0.045)
    assert t["remat.segment"]["self_device_ms"] == pytest.approx(0.045)
    # the backward node's own gemm and the add's backward, not the re-run
    assert t["remat.segment"]["bwd_device_ms"] == pytest.approx(0.053)
    assert t["remat.segment"]["bwd_nodes"] == {"MmBackward0": 1, "AddBackward0": 1}
    assert t["remat.recompute"]["self_device_ms"] == pytest.approx(0.040)
    assert t["trainer.grads"]["device_ms"] == pytest.approx(0.075)
    assert t["trainer.grads"]["self_device_ms"] == 0
    assert t["trainer.update"]["device_ms"] == pytest.approx(0.020)  # no mirror
    assert t[obs.OUTSIDE]["self_device_ms"] == pytest.approx(0.002)
    # each gap goes to the latest begun of the spans open when it begins
    idle = {k: round(r["idle_ms"] * 1e3, 6) for k, r in t.items() if r["idle_ms"]}
    assert idle == {"remat.segment": 105, "lm.head": 50, "remat.recompute": 20,
                    "trainer.grads": 90 + 187, "trainer.update": 230}


@pytest.mark.parametrize("drop", [None, "rerun", "node"])
def test_span_table_invariants(drop):
    host, device = _hand_built()
    if drop:  # the same pass without the re-run's span, or the node
        victim = next(e for e in host if e.name.startswith(
            "repro.remat.recompute" if drop == "rerun" else BWD + "MmBackward0"))
        for c in victim.cpu_children:
            c.cpu_parent = victim.cpu_parent
            if victim.cpu_parent is not None:
                victim.cpu_parent.cpu_children.append(c)
        host.remove(victim)
    t = obs.table(host + device)
    kernels = [d for d in device if not d.is_user_annotation]
    # every kernel once across the self and backward columns and (outside)
    owned = sum(r["self_device_ms"] + r["bwd_device_ms"] for r in t.values())
    assert owned == pytest.approx(sum(d.time_range.end - d.time_range.start
                                      for d in kernels) / 1e3)
    for name, r in t.items():
        if name != obs.OUTSIDE:
            assert r["self_device_ms"] <= r["device_ms"] + 1e-12, name
    # a nested span's device time is within its parent span's
    spans = {obs._base(e.name): e for e in host if e.name.startswith(obs.PREFIX)}
    for name, e in spans.items():
        p = e.cpu_parent
        while p is not None and not p.name.startswith(obs.PREFIX):
            p = p.cpu_parent
        if p is not None:
            assert t[name]["device_ms"] <= t[obs._base(p.name)]["device_ms"], name
    busy = obs._busy(kernels)
    gaps = sum(b - a for (_, a), (b, _) in zip(busy, busy[1:])) / 1e3
    assert sum(r["idle_ms"] for r in t.values()) == pytest.approx(gaps)
