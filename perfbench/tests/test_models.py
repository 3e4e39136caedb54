"""A configuration brings its own model: the model module it names under
``perfbench/reference/`` gives the leaves (``weights``), the plain loss
(``reference.follow``) and the FLOP count (``flops.model_flops``), and the
harness builds the port's configuration from the file's dicts.  ``lm``,
the default, computes what the harness computed before models were
modules, bit for bit.  The traced run reads the program's spans."""

import hashlib
import importlib.util
import sys

import pytest
import torch

from perfbench import flops, harness, traffic, weights
from perfbench.reference import follow, lm
from perfbench.tests.tiny import run, tiny_cell

CONFIGS = ["stablelm-3b", "granite-moe-3b-a800m"]

#: read on the CPU from the harness as it was before a configuration could
#: name its model: the digest of ``weights.leaves`` of each configuration
#: file, ``flops.model_flops`` at (1, 16,384), and of the float32 tiny cell
#: at seed 5 the weights ``weights.generate`` draws and the reference's
#: losses, step-1 gradient norms and changes over the checked steps
PINNED = {
    "stablelm-3b": {
        "leaves": "e7dc74cd54f6b8e2", "flops": 394060565053440.0,
        "tiny_weights": "f13b2f593068a597",
        "losses": ["0x1.84a0020000000p+2", "0x1.767bf30000000p+2", "0x1.8a8c2f0000000p+2"],
        "grad_norms": "bc4c65186475771d", "change_norms": "95cac08c83d8617a"},
    "granite-moe-3b-a800m": {
        "leaves": "60d2779324f1cc60", "flops": 165949936238592.0,
        "tiny_weights": "52835f773da9ca56",
        "losses": ["0x1.882b6a0000000p+2", "0x1.8d3b600000000p+2", "0x1.83add00000000p+2"],
        "grad_norms": "cfb3b8fe6acf444e", "change_norms": "15cebb26fd3c65c4"},
}

PROBE = '''
"""A model module a test installs: lm's leaves and FLOPs, and its loss doubled."""
from perfbench.reference import lm

CALLS = []
DROP_LAST = False


def leaves(config):
    CALLS.append("leaves")
    out = [(n, s, None if k is None else 0.5 * k) for n, s, k in lm.leaves(config)]
    return out[:-1] if DROP_LAST else out


def row_loss(P, config, tokens, labels, mm):
    CALLS.append("row_loss")
    return 2.0 * lm.row_loss(P, config, tokens, labels, mm)


def model_flops(config, rows, seq_len):
    CALLS.append("model_flops")
    return 1000.0 * rows * seq_len
'''


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def digest(items) -> str:
    h = hashlib.sha256()
    for x in items:
        if isinstance(x, torch.Tensor):
            h.update(x.detach().contiguous().numpy().tobytes())
        else:
            h.update(repr(x).encode())
    return h.hexdigest()[:16]


def reference(files, seed=5):
    config, mix = files["config"], files["mix"]
    gen = traffic.from_files(config, mix, seed)
    batches = [gen.batch(s) for s in range(mix["checked_steps"])]
    return follow(config, mix, seed, batches, torch.device("cpu"))


@pytest.mark.parametrize("name", CONFIGS)
def test_lm_is_bitwise_what_the_harness_computed_before(name, one_thread):
    pin = PINNED[name]
    cfg = harness.load_json(harness.BENCH / "configs" / f"{name}.json")
    assert "model" not in cfg
    assert digest(weights.leaves(cfg)) == pin["leaves"]
    assert flops.model_flops(cfg, 1, 16384) == pin["flops"]
    files = tiny_cell(name, "float32")
    drawn = [x for pair in weights.generate(files["config"], 5, "cpu") for x in pair]
    assert digest(drawn) == pin["tiny_weights"]
    ref = reference(files)
    assert [x.hex() for x in ref["losses"]] == pin["losses"]
    assert digest(sorted(ref["grad_norms"].items())) == pin["grad_norms"]
    assert digest(sorted(ref["change_norms"].items())) == pin["change_norms"]


@pytest.fixture
def probe(monkeypatch, tmp_path):
    """``perfbench.reference.probe``, from a file outside ``perfbench/``."""
    path = tmp_path / "probe.py"
    path.write_text(PROBE)
    spec = importlib.util.spec_from_file_location("perfbench.reference.probe", path)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mod)
    spec.loader.exec_module(mod)
    assert not (harness.BENCH / "reference" / "probe.py").exists()
    return mod


def probe_cell(model):
    files = tiny_cell("granite-moe-3b-a800m", "float32")
    files["config"]["model"] = model
    return files


def test_a_named_model_module_reaches_weights_follow_and_flops(probe, one_thread):
    files = probe_cell("probe")
    cfg = files["config"]
    assert weights.leaves(cfg) == [(n, s, None if k is None else 0.5 * k)
                                   for n, s, k in lm.leaves(cfg)]
    drawn, plain = dict(weights.generate(cfg, 5, "cpu")), dict(weights.generate(
        probe_cell("lm")["config"], 5, "cpu"))
    assert all(torch.equal(drawn[n], plain[n] if n.endswith(".scale") else 0.5 * plain[n])
               for n in plain)
    assert flops.model_flops(cfg, 2, 64) == 128000.0
    record = {"window": {"steps": 2, "seconds": 1.0}, "config": cfg,
              "mix": {"rows": 2, "seq_len": 64}}
    assert harness.reader("mfu")(record) == 100.0 * 2 * 128000.0 / flops.PEAK_FLOPS_BF16
    # the probe's loss is lm's doubled, over the probe's (halved) weights
    mine = reference(files)
    assert probe.CALLS.count("row_loss") == 3 * files["mix"]["rows"]
    probe.row_loss = lm.row_loss  # the same weights, the loss not doubled
    single = reference(files)
    assert mine["losses"][0] == 2.0 * single["losses"][0]
    assert all(mine["grad_norms"][n] == 2.0 * g for n, g in single["grad_norms"].items())


def test_build_program_holds_the_port_to_the_named_models_leaves(probe):
    files = probe_cell("probe")
    cfg, mix = files["config"], files["mix"]
    prog = harness.build_program(cfg, mix, 5, torch.device("cpu"), 2e6)
    tr = prog["trainer"]
    drawn = dict(weights.generate(cfg, 5, "cpu"))
    assert set(tr.names) == set(drawn)
    assert all(torch.equal(p, drawn[n]) for n, p in zip(tr.names, tr.params))
    probe.DROP_LAST = True
    with pytest.raises(RuntimeError, match="configuration's leaves"):
        harness.build_program(cfg, mix, 5, torch.device("cpu"), 2e6)


def test_an_unnamed_module_is_refused():
    cfg = dict(tiny_cell("stablelm-3b", "float32")["config"], model="../lm")
    with pytest.raises(ValueError):
        weights.leaves(cfg)


def test_port_config_builds_every_dataclass_field_from_a_dict():
    from repro_torch.configs.base import MoEConfig, SSMConfig
    from repro_torch.models import build_model

    ssm = {"d_state": 16, "d_conv": 4, "expand": 2, "chunk": 32}
    cfg = harness.port_config({"arch": "zamba2-2.7b", "port": {
        "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 128,
        "vocab_size": 256, "hybrid_shared_attn_every": 2, "ssm": ssm}})
    assert cfg.ssm == SSMConfig(**ssm) and cfg.moe is None and cfg.family == "hybrid"
    assert sum(p.numel() for p in build_model(cfg, device="meta").parameters()) > 0
    moe = {"num_experts": 4, "top_k": 2, "d_ff_expert": 32}
    assert harness.port_config({"arch": "granite-moe-3b-a800m",
                                "port": {"moe": moe}}).moe == MoEConfig(**moe)
    for name in CONFIGS:  # today's files: a top-level moe, or null
        f = harness.load_json(harness.BENCH / "configs" / f"{name}.json")
        want = MoEConfig(**f["moe"]) if f["moe"] else None
        assert harness.port_config(f).moe == want


@pytest.mark.parametrize("config", CONFIGS)
def test_traced_run_reads_the_programs_spans(config):
    span_metrics = ["recompute_ms", "moe_dispatch_ms", "moe_slot_use"]
    out = run(tiny_cell(config, "float32"), trace=True, metrics=span_metrics)
    got = {k: v["value"] for k, v in out["metrics"].items()}
    cell = next(c for c in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]
                if c["config"] == config)["name"]
    listed = [m for m in harness.per_layer_metrics(cell) if m in span_metrics]
    # the CPU has no device time: the span times read 0
    assert got["recompute_ms"] == 0.0 and out["metrics"]["recompute_ms"]["unit"] == "ms"
    if config.startswith("granite"):
        assert got["moe_dispatch_ms"] == 0.0
        assert 0 < got["moe_slot_use"] <= 100
        assert listed == span_metrics
    else:
        assert set(got) == {"recompute_ms"} and listed == ["recompute_ms"]
