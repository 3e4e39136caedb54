"""The benchmark's files: every cell resolves its configuration and mix,
every per-layer metric has its reader, a new cell or metric is found by
name without editing a file, ``BENCHMARK.json`` keeps to the contract's
shapes, and nothing under ``perfbench/`` imports JAX or the JAX package."""

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from perfbench import harness, weights

BENCH = harness.BENCH
SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def sources():
    return sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    # whole top-level names: "repro_torch" is not "repro"
    assert not imported_roots(path) & set(harness.FORBIDDEN)
    if "reference" in path.parts:
        assert "repro_torch" not in imported_roots(path)


def test_nothing_reads_the_jax_packages_benchmarks():
    folder = "bench" + "marks"
    pattern = re.compile(r"""["'/]%s["'/]""" % folder)
    assert not [p for p in sources() if pattern.search(p.read_text())]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['.', 'src']; from perfbench import harness; "
            "harness.prepare_environment(); import perfbench.reference, perfbench.readings, "
            "perfbench.faults; from repro_torch.launch.steps import build_train_step; "
            "from repro_torch.models import build_model; import repro_torch.train; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_resolves_its_files(cell):
    files = harness.load_cell(cell)
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    c = files["cell"]
    assert (c["name"], c["config"], c["traffic"], c["chips"], c["why"]) == (
        entry["name"], entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert files["config"]["name"] == entry["config"]
    assert files["mix"]["name"] == entry["traffic"]
    assert set(c["limits"]) == {"loss", "grad", "change"}
    assert 0 < c["hbm_bytes"] <= 80e9


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_file_states_what_runs(config):
    f = harness.load_json(harness.ROOT / config["file"])
    assert f["name"] == config["name"] and f["source"] == config["source"]
    assert f["reduced"] == config["reduced"]
    p, moe = f["port"], f.get("moe")
    assert (p["d_model"], p["n_heads"], p["n_kv_heads"], p["n_layers"], p["vocab_size"]) == (
        f["hidden_size"], f["num_attention_heads"], f["num_key_value_heads"],
        f["num_hidden_layers"], f["vocab_size"])
    assert p["tie_embeddings"] == f["tie_word_embeddings"]
    if moe:
        assert (moe["num_experts"], moe["top_k"], moe["d_ff_expert"]) == (
            f["num_local_experts"], f["num_experts_per_tok"], f["intermediate_size"])
    else:
        assert p["d_ff"] == f["intermediate_size"]
    for key in f["reduced"]:
        assert key in f["published"] and f["published"][key] != f[key]


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_weights_are_the_ports_parameters(config):
    import torch  # noqa: F401
    from repro_torch.models import build_model

    f = harness.load_json(harness.ROOT / config["file"])
    harness.prepare_environment()
    model = build_model(harness.port_config(f), device="meta")
    have = {n: tuple(t.shape) for n, t in model.named_parameters()}
    want = {n: s for n, s, _ in weights.leaves(f)}
    assert have == want
    assert sum(weights.numel(s) for s in want.values()) == f["params"]


def test_weights_come_from_the_seed():
    import torch

    f = harness.load_json(BENCH / "configs" / "stablelm-3b.json")
    f["port"].update(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16, d_ff=64,
                     vocab_size=100)
    a = dict(weights.generate(f, 3, "cpu", chunk=5000))
    b = dict(weights.generate(f, 3, "cpu", chunk=5000))
    c = dict(weights.generate(f, 4, "cpu", chunk=5000))
    assert set(a) == {n for n, _, _ in weights.leaves(f)}
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["head.unembed"], c["head.unembed"])
    assert torch.equal(a["final_norm.scale"], torch.ones(32))
    assert abs(float(a["embedding.embed"].std()) - 1.0) < 0.1


def test_a_tied_table_draws_as_the_head():
    f = harness.load_json(BENCH / "configs" / "granite-moe-3b-a800m.json")
    assert f["port"]["tie_embeddings"]
    f["port"].update(n_layers=1, d_model=64, n_heads=2, n_kv_heads=1, d_head=32, vocab_size=400)
    f["moe"].update(num_experts=2, top_k=1, d_ff_expert=16)
    w = dict(weights.generate(f, 3, "cpu", chunk=5000))
    assert "head.unembed" not in w
    assert abs(float(w["embedding.embed"].std()) - 64 ** -0.5) < 0.01


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_its_reader(metric):
    assert callable(harness.reader(metric["name"]))
    assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}


def test_a_new_cell_and_metric_are_found_by_name(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "perfbench", ignore=shutil.ignore_patterns(".cache"))
    spec = json.loads(json.dumps(SPEC))
    new_cell = dict(harness.load_json(BENCH / "workloads" / "stablelm-3b.train-16k.remat.json"),
                    name="stablelm-3b.train-8k.new")
    (root / "perfbench" / "workloads" / "stablelm-3b.train-8k.new.json").write_text(
        json.dumps(new_cell))
    (root / "perfbench" / "metrics" / "new_metric.py").write_text(
        "def read(rec):\n    return 1.5\n")
    spec["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "x", "moves": "tokens_per_s",
                              "workloads": ["stablelm-3b.train-8k.new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "BENCH", root / "perfbench")
    assert harness.load_cell("stablelm-3b.train-8k.new")["cell"]["name"] == new_cell["name"]
    assert "new_metric" in harness.per_layer_metrics("stablelm-3b.train-8k.new")
    assert "new_metric" not in harness.per_layer_metrics("stablelm-3b.train-16k.remat")
    assert harness.reader("new_metric")({}) == 1.5


def test_benchmark_json_keeps_the_contracts_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("perfbench/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    names = set()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in names
        assert m["better"] in ("lower", "higher")
        names.add(m["name"])
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
