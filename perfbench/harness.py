"""One run of one cell: set-up, the measured window, the traced steps and
the comparison with the plain reference.

The program under test is the port's training step as its users run it:
``repro_torch.launch.steps.build_train_step`` plans the segments and
microbatches under the cell's memory budget, ``TrainStep.trainer`` builds
the ``Trainer``, and every step of the run is ``Trainer.train_step``
(with its NaN guard's host read) on a batch from the benchmark's own
generator.  The first ``checked_steps`` steps are the set-up's warm-up and
the steps the reference follows; the window then steps on until
``seconds`` have passed, and ends on a step boundary.

A configuration brings its model: the port's ``ModelConfig`` is its
``arch`` with its ``port`` fields (:func:`port_config`), and its leaves,
plain reference loss and FLOP count are those of the model module under
``perfbench/reference/`` that it names (``"model"``, else ``lm``; see that
package's docstring).  A new architecture is a new module and new files.

The record a per-layer metric's reader gets (:func:`run_cell`) holds the
window's steps, seconds and update spans, the kernels' launch counts, the
plan, the memory peak and budget, and, with ``trace``, the profiled
steps' device kernels and host spans (``profile``) and a span pass over
the steps after them: the program's own span table and counters
(``spans``, :func:`perfbench.spans.span_pass`).
"""

from __future__ import annotations

import dataclasses
import gc
import heapq
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
#: fixed cache directories inside the checkout, so that only the first run
#: of a checkout plans and compiles cold
CACHE = BENCH / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROFILED_STEPS = 2
#: kernel-name fragments of matrix products in a device trace
MATMUL_FRAGMENTS = ("gemm", "xmma", "nvjet", "cutlass", "cublas")


def prepare_environment() -> None:
    """Point the program's caches at the checkout and put ``src`` on the
    path.  Runs before anything of the program is imported."""
    os.environ.setdefault("REPRO_PLAN_CACHE_DIR", str(CACHE / "plans"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> Dict[str, Any]:
    """The cell's workload, configuration and traffic mix, by name."""
    cell = load_json(BENCH / "workloads" / f"{name}.json")
    return {"cell": cell,
            "config": load_json(BENCH / "configs" / f"{cell['config']}.json"),
            "mix": load_json(BENCH / "mixes" / f"{cell['traffic']}.json")}


def per_layer_metrics(name: str) -> List[str]:
    """The per-layer metrics ``BENCHMARK.json`` reports in cell ``name``."""
    bench = load_json(ROOT / "BENCHMARK.json")
    return [m["name"] for m in bench["per_layer"]
            if "workloads" not in m or name in m["workloads"]]


def reader(metric: str):
    """``read(record) -> float | None`` of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_note() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


# ----------------------------------------------------------------- program


def port_config(config: Dict):
    """The port's ``ModelConfig`` as the configuration file states it: the
    ``arch``'s with the ``port`` fields replaced, each field typed as a
    dataclass (``moe``, ``ssm``) built from its dict.  The MoE block is
    ``port``'s ``moe``, else the top-level ``moe`` (none without one)."""
    import typing

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig

    fields = dict(config["port"])
    if "moe" not in fields:
        fields["moe"] = config.get("moe")
    hints = typing.get_type_hints(ModelConfig)
    for name, value in fields.items():
        if isinstance(value, dict):
            hint = hints[name]
            kind = next((t for t in typing.get_args(hint) + (hint,)
                         if dataclasses.is_dataclass(t)), None)
            if kind is not None:
                fields[name] = kind(**value)
    return dataclasses.replace(get_config(config["arch"]), **fields)


def build_program(config: Dict, mix: Dict, seed: int, device, hbm_bytes: float
                  ) -> Dict[str, Any]:
    """The port's model with the seed's weights, its train step planned for
    ``hbm_bytes`` of device memory, and its Trainer; the planning's seconds."""
    import torch

    from perfbench import weights
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig

    cfg = port_config(config)
    model = build_model(cfg, device="meta").to_empty(device=device)
    params = dict(model.named_parameters())
    want = {n: tuple(s) for n, s, _ in weights.leaves(config)}
    have = {n: tuple(p.shape) for n, p in params.items()}
    if want != have:
        raise RuntimeError(f"the port's parameters differ from the configuration's leaves: "
                           f"{sorted(set(want.items()) ^ set(have.items()))[:6]}")
    with torch.no_grad():
        for name, t in weights.generate(config, seed, device):
            params[name].copy_(t)
    shape = ShapeConfig(mix["name"], mix["seq_len"], mix["rows"], "train")
    t0 = time.perf_counter()
    step = build_train_step(cfg, shape, None, opt=AdamWConfig(**mix["optimizer"]),
                            hbm_bytes=hbm_bytes, device=device.type)[0]
    plan_s = time.perf_counter() - t0
    trainer = step.trainer(model, device=device)
    return {"trainer": trainer, "step": step, "plan_s": plan_s}


def feed(gen, step: int, device) -> Dict[str, Any]:
    import torch

    return {k: torch.as_tensor(v).to(device) for k, v in gen.batch(step).items()}


def checked_steps(prog: Dict, gen, config: Dict, mix: Dict, seed: int, device) -> Dict:
    """The run's first steps, through ``Trainer.train_step``: each step's
    loss, each leaf's step-1 gradient norm (from the AdamW state after one
    step, before clipping) and each leaf's change over the steps."""
    import torch

    from perfbench import weights

    tr = prog["trainer"]
    opt = mix["optimizer"]
    losses, ok, grad_norms = [], True, None
    for step in range(mix["checked_steps"]):
        out = tr.train_step(feed(gen, step, device))
        losses.append(out["loss"])
        ok = ok and bool(out["ok"])
        if step == 0:
            clip = opt["clip_norm"]
            scale = 1.0 if clip is None else min(1.0, clip / max(out["grad_norm"], 1e-9))
            with torch.no_grad():
                norms = torch.stack([m.norm() for m in tr.opt_state.mu]).tolist()
            grad_norms = {n: g / ((1 - opt["b1"]) * scale) for n, g in zip(tr.names, norms)}
    params = dict(zip(tr.names, tr.params))
    with torch.no_grad():
        change = {n: float((params[n] - t0).norm())
                  for n, t0 in weights.generate(config, seed, device)}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change, "ok": ok}


class UpdateSpans:
    """CUDA events around the Trainer instance's ``_update`` (wrapped on the
    instance), read once the window has closed."""

    def __init__(self, trainer):
        import torch

        self.pairs = []
        inner = trainer._update

        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with torch.profiler.record_function("bench.update"):
                out = inner(*a, **kw)
            end.record()
            self.pairs.append((start, end))
            return out

        trainer._update = timed
        self.trainer = trainer

    def close(self) -> List[float]:
        del self.trainer._update
        return [s.elapsed_time(e) for s, e in self.pairs]


def window(prog: Dict, gen, first: int, seconds: float, device, spans: bool) -> Dict:
    """Steps from batch ``first`` on until ``seconds`` have passed; the rate
    is over the whole steps and their wall time."""
    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    tr = prog["trainer"]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    timer = UpdateSpans(tr) if spans and cuda else None
    steps = failed = 0
    t0 = time.perf_counter()
    while True:
        out = tr.train_step(feed(gen, first + steps, device))
        steps += 1
        failed += 0 if out["ok"] else 1
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return {"steps": steps, "failed": failed, "seconds": elapsed,
            "update_ms": timer.close() if timer else None,
            "launches": dict(fa.LAUNCHES),
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
            "reserved_bytes": torch.cuda.max_memory_reserved() if cuda else 0}


def profiled(prog: Dict, gen, first: int, device) -> Dict:
    """``PROFILED_STEPS`` steps under ``torch.profiler``: the device
    kernels and the host's spans, as (name, start us, duration us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = prog["trainer"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    timer = UpdateSpans(tr) if device.type == "cuda" else None
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILED_STEPS):
            with record_function("bench.feed"):
                batch = feed(gen, first + i, device)
            with record_function("bench.train_step"):
                tr.train_step(batch)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if timer:
        timer.close()
    kernels, host = [], []
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.elapsed_us()))
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append(row)
        elif not (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")):
            kernels.append(row)  # a kernel, copy or fill; not a host span's mirror
    return {"steps": PROFILED_STEPS, "wall_s": wall, "kernels": kernels, "host": host}


def busy_intervals(kernels) -> List[List[float]]:
    """The device's busy intervals (us), overlapping kernels merged."""
    merged: List[List[float]] = []
    for _, start, dur in sorted(kernels, key=lambda k: k[1]):
        end = start + dur
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def busy_seconds(kernels) -> float:
    return sum(b - a for a, b in busy_intervals(kernels)) * 1e-6


def breakdown(profile: Dict) -> Dict[str, List]:
    """The ten device operations that took most time, and the ten longest
    idle gaps by the innermost host span open when each began, in seconds."""
    ops: Dict[str, float] = {}
    for name, _, dur in profile["kernels"]:
        ops[name] = ops.get(name, 0.0) + dur * 1e-6
    gaps: Dict[str, float] = {}
    busy = busy_intervals(profile["kernels"])
    host = sorted(profile["host"], key=lambda h: h[1])
    # a sweep over the gaps in time order: ``opened`` holds the host spans
    # begun so far, latest start on top; one that ended before a gap began
    # ends before every later gap too
    opened: List = []
    at = 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        while at < len(host) and host[at][1] <= a:
            heapq.heappush(opened, (-host[at][1], host[at][1] + host[at][2], host[at][0]))
            at += 1
        while opened and opened[0][1] < a:
            heapq.heappop(opened)
        name = opened[0][2] if opened else "(no host span)"
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def free_program(prog: Dict) -> None:
    import torch

    prog.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# --------------------------------------------------------------------- a run


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             loaded: Optional[Dict] = None, start: Optional[float] = None,
             metrics: Optional[List[str]] = None) -> Dict[str, Any]:
    """One run of cell ``name``: the result's keys in the order they are
    printed (``checks`` last).  ``loaded`` replaces the cell's files and
    ``metrics`` the per-layer metrics of ``BENCHMARK.json`` (tests run tiny
    cells on the CPU so)."""
    prepare_environment()
    import torch

    from perfbench import compare, spans, traffic
    from perfbench.reference import follow

    start = process_start() if start is None else start
    device = torch.device(device or "cuda")
    files = loaded or load_cell(name)
    config, mix, cell = files["config"], files["mix"], files["cell"]
    gen = traffic.from_files(config, mix, seed)

    prog = build_program(config, mix, seed, device, cell["hbm_bytes"])
    mine = checked_steps(prog, gen, config, mix, seed, device)
    setup_s = time.time() - start
    first = mix["checked_steps"]
    win = window(prog, gen, first, seconds, device, spans=trace)
    plan = {"seconds": prog["plan_s"], "n_micro": prog["step"].n_micro,
            "sizes": prog["step"].segment_sizes, "remat": prog["step"].segment_remat}
    prof = span_rec = None
    traced_s: Dict[str, float] = {}
    if trace:
        t0 = time.perf_counter()
        prof = profiled(prog, gen, first + win["steps"], device)
        t1 = time.perf_counter()
        span_rec = spans.span_pass(prog, gen, first + win["steps"] + PROFILED_STEPS, device)
        traced_s = {"profiled": t1 - t0, "span_pass": time.perf_counter() - t1}
    free_program(prog)

    tokens = win["steps"] * mix["rows"] * mix["seq_len"]
    if trace:
        record = {"cell": cell, "config": config, "mix": mix, "window": win,
                  "launches": win["launches"], "plan": plan, "peak_bytes": win["peak_bytes"],
                  "budget_bytes": cell["hbm_bytes"], "profile": prof, "spans": span_rec}
        values = {}
        for metric in (per_layer_metrics(name) if metrics is None else metrics):
            got = reader(metric)(record)
            if got is not None:
                values[metric] = got
        units = metric_units()
        out_metrics = {k: {"value": v, "unit": units.get(k, "")} for k, v in values.items()}
    else:
        out_metrics = {
            "tokens_per_s": {"value": tokens / win["seconds"], "unit": "tokens/s"},
            "peak_mem_gib": {"value": win["peak_bytes"] / 2**30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }

    batches = [gen.batch(s) for s in range(mix["checked_steps"])]
    t_ref = time.perf_counter()
    ref = follow(config, mix, seed, batches, device)
    t_ref = time.perf_counter() - t_ref
    found = compare.numbers(mine, ref)
    ok, checks = compare.judge(found, cell["limits"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": win["peak_bytes"]}
    result = {"correct": bool(ok and mine["ok"]), "attempted": win["steps"],
              "failed": win["failed"], "metrics": out_metrics, "device": dev}
    if trace:
        dev["busy_s"] = busy_seconds(prof["kernels"])
        dev["window_s"] = prof["wall_s"]
        result["breakdown"] = breakdown(prof)
    result["checks"] = {n: {"value": c["value"] if math.isfinite(c["value"]) else str(c["value"]),
                            "limit": c["limit"]} for n, c in checks.items()}
    result["_found"] = found
    result["_plan"] = plan
    result["_reserved"] = win["reserved_bytes"]
    result["_seconds"] = {"setup": setup_s, "window": win["seconds"], "reference": t_ref,
                          **traced_s}
    return result


def metric_units() -> Dict[str, str]:
    bench = load_json(ROOT / "BENCHMARK.json")
    return {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_environment()
    try:
        files = load_cell(args.workload)
    except OSError as e:
        print(f"perfbench: no such cell {args.workload!r}: {e}", file=sys.stderr)
        return 2
    import torch

    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      loaded=files, start=start)
    found, plan, took = result.pop("_found"), result.pop("_plan"), result.pop("_seconds")
    reserved = result.pop("_reserved")
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 4
    print(f"card: {card_note()}; plan: sizes {list(plan['sizes'] or [])} remat "
          f"{[int(r) for r in plan['remat'] or []]} n_micro {plan['n_micro']}", file=sys.stderr)
    traced = (f", profiled pass {took['profiled']:.1f}, span pass {took['span_pass']:.1f}"
              if "span_pass" in took else "")
    print(f"seconds: set-up {took['setup']:.1f}, window {took['window']:.1f}, reference "
          f"{took['reference']:.1f}{traced}, run {time.time() - start:.1f}", file=sys.stderr)
    print(f"memory: window peak allocated {result['device']['memory_peak_bytes'] / 2**30:.2f} "
          f"GiB, reserved {reserved / 2**30:.2f} GiB", file=sys.stderr)
    print(f"worst leaves: grad {found['grad']['at']}, change {found['change']['at']} "
          f"({found['change']['left_out']} leaves left out)", file=sys.stderr)
    for n, c in result["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
