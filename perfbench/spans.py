"""The program's own spans and counters (``repro_torch.obs``) in one cell,
beside what the benchmark's traced run measures, in one process on the card:

    python3 perfbench/spans.py --workload CELL --seed N [--seconds S] [--out FILE]

The cell's set-up (``harness.build_program`` and the checked steps) runs
under ``obs.recording()``, for the set-up counters: ``kernels.built`` and
``kernels.build_s`` where this process compiled the kernels,
``planner.plan_s`` and the plan cache's tier (``planner.hits``,
``planner.misses``, ``planner.disk_hits``).  Then three windows of ``S``
seconds, recording off, on, off (the cost of recording in tokens a
second; the first window's update spans are ``update_ms``), the harness's
profiled pass with recording off, and :func:`span_pass`: the same steps
profiled under ``obs.recording()``.  Its span table gives the three
readings :func:`recompute_ms`, :func:`moe_dispatch_ms` and
:func:`moe_slot_use`, and the checks that the table accounts for the
pass's kernel time.  Prints the table on stderr and one JSON line; the
whole record, per-span backward nodes included, goes to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402

#: the spans whose device time, forward, re-run and backward, is the
#: MoE dispatch (the experts' products are not)
DISPATCH = ("moe.route", "moe.pack", "moe.combine")


def span_pass(prog: Dict, gen, first: int, device) -> Dict[str, Any]:
    """``harness.PROFILED_STEPS`` steps from batch ``first`` profiled under
    ``obs.recording()``: the span table, the counters, the wall time, the
    device's kernel time (the harness's own kernel filter, in ms) and the
    kernel names that carry the program's span prefix.  A traced run of the
    harness makes this pass too, after its profiled steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    tr = prog["trainer"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with obs.recording(), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(harness.PROFILED_STEPS):
            tr.train_step(harness.feed(gen, first + i, device))
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type != torch.autograd.DeviceType.CPU
               and not (getattr(e, "is_user_annotation", False) or e.name.startswith("bench."))]
    return {"steps": harness.PROFILED_STEPS, "wall_s": wall, "spans": obs.span_table(prof),
            "counters": obs.counters(),
            "kernel_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
            "prefixed_kernels": sorted({e.name for e in kernels
                                        if e.name.startswith(obs.PREFIX)})}


def recompute_ms(rec: Optional[Dict]) -> Optional[float]:
    """Device time of the segments' re-runs in the backward, ms a step:
    0.0 where the plan recomputes nothing, None without a span pass."""
    if not rec:
        return None
    row = rec["spans"].get("remat.recompute")
    return (row["device_ms"] if row else 0.0) / rec["steps"]


def moe_dispatch_ms(rec: Optional[Dict]) -> Optional[float]:
    """Device time of routing, packing and combining, ms a step: their
    forwards and re-runs, and the backward nodes of their forward ops;
    None where no MoE layer ran."""
    if not rec or not any(n in rec["spans"] for n in DISPATCH):
        return None
    rows = [rec["spans"][n] for n in DISPATCH if n in rec["spans"]]
    return sum(r["device_ms"] + r["bwd_device_ms"] for r in rows) / rec["steps"]


def moe_slot_use(rec: Optional[Dict]) -> Optional[float]:
    """The share of the experts' capacity slots that carry a kept route,
    in %: 100 × ``moe.kept`` / ``moe.slots``; None where no MoE layer ran."""
    if not rec or not rec["counters"].get("moe.slots"):
        return None
    return 100.0 * rec["counters"]["moe.kept"] / rec["counters"]["moe.slots"]


def checks(rec: Dict, update_ms: Optional[float]) -> Dict[str, Any]:
    """Whether the table accounts for the pass: the owned columns and
    ``(outside)`` against the pass's kernel time, ``(outside)``'s share,
    and ``trainer.update``'s device time a step against ``update_ms``."""
    from repro_torch.obs import OUTSIDE

    spans = rec["spans"]
    owned = sum(r["self_device_ms"] + r["bwd_device_ms"] for r in spans.values())
    total = rec["kernel_ms"]
    upd = spans.get("trainer.update")
    return {
        "kernel_ms": total,
        "owned_ms": owned,
        "owned_over_kernels": owned / total if total else None,
        "outside_share": spans[OUTSIDE]["self_device_ms"] / total if total else None,
        "update_device_ms": upd["device_ms"] / rec["steps"] if upd else None,
        "update_idle_ms": upd["idle_ms"] / rec["steps"] if upd else None,
        "update_ms": update_ms,
        "prefixed_kernels": rec["prefixed_kernels"],
    }


def format_table(spans: Dict[str, Dict], steps: int) -> str:
    head = (f"{'span':<18}{'calls':>7}{'host':>10}{'device':>10}{'self':>10}"
            f"{'bwd':>10}{'idle':>9}   (ms a step)")
    lines = [head]
    for name, r in sorted(spans.items(), key=lambda kv: -kv[1]["device_ms"]):
        lines.append(f"{name:<18}{r['calls'] / steps:>7g}{r['host_ms'] / steps:>10.2f}"
                     f"{r['device_ms'] / steps:>10.2f}{r['self_device_ms'] / steps:>10.2f}"
                     f"{r['bwd_device_ms'] / steps:>10.2f}{r['idle_ms'] / steps:>9.2f}")
    return "\n".join(lines)


def run(name: str, seed: int, seconds: float, device=None,
        loaded: Optional[Dict] = None) -> Dict[str, Any]:
    """The record described in the module's docstring (``loaded`` replaces
    the cell's files: the tests run tiny cells on the CPU)."""
    harness.prepare_environment()
    import torch

    from perfbench import traffic
    from repro_torch import obs

    device = torch.device(device or "cuda")
    files = loaded or harness.load_cell(name)
    config, mix, cell = files["config"], files["mix"], files["cell"]
    gen = traffic.from_files(config, mix, seed)
    with obs.recording():
        prog = harness.build_program(config, mix, seed, device, cell["hbm_bytes"])
        harness.checked_steps(prog, gen, config, mix, seed, device)
        setup = {k: v for k, v in obs.counters().items()
                 if k.startswith(("kernels.", "planner."))}
    at = mix["checked_steps"]
    wins = []
    for record in (False, True, False):  # the first window times the update too
        with obs.recording() if record else contextlib.nullcontext():
            wins.append(harness.window(prog, gen, at, seconds, device, spans=not wins))
        at += wins[-1]["steps"]
    rates = [w["steps"] * mix["rows"] * mix["seq_len"] / w["seconds"] for w in wins]
    update_ms = statistics.fmean(wins[0]["update_ms"]) if wins[0]["update_ms"] else None
    plain = harness.profiled(prog, gen, at, device)
    at += plain["steps"]
    rec = span_pass(prog, gen, at, device)
    plan = {"sizes": list(prog["step"].segment_sizes or []),
            "remat": [int(r) for r in prog["step"].segment_remat or []],
            "n_micro": prog["step"].n_micro}
    harness.free_program(prog)
    return {
        "cell": files["cell"]["name"], "seed": seed, "plan": plan, "setup_counters": setup,
        "tokens_per_s": {"off": rates[0], "on": rates[1], "off_again": rates[2]},
        "recording_cost": rates[1] / statistics.fmean((rates[0], rates[2])) - 1,
        "plain_wall_s": plain["wall_s"], "span_wall_s": rec["wall_s"],
        "span_pass_overhead": rec["wall_s"] / plain["wall_s"] - 1,
        "plain_prefixed_ops": sorted({n for n, _, _ in plain["kernels"]
                                      if n.startswith(obs.PREFIX)}),
        "readings": {"recompute_ms": recompute_ms(rec), "moe_dispatch_ms": moe_dispatch_ms(rec),
                     "moe_slot_use": moe_slot_use(rec)},
        "checks": checks(rec, update_ms),
        "counters": rec["counters"],
        "steps": rec["steps"],
        "spans": rec["spans"],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = run(args.workload, args.seed, args.seconds)
    print(f"card: {harness.card_note()}", file=sys.stderr)
    print(f"set-up counters: {json.dumps(out['setup_counters'])}", file=sys.stderr)
    print(f"recording: window {100 * out['recording_cost']:+.3f} % tokens/s, span pass "
          f"{100 * out['span_pass_overhead']:+.3f} % wall time over the plain pass",
          file=sys.stderr)
    print(format_table(out["spans"], out["steps"]), file=sys.stderr)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    short = {k: v for k, v in out.items() if k != "spans"}
    short["spans"] = {n: {k: v for k, v in r.items() if k != "bwd_nodes"}
                      for n, r in out["spans"].items()}
    print(json.dumps(short))
    return 0


if __name__ == "__main__":
    sys.exit(main())
