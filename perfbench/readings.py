"""Readings that a cell's correctness limits are set from, at the cell's
size on the card, in one process:

    python3 perfbench/readings.py --workload CELL --seeds 11,12,13 \
        [--faults] [--control] [--window SECONDS]

For each seed: the sound program's checked steps (and, with ``--window``,
the rate of a window of that length), each planted fault's
(``perfbench/faults.py``), the float32 reference's, and the float8
control's (the reference in the program's place at the nearest precision
below the configuration's bfloat16).  Every side is compared with the
float32 reference by ``perfbench.compare``; one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402


def program_readings(files, seed, device, fault=None, seconds=0.0):
    import contextlib

    from perfbench import faults, traffic

    config, mix, cell = files["config"], files["mix"], files["cell"]
    gen = traffic.from_files(config, mix, seed)
    with (faults.FAULTS[fault]() if fault else contextlib.nullcontext()):
        prog = harness.build_program(config, mix, seed, device, cell["hbm_bytes"])
        mine = harness.checked_steps(prog, gen, config, mix, seed, device)
        rate = None
        if seconds:
            win = harness.window(prog, gen, mix["checked_steps"], seconds, device, spans=False)
            rate = win["steps"] * mix["rows"] * mix["seq_len"] / win["seconds"]
    harness.free_program(prog)
    return mine, rate


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--window", type=float, default=0.0)
    args = ap.parse_args()
    harness.prepare_environment()
    import torch

    from perfbench import compare, faults, traffic
    from perfbench.reference import F32Arith, Fp8Arith, follow

    files = harness.load_cell(args.workload)
    config, mix = files["config"], files["mix"]
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = {"cell": args.workload, "seed": seed}
        sides = {}
        sides["program"], out["tokens_per_s"] = program_readings(files, seed, device,
                                                                 seconds=args.window)
        if args.faults:
            for name in faults.FAULTS:
                if name != "unchanged":  # reads 1 on grad and change by construction
                    sides[name], _ = program_readings(files, seed, device, fault=name)
        gen = traffic.from_files(config, mix, seed)
        batches = [gen.batch(s) for s in range(mix["checked_steps"])]
        ref = follow(config, mix, seed, batches, device, arith=F32Arith)
        if args.control:
            sides["control"] = follow(config, mix, seed, batches, device, arith=Fp8Arith)
        for side, got in sides.items():
            found = compare.numbers(got, ref)
            out[side] = {k: v["value"] for k, v in found.items()}
            out[side]["worst"] = {k: v["at"] for k, v in found.items() if k != "loss"}
        out["losses"] = {"reference": ref["losses"], "program": sides["program"]["losses"]}
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
