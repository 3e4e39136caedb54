"""Serving example: continuous batching over a fresh model (port of
``examples/serve_lm.py``).

Submits a mixed workload (short/long prompts, greedy + sampled) to the
slot-based engine and prints per-request outputs + throughput.

Run: python -m repro_torch.examples.serve_lm [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model
from repro_torch.serving import Engine

from ._device import pick


def workload() -> list:
    """(prompt, new tokens, temperature) of the six requests."""
    rng = np.random.default_rng(0)
    return [
        ([1, 2, 3], 12, 0.0),
        (list(rng.integers(1, 200, size=24)), 8, 0.0),
        ([7] * 5, 16, 0.8),
        (list(rng.integers(1, 200, size=10)), 8, 0.0),
        ([42], 20, 1.0),
        (list(rng.integers(1, 200, size=40)), 6, 0.0),
    ]


def main(argv: Optional[Sequence[str]] = None,
         weights: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """``weights`` (a state dict) replaces the seed-0 initial weights."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = pick(args.device)

    cfg = reduced(get_config("qwen2.5-14b"), n_layers=4, d_model=128)
    model = build_model(cfg, device=device)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    eng = Engine(model, max_slots=4, max_seq=128, rng_seed=0)
    for prompt, n, temp in workload():
        eng.submit([int(t) for t in prompt], max_new_tokens=n, temperature=temp)

    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    for r in sorted(done, key=lambda r: r.uid):
        print(f"req {r.uid}: prompt[{len(r.prompt)} toks] → {r.output}")
    toks = sum(len(r.output) for r in done)
    print(f"\n{len(done)} requests, {toks} new tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s on {device.type})")
    return {"outputs": {r.uid: list(r.output) for r in done}, "tokens": toks,
            "seconds": dt}


if __name__ == "__main__":
    main()
