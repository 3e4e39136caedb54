"""Tiny cells for the CPU tests: the cells' configurations cut to a few
layers of width 64, one or two rows of 64 tokens, run by the harness on
the CPU (the flash kernels' plain versions)."""

import copy

from perfbench import harness

#: (config, activation dtype) -> limits between the sound runs' readings
#: and the control's and faults' at this size (seeds 5 and 6)
LIMITS = {
    ("stablelm-3b", "float32"): {"loss": 1e-5, "grad": 1e-4, "change": 1e-4},
    ("granite-moe-3b-a800m", "float32"): {"loss": 1e-5, "grad": 1e-4, "change": 1e-4},
    ("stablelm-3b", "bfloat16"): {"loss": 6e-4, "grad": 8e-3, "change": 4e-3},
}


def tiny_cell(config: str, dtype: str, rows: int = 2, seq: int = 64) -> dict:
    cfg = copy.deepcopy(harness.load_json(harness.BENCH / "configs" / f"{config}.json"))
    moe = cfg.get("moe")
    cfg["port"].update(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2 if moe else 4,
                       d_head=16, d_ff=128, vocab_size=256, dtype=dtype)
    if moe:
        cfg["moe"].update(num_experts=4, top_k=2, d_ff_expert=32)
    mix = copy.deepcopy(harness.load_json(harness.BENCH / "mixes" / "train-16k.remat.json"))
    mix.update(rows=rows, seq_len=seq)
    cell = {"name": f"tiny.{config}.{dtype}", "config": config, "traffic": mix["name"],
            "chips": 1, "why": "a CPU test", "hbm_bytes": 2e6,
            "limits": LIMITS[(config, dtype)]}
    return {"cell": cell, "config": cfg, "mix": mix}


def run(files: dict, seed: int = 5, trace: bool = False, metrics=()):
    return harness.run_cell(files["cell"]["name"], seed, 0.05, trace, device="cpu",
                            loaded=files, metrics=list(metrics))
