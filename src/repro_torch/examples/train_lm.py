"""End-to-end example: train a ~100M-parameter LM for a few hundred steps
under a DP recomputation plan, with checkpointing and restart (port of
``examples/train_lm.py``).

The model is a 12-layer / d=768 dense transformer (GPT-2-small class,
~124M params) on the synthetic pipeline.  The paper's technique enters as
the DP-planned ``segment_sizes`` / ``segment_remat``.  The plan budgets the
card's memory on CUDA and the reference's 16 GiB on the CPU, where it is
the reference example's plan.

Run: python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.mesh import REFERENCE_HBM_BYTES
from repro_torch.launch.plan import plan_with_microbatching
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import TrainConfig, Trainer

from ._device import pick


def config_100m() -> ModelConfig:
    return dataclasses.replace(
        get_config("stablelm-3b"),
        name="lm-124m",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_head=64,
        d_ff=3072,
        vocab_size=50304,
    )


def main(argv: Optional[Sequence[str]] = None,
         weights: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """``weights`` (a state dict) replaces the seed-0 initial weights."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="repro_train_lm_ckpt",
                    help="checkpoint directory ('' for none)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = pick(args.device)

    cfg = config_100m()
    print(f"model: {cfg.name}  params≈{cfg.num_params()/1e6:.0f}M")
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    sp, res = plan_with_microbatching(
        cfg, shape, dp_shards=1, model_shards=1, device=device.type,
        hbm_bytes=REFERENCE_HBM_BYTES if device.type == "cpu" else None)
    print(f"plan: {sp.n_segments} segments "
          f"(remat {sum(s for s, r in zip(sp.sizes, sp.remat) if r)}/{sum(sp.sizes)}"
          f" units), feasible={res.feasible}, "
          f"overhead={res.overhead:.0f} T units")

    model = build_model(cfg, device=device)
    if weights is not None:
        model.load_state_dict(weights, strict=True)

    def loss_fn(m, b):
        return m.loss(b, segment_sizes=sp.sizes, segment_remat=sp.remat)

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                  global_batch=args.batch))
    tc = TrainConfig(
        total_steps=args.steps,
        ckpt_every=100,
        ckpt_dir=args.ckpt_dir or None,
        log_every=20,
        optimizer=AdamWConfig(lr=3e-4, warmup_steps=30, total_steps=args.steps),
    )
    tr = Trainer(loss_fn, model, tc, device=device)
    if tr.maybe_restore():
        print(f"resumed from step {tr.step}")
    out = tr.run(iter(data))
    tr.close()
    print(f"final loss {out['final_loss']:.4f} after {out['step']} steps "
          f"(skipped={out['skipped']}, stragglers={out['straggler_steps']})")
    return {**out, "plan": sp, "plan_result": res}


if __name__ == "__main__":
    main()
