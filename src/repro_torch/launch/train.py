"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs the port's stack end to end on one device: config → DP remat plan
(chain carrier → Planner → segment lowering, budgeted against the card's
memory) → the dense LM with the flash-attention kernels → the Trainer
(NaN guard, straggler hooks) over the synthetic pipeline.  The device is
CUDA unless ``--device cpu`` is given; without a card the CUDA default
raises instead of falling back.  On the CPU the plan budgets the
reference's per-device memory (16 GiB), so its plan equals the reference
launcher's.  As in the reference, the plan's ``n_micro`` is printed but
not applied: the Trainer runs the whole batch at once.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.mesh import REFERENCE_HBM_BYTES, device_hbm_bytes
from repro_torch.launch.steps import segment_plan
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import TrainConfig, Trainer


def resolve_device(name: str) -> torch.device:
    """The device the launcher runs on; CUDA without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to "
                           "run on the CPU")
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny config of the same family (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0, help="weight init seed")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--plan-cache-dir", default=None,
                    help="on-disk recomputation-plan cache (restart = lookup)")
    ap.add_argument("--objective", default="time_centric",
                    choices=["time_centric", "memory_centric"])
    ap.add_argument("--no-plan", action="store_true",
                    help="disable the DP remat plan (vanilla remat fallback)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    hbm = device_hbm_bytes(device) if device.type == "cuda" else REFERENCE_HBM_BYTES

    if args.plan_cache_dir:
        from repro_torch.core.plan_cache import set_default_cache_dir

        set_default_cache_dir(args.plan_cache_dir)

    sp = res = None
    segment_sizes = segment_remat = None
    if not args.no_plan:
        sp, res = segment_plan(cfg, shape, objective=args.objective, hbm_bytes=hbm)
        if sp is not None:
            segment_sizes, segment_remat = sp.sizes, sp.remat
            print(f"plan: {sp.n_segments} segments, remat "
                  f"{sum(s for s, r in zip(sp.sizes, sp.remat) if r)}/{sum(sp.sizes)}"
                  f" units, micro={sp.n_micro}, feasible={res.feasible}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = build_model(cfg, device=device, generator=gen)

    def loss_fn(m, batch):
        return m.loss(batch, segment_sizes=segment_sizes,
                      segment_remat=segment_remat)

    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch
    ))
    tc = TrainConfig(
        total_steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        plan_cache_dir=args.plan_cache_dir,
        log_every=max(1, args.steps // 20),
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                              total_steps=args.steps),
    )
    tr = Trainer(loss_fn, model, tc, device=device)
    out = tr.run(iter(data))
    print(f"done: step={out['step']} final_loss={out['final_loss']:.4f} "
          f"skipped={out['skipped']} stragglers={out['straggler_steps']}")
    out.update(plan=sp, plan_result=res, n_units=model.n_units)
    return out


if __name__ == "__main__":
    main()
