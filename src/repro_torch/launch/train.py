"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs the port's stack end to end on one device: config → DP remat plan
(chain carrier → Planner → segment lowering, budgeted against the card's
memory) → the LM (dense, MoE, Mamba2 hybrid, xLSTM or the vision stub's
backbone, text-only) with the flash-attention kernels → the Trainer (NaN
guard, straggler hooks) over the synthetic pipeline.  The pipeline makes
tokens only, so an encoder-decoder arch (whisper), whose loss reads
``frames``, raises a ``ValueError`` before anything is built (the
reference launcher fails at its first step with ``KeyError: 'frames'``).
The device is CUDA unless ``--device cpu`` is given; without a card the
CUDA default raises instead of falling back.  On the CPU the plan budgets the
reference's per-device memory (16 GiB), so its plan equals the reference
launcher's.  As in the reference, the plan's ``n_micro`` is printed but
not applied: the Trainer runs the whole batch at once.

``--ckpt-dir D --ckpt-every N`` checkpoints every N steps and at the end;
rerunning the same command resumes from the latest committed step.  The
data stream resumes at that step too (the reference restarts it at batch
0), so a restarted run continues the interrupted one bitwise.

**Data parallel under torchrun** (``WORLD_SIZE`` set, e.g.
``torchrun --nproc_per_node N -m repro_torch.launch.train ...``): each
process joins the group (NCCL on CUDA with a card per rank, gloo on the
CPU or for ranks sharing one node's cards), the world becomes
the host mesh ``("data", "model")`` with ``model`` = 1, each rank reads its
slice of the global batch ``--batch`` (the pipeline's ``num_hosts`` /
``host_id``), the remat plan budgets per-device bytes on the mesh's axis
sizes, and the Trainer steps on the mesh (``Trainer(mesh=)``), as the
reference launcher does.  Rank 0 logs, and prints a last ``summary:`` line
(JSON: losses, step seconds, peak device bytes, the first step's
collectives in all and by mesh axis, the kernels' launches in this
process).  With ``--ckpt-dir``
rank 0 writes the checkpoints and every rank restores from them.  A group
the caller started is joined and left running; one the launcher started
is destroyed at the end.  Without ``torchrun`` the launcher runs as before.

``--layers N`` cuts the config's depth to N layers at full width: a
quick run of the full-size step's shapes (kernels, collectives, per-layer
memory) on a card or a group too small for the whole depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.mesh import init_distributed, make_host_mesh, planning_hbm_bytes
from repro_torch.parallel.sharding import axis_sizes_of
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
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--plan-cache-dir", default=None,
                    help="on-disk recomputation-plan cache (restart = lookup)")
    ap.add_argument("--objective", default="time_centric",
                    choices=["time_centric", "memory_centric"])
    ap.add_argument("--no-plan", action="store_true",
                    help="disable the DP remat plan (vanilla remat fallback)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers (width kept)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if cfg.encoder_decoder:
        raise ValueError(f"{cfg.name} is an encoder-decoder model whose loss reads "
                         "`frames`; the synthetic pipeline has no frames (train it "
                         "through Trainer on batches that carry them)")
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    hbm = planning_hbm_bytes(device)
    mesh, rank, world, owned = None, 0, 1, False
    if "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        owned = not dist.is_initialized()
        rank = init_distributed(device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = make_host_mesh(device)
        world = mesh.size()
    say = print if rank == 0 else (lambda *a, **k: None)

    if args.plan_cache_dir:
        from repro_torch.core.plan_cache import set_default_cache_dir

        set_default_cache_dir(args.plan_cache_dir)

    sp = res = None
    segment_sizes = segment_remat = None
    if not args.no_plan:
        sp, res = segment_plan(cfg, shape, axis_sizes=axis_sizes_of(mesh) or None,
                               objective=args.objective, hbm_bytes=hbm, device=device.type)
        if sp is not None:
            segment_sizes, segment_remat = sp.sizes, sp.remat
            say(f"plan: {sp.n_segments} segments, remat "
                  f"{sum(s for s, r in zip(sp.sizes, sp.remat) if r)}/{sum(sp.sizes)}"
                  f" units, micro={sp.n_micro}, feasible={res.feasible}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = build_model(cfg, device=device, generator=gen)

    def loss_fn(m, batch):
        return m.loss(batch, segment_sizes=segment_sizes,
                      segment_remat=segment_remat)

    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        num_hosts=world, host_id=rank,
    ))
    tc = TrainConfig(
        total_steps=args.steps,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        plan_cache_dir=args.plan_cache_dir,
        log_every=max(1, args.steps // 20),
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                              total_steps=args.steps),
    )
    tr = Trainer(loss_fn, model, tc, device=device, mesh=mesh)
    if tr.maybe_restore():
        say(f"restored from step {tr.step}")
    # the stream resumes at the restored step, so a restart continues the run
    out = tr.run((data.batch(i) for i in itertools.count(tr.step)), log=say)
    tr.close()
    say(f"done: step={out['step']} final_loss={out['final_loss']:.4f} "
        f"skipped={out['skipped']} stragglers={out['straggler_steps']}")
    out.update(plan=sp, plan_result=res, n_units=model.n_units, comm=tr.comm_stats)
    if mesh is not None:
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        from repro_torch.kernels.flash_attention import LAUNCHES

        say("summary: " + json.dumps({
            "world": world, "losses": out["losses"], "step_seconds": out["step_seconds"],
            "peak_bytes": peak, "collectives": tr.comm_stats,
            "collectives_by_axis": tr.comm_by_axis, "launches": dict(LAUNCHES)}))
        if owned:
            dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
