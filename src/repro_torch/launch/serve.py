"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Spins up the slot-based continuous-batching engine on the port's LM (random
weights from ``--seed``) and drives a batch of synthetic requests through
it, with the reference launcher's prompt generator, so both launchers
submit the same prompts.  An encoder-decoder arch (whisper) gets one clip
of frames a slot, drawn from a generator seeded 1 on the device (the
reference draws them from ``PRNGKey(1)``, so the clips differ).  The
device is CUDA unless ``--device cpu`` is given; without a card the CUDA
default raises.  Under ``torchrun`` (``WORLD_SIZE`` set) every rank serves
the same requests through one sharded engine on the host mesh
``{data: world, model: 1}`` (``Engine(mesh=)``: the slots split over
``data``), on ``launch.mesh.init_distributed``'s backend; rank 0 prints.  ``main`` returns the
completed requests, the wall seconds, the engine steps and each step's
seconds, and the engine.  ``--layers N`` cuts the config's depth to N
layers at full width, as the training launcher's does.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.launch.train import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import Engine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--plan-cache-dir", default=None,
                    help="shared on-disk recomputation-plan cache")
    ap.add_argument("--seed", type=int, default=0, help="weight init seed")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers (width kept)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    mesh, rank, owned = None, 0, False
    if "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        owned = not dist.is_initialized()
        rank = init_distributed(device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = make_host_mesh(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = build_model(cfg, device=device, generator=gen)
    kw = {}
    if cfg.encoder_decoder:
        kw["frames"] = torch.randn(
            (args.slots, cfg.frontend_seq, cfg.d_model), device=device,
            generator=torch.Generator(device=device).manual_seed(1))
    eng = Engine(model, max_slots=args.slots, max_seq=args.max_seq,
                 plan_cache_dir=args.plan_cache_dir, mesh=mesh, **kw)

    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size, size=rng.integers(4, 32)).tolist()
        eng.submit(prompt, max_new_tokens=args.new_tokens,
                   temperature=args.temperature)

    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    if rank == 0:
        print(f"served {len(done)} requests, {toks} tokens in {dt:.2f}s "
              f"({toks / dt:.1f} tok/s) over {len(eng.step_seconds)} engine steps")
    if owned:
        torch.distributed.destroy_process_group()
    return dict(completed=done, seconds=dt, steps=len(eng.step_seconds),
                step_seconds=list(eng.step_seconds), engine=eng)


if __name__ == "__main__":
    main()
