"""AdamW with decoupled weight decay, global-norm clipping and LR schedules
(port of ``repro/optim/adamw.py``).

The arithmetic is the reference's.  What differs: the update is applied
*in place* to the parameters and moments (the reference returns new
pytrees; at stablelm-3b width a functional update would hold a second copy
of 45 GB of static state), and parameters are lists of tensors.  Which
leaves take weight decay is an explicit mask: the reference decays leaves
of rank ≥ 2, and its stacked unit leaves (norm scales included) all have
rank ≥ 2 — ``weights.reference_ndim`` reproduces that for the port's
unstacked units.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class AdamWState:
    step: int
    mu: List[torch.Tensor]  # f32, like params
    nu: List[torch.Tensor]  # f32, like params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup → cosine decay to min_lr_frac·lr (f32, as the reference)."""
    f = np.float32
    s = f(step)
    warm = min(f(1.0), s / f(max(1, cfg.warmup_steps)))
    prog = np.clip((s - f(cfg.warmup_steps))
                   / f(max(1, cfg.total_steps - cfg.warmup_steps)), f(0.0), f(1.0))
    cos = f(0.5) * (f(1.0) + np.cos(f(math.pi) * prog))
    frac = f(cfg.min_lr_frac) + f(1 - cfg.min_lr_frac) * cos
    return float(f(cfg.lr) * warm * frac)


def init(params: Sequence[torch.Tensor]) -> AdamWState:
    zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    return AdamWState(step=0, mu=zeros, nu=[torch.zeros_like(z) for z in zeros])


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """√(Σ‖t‖²) in f32, as a 0-dim plain tensor on the tensors' device.

    A DTensor contributes its local squares, summed over the ranks of
    every mesh dim that shards it: the leaves sharded over the same mesh
    dims share one all-reduce of their local sums per dim.  Replicated
    leaves (plain tensors too) send nothing, so without sharded leaves the
    norm is the local one, bit for bit."""
    from torch.distributed.tensor import DTensor

    terms: List[torch.Tensor] = []
    groups: Dict[Tuple[int, ...], List[int]] = {}
    mesh = None
    for i, t in enumerate(tensors):
        local = t.to_local() if isinstance(t, DTensor) else t
        terms.append(local.float().square().sum())
        if isinstance(t, DTensor):
            dims = tuple(d for d, p in enumerate(t.placements) if not p.is_replicate())
            if dims:
                groups.setdefault(dims, []).append(i)
                mesh = t.device_mesh
    if groups:
        import torch.distributed._functional_collectives as funcol

        for dims, idx in groups.items():
            part = torch.stack([terms[i] for i in idx])
            for d in dims:
                part = funcol.all_reduce(part, "sum", (mesh, d))
            for j, i in enumerate(idx):
                terms[i] = part[j]
    return torch.stack(terms).sum().sqrt()


@torch.no_grad()
def update(
    cfg: AdamWConfig,
    grads: Sequence[torch.Tensor],
    state: AdamWState,
    params: Sequence[torch.Tensor],
    decay: Optional[Sequence[bool]] = None,
    gnorm: Optional[torch.Tensor] = None,
) -> Dict[str, object]:
    """One AdamW step, in place on ``params``, ``state.mu`` and ``state.nu``.

    ``decay[i]`` says whether ``params[i]`` takes weight decay (default:
    rank ≥ 2, the reference's rule).  ``gnorm`` may pass a global norm the
    caller already computed.  Returns the metrics ``grad_norm`` and ``lr``.
    """
    if decay is None:
        decay = [p.dim() >= 2 for p in params]
    state.step += 1
    if gnorm is None:
        gnorm = global_norm(grads)
    f = np.float32
    step = f(state.step)
    lr = lr_schedule(cfg, state.step)
    bc1 = float(f(1.0) - f(cfg.b1) ** step)
    bc2 = float(f(1.0) - f(cfg.b2) ** step)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    for g, m, v, p, dec in zip(grads, state.mu, state.nu, params, decay):
        g = g.float()
        if scale is not None:
            g = g * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        delta = (m / bc1) / ((v / bc2).sqrt() + cfg.eps)
        if cfg.weight_decay and dec:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return {"grad_norm": gnorm, "lr": lr}
