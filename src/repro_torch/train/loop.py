"""Training loop (port of ``repro/train/loop.py``).

Ported responsibilities:

* **the step** — ``loss_fn(model, batch)`` (the launchers hand in a loss
  whose remat segmentation is the DP plan), ``torch.autograd.grad`` over
  the model's parameters, then an in-place AdamW update;
* **NaN guard** — a non-finite loss or grad-norm skips the parameter update
  (parameters and optimizer state stay as they were) and increments a skip
  counter; the run never poisons its weights;
* **straggler mitigation** — per-step wall-times feed an EWMA; steps slower
  than ``straggler_factor``× the EWMA are counted and surfaced through
  ``on_straggler``;
* **plan cache** — ``plan_cache_dir`` attaches the on-disk recomputation-plan
  store (core.plan_cache), so a restarted job recovers its remat plan as a
  lookup instead of a re-solve.

The reference jits a step that donates a private copy of the params; the
port trains the given module in place (a copy would double 11 GB of f32
masters at stablelm-3b width).  Checkpoint/restart (``ckpt_dir``), int8
gradient compression (``compress_grads``), planned steps (``plan_budget``)
and ``remesh`` raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.optim import adamw
from repro_torch.weights import reference_ndim


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md module queue, item {item!r}"
    )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1
    compress_grads: bool = False
    # On-disk recomputation-plan cache (core.plan_cache); None keeps the
    # cache in memory only.
    plan_cache_dir: Optional[str] = None
    plan_budget: Optional[float] = None
    optimizer: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig
    )


class Trainer:
    def __init__(
        self,
        loss_fn: Callable[[nn.Module, Dict[str, torch.Tensor]], torch.Tensor],
        model: nn.Module,
        cfg: TrainConfig,
        device="cuda",
    ):
        if cfg.ckpt_dir:
            raise _not_ported("ckpt_dir (checkpoint/restart)", "Checkpointing")
        if cfg.compress_grads:
            raise _not_ported("compress_grads", "Multi-device")
        if cfg.plan_budget is not None:
            raise _not_ported("plan_budget (plan_function steps)",
                              "Torch graph carrier and lowerings")
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.model = model
        self.device = torch.device(device)
        if cfg.plan_cache_dir:
            from repro_torch.core.plan_cache import set_default_cache_dir

            set_default_cache_dir(cfg.plan_cache_dir)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.params = [p for _, p in named]
        self.decay = [reference_ndim(n, p) >= 2 for n, p in named]
        self.opt_state = adamw.init(self.params)
        self.step = 0
        self.skipped = 0
        self.straggler_steps = 0
        self._ewma: Optional[float] = None
        self.on_straggler: Optional[Callable[[int, float, float], None]] = None

    # ------------------------------------------------------------- step fn

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """One step; returns loss, grad_norm, lr (floats) and ok (bool)."""
        loss = self.loss_fn(self.model, batch)
        grads = torch.autograd.grad(loss, self.params)
        gnorm = adamw.global_norm(grads)
        loss_f, gnorm_f = float(loss.detach()), float(gnorm)
        # NaN guard: skip the update when loss/grad-norm is non-finite.
        ok = math.isfinite(loss_f) and math.isfinite(gnorm_f)
        lr = adamw.lr_schedule(self.cfg.optimizer, self.opt_state.step + 1)
        if ok:
            lr = adamw.update(self.cfg.optimizer, grads, self.opt_state, self.params,
                              decay=self.decay, gnorm=gnorm)["lr"]
        return {"loss": loss_f, "grad_norm": gnorm_f, "lr": lr, "ok": ok}

    # --------------------------------------------------------- run control

    def _track_time(self, dt: float) -> None:
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.cfg.straggler_factor * self._ewma:
            self.straggler_steps += 1
            if self.on_straggler:
                self.on_straggler(self.step, dt, self._ewma)
        a = self.cfg.ewma_alpha
        self._ewma = (1 - a) * self._ewma + a * dt

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def run(
        self,
        batches,
        log: Callable[[str], None] = print,
    ) -> Dict[str, Any]:
        """Run to total_steps; ``batches`` is an iterable of host batches."""
        c = self.cfg
        it = iter(batches)
        losses, grad_norms, seconds = [], [], []
        while self.step < c.total_steps:
            batch = self._to_device(next(it))
            t0 = time.perf_counter()
            m = self.train_step(batch)  # ends in a host sync (loss, grad-norm)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self._track_time(dt)
            if not m["ok"]:
                self.skipped += 1
            self.step += 1
            losses.append(m["loss"])
            grad_norms.append(m["grad_norm"])
            seconds.append(dt)
            if c.log_every and self.step % c.log_every == 0:
                log(
                    f"step {self.step:6d}  loss {m['loss']:.4f}  "
                    f"gnorm {m['grad_norm']:.3f}  lr {m['lr']:.2e}  "
                    f"{dt*1e3:.0f} ms"
                    + (f"  [skipped={self.skipped}]" if self.skipped else "")
                )
        return {
            "final_loss": losses[-1] if losses else float("nan"),
            "losses": losses,
            "grad_norms": grad_norms,
            "step_seconds": seconds,
            "skipped": self.skipped,
            "straggler_steps": self.straggler_steps,
            "step": self.step,
        }

    def remesh(self, *args: Any, **kwargs: Any) -> None:
        raise _not_ported("remesh", "Multi-device")
