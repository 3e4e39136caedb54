"""The plain float32 training step that every model module shares: the
row loop, the gradient norms and AdamW, over the loss that the
configuration's model module (:func:`perfbench.reference.model`) gives a
row, and the arithmetic of that loss's products.

``arith`` is the arithmetic of every product but the router's:
:class:`F32Arith` (float32, TF32 off) or :class:`Fp8Arith` (operands
rounded to float8 with one scale a tensor: the control that a lower
precision must fail).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch

from perfbench import weights as W


class F32Arith:
    name = "float32"

    @staticmethod
    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(a, b)


def _round8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` (a float8 type) under one scale that maps its
    largest magnitude onto the type's largest, returned in float32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq, bq = _round8(a, torch.float8_e4m3fn), _round8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(aq, bq)
        ctx.b_shape = b.shape
        return torch.matmul(aq, bq)

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _round8(g, torch.float8_e5m2)
        ga = torch.matmul(gq, bq.transpose(-1, -2))
        if len(ctx.b_shape) == 2:
            gb = aq.reshape(-1, aq.shape[-1]).t() @ gq.reshape(-1, gq.shape[-1])
        else:
            gb = torch.matmul(aq.transpose(-1, -2), gq)
        return ga, gb


class Fp8Arith:
    """float8 products: e4m3 operands forward, e5m2 cotangents backward,
    float32 sums (the usual float8 training recipe)."""

    name = "float8"

    @staticmethod
    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _Fp8Matmul.apply(a, b)


# ------------------------------------------------------------------ AdamW


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up, then a cosine down to ``min_lr_frac`` of the peak."""
    warm = min(1.0, step / max(1, opt["warmup_steps"]))
    prog = min(1.0, max(0.0, (step - opt["warmup_steps"])
                        / max(1, opt["total_steps"] - opt["warmup_steps"])))
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


def decays(name: str, t: torch.Tensor) -> bool:
    """The configuration's weight-decay rule: every matrix, and every
    per-layer leaf (the layers' norm scales too); not the final norm."""
    return t.dim() >= 2 or name.startswith("layers.")


# ---------------------------------------------------------------- the steps


def follow(cfg: dict, mix: dict, seed: int, batches: Sequence[Dict], device,
           arith=F32Arith, step_hook: Callable = None) -> Dict:
    """Three (``len(batches)``) training steps from the seed's weights:
    the loss of each step, each leaf's gradient norm at step 1 (before
    clipping) and each leaf's change over the steps.  ``batches`` hold
    numpy ``tokens`` and ``labels`` (rows, S).  A row's loss is the
    ``row_loss`` of the configuration's model module."""
    from perfbench.reference import model

    row_loss = model(cfg).row_loss
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    opt = mix["optimizer"]
    names, params = [], []
    for name, t in W.generate(cfg, seed, device):
        names.append(name)
        params.append(t.requires_grad_(True))
    P = dict(zip(names, params))
    m = [torch.zeros_like(t) for t in params]
    v = [torch.zeros_like(t) for t in params]
    losses, grad_norms = [], None
    for step, batch in enumerate(batches, start=1):
        tokens = torch.as_tensor(batch["tokens"], device=device).long()
        labels = torch.as_tensor(batch["labels"], device=device)
        rows, S = tokens.shape
        count = rows * (S - 1)
        grads, loss = None, 0.0
        for r in range(rows):
            part = row_loss(P, cfg, tokens[r:r + 1], labels[r:r + 1], arith.mm) / count
            got = torch.autograd.grad(part, params)
            if grads is None:
                grads = list(got)
            else:
                for g, d in zip(grads, got):
                    g.add_(d)
            del got
            loss += float(part.detach())
        if step_hook is not None:
            step_hook(step, grads)
        losses.append(loss)
        with torch.no_grad():
            norms = torch.stack([g.norm() for g in grads])
            if grad_norms is None:
                grad_norms = dict(zip(names, norms.tolist()))
            total = float(norms.square().sum().sqrt())
            clip = opt["clip_norm"]
            scale = 1.0 if clip is None else min(1.0, clip / max(total, 1e-9))
            lr = lr_at(opt, step)
            bc1, bc2 = 1 - opt["b1"] ** step, 1 - opt["b2"] ** step
            for name, p, g, mt, vt in zip(names, params, grads, m, v):
                g.mul_(scale)
                mt.mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                vt.mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
                delta = (mt / bc1) / ((vt / bc2).sqrt() + opt["eps"])
                if opt["weight_decay"] and decays(name, p):
                    delta.add_(p, alpha=opt["weight_decay"])
                p.sub_(lr * delta)
        del grads
    del m, v
    with torch.no_grad():
        change = {name: float((P[name] - t0).norm())
                  for name, t0 in W.generate(cfg, seed, device)}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
