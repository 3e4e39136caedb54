"""Plain float32 reference of a training step: the configuration's model
(pre-norm attention with rotary positions and, per layer, a SwiGLU MLP or
a top-k mixture of experts with capacity), its next-token loss, the
gradients and AdamW.

It follows what the configuration states, as the program runs it
(``configs/<config>.json``: ``port``, ``moe``, ``departures``), and is
computed in blocks: each layer under a checkpoint (its interior is made
again in the backward pass), attention a block of 1,024 queries at a time
over the keys the causal mask keeps, the loss 2,048 positions at a time,
the batch a row at a time.  ``arith`` is the arithmetic of every product
but the router's: :class:`F32Arith` (float32, TF32 off) or
:class:`Fp8Arith` (operands rounded to float8 with one scale a tensor: the
control that a lower precision must fail).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import weights as W

Q_BLOCK = 1024
LOSS_BLOCK = 2048


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


# ----------------------------------------------------------------- the model


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, D): each position's pairs (i, i + D/2) turned by
    position / theta^(2i/D)."""
    S, D = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def causal_attention(q, k, v, mm) -> torch.Tensor:
    """q (B, H, S, D), k and v (B, H, S, D) -> (B, H, S, D), a block of
    queries at a time over the keys up to the block's last query."""
    S, D = q.shape[2], q.shape[3]
    outs = []
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(S, q0 + Q_BLOCK)

        def block(qb, kb, vb, q0=q0, q1=q1):
            s = mm(qb, kb.transpose(-1, -2)) / math.sqrt(D)
            keep = (torch.arange(q0, q1, device=q.device)[:, None]
                    >= torch.arange(q1, device=q.device)[None, :])
            p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
            return mm(p, vb)

        outs.append(checkpoint(block, q[:, :, q0:q1], k[:, :, :q1], v[:, :, :q1],
                               use_reentrant=False))
    return torch.cat(outs, dim=2)


def attention(P, pre, x, cfg, mm):
    p = cfg["port"]
    B, S, _ = x.shape
    H, KV, Dh = p["n_heads"], p["n_kv_heads"], p["d_head"]
    q = rotary(mm(x, P[pre + "attn.wq"]).view(B, S, H, Dh), p["rope_theta"])
    k = rotary(mm(x, P[pre + "attn.wk"]).view(B, S, KV, Dh), p["rope_theta"])
    v = mm(x, P[pre + "attn.wv"]).view(B, S, KV, Dh)
    # query head h reads key/value head h // (H / KV)
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    ctx = causal_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mm)
    return mm(ctx.transpose(1, 2).reshape(B, S, H * Dh), P[pre + "attn.wo"])


def swiglu(x, wg, wu, wd, mm):
    return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)


def experts(P, pre, x, cfg, mm):
    """Top-k routing in float32 over the softmax of the router's logits,
    the k gates renormalised; each expert takes its routes in token order
    up to its capacity, max(8, int(cf * T * k / E)); a route past it adds
    nothing."""
    moe = cfg["moe"]
    B, S, d = x.shape
    E, K = moe["num_experts"], moe["top_k"]
    xt = x.reshape(B * S, d)
    T = xt.shape[0]
    probs = torch.softmax(xt @ P[pre + "moe.router"], dim=-1)
    gate, chosen = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    cap = max(8, int(moe["capacity_factor"] * T * K / E))
    with torch.no_grad():
        flat = chosen.reshape(T * K)
        # a route's place in its expert's queue: the routes before it, in
        # token order, that chose the same expert
        hot = (flat[:, None] == torch.arange(E, device=x.device)).long()
        place = ((torch.cumsum(hot, dim=0) - hot) * hot).sum(dim=1)
        kept = place < cap
    y = torch.zeros_like(xt)
    wg, wu, wd = (P[pre + "moe.experts." + n] for n in ("w_gate", "w_up", "w_down"))
    for e in range(E):
        routes = torch.nonzero(kept & (flat == e)).squeeze(1)
        if routes.numel() == 0:
            continue
        tok = routes // K
        out = swiglu(xt[tok], wg[e], wu[e], wd[e], mm)
        y = y.index_add(0, tok, out * gate.reshape(T * K)[routes][:, None])
    return y.view(B, S, d)


def layer(P, pre, h, cfg, mm):
    p = cfg["port"]
    eps = p["norm_eps"]
    h = h + attention(P, pre, rmsnorm(h, P[pre + "ln1.scale"], eps), cfg, mm)
    x = rmsnorm(h, P[pre + "ln2.scale"], eps)
    if cfg.get("moe"):
        return h + experts(P, pre, x, cfg, mm)
    return h + swiglu(x, P[pre + "mlp.w_gate"], P[pre + "mlp.w_up"], P[pre + "mlp.w_down"], mm)


def block_names(cfg) -> List[str]:
    kind = "b0_attn_moe." if cfg.get("moe") else "b0_attn_mlp."
    return [f"layers.{u}.{kind}" for u in range(cfg["port"]["n_layers"])]


def row_loss(P, cfg, tokens, labels, mm) -> torch.Tensor:
    """Summed loss of one row (1, S): the logits at position t against
    labels[t + 1], as the configuration's loss pairs them."""
    p = cfg["port"]
    h = P["embedding.embed"][tokens]
    for pre in block_names(cfg):
        h = checkpoint(lambda x, pre=pre: layer(P, pre, x, cfg, mm), h, use_reentrant=False)
    h = rmsnorm(h, P["final_norm.scale"], p["norm_eps"])
    table = P["embedding.embed"] if p["tie_embeddings"] else P["head.unembed"]
    S = tokens.shape[1]
    total = h.new_zeros(())
    for s0 in range(0, S - 1, LOSS_BLOCK):
        s1 = min(S - 1, s0 + LOSS_BLOCK)

        def part(hb, lab):
            logits = mm(hb, table.t())
            return (torch.logsumexp(logits, dim=-1)
                    - logits.gather(-1, lab[..., None])[..., 0]).sum()

        total = total + checkpoint(part, h[:, s0:s1], labels[:, s0 + 1:s1 + 1].long(),
                                   use_reentrant=False)
    return total


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
    numpy ``tokens`` and ``labels`` (rows, S)."""
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
