"""The model module ``granite_hybrid``: granite-4.0-h's decoder, a chain of
Mamba-2 and attention layers, each followed by a mixture of experts with a
shared expert, and its next-token loss, as the port's ``LM`` runs
``configs/<config>.json`` with a ``port.layer_pattern`` (``port``,
``departures``), written from the source's equations:

* the embedding times ``embedding_multiplier``;
* each layer ``h + r·mixer(rmsnorm(h))``, then ``h + r·(moe(x) + shared(x))``
  with ``x = rmsnorm(h)`` and ``r`` the ``residual_multiplier``;
* a Mamba-2 mixer: ``[z, xBC, dt] = in_proj(x)``; ``xBC = silu(conv(xBC) + b)``
  (a causal depthwise conv over x, B and C); ``dt = softplus(dt + dt_bias)``,
  ``A = -exp(A_log)``; ``y = SSD(x·dt, A·dt, B, C) + D·x`` (one group of B
  and C); ``out_proj(rmsnorm(y·silu(z)))``;
* attention: grouped queries over no positional encoding, the scores times
  ``attention_multiplier``;
* the MoE: top-k of the softmax over all the router's experts, the k gates
  renormalised; the experts held here (the first ``experts_held``) take
  their routes in token order up to the capacity max(8, int(cf·T·k/E)) over
  all E; a route to an expert held elsewhere, or past the capacity, adds
  nothing; the shared SwiGLU expert of every token;
* the logits of the tied table, over ``logits_scaling``.

It gives the three things a model module gives (``perfbench/reference/
__init__.py``) and :func:`ssd_work`, the operations and bytes of one
layer's scan that ``model_flops`` and ``metrics/ssd_roofline.py`` count.

The scan (:func:`ssd`) is the state space recurrence ``h_t = exp(a_t)·h_{t-1}
+ x_t ⊗ B_t``, ``y_t = h_t·C_t`` in its dual form, a chunk of
``ssm.chunk`` steps at a time: within a chunk every output is a decayed sum
over the chunk's earlier steps (a masked product), plus the state carried
from the chunks before, which the chunk then advances.  :func:`ssd_sequential`
is the recurrence step by step; the tests hold the two together.  Each
layer runs under a checkpoint, attention a block of 1,024 queries at a
time, the loss 2,048 positions at a time.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import flops
from perfbench.reference.lm import LOSS_BLOCK, Q_BLOCK, rmsnorm, swiglu
from perfbench.weights import Leaf

#: Mamba-2's head width (the source's ``mamba_d_head``)
HEAD_P = 64


def sizes(config: dict) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head width, state) of a Mamba-2 mixer."""
    p, ssm = config["port"], config["port"]["ssm"]
    d_inner = ssm["expand"] * p["d_model"]
    return d_inner, d_inner // HEAD_P, HEAD_P, ssm["d_state"]


def kinds(config: dict) -> List[str]:
    """Each layer's kind: the pattern repeated over ``n_layers``."""
    pat = config["port"]["layer_pattern"]
    return [pat[u % len(pat)] for u in range(config["port"]["n_layers"])]


# ------------------------------------------------------------------ the scan


def ssd_sequential(x, a, B, C):
    """The recurrence a step at a time.  x (S, H, P), a (S, H) log decays,
    B and C (S, N) → y (S, H, P)."""
    S, H, P = x.shape
    h = x.new_zeros((H, P, B.shape[-1]))
    ys = []
    for t in range(S):
        h = torch.exp(a[t])[:, None, None] * h + x[t][:, :, None] * B[t][None, None, :]
        ys.append(h @ C[t])
    return torch.stack(ys)


def ssd(x, a, B, C, chunk: int, mm):
    """The recurrence in its dual form, ``chunk`` steps at a time; the
    products through ``mm``.  Shapes as :func:`ssd_sequential`'s."""
    S, H, P = x.shape
    h = x.new_zeros((H, P, B.shape[-1]))
    ys = []
    for c0 in range(0, S, chunk):
        xc, Bc, Cc = x[c0:c0 + chunk], B[c0:c0 + chunk], C[c0:c0 + chunk]
        cum = torch.cumsum(a[c0:c0 + chunk], dim=0).t()  # (H, Q): decay from the chunk's start
        Q = cum.shape[1]
        causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        # decay[h, i, j]: from step j to step i of the chunk, for j <= i
        decay = torch.exp((cum[:, :, None] - cum[:, None, :]).masked_fill(~causal, -math.inf))
        scores = mm(Cc, Bc.t())[None] * decay  # (H, Q, Q)
        within = mm(scores, xc.transpose(0, 1))  # (H, Q, P)
        # (the products take no broadcast operand: the float8 control's
        # backward gives each operand's gradient in the shape it multiplied)
        carried = mm(Cc.expand(H, Q, -1), h.transpose(1, 2)) * torch.exp(cum)[:, :, None]
        ys.append((within + carried).transpose(0, 1))
        to_end = torch.exp(cum[:, -1:] - cum)  # (H, Q)
        h = (torch.exp(cum[:, -1])[:, None, None] * h
             + mm((xc.transpose(0, 1) * to_end[:, :, None]).transpose(1, 2),
                  Bc.expand(H, Q, -1)))
    return torch.cat(ys)


def ssd_work(config: dict, seq_len: int, itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one layer's scan forward over ``seq_len``
    tokens in chunks of Q, with one group of B and C: a chunk's scores
    C·Bᵀ 2·Q²·N, their product with x 2·H·Q²·P, the carried state's
    contribution 2·H·Q·N·P and its update 2·H·Q·N·P; x, B, C and y read or
    written once in the activations' ``itemsize``, the decay once in f32.
    The backward is twice the forward."""
    _, H, P, N = sizes(config)
    Q = min(config["port"]["ssm"]["chunk"], seq_len)
    chunks = seq_len // Q
    ops = chunks * (2 * Q * Q * N + 2 * H * Q * Q * P + 4 * H * Q * N * P)
    nbytes = seq_len * (2 * H * P * itemsize + 2 * N * itemsize + H * 4)
    return float(ops), float(nbytes)


# ----------------------------------------------------------------- the model


def causal_conv(x, w, b):
    """Depthwise causal conv: x (1, S, C), w (K, C), b (C,); out[t] =
    b + Σ_i w[i]·x[t - K + 1 + i]."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    return b + sum(pad[:, i:i + S] * w[i] for i in range(K))


def mamba(P, pre, x, cfg, mm):
    p = cfg["port"]
    d_inner, H, Pw, N = sizes(cfg)
    S = x.shape[1]
    zxbcdt = mm(x, P[pre + "in_proj.w"])
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H], dim=-1)
    xbc = F.silu(causal_conv(xbc, P[pre + "conv_w"], P[pre + "conv_b"]))
    xs, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt + P[pre + "dt_bias"])[0]  # (S, H)
    a = dt * -torch.exp(P[pre + "A_log"])
    xh = xs[0].reshape(S, H, Pw)
    y = ssd(xh * dt[:, :, None], a, Bm[0], Cm[0], p["ssm"]["chunk"], mm)
    y = (y + P[pre + "D_skip"][:, None] * xh).reshape(1, S, d_inner)
    y = rmsnorm(y * F.silu(z), P[pre + "norm_out.scale"], p["norm_eps"])
    return mm(y, P[pre + "out_proj.w"])


def causal_attention(q, k, v, mm, scale: float) -> torch.Tensor:
    """q, k, v (B, H, S, D) → (B, H, S, D), scores × ``scale``, a block of
    queries at a time over the keys up to the block's last query."""
    S = q.shape[2]
    outs = []
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(S, q0 + Q_BLOCK)

        def block(qb, kb, vb, q0=q0, q1=q1):
            s = mm(qb, kb.transpose(-1, -2)) * scale
            keep = (torch.arange(q0, q1, device=q.device)[:, None]
                    >= torch.arange(q1, device=q.device)[None, :])
            return mm(torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1), vb)

        outs.append(checkpoint(block, q[:, :, q0:q1], k[:, :, :q1], v[:, :, :q1],
                               use_reentrant=False))
    return torch.cat(outs, dim=2)


def attention(P, pre, x, cfg, mm):
    p = cfg["port"]
    B, S, _ = x.shape
    H, KV, Dh = p["n_heads"], p["n_kv_heads"], p["d_head"]
    q = mm(x, P[pre + "wq"]).view(B, S, H, Dh)
    k = mm(x, P[pre + "wk"]).view(B, S, KV, Dh).repeat_interleave(H // KV, dim=2)
    v = mm(x, P[pre + "wv"]).view(B, S, KV, Dh).repeat_interleave(H // KV, dim=2)
    ctx = causal_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mm,
                           p["attention_multiplier"])
    return mm(ctx.transpose(1, 2).reshape(B, S, H * Dh), P[pre + "wo"])


def experts(P, pre, x, cfg, mm):
    """The held experts' part of the routed result, and the shared expert's."""
    moe = cfg["port"]["moe"]
    B, S, d = x.shape
    E, K, held = moe["num_experts"], moe["top_k"], moe["experts_held"]
    xt = x.reshape(B * S, d)
    T = xt.shape[0]
    probs = torch.softmax(xt @ P[pre + "router"], dim=-1)
    gate, chosen = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    cap = max(8, int(moe["capacity_factor"] * T * K / E))
    with torch.no_grad():
        flat = chosen.reshape(T * K)
        # a route's place in its expert's queue: the earlier routes, in
        # token order, that chose the same expert
        hot = (flat[:, None] == torch.arange(held, device=x.device)).long()
        place = ((torch.cumsum(hot, dim=0) - hot) * hot).sum(dim=1)
        kept = (flat < held) & (place < cap)
    y = swiglu(xt, P[pre + "shared.w_gate"], P[pre + "shared.w_up"], P[pre + "shared.w_down"],
               mm)
    wg, wu, wd = (P[pre + "experts." + n] for n in ("w_gate", "w_up", "w_down"))
    for e in range(held):
        routes = torch.nonzero(kept & (flat == e)).squeeze(1)
        if routes.numel() == 0:
            continue
        tok = routes // K
        out = swiglu(xt[tok], wg[e], wu[e], wd[e], mm)
        y = y.index_add(0, tok, out * gate.reshape(T * K)[routes][:, None])
    return y.view(B, S, d)


def layer(P, pre, kind, h, cfg, mm):
    p = cfg["port"]
    eps, r = p["norm_eps"], p["residual_multiplier"]
    if kind == "mamba_moe":
        mixed = mamba(P, pre + "mamba.", rmsnorm(h, P[pre + "mamba.norm.scale"], eps), cfg, mm)
    else:
        mixed = attention(P, pre + "attn.", rmsnorm(h, P[pre + "ln1.scale"], eps), cfg, mm)
    h = h + r * mixed
    return h + r * experts(P, pre + "moe.", rmsnorm(h, P[pre + "ln2.scale"], eps), cfg, mm)


def row_loss(P, cfg, tokens, labels, mm) -> torch.Tensor:
    """Summed loss of one row (1, S): the logits at position t against
    labels[t + 1], as the configuration's loss pairs them."""
    p = cfg["port"]
    h = p["embedding_multiplier"] * P["embedding.embed"][tokens]
    for u, kind in enumerate(kinds(cfg)):
        pre = f"layers.{u}.b0_{kind}."
        h = checkpoint(lambda x, pre=pre, kind=kind: layer(P, pre, kind, x, cfg, mm), h,
                       use_reentrant=False)
    h = rmsnorm(h, P["final_norm.scale"], p["norm_eps"])
    table = P["embedding.embed"]
    S = tokens.shape[1]
    total = h.new_zeros(())
    for s0 in range(0, S - 1, LOSS_BLOCK):
        s1 = min(S - 1, s0 + LOSS_BLOCK)

        def part(hb, lab):
            logits = mm(hb, table.t()) / p["logits_scaling"]
            return (torch.logsumexp(logits, dim=-1)
                    - logits.gather(-1, lab[..., None])[..., 0]).sum()

        total = total + checkpoint(part, h[:, s0:s1], labels[:, s0 + 1:s1 + 1].long(),
                                   use_reentrant=False)
    return total


# ----------------------------------------------------------- leaves, FLOPs


def _moe_leaves(pre: str, p: dict) -> List[Leaf]:
    d, moe = p["d_model"], p["moe"]
    held, ff, fs = moe["experts_held"], moe["d_ff_expert"], moe["d_ff_shared"]
    return [
        (pre + "ln2.scale", (d,), None),
        (pre + "moe.router", (d, moe["num_experts"]), d ** -0.5),
        (pre + "moe.experts.w_gate", (held, d, ff), d ** -0.5),
        (pre + "moe.experts.w_up", (held, d, ff), d ** -0.5),
        (pre + "moe.experts.w_down", (held, ff, d), ff ** -0.5),
        (pre + "moe.shared.w_gate", (d, fs), d ** -0.5),
        (pre + "moe.shared.w_up", (d, fs), d ** -0.5),
        (pre + "moe.shared.w_down", (fs, d), fs ** -0.5),
    ]


def leaves(config: dict) -> List[Leaf]:
    """Every parameter, named as the port's ``LM`` names it: matrices
    N(0, 1/fan_in) (the tied table as the head's, fan_in d_model; the
    depthwise conv's taps and bias fan_in ``d_conv``), ``A_log`` and
    ``dt_bias`` N(0, 1), norm scales and ``D_skip`` ones."""
    p = config["port"]
    d, V, H, KV, Dh = p["d_model"], p["vocab_size"], p["n_heads"], p["n_kv_heads"], p["d_head"]
    d_inner, Hs, _, N = sizes(config)
    K = p["ssm"]["d_conv"]
    conv = d_inner + 2 * N
    out: List[Leaf] = [("embedding.embed", (V, d), d ** -0.5)]
    for u, kind in enumerate(kinds(config)):
        pre = f"layers.{u}.b0_{kind}."
        if kind == "mamba_moe":
            m = pre + "mamba."
            out += [
                (m + "norm.scale", (d,), None),
                (m + "in_proj.w", (d, 2 * d_inner + 2 * N + Hs), d ** -0.5),
                (m + "conv_w", (K, conv), K ** -0.5),
                (m + "conv_b", (conv,), K ** -0.5),
                (m + "A_log", (Hs,), 1.0),
                (m + "D_skip", (Hs,), None),
                (m + "dt_bias", (Hs,), 1.0),
                (m + "norm_out.scale", (d_inner,), None),
                (m + "out_proj.w", (d_inner, d), d_inner ** -0.5),
            ]
        else:
            out += [
                (pre + "ln1.scale", (d,), None),
                (pre + "attn.wq", (d, H * Dh), d ** -0.5),
                (pre + "attn.wk", (d, KV * Dh), d ** -0.5),
                (pre + "attn.wv", (d, KV * Dh), d ** -0.5),
                (pre + "attn.wo", (H * Dh, d), (H * Dh) ** -0.5),
            ]
        out += _moe_leaves(pre, p)
    out.append(("final_norm.scale", (d,), None))
    return out


def matmul_params(config: dict) -> float:
    """Parameters a token multiplies by: the projections of each mixer,
    the router, the shared expert and the routed experts at the share of
    the k routes that land on the experts held here (k·held/E), and the
    tied table as the output head (the input embedding is a gather; the
    depthwise conv no matrix)."""
    p = config["port"]
    moe = p["moe"]
    d, H, KV, Dh = p["d_model"], p["n_heads"], p["n_kv_heads"], p["d_head"]
    d_inner, Hs, _, N = sizes(config)
    mixer = {"mamba_moe": d * (2 * d_inner + 2 * N + Hs) + d_inner * d,
             "attn_moe": d * H * Dh + 2 * d * KV * Dh + H * Dh * d}
    routed = 3 * d * moe["d_ff_expert"] * moe["top_k"] * moe["experts_held"] / moe["num_experts"]
    ffn = d * moe["num_experts"] + 3 * d * moe["d_ff_shared"] + routed
    return sum(mixer[k] + ffn for k in kinds(config)) + p["vocab_size"] * d


def model_flops(config: dict, rows: int, seq_len: int) -> float:
    """FLOPs of one training step on ``rows`` x ``seq_len`` tokens, not
    counting recomputation: 6 per matmul parameter and token (forward 2,
    backward 4), causal attention's two products over the kept pairs
    (forward 2 x 2 x D a pair and head, backward twice that) in each
    attention layer, and each Mamba-2 layer's scan (:func:`ssd_work`, its
    backward twice its forward)."""
    p = config["port"]
    layers = kinds(config)
    attn = 12.0 * p["d_head"] * p["n_heads"] * flops.causal_pairs(seq_len, seq_len) * rows
    scan = 3.0 * ssd_work(config, seq_len)[0] * rows
    return (6.0 * matmul_params(config) * rows * seq_len
            + layers.count("attn_moe") * attn + layers.count("mamba_moe") * scan)
