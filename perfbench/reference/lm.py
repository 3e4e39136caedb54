"""The model module ``lm`` (the default of a configuration without
``"model"``): a decoder-only language model of pre-norm layers, each
attention with rotary positions and a SwiGLU MLP or a top-k mixture of
experts with capacity, and its next-token loss, as the port's ``LM`` runs
``configs/<config>.json`` (``port``, ``moe``, ``departures``).

It gives the three things a model module gives (see
``perfbench/reference/__init__.py``): :func:`leaves`, :func:`row_loss` and
:func:`model_flops`.  The loss is computed in blocks: each layer under a
checkpoint (its interior is made again in the backward pass), attention a
block of 1,024 queries at a time over the keys the causal mask keeps, the
loss 2,048 positions at a time.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import flops
from perfbench.weights import Leaf

Q_BLOCK = 1024
LOSS_BLOCK = 2048


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


# ----------------------------------------------------------- leaves, FLOPs


def leaves(config: dict) -> List[Leaf]:
    """Every parameter, named as the port's ``LM`` names it: matrices
    N(0, 1/fan_in) (fan_in: the dimension a product contracts), the
    embedding N(0, 1), norm scales ones; a table tied to the output head is
    the head's matrix too and draws N(0, 1/d_model)."""
    p, moe = config["port"], config.get("moe")
    V, d, H, KV, Dh = p["vocab_size"], p["d_model"], p["n_heads"], p["n_kv_heads"], p["d_head"]
    out: List[Leaf] = [("embedding.embed", (V, d), d ** -0.5 if p["tie_embeddings"] else 1.0)]
    for u in range(p["n_layers"]):
        pre = f"layers.{u}.b0_attn_moe." if moe else f"layers.{u}.b0_attn_mlp."
        out += [
            (pre + "ln1.scale", (d,), None),
            (pre + "attn.wq", (d, H * Dh), d ** -0.5),
            (pre + "attn.wk", (d, KV * Dh), d ** -0.5),
            (pre + "attn.wv", (d, KV * Dh), d ** -0.5),
            (pre + "attn.wo", (H * Dh, d), (H * Dh) ** -0.5),
            (pre + "ln2.scale", (d,), None),
        ]
        if moe:
            E, ff = moe["num_experts"], moe["d_ff_expert"]
            out += [
                (pre + "moe.router", (d, E), d ** -0.5),
                (pre + "moe.experts.w_gate", (E, d, ff), d ** -0.5),
                (pre + "moe.experts.w_up", (E, d, ff), d ** -0.5),
                (pre + "moe.experts.w_down", (E, ff, d), ff ** -0.5),
            ]
        else:
            ff = p["d_ff"]
            out += [
                (pre + "mlp.w_gate", (d, ff), d ** -0.5),
                (pre + "mlp.w_up", (d, ff), d ** -0.5),
                (pre + "mlp.w_down", (ff, d), ff ** -0.5),
            ]
    out.append(("final_norm.scale", (d,), None))
    if not p["tie_embeddings"]:
        out.append(("head.unembed", (V, d), d ** -0.5))
    return out


def matmul_params(config: dict) -> int:
    """Parameters a token multiplies by: all but the input embedding, which
    is a gather (a tied table still multiplies as the output head); of the
    experts only ``top_k`` of ``num_experts``."""
    p, moe = config["port"], config.get("moe")
    d, L, V = p["d_model"], p["n_layers"], p["vocab_size"]
    H, KV, Dh = p["n_heads"], p["n_kv_heads"], p["d_head"]
    attn = d * H * Dh + 2 * d * KV * Dh + H * Dh * d
    if moe:
        ffn = d * moe["num_experts"] + moe["top_k"] * 3 * d * moe["d_ff_expert"]
    else:
        ffn = 3 * d * p["d_ff"]
    return L * (attn + ffn) + V * d


def model_flops(config: dict, rows: int, seq_len: int) -> float:
    """FLOPs of one training step on ``rows`` x ``seq_len`` tokens, not
    counting recomputation: 6 per matmul parameter and token (forward 2,
    backward 4), and causal attention's two products over the kept pairs
    (forward 2 x 2 x D a pair and head, backward twice that)."""
    p = config["port"]
    tokens = rows * seq_len
    attn = 12.0 * p["d_head"] * p["n_heads"] * flops.causal_pairs(seq_len, seq_len) * rows
    return 6.0 * matmul_params(config) * tokens + p["n_layers"] * attn
