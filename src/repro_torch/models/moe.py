"""Mixture-of-Experts layer (port of ``repro/models/moe.py``): top-k routing
with capacity, on one device.

The reference's single-device path, bit for bit in its semantics: the
router runs in f32; ``top_k`` of the softmax, gates renormalized with a
1e-9 floor; capacity ``max(8, int(capacity_factor·T·K/E))``; each route's
position in its expert's queue from a cumsum over the token-major (T·K, E)
one-hot; routes over capacity are dropped, clamped to slot C-1 with a zero
source.  The dispatch ``.at[eid, pos_c].add`` is an accumulating
``index_put``: kept routes have distinct (expert, slot) pairs, so the only
colliding adds are the exact zeros of dropped routes and the result does
not depend on the order of the adds (nor does the gather's backward, whose
dropped rows carry zero cotangents).  The expert FFN is three batched
products (``torch.bmm``), as the reference computes them with
``jnp.einsum`` outside any kernel.

The reference's expert-parallel ``shard_map`` path needs a mesh; it waits
for ROADMAP.md module queue, item 'Multi-device'.  Like the reference
without a mesh, this module never takes it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from .layers import init_normal


def moe_init(d_model: int, cfg: MoEConfig, *, device=None,
             generator: Optional[torch.Generator] = None) -> Dict:
    """The reference's param tree: ``router`` (D, E) and ``experts``
    ``w_gate``/``w_up`` (E, D, F), ``w_down`` (E, F, D), all f32."""
    E, Fd = cfg.num_experts, cfg.d_ff_expert
    kw = dict(device=device, generator=generator)
    scale_in = d_model**-0.5
    return {
        "router": init_normal((d_model, E), scale_in, **kw),
        "experts": {
            "w_gate": init_normal((E, d_model, Fd), scale_in, **kw),
            "w_up": init_normal((E, d_model, Fd), scale_in, **kw),
            "w_down": init_normal((E, Fd, d_model), Fd**-0.5, **kw),
        },
    }


def capacity(cfg: MoEConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens (the reference's formula)."""
    return max(8, int(cfg.capacity_factor * tokens * cfg.top_k / cfg.num_experts))


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Integer one-hot over a new last axis.  ``F.one_hot`` checks its ids'
    range on the host, a device sync on every call; this compare is what
    it decomposes to when traced."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).long()


def _route(router_w: torch.Tensor, xt: torch.Tensor, cfg: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, D) → gates (T, K) f32, expert ids (T, K), logits and probs (T, E) f32."""
    logits = xt.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return gate_vals, expert_ids, logits, probs


def _pack(xt: torch.Tensor, expert_ids: torch.Tensor, E: int, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter tokens into an (E, C, D) buffer; returns (disp, eid, pos_c, keep)."""
    T, D = xt.shape
    K = expert_ids.shape[-1]
    flat_onehot = _one_hot(expert_ids, E).reshape(T * K, E)
    pos_in_expert = torch.cumsum(flat_onehot, dim=0) - flat_onehot
    pos = (pos_in_expert * flat_onehot).sum(dim=-1)  # (T·K,)
    eid = expert_ids.reshape(T * K)
    keep = pos < cap
    src = torch.where(keep[:, None], xt.repeat_interleave(K, dim=0), 0)
    pos_c = pos.clamp(max=cap - 1)
    disp = xt.new_zeros((E, cap, D)).index_put((eid, pos_c), src, accumulate=True)
    return disp, eid, pos_c, keep


def _expert_ffn(w: Dict[str, torch.Tensor], disp: torch.Tensor) -> torch.Tensor:
    dt = disp.dtype
    g = torch.bmm(disp, w["w_gate"].to(dt))
    u = torch.bmm(disp, w["w_up"].to(dt))
    h = F.silu(g.float()).to(dt) * u
    return torch.bmm(h, w["w_down"].to(dt))


def _combine(out_e: torch.Tensor, eid: torch.Tensor, pos_c: torch.Tensor,
             keep: torch.Tensor, gate_vals: torch.Tensor, T: int, K: int) -> torch.Tensor:
    D = out_e.shape[-1]
    gathered = torch.where(keep[:, None], out_e[eid, pos_c], 0)
    weights = gate_vals.reshape(T * K).to(out_e.dtype)
    return (gathered * weights[:, None]).reshape(T, K, D).sum(dim=1)


def moe_apply(p: Dict, x: torch.Tensor, cfg: MoEConfig, return_aux: bool = False):
    """x (B, S, D) → (B, S, D)[, {"lb_loss", "z_loss"}]."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    gate_vals, expert_ids, logits, probs = _route(p["router"], xt, cfg)
    disp, eid, pos_c, keep = _pack(xt, expert_ids, E, capacity(cfg, T))
    out_e = _expert_ffn(p["experts"], disp)
    y = _combine(out_e, eid, pos_c, keep, gate_vals, T, K).reshape(B, S, D)
    if not return_aux:
        return y
    # Switch-style load-balance loss + router z-loss
    density = probs.mean(dim=0)
    usage = _one_hot(expert_ids[:, 0], E).float().mean(dim=0)
    lb_loss = E * (density * usage).sum()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    return y, {"lb_loss": lb_loss, "z_loss": z_loss}
