"""Mixture-of-Experts layer (port of ``repro/models/moe.py``): top-k routing
with capacity, expert parallelism.

Two execution paths, as in the reference:

* **the mesh path** (``_moe_mesh``, the reference's ``_moe_shard_map``),
  taken when ``x`` is a DTensor on a ``DeviceMesh`` and the shapes fit:
  tokens are split over every mesh axis (batch over pod/data, sequence
  over model when the model axis divides it), each rank routes and packs
  its own (E, C_loc, D) buffer, ``C_loc = max(8, ceil(cf·T_loc·K/E))``,
  and when E divides the model axis one ``all_to_all`` pair over
  ``model`` moves the rows to their experts' owners and back
  (``all_to_all_single_autograd``: a ``_c10d_functional`` collective in
  the forward and in the backward, which ``analysis.census`` counts by
  axis).  Otherwise the experts are gathered whole onto every rank and
  the layer sends nothing (decode's S = 1 goes this way).  The local
  tensors join autograd through ``to_local``/``from_local``: the router's
  and the replicated experts' local gradients are partial sums over the
  axes that split the tokens, as the transpose of ``shard_map`` sums an
  unmapped input's cotangent over the axes it varies along.
  The reference decides from its ambient abstract mesh; the port from its
  input, so a trace on the fx carrier (a dict mesh, plain tensors) keeps
  the dense path with its three constraints, as the reference's jaxpr
  does.
* **the dense path** (no mesh, shapes that do not fit, the fx carrier):
  the reference's single-device math, bit for bit in its semantics.

The router runs in f32; ``top_k`` of the softmax, gates renormalized with a
1e-9 floor; capacity ``max(8, int(capacity_factor·T·K/E))``; each route's
position in its expert's queue is its rank among the earlier routes to the
same expert in token-major order, and routes over capacity are dropped.
Both paths dispatch through ``_dispatch``, which takes one of two routes by
the device of its input and returns the routes in a form whose
``combine`` brings the experts' rows back, so that no caller branches:

* a tensor on the card (plain, fake in a ``make_fx`` trace, a DTensor)
  runs the hand-written kernels of ``kernels/moe_dispatch.py``, custom ops
  that a trace records as one node each: the assignment is built once as
  a slot map in which a dropped route has no slot, and the pack, the
  combine and both backwards are gathers through it, each output row
  written once (no scan over a one-hot, no accumulating ``index_put``); a
  CUDA tensor the kernels refuse (dtype, E) raises;
* a tensor elsewhere (the CPU, the meta device) runs the plain version,
  ``_pack`` and ``_combine``, the reference's ops: the position from a
  cumsum over the token-major (T·K, E) one-hot, dropped routes clamped to
  slot C-1 with a zero source, and the dispatch ``.at[eid, pos_c].add`` as
  an accumulating ``index_put``.  Kept routes have distinct (expert,
  slot) pairs, so the only colliding adds are the exact zeros of dropped
  routes and the result does not depend on the order of the adds (nor
  does the gather's backward, whose dropped rows carry zero cotangents).

The expert FFN is three batched products (``torch.bmm``), as the reference
computes them with ``jnp.einsum`` outside any kernel.

**Held experts** (``MoEConfig.experts_held``, granite-4.0-h's cut to one
device's share of a layer): the layer holds the first ``held`` of the
``num_experts`` experts.  The router keeps its width, the top-k its
choices and the capacity its formula over all experts; a route to an
expert held elsewhere takes no slot (the slot map's kernel reads an id
outside ``[0, held)`` as no expert, the plain version masks it), so the
dispatch buffer is (held, cap, D) and the layer computes its own experts'
part of the result; what the others would add is left out, with no
exchange.  **A shared expert** (``MoEConfig.d_ff_shared``): a SwiGLU every
token passes through, added to the routed result.

The dense path pins the dispatch buffer and the experts' output to
``("experts", "expert_cap", None)`` and its output to ``("batch", None,
"model")`` (``parallel.sharding.shard``: nodes of a model-axis trace,
redistributions on DTensors, the identity elsewhere).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import moe_dispatch as md
from repro_torch.parallel import sharding as sh
from .layers import init_normal, swiglu


def moe_init(d_model: int, cfg: MoEConfig, *, device=None,
             generator: Optional[torch.Generator] = None) -> Dict:
    """The reference's param tree: ``router`` (D, E) and ``experts``
    ``w_gate``/``w_up`` (E, D, F), ``w_down`` (E, F, D), all f32; with
    held experts, ``experts`` holds ``held`` of the router's E; with a
    shared expert, ``shared`` ``w_gate``/``w_up`` (D, F_s), ``w_down``
    (F_s, D)."""
    E, Fd = cfg.num_experts, cfg.d_ff_expert
    kw = dict(device=device, generator=generator)
    scale_in = d_model**-0.5
    tree = {
        "router": init_normal((d_model, E), scale_in, **kw),
        "experts": {
            "w_gate": init_normal((cfg.held, d_model, Fd), scale_in, **kw),
            "w_up": init_normal((cfg.held, d_model, Fd), scale_in, **kw),
            "w_down": init_normal((cfg.held, Fd, d_model), Fd**-0.5, **kw),
        },
    }
    if cfg.d_ff_shared:
        Fs = cfg.d_ff_shared
        tree["shared"] = {
            "w_gate": init_normal((d_model, Fs), scale_in, **kw),
            "w_up": init_normal((d_model, Fs), scale_in, **kw),
            "w_down": init_normal((Fs, d_model), Fs**-0.5, **kw),
        }
    return tree


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


def _pack(xt: torch.Tensor, expert_ids: torch.Tensor, E: int, cap: int,
          absent: bool = False
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter tokens into an (E, C, D) buffer; returns (disp, eid, pos_c, keep).
    ``absent``: ids from E up name experts held elsewhere, whose routes
    are not kept (their expert clamped to E-1 with a zero source)."""
    T, D = xt.shape
    K = expert_ids.shape[-1]
    flat_onehot = _one_hot(expert_ids, E).reshape(T * K, E)
    pos_in_expert = torch.cumsum(flat_onehot, dim=0) - flat_onehot
    pos = (pos_in_expert * flat_onehot).sum(dim=-1)  # (T·K,)
    eid = expert_ids.reshape(T * K)
    keep = pos < cap
    if absent:
        keep = keep & (eid < E)
        eid = eid.clamp(max=E - 1)
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


class PlainRoutes(NamedTuple):
    """The plain version's routes: expert, clamped slot and kept mask of
    each of the T·K routes (``_pack``'s last three values)."""

    eid: torch.Tensor
    pos_c: torch.Tensor
    keep: torch.Tensor

    def kept(self) -> torch.Tensor:
        return self.keep.sum()

    def kept_mask(self) -> torch.Tensor:
        return self.keep

    def combine(self, out_e: torch.Tensor, gate_vals: torch.Tensor) -> torch.Tensor:
        T, K = gate_vals.shape
        return _combine(out_e, *self, gate_vals, T, K)


def _dispatch(xt: torch.Tensor, expert_ids: torch.Tensor, E: int, cap: int,
              absent: bool = False):
    """Pack ``xt`` (T, D) into the (E, cap, D) buffer on the route its
    device takes: (disp, routes), ``routes`` a ``moe_dispatch.SlotMap`` on
    the card, else ``PlainRoutes``; either one's ``combine(out_e, gates)``
    gives (T, D), ``kept()`` the kept routes and ``kept_mask()`` which.
    ``absent``: ids from E up (experts held elsewhere) take no slot, which
    the slot map's kernel does for any id outside [0, E)."""
    if md.kernel_route(xt):
        obs.count("moe.kernel_route", 1)
        sm = md.slot_map(expert_ids.contiguous(), E, cap)
        return md.pack(xt.contiguous(), sm), sm
    disp, eid, pos_c, keep = _pack(xt, expert_ids, E, cap, absent)
    return disp, PlainRoutes(eid, pos_c, keep)


def _local(w: torch.Tensor, mesh, spec: sh.Spec, grad_placements) -> torch.Tensor:
    """``w`` laid out on ``mesh`` in ``spec``, as this rank's local tensor
    whose gradient DTensor reads in ``grad_placements``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return sh.place(w, mesh, spec).to_local(grad_placements=grad_placements)


def _all_to_all(t: torch.Tensor, mesh) -> torch.Tensor:
    """Split ``t``'s dim 0 into as many chunks as the model axis has ranks,
    send chunk j to model rank j, stack what arrives along dim 0 in
    source order (autograd: the same exchange of the cotangent)."""
    import torch.distributed._functional_collectives as funcol

    group = (mesh, mesh.mesh_dim_names.index("model"))
    return funcol.all_to_all_single_autograd(t.contiguous(), None, None, group)


def _moe_mesh(p: Dict, x: torch.Tensor, cfg: MoEConfig) -> Optional[torch.Tensor]:
    """Expert-parallel MoE on ``x``'s mesh (the reference's
    ``_moe_shard_map``); None where the mesh or the shapes do not fit."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if cfg.held != cfg.num_experts:
        return None
    mesh = x.device_mesh
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    sizes = sh.axis_sizes_of(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    tp = sizes.get("model", 1)
    dp = math.prod(sizes[a] for a in dp_axes)
    if (dp == 1 and tp == 1) or B % dp:
        return None
    seq_split = tp if (tp > 1 and S % tp == 0) else 1
    ep = tp > 1 and E % tp == 0 and seq_split == tp  # the all_to_all layout
    T_loc = (B // dp) * (S // seq_split)
    C_loc = max(8, int(math.ceil(cfg.capacity_factor * T_loc * K / E)))

    x_spec = (dp_axes or None, "model" if seq_split > 1 else None, None)
    xd = sh.place(x, mesh, x_spec)
    x_loc = xd.to_local()
    # a weight's local gradient sums over the tokens of this rank's shard:
    # a partial sum over the axes that split the tokens, whole over the
    # others (an axis the tokens are replicated over computes it alike)
    split = set(dp_axes) | ({"model"} if seq_split > 1 else set())
    partial = [Partial() if n in split else Replicate() for n in mesh.mesh_dim_names]
    router = _local(p["router"], mesh, (), partial)
    e_spec = ("model", None, None) if ep else ()
    e_grads = [Shard(0) if ep and n == "model" else g
               for n, g in zip(mesh.mesh_dim_names, partial)]
    experts = {k: _local(w, mesh, e_spec, e_grads) for k, w in p["experts"].items()}

    b, s, _ = x_loc.shape
    xt = x_loc.reshape(b * s, D)
    with obs.span("moe.route"):
        gate_vals, expert_ids, _, _ = _route(router, xt, cfg)
    with obs.span("moe.pack"):
        disp, routes = _dispatch(xt, expert_ids, E, C_loc)
    _count(b * s * K, E * C_loc, routes)
    with obs.span("moe.experts"):
        if ep:
            # (E, C_loc, D) → (E/tp, tp·C_loc, D): each rank's rows travel to
            # their experts' owner, concatenated along capacity in rank order
            el = E // tp
            disp = _all_to_all(disp, mesh).reshape(tp, el, C_loc, D).transpose(0, 1)
            out = _expert_ffn(experts, disp.reshape(el, tp * C_loc, D))
            out = out.reshape(el, tp, C_loc, D).transpose(0, 1)
            out = _all_to_all(out, mesh).reshape(E, C_loc, D)
        else:
            out = _expert_ffn(experts, disp)
    with obs.span("moe.combine"):
        y = routes.combine(out, gate_vals).reshape(b, s, D)
    return DTensor.from_local(y, mesh, xd.placements, run_check=False)


def _count(n_routes: int, slots: int, routes) -> None:
    """The dispatch's counters (while recording): routes (T·K), expert
    slots (E·capacity) and kept routes, a device sum (on the card of
    ``min(counts[e], cap)``)."""
    if obs.enabled():
        obs.count("moe.routes", n_routes)
        obs.count("moe.slots", slots)
        obs.count_device("moe.kept", routes.kept())


def _shared(p: Dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The routed result ``y`` plus the shared expert's of ``x``, if the
    layer has one."""
    if "shared" not in p:
        return y
    with obs.span("moe.shared"):
        w = p["shared"]
        return y + swiglu(w["w_gate"], w["w_up"], w["w_down"], x)


def moe_apply(p: Dict, x: torch.Tensor, cfg: MoEConfig, return_aux: bool = False):
    """x (B, S, D) → (B, S, D)[, {"lb_loss", "z_loss"}]."""
    from torch.distributed.tensor import DTensor

    if not return_aux and isinstance(x, DTensor):
        y = _moe_mesh(p, x, cfg)
        if y is not None:
            return _shared(p, x, y)
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    held = cfg.held
    T = B * S
    xt = x.reshape(T, D)
    cap = capacity(cfg, T)
    with obs.span("moe.route"):
        gate_vals, expert_ids, logits, probs = _route(p["router"], xt, cfg)
    with obs.span("moe.pack"):
        disp, routes = _dispatch(xt, expert_ids, held, cap, absent=held < E)
        # experts over the model axis, or (where E does not divide it) the
        # capacity rows: an unsharded dispatch buffer is large at scale
        disp = sh.shard(disp, "experts", "expert_cap", None)
    _count(T * K, held * cap, routes)
    if held < E and obs.enabled():
        obs.count_device("moe.absent", (expert_ids >= held).sum())
    with obs.span("moe.experts"):
        out_e = sh.shard(_expert_ffn(p["experts"], disp), "experts", "expert_cap", None)
    with obs.span("moe.combine"):
        y = routes.combine(out_e, gate_vals).reshape(B, S, D)
        y = sh.shard(y, "batch", None, "model")
    y = _shared(p, x, y)
    if not return_aux:
        return y
    # Switch-style load-balance loss + router z-loss
    density = probs.mean(dim=0)
    usage = _one_hot(expert_ids[:, 0], E).float().mean(dim=0)
    lb_loss = E * (density * usage).sum()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    return y, {"lb_loss": lb_loss, "z_loss": z_loss}
