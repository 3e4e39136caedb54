"""State-space blocks (port of ``repro/models/ssm.py``): Mamba2 and xLSTM.

Training runs the *chunked* SSD formulation, quadratic only within a chunk
and recurrent across chunks; decode runs one step of the recurrence on an
O(1) state.  As in the reference, zamba2's depthwise conv applies to the
x-branch only; with ``SSMConfig.conv_bc`` (granite-4.0-h, as Mamba-2
itself) it runs over x, B and C with a bias, before the SiLU (training
only: such a block has no decode step here).  The reference scans the
chunks one at a time under ``jax.checkpoint``; here the scan takes
``GROUP`` chunks a step, their intra-chunk products batched and the state
carried through them in order, each group under a non-reentrant
``torch.utils.checkpoint``, so the backward recomputes a group's f32
(B, H, Q, Q) decay and score blocks instead of keeping them for every
chunk.  While the fx carrier traces, the checkpoint is left out
(``layers.checkpointed``): the traced graph holds each group's ops, and
the plan decides what they recompute (ROADMAP.md §3).

The xLSTM blocks: mLSTM runs the same chunked SSD with N = P = d_head;
sLSTM's elementwise recurrence runs as a doubling scan (``linear_scan``),
eager torch having no ``associative_scan``.

The reference's sharding constraints (``parallel.sharding.shard``: nodes
of a model-axis trace, redistributions on DTensors, the identity
elsewhere): Mamba2's x-branch over ``ffn`` after its conv, so the SSD scan
runs on H/tp heads (the fused in-projection, whose name the rules see as
``w``, stays replicated, as in the reference); mLSTM's q, k and v over
``heads``; each block's output made whole over ``model``.  Before a
block's input projection the sequence-parallel residual is gathered
(``layers.gather_sequence``), as the attention and MLP blocks do.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import obs
from repro_torch.configs.base import SSMConfig
from repro_torch.parallel.sharding import shard
from .attention import merge_heads, split_heads
from .layers import checkpointed, gather_sequence, init_normal, rmsnorm


# ---------------------------------------------------------------------------
# Chunked SSD core: h_t = a_t·h_{t-1} + b_t ⊗ x_t
# ---------------------------------------------------------------------------


def _segsum(a_log: torch.Tensor) -> torch.Tensor:
    """(…, Q) → (…, Q, Q) lower-triangular decay: out[i,j] = Σ_{k=j+1..i} a."""
    Q = a_log.shape[-1]
    cs = torch.cumsum(a_log, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=a_log.device).tril()
    return torch.where(mask, diff, -math.inf)


#: chunks one step of the scan computes together, under one checkpoint.
#: A chunk at a time launches some 320 small ops a chunk (its forward, its
#: re-run and its backward), which at granite-4.0-h's 16k tokens and 128
#: heads left an H100 idle three quarters of a step and the step's time
#: 13-20 % apart between runs; a group of 16 launches some 28 a chunk,
#: and its f32 (B, H, Q, Q) decay and score blocks, recomputed in the
#: backward, are 16 chunks' worth (0.5 GiB each at 128 heads of 256).
GROUP = 16


def _segsum_stable(z: torch.Tensor) -> torch.Tensor:
    """(…, T) → (…, T, T): out[i,j] = Σ_{k=j+1..i} z_k for j ≤ i, -inf above,
    each a sum of the terms themselves (no difference of two running sums,
    which loses the small decays between chunks after a large one)."""
    T = z.shape[-1]
    below = torch.ones(T, T, dtype=torch.bool, device=z.device).tril(-1)
    sums = torch.cumsum(z[..., :, None].expand(*z.shape, T).masked_fill(~below, 0), dim=-2)
    return sums.masked_fill(~torch.ones_like(below).tril(), -math.inf)


def _ssd_group(h: torch.Tensor, xg: torch.Tensor, ag: torch.Tensor, Bg: torch.Tensor,
               Cg: torch.Tensor, Q: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """G consecutive chunks of Q: state (B,H,P,N) f32, x (B,G·Q,H,P), a
    (B,G·Q,H) f32, B/C (B,G·Q,H,N) → (the state after the last chunk, y
    (B,G·Q,H,P) in x's dtype).  Each chunk's outputs and own state in ops
    batched over the chunks; the state carried into each chunk by one
    product over the chunks' decays, as the SSD's chunked form passes
    states.  Counts ``ssm.chunks`` while recording: forwards and re-runs
    alike."""
    Bs, S, H, P = xg.shape
    G, N = S // Q, Bg.shape[-1]
    obs.count("ssm.chunks", G)
    x = xg.reshape(Bs, G, Q, H, P).float()
    Bc, Cc = Bg.reshape(Bs, G, Q, H, N), Cg.reshape(Bs, G, Q, H, N)
    a_cum = torch.cumsum(ag.reshape(Bs, G, Q, H), dim=2)  # (B,G,Q,H)
    # intra-chunk (flash-style blockwise "attention" with decay)
    L = torch.exp(_segsum(ag.reshape(Bs, G, Q, H).transpose(2, 3)))  # (B,G,H,Q,Q)
    scores = torch.einsum("bgqhn,bgshn->bghqs", Cc, Bc).float()
    y = torch.einsum("bghqs,bghqs,bgshp->bgqhp", scores, L, x)
    # each chunk's own state, then the state carried into each chunk: the
    # incoming state and the earlier chunks' own, each decayed over the
    # chunks between (one product, no loop over the chunks)
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (B,G,Q,H)
    own = torch.einsum("bgqhn,bgqh,bgqhp->bghpn", Bc.float(), decay_to_end, x)
    states = torch.cat([h[:, None], own], dim=1)  # (B,G+1,H,P,N)
    totals = F.pad(a_cum[:, :, -1, :].transpose(1, 2), (1, 0))  # (B,H,G+1): 0, then each chunk's
    carried = torch.einsum("bhzc,bchpn->bzhpn", torch.exp(_segsum_stable(totals)), states)
    y = y + torch.einsum("bgqhn,bghpn,bgqh->bgqhp", Cc.float(), carried[:, :-1],
                         torch.exp(a_cum))
    return carried[:, -1], y.reshape(Bs, S, H, P).to(xg.dtype)


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P) dt-scaled inputs
    a_log: torch.Tensor,  # (B, S, H) log decay per step (≤ 0)
    Bm: torch.Tensor,  # (B, S, H, N)
    Cm: torch.Tensor,  # (B, S, H, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P), final state (B,H,P,N) f32), under the span
    ``ssm.scan``.

    On DTensors split over the batch and the heads the scan runs on each
    rank's local rows and heads (:func:`_ssd_local`): every (row, head)
    recurs on its own."""
    if h0 is None and any(isinstance(t, DTensor) for t in (x, a_log, Bm, Cm)):
        out = _ssd_local(x, a_log, Bm, Cm, chunk)
        if out is not None:
            return out
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")
    with obs.span("ssm.scan"):
        h = h0 if h0 is not None else x.new_zeros((B, H, P, N), dtype=torch.float32)
        ys = []
        # one split a tensor, whose backward concatenates the groups'
        # gradients once; a slice a group would each scatter into a zero
        # tensor of the whole input's size, all of them summed
        parts = (t.split(GROUP * Q, dim=1) for t in (x, a_log.float(), Bm, Cm))
        for xg, ag, Bg, Cg in zip(*parts):
            h, y = checkpointed(_ssd_group, h, xg, ag, Bg, Cg, Q)
            ys.append(y)
        return torch.cat(ys, dim=1), h


def _ssd_local(x, a_log, Bm, Cm, chunk: int):
    """``ssd_chunked`` on each rank's shard: every input laid out with the
    batch and the heads as the most split of them splits them (a
    replicated input is sliced, no collective), the scan run on the local
    tensors, y and the final state returned as DTensors in that layout.
    None when an input is split along its sequence or last dim, or holds
    partial sums: the scan then runs on the DTensors themselves."""
    mesh = next(t.device_mesh for t in (x, a_log, Bm, Cm) if isinstance(t, DTensor))
    want = []
    for i in range(mesh.ndim):
        dims = set()
        for t in (x, a_log, Bm, Cm):
            if not isinstance(t, DTensor):
                continue
            pl = t.placements[i]
            if isinstance(pl, Shard) and pl.dim in (0, 2):
                dims.add(pl.dim)
            elif not pl.is_replicate():
                return None
        if len(dims) > 1:
            return None
        want.append(Shard(dims.pop()) if dims else Replicate())

    def local(t):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, want).to_local()

    y, h = ssd_chunked(*(local(t) for t in (x, a_log, Bm, Cm)), chunk)
    h_pl = [Shard(1) if isinstance(pl, Shard) and pl.dim == 2 else pl for pl in want]
    return (DTensor.from_local(y, mesh, want, run_check=False),
            DTensor.from_local(h, mesh, h_pl, run_check=False))


def ssd_step(
    x: torch.Tensor,  # (B, H, P)
    a_log: torch.Tensor,  # (B, H)
    Bm: torch.Tensor,  # (B, H, N)
    Cm: torch.Tensor,  # (B, H, N)
    h: torch.Tensor,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step of the SSD recurrence."""
    a = torch.exp(a_log.float())[..., None, None]
    h = h * a + torch.einsum("bhp,bhn->bhpn", x.float(), Bm.float())
    y = torch.einsum("bhpn,bhn->bhp", h, Cm.float())
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def mamba2_sizes(d_model: int, cfg: SSMConfig, head_p: int = 64) -> Tuple[int, int, int]:
    d_inner = cfg.expand * d_model
    H = max(1, d_inner // head_p)
    P = d_inner // H
    return d_inner, H, P


def mamba2_init(d_model: int, cfg: SSMConfig, *, device=None,
                generator: Optional[torch.Generator] = None) -> Dict:
    """The reference's param tree, f32; with ``conv_bc`` the conv's weights
    (K, d_inner + 2N) and its bias ``conv_b`` over x, B and C."""
    d_inner, H, P = mamba2_sizes(d_model, cfg)
    N = cfg.d_state
    kw = dict(device=device, generator=generator)
    proj_out = 2 * d_inner + 2 * N + H  # z, x, B, C, dt
    conv = d_inner + 2 * N if cfg.conv_bc else d_inner
    tree = {
        "norm": {"scale": torch.ones(d_model, device=device)},
        "in_proj": {"w": init_normal((d_model, proj_out), d_model**-0.5, **kw)},
        "conv_w": init_normal((cfg.d_conv, conv), 0.5, **kw),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)),  # A = -exp(A_log)
        "D_skip": torch.ones(H, device=device),
        "dt_bias": torch.zeros(H, device=device),
        "norm_out": {"scale": torch.ones(d_inner, device=device)},
        "out_proj": {"w": init_normal((d_inner, d_model), d_inner**-0.5, **kw)},
    }
    if cfg.conv_bc:
        tree["conv_b"] = torch.zeros(conv, device=device)
    return tree


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, N: int, H: int):
    return torch.split(zxbcdt, [d_inner, d_inner, N, N, H], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x (B,S,C), w (K,C).  On a DTensor whose
    sequence is whole, on each rank's rows and channels (``_conv_local``)."""
    if isinstance(x, DTensor):
        out = _conv_local(x, w)
        if out is not None:
            return out
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = pad[:, :S, :] * w[0][None, None, :]
    for i in range(1, K):
        out = out + pad[:, i:i + S, :] * w[i][None, None, :]
    return out


def _conv_local(x: DTensor, w: torch.Tensor) -> Optional[DTensor]:
    """The conv on this rank's rows and channels of ``x``, ``w`` sliced to
    those channels; None when the sequence is split or ``x`` holds partial
    sums.  ``w``'s local gradient sums this rank's rows: a partial sum over
    the axes that split the rows, whole over the others."""
    mesh, pl = x.device_mesh, list(x.placements)
    if not all(p.is_replicate() or (isinstance(p, Shard) and p.dim in (0, 2)) for p in pl):
        return None
    w_pl = [Shard(1) if isinstance(p, Shard) and p.dim == 2 else Replicate() for p in pl]
    w_grad = [Partial() if isinstance(p, Shard) and p.dim == 0 else q
              for p, q in zip(pl, w_pl)]
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, mesh, [Replicate()] * mesh.ndim, run_check=False)
    w_loc = w.redistribute(mesh, w_pl).to_local(grad_placements=w_grad)
    return DTensor.from_local(_causal_conv(x.to_local(), w_loc), mesh, pl, run_check=False)


def _ssd_inputs(p: Dict, dt: torch.Tensor, xs: torch.Tensor, H: int, P: int):
    """dt-scaled x, the log decay and dt_soft from the projection's dt."""
    dt_soft = F.softplus(dt.float() + p["dt_bias"])  # (…, H)
    a_log = dt_soft * -torch.exp(p["A_log"])  # ≤ 0
    xh = xs.reshape(*xs.shape[:-1], H, P) * dt_soft[..., None].to(xs.dtype)
    return xh, a_log


def mamba2_apply(p: Dict, x: torch.Tensor, cfg: SSMConfig,
                 residual: float = 1.0) -> torch.Tensor:
    """Full-sequence forward.  x (B,S,D) → x + residual·mixer(x), (B,S,D)."""
    B, S, D = x.shape
    dt_ = x.dtype
    d_inner, H, P = mamba2_sizes(D, cfg)
    N = cfg.d_state
    h = gather_sequence(rmsnorm(p["norm"]["scale"], x))
    with obs.span("ssm.proj"):
        zxbcdt = h @ p["in_proj"]["w"].to(dt_)
    if cfg.conv_bc:
        z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H], dim=-1)
        with obs.span("ssm.conv"):
            xbc = _causal_conv(xbc, p["conv_w"].to(dt_)) + p["conv_b"].to(dt_)
            xbc = F.silu(xbc.float()).to(dt_)
        xs, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
        xs = shard(xs, "batch", None, "ffn")
    else:
        z, xs, Bm, Cm, dt = _split_proj(zxbcdt, d_inner, N, H)
        xs = _causal_conv(xs, p["conv_w"].to(dt_))
        xs = shard(F.silu(xs.float()).to(dt_), "batch", None, "ffn")  # the scan on H/tp heads
    xh, a_log = _ssd_inputs(p, dt, xs, H, P)
    Bh = Bm[:, :, None, :].expand(B, S, H, N)
    Ch = Cm[:, :, None, :].expand(B, S, H, N)
    y, _ = ssd_chunked(xh, a_log, Bh, Ch, cfg.chunk)
    y = y + xs.reshape(B, S, H, P) * p["D_skip"][None, None, :, None].to(dt_)
    y = y.reshape(B, S, d_inner) * F.silu(z.float()).to(dt_)
    y = rmsnorm(p["norm_out"]["scale"], y)
    with obs.span("ssm.proj"):
        out = shard(y @ p["out_proj"]["w"].to(dt_), "batch", None, "model")
    return x + (out if residual == 1.0 else out * residual)


def mamba2_init_state(batch: int, d_model: int, cfg: SSMConfig,
                      dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    d_inner, H, P = mamba2_sizes(d_model, cfg)
    return {
        "ssm": torch.zeros((batch, H, P, cfg.d_state), dtype=torch.float32),
        "conv": torch.zeros((batch, cfg.d_conv - 1, d_inner), dtype=dtype),
    }


def mamba2_step(p: Dict, x: torch.Tensor, state: Dict[str, torch.Tensor], cfg: SSMConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step.  x (B,1,D) → (B,1,D), new state."""
    B, _, D = x.shape
    dt_ = x.dtype
    d_inner, H, P = mamba2_sizes(D, cfg)
    N = cfg.d_state
    h = rmsnorm(p["norm"]["scale"], x)
    z, xs, Bm, Cm, dt = _split_proj((h @ p["in_proj"]["w"].to(dt_))[:, 0], d_inner, N, H)

    conv_buf = torch.cat([state["conv"], xs[:, None, :]], dim=1)
    xs = torch.einsum("bkc,kc->bc", conv_buf, p["conv_w"].to(dt_))
    xs = F.silu(xs.float()).to(dt_)

    xh, a_log = _ssd_inputs(p, dt, xs, H, P)
    Bh = Bm[:, None, :].expand(B, H, N)
    Ch = Cm[:, None, :].expand(B, H, N)
    y, new_ssm = ssd_step(xh, a_log, Bh, Ch, state["ssm"])
    y = y + xs.reshape(B, H, P) * p["D_skip"][None, :, None].to(dt_)
    y = y.reshape(B, d_inner) * F.silu(z.float()).to(dt_)
    y = rmsnorm(p["norm_out"]["scale"], y)
    out = y @ p["out_proj"]["w"].to(dt_)
    return x + out[:, None, :], {"ssm": new_ssm, "conv": conv_buf[:, 1:, :]}


# ---------------------------------------------------------------------------
# xLSTM — mLSTM (matrix memory) and sLSTM (scalar memory) blocks
# ---------------------------------------------------------------------------


def mlstm_init(d_model: int, n_heads: int, *, device=None,
               generator: Optional[torch.Generator] = None) -> Dict:
    """The reference's param tree, f32."""
    s = d_model**-0.5
    kw = dict(device=device, generator=generator)
    return {
        "norm": {"scale": torch.ones(d_model, device=device)},
        "wq": init_normal((d_model, d_model), s, **kw),
        "wk": init_normal((d_model, d_model), s, **kw),
        "wv": init_normal((d_model, d_model), s, **kw),
        "w_gates": init_normal((d_model, 2 * n_heads), s, **kw),
        "wo": init_normal((d_model, d_model), s, **kw),
        "out_norm": {"scale": torch.ones(d_model, device=device)},
    }


def _mlstm_gates(p: Dict, h: torch.Tensor, H: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Input gate and log forget gate, f32, from the normed input."""
    gates = (h @ p["w_gates"].to(h.dtype)).float()
    i_gate = torch.sigmoid(gates[..., :H])
    f_gate = torch.sigmoid(gates[..., H:] + 2.0)
    return i_gate, torch.log(f_gate + 1e-9)


def mlstm_apply(p: Dict, x: torch.Tensor, n_heads: int, chunk: int) -> torch.Tensor:
    """mLSTM layer: C_t = f_t·C_{t-1} + i_t·v_t k_tᵀ ;  y_t = C_t q_t / nrm.

    The same chunked recurrence as SSD with N = P = d_head; the normalizer
    runs as a second recurrence with P = 1.
    """
    B, S, D = x.shape
    dt_ = x.dtype
    H = n_heads
    Dh = D // H
    h = gather_sequence(rmsnorm(p["norm"]["scale"], x))
    q = shard(split_heads(h @ p["wq"].to(dt_), H, Dh), "batch", None, "heads", None)
    k = shard(split_heads(h @ p["wk"].to(dt_), H, Dh), "batch", None, "heads", None)
    v = shard(split_heads(h @ p["wv"].to(dt_), H, Dh), "batch", None, "heads", None)
    k = k * (Dh**-0.5)
    i_gate, a_log = _mlstm_gates(p, h, H)
    ig = i_gate[..., None].to(dt_)
    y, _ = ssd_chunked(v * ig, a_log, k, q, chunk)  # state (B,H,Dh_v,Dh_k)
    nrm, _ = ssd_chunked(ig, a_log, k, q, chunk)  # (B,S,H,1)
    y = y / torch.clamp(nrm.abs(), min=1.0)
    y = rmsnorm(p["out_norm"]["scale"], merge_heads(y))
    return x + shard(y @ p["wo"].to(dt_), "batch", None, "model")


def mlstm_init_state(batch: int, d_model: int, n_heads: int) -> Dict[str, torch.Tensor]:
    Dh = d_model // n_heads
    return {
        "C": torch.zeros((batch, n_heads, Dh, Dh), dtype=torch.float32),
        "n": torch.zeros((batch, n_heads, 1, Dh), dtype=torch.float32),
    }


def mlstm_step(p: Dict, x: torch.Tensor, state: Dict[str, torch.Tensor], n_heads: int
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step.  x (B,1,D) → (B,1,D), new state."""
    B, _, D = x.shape
    dt_ = x.dtype
    H, Dh = n_heads, D // n_heads
    h = rmsnorm(p["norm"]["scale"], x)[:, 0]
    q = split_heads(h @ p["wq"].to(dt_), H, Dh)
    k = split_heads(h @ p["wk"].to(dt_), H, Dh) * (Dh**-0.5)
    v = split_heads(h @ p["wv"].to(dt_), H, Dh)
    i_gate, a_log = _mlstm_gates(p, h, H)
    ig = i_gate[..., None].to(dt_)
    y, C = ssd_step(v * ig, a_log, k, q, state["C"])
    nrm, n = ssd_step(ig, a_log, k, q, state["n"])
    y = y / torch.clamp(nrm.abs(), min=1.0)
    y = rmsnorm(p["out_norm"]["scale"], merge_heads(y))
    return x + (y @ p["wo"].to(dt_))[:, None, :], {"C": C, "n": n}


def slstm_init(d_model: int, *, device=None,
               generator: Optional[torch.Generator] = None) -> Dict:
    """The reference's param tree, f32."""
    kw = dict(device=device, generator=generator)
    return {
        "norm": {"scale": torch.ones(d_model, device=device)},
        "w_zifo": init_normal((d_model, 4 * d_model), d_model**-0.5, **kw),
        "wo": init_normal((d_model, d_model), d_model**-0.5, **kw),
    }


def linear_scan(f: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """c_t = f_t·c_{t-1} + u_t along axis 1 from c_0 = 0, for all t at once.

    The reference runs ``jax.lax.associative_scan`` with the combine
    ``(f1, u1)∘(f2, u2) = (f1·f2, u1·f2 + u2)``; eager torch has none, so
    this is the doubling (Hillis–Steele) scan with the same combine: after
    the step of distance d, position t holds the composition of the
    2d positions up to t, the ones before 0 being the identity (1, 0).
    ⌈log2 S⌉ steps of whole-tensor ops, no division, so a forget-gate
    product that underflows to 0 stays exact.  The association order
    differs from JAX's, so sums agree to f32 rounding, not bitwise.
    """
    S = f.shape[1]
    d = 1
    while d < S:
        f_prev = torch.cat([torch.ones_like(f[:, :d]), f[:, :-d]], dim=1)
        u_prev = torch.cat([torch.zeros_like(u[:, :d]), u[:, :-d]], dim=1)
        u = u_prev * f + u
        f = f_prev * f
        d *= 2
    return u


def _slstm_gates(p: Dict, h: torch.Tensor):
    zifo = (h @ p["w_zifo"].to(h.dtype)).float()
    z, i, f, o = torch.chunk(zifo, 4, dim=-1)
    return torch.tanh(z), torch.sigmoid(i), torch.sigmoid(f + 1.0), torch.sigmoid(o)


def slstm_apply(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """sLSTM: elementwise gated recurrence by a parallel scan (O(S log S))."""
    dt_ = x.dtype
    h = gather_sequence(rmsnorm(p["norm"]["scale"], x))
    z, i, f, o = _slstm_gates(p, h)
    c = linear_scan(f, i * z)  # zero initial state
    n = torch.clamp(linear_scan(f, i), min=1e-6)
    y = (o * c / n).to(dt_)
    return x + shard(y @ p["wo"].to(dt_), "batch", None, "model")


def slstm_init_state(batch: int, d_model: int) -> Dict[str, torch.Tensor]:
    return {
        "c": torch.zeros((batch, d_model), dtype=torch.float32),
        "n": torch.zeros((batch, d_model), dtype=torch.float32),
    }


def slstm_step(p: Dict, x: torch.Tensor, state: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step.  x (B,1,D) → (B,1,D), new state."""
    dt_ = x.dtype
    h = rmsnorm(p["norm"]["scale"], x)[:, 0]
    z, i, f, o = _slstm_gates(p, h)
    c = f * state["c"] + i * z
    n = f * state["n"] + i
    y = (o * c / torch.clamp(n, min=1e-6)).to(dt_)
    return x + (y @ p["wo"].to(dt_))[:, None, :], {"c": c, "n": n}
