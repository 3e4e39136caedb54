"""Apply the paper's planner to the production models (port of
``repro/launch/plan.py``).

The logic is the reference's.  What differs: the per-device memory
``hbm_bytes`` is an argument of ``needs_fsdp``, ``plan_inputs``,
``plan_unit_segments``, ``plan_with_microbatching`` and
``prewarm_unit_plans``; ``None`` reads the CUDA card's total memory
(``launch.mesh.device_hbm_bytes``), and tests pin the reference's 16 GiB.
The measured cost model (``REPRO_MEASURED_COSTS``: ``_dp_chain_graph``
prices the chain from a profile of the device) and the static plan
verifier (``REPRO_VERIFY_PLANS``: ``_maybe_verify`` checks each plan) run
as the reference's do.

One instance of the unified pipeline (carrier → Planner → lowering): the
carrier here is the unit-granularity *chain graph* of the scan-over-units
LM, the Planner is the shared process-default one (plan cache + budget
sweep + lazy cap extension), and the lowering is the scan-chain projection
of the ``"segment"`` backend (``segments_from_result`` →
``models.transformer`` ``segment_sizes``).

The scan-over-units LM is, at unit granularity, a *chain* — and on a chain
the lower-set lattice is exactly the set of prefixes, so the DP solution is
the true optimum (DESIGN.md §3).  Each unit is modelled as two nodes:

  interior  (M_v = unit's interior activation bytes, T_v = unit FLOPs)
  boundary  (M_v = bytes of the unit output h,        T_v ≈ 0)

so the DP's memory functional sees the real working set while the cached
boundary ∂(L_i) costs only the h tensor — the same accounting XLA applies to
the per-segment ``jax.checkpoint`` this plan lowers to (models.transformer
``segment_sizes``).  The functional is liveness-tight
(``dp.peak_memory_live``): within a segment's backward window buffers are
charged only while they are actually live, so at a fixed per-device budget
the escalation below can pick coarser segmentations (fewer microbatches /
less recompute) than eq. (2)'s full-footprint charge admitted.

**Byte accounting is sharding-derived, not hand-rolled**: every chain-node
size comes from the shared per-device accounting in
``repro_torch.parallel.sharding`` — each unit tensor is named by its logical axes
(:func:`unit_activation_inventory`), resolved to a PartitionSpec under the
active rules table, and ceil-divided into its per-device shard
(``resolve_spec`` + ``local_bytes``).  The same rules table drives the
model's GSPMD layout, so the bytes the DP budgets and the bytes the
compiled step materializes cannot drift apart.

Budget: per-device HBM minus params+optimizer+workspace, i.e. the activation
budget the paper's B represents (§3 "budget semantics on TPU" — B is the
memory of ONE accelerator).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig, SSMConfig
from repro_torch.core import Graph
from repro_torch.core.dp import DPResult, quantize_times
from repro_torch.core.graph import Node
from repro_torch.core.planner import get_default_planner
from repro_torch.launch.mesh import device_hbm_bytes
from repro_torch.models.transformer import unit_kinds, unit_pattern
from repro_torch.parallel.sharding import (
    DEFAULT_RULES,
    Rules,
    local_bytes,
    local_shape,
    resolve_spec,
)


@dataclasses.dataclass(frozen=True)
class PlanInputs:
    n_units: int
    bytes_boundary: float  # unit output h, per device
    bytes_interior: float  # unit interior activations, per device
    flops_unit: float  # per-shard forward FLOPs of one unit
    budget: float  # per-device activation budget (the paper's B)

    def units(self) -> List[Tuple[float, float]]:
        """(forward FLOPs, interior bytes) of each unit, in chain order."""
        return [(self.flops_unit, self.bytes_interior)] * self.n_units


@dataclasses.dataclass(frozen=True)
class MixedPlanInputs(PlanInputs):
    """:class:`PlanInputs` of a chain of unlike units (``layer_pattern``):
    each unit's own forward FLOPs and interior bytes, from its kinds;
    ``flops_unit`` and ``bytes_interior`` are their mean and largest."""

    unit_flops: Tuple[float, ...] = ()
    unit_interiors: Tuple[float, ...] = ()

    def units(self) -> List[Tuple[float, float]]:
        return list(zip(self.unit_flops, self.unit_interiors))


def _chain_rules(rules: Optional[Rules]) -> Rules:
    """The rules table for chain accounting, plus the derived ``seq_chain``
    entry: the residual stream between units is sharded over whatever the
    sequence-parallel axes are — ``seq_sp`` (data, long-context) first,
    then ``seq_act`` (Megatron SP over the model axis)."""
    r = dict(DEFAULT_RULES if rules is None else rules)

    def axes(name) -> Tuple:
        t = r.get(name)
        if t is None:
            return ()
        return t if isinstance(t, tuple) else (t,)

    r["seq_chain"] = (axes("seq_sp") + axes("seq_act")) or None
    return r


def unit_activation_inventory(
    cfg: ModelConfig, b: int, s: int, tokens_local: Optional[int] = None
) -> List[Tuple[str, int, Tuple[int, ...], Tuple[Optional[str], ...]]]:
    """Live activation tensors of one unit: (name, count, shape, logical).

    Shapes are *global* per-microbatch; the logical axis names are resolved
    against the sharding rules table to produce per-device bytes — the
    single source of truth replacing the old hand-rolled
    ``activation_expansion`` table.  Sequence dims are GSPMD-padded
    (``pad_dims`` below); head/expert counts keep the strict divisibility
    guard (indivisible → replicated, like ``drop_indivisible``).
    """
    d = cfg.d_model
    kinds, _ = unit_pattern(cfg)
    nk = len(kinds)
    inv: List[Tuple[str, int, Tuple[int, ...], Tuple[Optional[str], ...]]] = []
    # gathered full-sequence attention tensors (k/v/context) — replicated
    # over the model axis for the unit's attention working set
    inv.append(("attn_gather", 2, (b, s, d), ("batch", "seq_sp", None)))
    # residual stream per sub-layer: 2 ln outs, mixer out, mlp out, 2 adds
    inv.append(("residual", 6 * nk, (b, s, d), ("batch", "seq_chain", None)))
    inv.append(
        ("q", nk, (b, s, cfg.n_heads, cfg.head_dim),
         ("batch", "seq_sp", "heads", None))
    )
    inv.append(
        ("kv", 2 * nk, (b, s, cfg.n_kv_heads, cfg.head_dim),
         ("batch", "seq_sp", "kv_heads", None))
    )
    if cfg.d_ff > 0:
        inv.append(
            ("ffn", 3 * nk, (b, s, cfg.d_ff), ("batch", "seq_sp", "ffn"))
        )
    if cfg.moe is not None:
        ntok = tokens_local if tokens_local is not None else b * s
        cap = max(
            1,
            -(-int(cfg.moe.capacity_factor * cfg.moe.top_k * ntok)
              // cfg.moe.num_experts),
        )
        inv.append(
            ("moe_capacity", 3 * nk,
             (cfg.moe.num_experts, cap, cfg.moe.d_ff_expert),
             ("experts", "expert_cap", None))
        )
    if cfg.ssm is not None:
        inv.append(
            ("ssm_branches", 2 * nk, (b, s, int(cfg.ssm.expand * d)),
             ("batch", "seq_sp", "ffn"))
        )
    return inv


def kind_inventory(
    cfg: ModelConfig, kind: str, b: int, s: int, tokens_local: Optional[int] = None
) -> List[Tuple[str, int, Tuple[int, ...], Tuple[Optional[str], ...]]]:
    """Live activation tensors of one unit of a ``layer_pattern`` chain, a
    block of ``kind`` (``mamba_moe`` or ``attn_moe``), as
    :func:`unit_activation_inventory` lists them (an f32 tensor counts
    twice).  Counted from the tensors the blocks save for their backward
    (a CPU probe with ``saved_tensors_hooks``):

    * the residual stream: the 6 of a block, and each pre-norm's f32 input;
    * ``mamba_moe``'s mixer, in (b, s, d_inner) units: the in-projection's
      output (2), the conv's input and its f32 SiLU input (3), the scan's
      input, output and chunk states (3), the gate's and the out-norm's
      f32 inputs (4), the gated, skipped and normed outputs (4);
    * ``attn_moe``'s attention: the gathered k/v/context, q, k and v;
    * the MoE of every unit: the held experts' dispatch buffer and
      outputs (E_held, cap, d), their three hidden products (the gate's in
      f32), the combine's route rows (T·K, d), the shared expert's three
      hidden products (its gate in f32)."""
    d, m = cfg.d_model, cfg.moe
    ntok = tokens_local if tokens_local is not None else b * s
    inv: List[Tuple[str, int, Tuple[int, ...], Tuple[Optional[str], ...]]] = [
        ("residual", 6 + 2 * 2, (b, s, d), ("batch", "seq_chain", None))]
    if kind == "mamba_moe":
        d_inner = int((cfg.ssm or SSMConfig()).expand * d)
        inv.append(("ssm_inner", 16, (b, s, d_inner), ("batch", "seq_sp", "ffn")))
    elif kind == "attn_moe":
        inv += [
            ("attn_gather", 2, (b, s, d), ("batch", "seq_sp", None)),
            ("q", 1, (b, s, cfg.n_heads, cfg.head_dim), ("batch", "seq_sp", "heads", None)),
            ("kv", 2, (b, s, cfg.n_kv_heads, cfg.head_dim),
             ("batch", "seq_sp", "kv_heads", None)),
        ]
    else:
        raise ValueError(f"no inventory of a {kind!r} unit in a layer pattern")
    cap = max(8, int(m.capacity_factor * ntok * m.top_k / m.num_experts))
    inv += [
        ("moe_rows", 2, (m.held, cap, d), ("experts", "expert_cap", None)),
        ("moe_capacity", 4, (m.held, cap, m.d_ff_expert), ("experts", "expert_cap", None)),
        ("moe_routes", 1, (ntok * m.top_k, d), (None, None)),
    ]
    if m.d_ff_shared:
        inv.append(("moe_shared", 4, (b, s, m.d_ff_shared), ("batch", "seq_sp", "ffn")))
    return inv


def kind_flops(cfg: ModelConfig, kind: str, tokens: int) -> float:
    """Forward FLOPs of one ``layer_pattern`` unit of ``kind``: 2 · its
    matmul parameters a token multiplies by · tokens, a routed expert
    counted at the share of routes its layer holds."""
    d, m = cfg.d_model, cfg.moe
    if kind == "mamba_moe":
        ssm = cfg.ssm or SSMConfig()
        d_inner = int(ssm.expand * d)
        mixer = d * (2 * d_inner + 2 * ssm.d_state + max(1, d_inner // 64)) + d_inner * d
    else:
        mixer = cfg._attn_params()
    routed = 3 * d * m.d_ff_expert * m.top_k * m.held / m.num_experts
    moe = d * m.num_experts + routed + 3 * d * m.d_ff_shared
    return 2.0 * (mixer + moe) * tokens


def _per_device_bytes(
    shape: Tuple[int, ...],
    logical: Tuple[Optional[str], ...],
    axis_sizes: Dict[str, int],
    rules: Rules,
    act_bytes: int,
) -> int:
    """One tensor through the shared accounting: logical → spec → shard
    bytes.  Sequence dims are GSPMD-padded (ceil shards); head/expert
    count dims keep the strict divisibility guard (→ replicated)."""
    pad = tuple(
        i for i, nm in enumerate(logical) if nm and nm.startswith("seq")
    )
    spec = resolve_spec(logical, axis_sizes, shape=shape, rules=rules,
                        pad_dims=pad)
    return local_bytes(shape, spec, axis_sizes, act_bytes)


def unit_flops(cfg: ModelConfig, tokens: int) -> float:
    """Forward FLOPs of one unit (≈ 2 · active-params-per-unit · tokens)."""
    kinds, n_units = unit_pattern(cfg)
    per_unit_params = (cfg.num_active_params() - 2 * cfg.vocab_size * cfg.d_model) / max(
        n_units, 1
    )
    return 2.0 * max(per_unit_params, 1.0) * tokens


def chain_graph(pi: PlanInputs) -> Graph:
    """2-node-per-unit chain: interior → boundary → interior → …, each
    interior priced at its own unit's FLOPs and bytes (:meth:`PlanInputs.units`)."""
    nodes = []
    edges = []
    for u, (flops, interior) in enumerate(pi.units()):
        i_int = 2 * u
        nodes.append(
            Node(i_int, f"u{u}_interior", max(flops, 1.0), max(interior, 1.0), "unit")
        )
        nodes.append(
            Node(i_int + 1, f"u{u}_out", 1.0, max(pi.bytes_boundary, 1.0), "boundary")
        )
        edges.append((i_int, i_int + 1))
        if u:
            edges.append((i_int - 1, i_int))
    return Graph(nodes, edges)


def static_bytes(cfg: ModelConfig, model_shards: int, fsdp_shards: int = 1) -> float:
    """Per-device params (f32) + AdamW mu/nu (f32)."""
    return cfg.num_params() * (4 + 8) / max(model_shards, 1) / max(fsdp_shards, 1)


def _hbm(hbm_bytes: Optional[float]) -> float:
    """The per-device memory: as given, or the CUDA card's."""
    return float(device_hbm_bytes()) if hbm_bytes is None else hbm_bytes


def needs_fsdp(cfg: ModelConfig, model_shards: int,
               hbm_bytes: Optional[float] = None) -> bool:
    """TP-only static state over ~35% of HBM → also shard params over data."""
    return static_bytes(cfg, model_shards) > 0.35 * _hbm(hbm_bytes)


def plan_inputs(
    cfg: ModelConfig,
    shape: ShapeConfig,
    dp_shards: int,
    seq_shards: int = 1,
    model_shards: int = 16,
    n_micro: int = 1,
    hbm_bytes: Optional[float] = None,
    act_bytes: int = 2,  # bf16
    rules: Optional[Rules] = None,
) -> PlanInputs:
    """Chain-graph inputs with every byte size derived from the shared
    sharding-aware accounting (``repro_torch.parallel.sharding``).

    ``dp_shards``/``seq_shards`` both occupy the mesh "data" axis (which of
    the two actually shards is decided by the rules table + divisibility:
    batch takes it when it divides, otherwise ``seq_sp`` does — exactly the
    launchers' layout logic).  ``rules=None`` uses ``DEFAULT_RULES`` so
    direct calls are deterministic; the launchers pass their active table.
    """
    kinds = unit_kinds(cfg)
    n_units = len(kinds)
    hbm_bytes = _hbm(hbm_bytes)
    r = _chain_rules(rules)
    axis_sizes = {
        "pod": 1,
        "data": max(dp_shards, 1) * max(seq_shards, 1),
        "model": max(model_shards, 1),
    }
    b_g = max(1, shape.global_batch // max(n_micro, 1))
    s = shape.seq_len
    d = cfg.d_model

    # local token count (drives FLOPs and MoE capacity rows)
    tok_spec = resolve_spec(("batch", "seq_sp"), axis_sizes, shape=(b_g, s),
                            rules=r, pad_dims=(1,))
    tl = local_shape((b_g, s), tok_spec, axis_sizes)
    tokens_local = tl[0] * tl[1]

    def total(inventory) -> float:
        return float(sum(count * _per_device_bytes(shp, logical, axis_sizes, r, act_bytes)
                         for _, count, shp, logical in inventory))

    h_boundary = _per_device_bytes(
        (b_g, s, d), ("batch", "seq_chain", None), axis_sizes, r, act_bytes
    )
    if cfg.layer_pattern:
        per_kind = {k: (kind_flops(cfg, k, tokens_local) / max(model_shards, 1),
                        total(kind_inventory(cfg, k, b_g, s, tokens_local)))
                    for k in cfg.layer_pattern}
        units = [per_kind[k] for (k,) in kinds]
        interior = max(b for _, b in units)
        flops = sum(f for f, _ in units) / n_units
    else:
        interior = total(unit_activation_inventory(cfg, b_g, s, tokens_local=tokens_local))
        # per-shard forward FLOPs (TP splits every unit matmul model_shards ways)
        flops = unit_flops(cfg, tokens_local) / max(model_shards, 1)
    fsdp = dp_shards if needs_fsdp(cfg, model_shards, hbm_bytes) else 1
    static = static_bytes(cfg, model_shards, fsdp)
    if n_micro > 1:
        static += cfg.num_params() * 4 / max(model_shards, 1) / max(fsdp, 1)  # grad accum f32
    budget = max(hbm_bytes - static, 0.05 * hbm_bytes)
    common = dict(n_units=n_units, bytes_boundary=float(h_boundary),
                  bytes_interior=float(interior), flops_unit=float(flops),
                  budget=float(budget))
    if cfg.layer_pattern:
        return MixedPlanInputs(**common, unit_flops=tuple(f for f, _ in units),
                               unit_interiors=tuple(b for _, b in units))
    return PlanInputs(**common)


def segments_from_result(
    res: DPResult, n_units: int
) -> Tuple[Tuple[int, ...], Tuple[bool, ...]]:
    """Lower-set sequence on the 2-node chain → (group sizes, remat flags).

    This is the scan-chain projection of the ``"segment"`` lowering backend
    (``core.lowering.segment.segment_groups``), specialized to the
    interior/boundary 2-node unit encoding of :func:`chain_graph`.

    On the chain, ∂(L) = {max(L)}: a lower set ending at a unit's *interior*
    node caches that interior — the unit runs unwrapped (vanilla residuals,
    no recompute).  Lower sets ending at *boundary* nodes delimit
    jax.checkpoint groups whose interiors are recomputed.  With ample budget
    the time-centric DP caches everything (overhead 0 = vanilla); under
    pressure it mixes — exactly the paper's trade, lowered to XLA.
    """
    cached_units = set()
    end_units = []
    for L in res.sequence:
        m = max(L)
        if m % 2 == 0:
            cached_units.add(m // 2)
        else:
            end_units.append(m // 2)
    sizes: list = []
    remat: list = []

    def emit(lo: int, hi: int) -> None:
        """units [lo, hi] — split into maximal cached/uncached runs."""
        u = lo
        while u <= hi:
            flag = u in cached_units
            v = u
            while v + 1 <= hi and ((v + 1) in cached_units) == flag:
                v += 1
            sizes.append(v - u + 1)
            remat.append(not flag)
            u = v + 1

    prev = -1
    for e in end_units:
        if e > prev:
            emit(prev + 1, e)
            prev = e
    if prev < n_units - 1:
        emit(prev + 1, n_units - 1)
    return tuple(sizes), tuple(remat)


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    sizes: Tuple[int, ...]
    remat: Tuple[bool, ...]
    n_micro: int = 1

    @property
    def n_segments(self) -> int:
        return len(self.sizes)


def _dp_chain_graph(pi: PlanInputs, measured: Optional[bool] = None,
                    device: str = "cuda") -> Graph:
    """Chain graph with the DP's integer t-axis.

    With measured costs (``measured=True`` or ``REPRO_MEASURED_COSTS=1``) the
    interior/boundary nodes are priced by the profiled cost model
    (FLOPs·matmul-rate vs bytes·HBM-rate) before quantization, so the DP
    trades real seconds, not FLOP proxies.  Default stays analytic —
    profiling costs a one-off timing run per device.  ``device`` is the
    device whose profile prices the graph (``cost_model.load_or_profile``).
    """
    raw = chain_graph(pi)
    if measured is None:
        measured = bool(os.environ.get("REPRO_MEASURED_COSTS"))
    if measured:
        from repro_torch.core.cost_model import calibrated_graph, load_or_profile

        return calibrated_graph(raw, load_or_profile(device=device), levels=32)
    return quantize_times(raw, levels=32)


def plan_unit_segments(
    cfg: ModelConfig,
    shape: ShapeConfig,
    dp_shards: int,
    seq_shards: int = 1,
    model_shards: int = 16,
    n_micro: int = 1,
    budget: Optional[float] = None,
    objective: str = "time_centric",
    measured_costs: Optional[bool] = None,
    rules: Optional[Rules] = None,
    hbm_bytes: Optional[float] = None,
    device: str = "cuda",
) -> Tuple[SegmentPlan, DPResult]:
    """One-call front door used by the launchers.

    Solves through the process-default ``Planner``: repeated cells of the
    dry-run matrix, microbatch escalation retries, and job restarts hit the
    plan cache instead of re-running the exact DP.
    """
    pi = plan_inputs(cfg, shape, dp_shards, seq_shards, model_shards, n_micro,
                     hbm_bytes=hbm_bytes, rules=rules)
    g = _dp_chain_graph(pi, measured_costs, device)
    B = budget if budget is not None else pi.budget
    res = get_default_planner().solve(g, B, "exact_dp", objective)
    if not res.feasible:
        sp = SegmentPlan(tuple(1 for _ in range(pi.n_units)),
                         tuple(True for _ in range(pi.n_units)), n_micro)
        return sp, res
    _maybe_verify(g, res, B)
    sizes, remat = segments_from_result(res, pi.n_units)
    return SegmentPlan(sizes, remat, n_micro), res


def prewarm_unit_plans(
    cfg: ModelConfig,
    shapes: Sequence[ShapeConfig],
    dp_shards: int,
    seq_shards: int = 1,
    model_shards: int = 16,
    n_micro: int = 1,
    objective: str = "time_centric",
    measured_costs: Optional[bool] = None,
    rules: Optional[Rules] = None,
    hbm_bytes: Optional[float] = None,
    device: str = "cuda",
) -> Dict[str, bool]:
    """Pre-warm the plan cache for every expected planning signature.

    For each shape, builds the exact chain graph :func:`plan_unit_segments`
    would solve and makes sure a **full budget-free sweep** for it is hot
    (``Planner.prewarm`` on the process-default planner) — so the first
    real ``plan_unit_segments`` / ``plan_with_microbatching`` call at that
    signature is a frontier lookup, not a cold DP.  With a fleet store
    attached (``set_default_remote_store`` / ``REPRO_PLAN_REMOTE_DIR``) one
    replica's pre-warm serves the whole fleet via read-through.

    Returns ``{shape.name: already_warm}`` — False entries are the
    signatures this call paid a cold solve for.
    """
    planner = get_default_planner()
    out: Dict[str, bool] = {}
    for shape in shapes:
        pi = plan_inputs(cfg, shape, dp_shards, seq_shards, model_shards,
                         n_micro, hbm_bytes=hbm_bytes, rules=rules)
        g = _dp_chain_graph(pi, measured_costs, device)
        out[shape.name] = planner.prewarm(g, "exact_dp", objective)
    return out


def _maybe_verify(g: Graph, res: DPResult, budget: float) -> None:
    """``REPRO_VERIFY_PLANS=1``: statically re-verify the launch plan.

    Runs the DP-independent verifier (``repro_torch.analysis.check_plan``)
    over the solved lower-set sequence — topology, replay soundness,
    simulated peak vs. the per-device budget, eq. (1) overhead — and
    refuses to hand a launcher an unsound schedule.  Off by default: the
    checks are cheap (linear in segments) but this path sits under sweeps
    that may call it many times.

    The stronger ``REPRO_VERIFY_PLANS=hlo`` level (the census and drift
    gate, ``analysis.check_hlo``) applies at the ``plan_function`` front
    door, where a traced carrier exists to run; the launch chain graphs
    here have no twin of their own, so any value — ``hlo`` included — runs
    the static verifier only.
    """
    if not os.environ.get("REPRO_VERIFY_PLANS"):
        return
    from repro_torch import analysis
    from repro_torch.analysis.report import PlanVerificationError
    from repro_torch.core.schedule import make_plan

    report = analysis.check_plan(g, make_plan(g, res.sequence), budget=budget)
    if not report.ok:
        raise PlanVerificationError(str(report))


#: modeled per-extra-microbatch fixed cost, as a fraction of the whole
#: step's forward time (weight re-gathers under FSDP, scan constants,
#: pipeline fill) — escalating one more factor must buy at least this much
#: recompute overhead back
MICRO_STEP_TAX = 0.05


def plan_with_microbatching(
    cfg: ModelConfig,
    shape: ShapeConfig,
    dp_shards: int,
    seq_shards: int = 1,
    model_shards: int = 16,
    objective: str = "time_centric",
    max_micro: int = 16,
    rules: Optional[Rules] = None,
    hbm_bytes: Optional[float] = None,
    device: str = "cuda",
) -> Tuple[SegmentPlan, DPResult]:
    """Pick ``(n_micro, plan)`` jointly by modeled step time.

    Beyond §5.1's "smallest feasible factor": each candidate factor's
    (budget → overhead) Pareto staircase comes from a cached budget sweep
    capped at that factor's per-device budget (``Planner.solve_grid`` — one
    DP pass, reused verbatim by the final ``plan_unit_segments`` solve), so
    the modeled step time

        t(k) ≈ fwd_total · (3 + overhead_k(B_k)/T(V_k) + (k-1) · tax)

    trades recompute overhead (read off the staircase at the factor's
    budget) against the fixed per-microbatch cost ``MICRO_STEP_TAX``.  The
    best feasible factor wins; ties break toward fewer microbatches.
    Infeasible-everywhere falls back to the largest factor (old behavior).

    With ``objective="wallclock"`` each candidate factor is priced by the
    discrete-event replay simulator (``core.replay``) instead of the
    additive model: recompute that hides under the next segment's backward
    window (budget headroom permitting) is not charged, so a factor whose
    overhead overlaps away can beat a nominally lower-overhead one.  The
    early-exit guard is unchanged — overlap only shrinks a factor's step
    time, so the overhead bound on potential savings still holds.
    """
    b_loc = max(1, shape.global_batch // max(dp_shards, 1))
    hbm_bytes = _hbm(hbm_bytes)
    planner = get_default_planner()
    best: Optional[Tuple[float, int]] = None  # (modeled time, n_micro)
    n_micro = 1
    while n_micro <= min(max_micro, b_loc):
        pi = plan_inputs(cfg, shape, dp_shards, seq_shards, model_shards,
                         n_micro, hbm_bytes=hbm_bytes, rules=rules)
        g = _dp_chain_graph(pi, device=device)
        res = planner.solve_grid(g, [pi.budget], "exact_dp", objective)[0]
        if res.feasible:
            oh_frac = res.overhead / g.total_time
            if objective == "wallclock":
                # Price the candidate with the replay simulator instead of
                # the additive overhead model: replayed seconds (with the
                # budget's headroom spent on overlap) normalized by forward
                # time is directly comparable to 3 + oh_frac across factors.
                from repro_torch.core.replay import replay
                from repro_torch.core.schedule import make_plan

                rr = replay(g, make_plan(g, res.sequence), budget=pi.budget)
                t_model = (rr.seconds / g.total_time
                           + (n_micro - 1) * MICRO_STEP_TAX)
            else:
                t_model = 3.0 + oh_frac + (n_micro - 1) * MICRO_STEP_TAX
            if best is None or t_model < best[0]:
                best = (t_model, n_micro)
            # sound early exit: a larger factor k' ≥ 2k pays ≥ k·tax extra
            # and can save at most this factor's whole overhead
            if oh_frac <= n_micro * MICRO_STEP_TAX:
                break
        n_micro *= 2
    chosen = best[1] if best is not None else min(max_micro, b_loc)
    return plan_unit_segments(
        cfg, shape, dp_shards, seq_shards, model_shards, chosen,
        objective=objective, rules=rules, hbm_bytes=hbm_bytes, device=device,
    )
