"""Deterministic discrete-event replay: wall-clock pricing of a plan.

The DP's objective (eq. 1) is *summed overhead* — recompute seconds charged
as if every forward replay serializes with the backward pass.  On real
hardware it does not have to: while the VJP sweep of segment ``k+1`` runs,
the forward replay of segment ``k`` can stream concurrently **iff** its
buffers fit under the analytic peak.  This module prices that schedule with
a deterministic discrete-event model (no clocks, no RNG — pure folds over
the plan), so plan selection can rank candidates by *replayed wall-clock at
a memory point* instead of abstract overhead.

Event model (one backward step, segments processed last → first):

* ``forward_seconds`` — one serial forward pass over every node.
* per segment ``i``: ``recompute_seconds`` (forward replay of
  ``segments[i].recompute``), ``backward_seconds`` (the VJP sweep, priced
  ``backward_factor ×`` the segment's forward compute), ``comm_seconds``
  (collective traffic attributed to the segment, see below).
* **overlap window**: while segment ``i``'s backward runs, segment
  ``i-1``'s recompute may stream concurrently.  The window's byte headroom
  comes from ``liveness.transition_excess``'s backward-window decomposition
  — window ``i``'s live bytes are exactly
  ``M(U_{i-1}) + excess(L_{i-1}, L_i)`` and the analytic
  ``plan.peak_memory`` is the max over windows — so the replay admits at
  most ``headroom_i = peak − window_i`` bytes of early recompute.  The
  hidden time is ``min(φ·r_{i-1}, b_i + c_i)`` with
  ``φ = min(1, headroom_i / recompute_bytes_{i-1})``: recompute production
  is modeled linear in time, so a window that can hold the whole replay
  hides all of it, a zero-headroom window hides nothing, and the simulated
  peak ``max_i(window_i + min(recompute_bytes_{i-1}, headroom_i))`` stays
  ≤ the analytic peak *by construction*.

Communication is priced from the mesh: one ring all-reduce's traffic factor
``2·(n-1)/n`` over the plan's cached residuals (gradient collectives), or —
when a step was measured — the per-device collective bytes the analysis
layer's collective counter saw (:func:`hlo_comm_bytes`; the reference reads
them from optimized HLO text).  Bytes are attributed to
segments proportional to their kept-residual mass and divided by the
interconnect bandwidth.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Sequence, Tuple

from .cost_model import OpProfile, node_seconds
from .graph import Graph, NodeSet, mask_iter, to_mask
from .liveness import transition_excess
from .schedule import ExecutionPlan
from .strategies import OFFLOAD, QUANTIZE, StrategyConfig, device_bytes

#: Mesh interconnect bandwidth used to turn collective bytes into seconds
#: (TPU-v5e ICI order of magnitude; override per call for other fabrics).
DEFAULT_INTERCONNECT_BYTES_PER_SEC: float = 4.5e10

#: VJP sweep compute relative to the segment's forward compute.  The
#: standard 1 matmul forward / 2 matmuls backward accounting; the §2 model
#: excludes backward T from *overhead*, but wall-clock must price it.
DEFAULT_BACKWARD_FACTOR: float = 2.0


@dataclasses.dataclass(frozen=True)
class SegmentTiming:
    """Replayed timings of one backward window (segment ``index``)."""

    index: int
    recompute_seconds: float  # forward replay of the uncached nodes
    backward_seconds: float  # VJP sweep (backward_factor × fwd compute)
    comm_seconds: float  # collective traffic attributed to this window
    hidden_seconds: float  # recompute of segment index-1 hidden under us
    headroom_bytes: float  # peak − this window's analytic live bytes
    #: D2H+H2D transfer plus int8 codec seconds of this segment's kept
    #: residuals under the plan's storage strategies (0 for binary plans).
    transfer_seconds: float = 0.0


@dataclasses.dataclass(frozen=True)
class ReplayResult:
    """Deterministic replay of one training step under a plan.

    ``seconds`` is the replayed step time (overlap applied when enabled),
    ``serial_seconds`` the no-overlap sum — ``seconds ≤ serial_seconds``
    always.  ``simulated_peak`` ≤ the plan's analytic peak by construction.
    """

    seconds: float
    serial_seconds: float
    forward_seconds: float
    simulated_peak: float
    overlap: bool
    segments: Tuple[SegmentTiming, ...]

    @property
    def hidden_seconds(self) -> float:
        return sum(s.hidden_seconds for s in self.segments)


def _seconds_of(g: Graph, nodes: NodeSet | Sequence[int],
                profile: Optional[OpProfile]) -> float:
    """Compute seconds of a node set: profiled rates or raw ``T_v``."""
    if profile is None:
        return sum(g.time_v[v] for v in nodes)
    return sum(node_seconds(g.nodes[v], profile) for v in nodes)


def _bytes_of(g: Graph, nodes: NodeSet | Sequence[int]) -> float:
    return sum(g.mem_v[v] for v in nodes)


def mesh_comm_bytes(plan: ExecutionPlan, g: Graph, mesh: object) -> float:
    """Ring all-reduce traffic model for one backward step on ``mesh``.

    Gradient collectives move the plan's cached residual mass once per
    step; a ring all-reduce over ``n`` devices sends ``2·(n-1)/n ×`` the
    payload per chip.  A 1-device (or absent) mesh prices to zero.
    """
    if mesh is None:
        return 0.0
    try:
        from repro_torch.parallel.sharding import axis_sizes_of

        n = 1
        for size in axis_sizes_of(mesh).values():
            n *= size
    except Exception:
        return 0.0
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * _bytes_of(g, plan.cached)


def hlo_comm_bytes(counted: Any) -> float:
    """Measured per-device collective bytes of one step.

    The reference sums the collectives' result shapes in XLA's optimized
    (partitioned, so per-chip) HLO text.  Eager torch has no HLO; the
    substitute is the collective counter of the analysis layer
    (``repro_torch.analysis.census.CountCollectives``), run around one step:
    ``counted`` is that counter (or its ``stats`` dict), and the result is
    the payload bytes this rank handed to every ``_c10d_functional``
    collective.  Pass it to :func:`replay` as ``comm_bytes``.
    """
    stats = getattr(counted, "stats", counted)
    return float(sum(rec["payload_bytes"] for rec in stats.values()))


def window_peaks(g: Graph, plan: ExecutionPlan) -> List[float]:
    """Per-window analytic live bytes ``M(U_{i-1}) + excess(L_{i-1}, L_i)``.

    The backward-window decomposition behind ``dp.peak_memory_live``:
    ``max(window_peaks) == plan.peak_memory`` for any valid plan, and each
    entry bounds the bytes live while that segment's window executes.
    For strategy plans the carried mass folds each cached node at its
    strategy's device bytes (offloaded → 0, quantized → int8+scale) — the
    same ``core.strategies.device_bytes`` weights ``dp.peak_memory_live``
    uses, so the invariant holds float-for-float there too.
    """
    pins = g.store_pins_mask
    w = device_bytes(g, plan.strategy) if plan.strategy else g.mem_v
    prev_mask = 0
    m = 0.0
    peaks: List[float] = []
    for seg in plan.segments:
        mask_lp = to_mask(seg.lower_set)
        bd_mask = to_mask(g.boundary(seg.lower_set))
        peaks.append(m + transition_excess(g, prev_mask, mask_lp, bd_mask))
        # Same fold as dp.peak_memory_live's ``m + m_step`` — ascending node
        # order — so max(window_peaks) == plan.peak_memory in float, not
        # just on paper.
        cache_mask = (bd_mask | (pins & mask_lp)) & ~prev_mask
        m += sum(w[v] for v in mask_iter(cache_mask))
        prev_mask = mask_lp
    return peaks


def replay(
    g: Graph,
    plan: ExecutionPlan,
    *,
    profile: Optional[OpProfile] = None,
    backward_factor: float = DEFAULT_BACKWARD_FACTOR,
    overlap: bool = True,
    budget: Optional[float] = None,
    mesh: object = None,
    comm_bytes: Optional[float] = None,
    interconnect_bytes_per_sec: float = DEFAULT_INTERCONNECT_BYTES_PER_SEC,
    segment_costs: Optional[Mapping[int, float]] = None,
    strategies: Optional[StrategyConfig] = None,
) -> ReplayResult:
    """Price one training step of ``plan`` on ``g`` (see module docstring).

    ``profile`` converts nodes to seconds via ``cost_model.node_seconds``;
    without one, ``g.time_v`` is read directly (correct for calibrated /
    measured graphs whose ``T_v`` already are seconds-proportional).
    ``budget`` is the device memory the overlap stream may fill — defaults
    to the plan's own analytic peak, so the simulated peak never exceeds
    it; plan *selection* passes the DP budget instead, letting a
    lower-peak candidate spend its slack on early recompute (the replay
    then stays ≤ that budget).  ``segment_costs`` overrides per-segment
    *forward* seconds with compiled or profiled measurements
    (``analysis.hlo.extract_segment_costs``), keyed by segment index;
    recompute within an overridden segment is scaled by its ``T``-ratio.
    ``comm_bytes`` (the collective counter's bytes, :func:`hlo_comm_bytes`)
    overrides the :func:`mesh_comm_bytes` model.

    Strategy plans (``plan.strategy`` non-empty) additionally price each
    window's kept residuals: offloaded nodes pay a D2H+H2D round trip over
    the host link and quantized nodes pay the int8 codec round trip.
    Those ``transfer_seconds`` join the window's backward/collective work —
    serial cost that the previous segment's recompute may hide under, the
    same overlap budgeting as everything else in the window.  Bandwidths
    come from ``strategies`` when given, else from the profile's
    ``host_bytes_per_sec``/``quantize_bytes_per_sec``, else the cost-model
    defaults.
    """
    segs = plan.segments
    k = len(segs)
    if comm_bytes is None:
        comm_bytes = mesh_comm_bytes(plan, g, mesh)

    # Per-segment transfer/codec seconds of the kept residuals.
    xfer_s = [0.0] * k
    if plan.strategy:
        if strategies is not None:
            off_bw = strategies.offload_bytes_per_sec
            qz_bw = strategies.quantize_bytes_per_sec
        elif profile is not None:
            off_bw = profile.host_bytes_per_sec
            qz_bw = profile.quantize_bytes_per_sec
        else:
            defaults = StrategyConfig()
            off_bw = defaults.offload_bytes_per_sec
            qz_bw = defaults.quantize_bytes_per_sec
        for i, seg in enumerate(segs):
            ob = sum(g.mem_v[v] for v in sorted(seg.keep)
                     if plan.strategy.get(v) == OFFLOAD)
            qb = sum(g.mem_v[v] for v in sorted(seg.keep)
                     if plan.strategy.get(v) == QUANTIZE)
            xfer_s[i] = 2.0 * ob / off_bw + 2.0 * qb / qz_bw

    # Per-segment forward compute seconds (and the recompute subset).
    fwd_s: List[float] = []
    rec_s: List[float] = []
    for seg in segs:
        full = _seconds_of(g, seg.nodes, profile)
        rec = _seconds_of(g, seg.recompute, profile)
        if segment_costs is not None and seg.index in segment_costs:
            measured = float(segment_costs[seg.index])
            ratio = rec / full if full > 0.0 else 0.0
            full, rec = measured, measured * ratio
        fwd_s.append(full)
        rec_s.append(rec)
    forward_seconds = sum(fwd_s)

    # Collective bytes → per-segment seconds, ∝ kept-residual mass.
    kept_mass = [_bytes_of(g, seg.keep) for seg in segs]
    total_kept = sum(kept_mass)
    comm_s = [
        (comm_bytes * km / total_kept / interconnect_bytes_per_sec
         if total_kept > 0.0 else 0.0)
        for km in kept_mass
    ]

    peaks = window_peaks(g, plan)
    peak_budget = plan.peak_memory if budget is None else max(
        budget, plan.peak_memory)

    timings: List[SegmentTiming] = []
    serial = forward_seconds
    hidden_total = 0.0
    simulated_peak = max(peaks, default=0.0)
    sim_overlap = 0.0
    for i in range(k - 1, -1, -1):
        b_i = backward_factor * fwd_s[i]
        c_i = comm_s[i]
        x_i = xfer_s[i]
        serial += rec_s[i] + b_i + c_i + x_i
        hidden = 0.0
        headroom = max(0.0, peak_budget - peaks[i])
        if overlap and i > 0 and rec_s[i - 1] > 0.0:
            rbytes = _bytes_of(g, segs[i - 1].recompute)
            phi = 1.0 if rbytes <= headroom else (
                headroom / rbytes if rbytes > 0.0 else 1.0)
            hidden = min(phi * rec_s[i - 1], b_i + c_i + x_i)
            hidden_total += hidden
            sim_overlap = max(sim_overlap, peaks[i] + min(rbytes, headroom))
        timings.append(
            SegmentTiming(
                index=segs[i].index,
                recompute_seconds=rec_s[i],
                backward_seconds=b_i,
                comm_seconds=c_i,
                hidden_seconds=hidden,
                headroom_bytes=headroom,
                transfer_seconds=x_i,
            )
        )
    timings.reverse()
    if overlap:
        simulated_peak = max(simulated_peak, sim_overlap)

    return ReplayResult(
        seconds=serial - hidden_total,
        serial_seconds=serial,
        forward_seconds=forward_seconds,
        simulated_peak=simulated_peak,
        overlap=overlap,
        segments=tuple(timings),
    )


def rank_by_replay(
    g: Graph,
    sequences: Sequence[Sequence[NodeSet]],
    *,
    assignments: Optional[Sequence[Optional[Mapping[int, str]]]] = None,
    strategies: Optional[StrategyConfig] = None,
    profile: Optional[OpProfile] = None,
    backward_factor: float = DEFAULT_BACKWARD_FACTOR,
    overlap: bool = True,
    budget: Optional[float] = None,
    mesh: object = None,
    comm_bytes: Optional[float] = None,
    segment_costs: Optional[Mapping[int, float]] = None,
) -> Tuple[int, ExecutionPlan, ReplayResult]:
    """Replay every candidate sequence; return the wall-clock winner.

    ``budget`` should be the DP budget the candidates were admitted under
    (the device memory the overlap stream may fill).  ``overlap=False``
    ranks by the serial replay — for targets that cannot run a second
    stream (a single-stream host, or profiling-only comparisons).
    ``assignments`` optionally pairs each sequence with a per-node storage
    strategy map (``None`` entries are plain binary candidates), letting
    the joint memory-strategy DP rank strategy plans and legacy all-store
    plans in one pool; ``strategies`` supplies the transfer/codec
    bandwidths pricing them.  Deterministic tie-break: (replayed seconds,
    analytic peak, index) — two candidates with identical replays resolve
    to the earlier (for sweeps: lower-overhead) one.  Returns
    ``(winner_index, plan, replay_result)``.
    """
    if not sequences:
        raise ValueError("no candidate sequences to rank")
    if assignments is not None and len(assignments) != len(sequences):
        raise ValueError("assignments must pair 1:1 with sequences")
    from .schedule import make_plan

    best: Optional[Tuple[float, float, int, ExecutionPlan, ReplayResult]] = None
    for idx, seq in enumerate(sequences):
        asg = assignments[idx] if assignments is not None else None
        plan = make_plan(
            g, list(seq), assignment=dict(asg) if asg else None,
            strategies=strategies,
        )
        res = replay(
            g, plan, profile=profile, backward_factor=backward_factor,
            overlap=overlap, budget=budget, mesh=mesh, comm_bytes=comm_bytes,
            segment_costs=segment_costs, strategies=strategies,
        )
        key = (res.seconds, plan.peak_memory, idx)
        if best is None or key < (best[0], best[1], best[2]):
            best = (res.seconds, plan.peak_memory, idx, plan, res)
    assert best is not None
    return best[2], best[3], best[4]
