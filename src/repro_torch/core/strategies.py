"""Per-node storage-strategy lattice for the joint memory-strategy DP.

The paper's DP decides a per-node binary — *store* (the node joins the
cache ``U_i`` at full bytes) or *recompute* (it does not join at all).
Gruslys et al. and the Capuchin/byteprofile line (PAPERS.md / SNIPPETS.md)
show mixed storage strategies dominate pure recomputation, so the planner
generalizes the choice for every node that enters the cache:

=============  ======================  =====================================
strategy       device bytes charged    time tax (added to the t axis)
=============  ======================  =====================================
``store``      ``M_v``                 0
``offload``    0                       ``2·M_v / offload_bytes_per_sec``
``quantize``   ``quantized_bytes(M_v)``  ``2·M_v / quantize_bytes_per_sec``
=============  ======================  =====================================

**Model.**  A node picks its strategy once, when it first enters the cache
(the DP's ``m_step`` charges each newly cached node exactly once, so the
per-transition choice *is* a per-node choice).  During its own forward
window the node exists on device at full bytes regardless of strategy —
compression/offload happens when the segment retires — which is why
``liveness.transition_excess`` stays strategy-independent and only the
*carried* cache mass ``m`` shrinks.  Readback on replay is streamed in
chunks (double-buffered, Gruslys-style), so its transient device footprint
is not charged against the budget; its cost is the time tax, which
``core.replay`` prices into the backward stream where overlap can hide it.

The time taxes enter the DP's ``t`` axis for the ``time_centric`` and
``wallclock`` objectives (total time overhead = recomputation + transfer +
codec).  ``memory_centric`` maximizes *recomputation* overhead and treats
strategies purely as byte reduction: every node takes its minimal-bytes
legal strategy (canonical order breaks ties), which weakly enlarges the
feasible set and leaves the objective untouched.

Legality: ``quantize`` is illegal for ``must_store``-pinned nodes (PRNG
draws and effectful values must be preserved bit-exactly); ``offload``
preserves bits and stays legal everywhere.

``StrategyConfig`` is frozen and hashable; ``digest_token()`` is the
content-address fragment ``planner``/``plan_cache`` mix into their keys —
the empty string when only {store, recompute} is enabled, so legacy digests
are unchanged by this subsystem's existence.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

from .graph import Graph, mask_iter

#: Strategy codes.  "store" and "recompute" are the paper's binary;
#: "offload" and "quantize" extend it.
STORE = "store"
RECOMPUTE = "recompute"
OFFLOAD = "offload"
QUANTIZE = "quantize"

_ALL = (STORE, RECOMPUTE, OFFLOAD, QUANTIZE)

#: Default bandwidths pricing the extended strategies, re-exported by
#: ``cost_model`` (defined here so ``strategies`` stays import-light —
#: ``cost_model`` imports ``dp`` which imports this module).
#: Host link: one PCIe 4.0 x16 direction, de-rated for pageable staging.
DEFAULT_HOST_BYTES_PER_SEC = 1.6e10
#: int8 block codec throughput (memory-bound elementwise kernel).
DEFAULT_QUANTIZE_BYTES_PER_SEC = 2.5e11
#: Canonical order in which a node's storage options are generated (and in
#: which ties are broken everywhere — DP, oracle, sweep).
_STORAGE_ORDER = (STORE, OFFLOAD, QUANTIZE)

#: int8 payload of an f32 source plus one f32 scale per 256-element block
#: (``optim.compression``: BLOCK=256, int8 q + f32 scale).
QUANTIZE_BYTES_RATIO = 0.25 + 1.0 / 256.0


def quantized_bytes(mem: float) -> float:
    """Device bytes of an int8 block-quantized residual of ``mem`` f32 bytes."""
    return mem * QUANTIZE_BYTES_RATIO


@dataclasses.dataclass(frozen=True)
class StrategyConfig:
    """Enabled strategy set + the bandwidths that price the extensions.

    ``strategies`` always behaves as if "store" and "recompute" are present
    (they are the paper's baseline); the config is *extended* iff "offload"
    or "quantize" is enabled.  Bandwidths are bytes per second of the
    graph's time unit — pass ``seconds_per_time_unit`` when the graph's
    ``T_v`` axis is not literal seconds (e.g. after ``quantize_times``) so
    taxes land on the same axis as ``T_v``.
    """

    strategies: Tuple[str, ...] = (STORE, RECOMPUTE)
    offload_bytes_per_sec: float = 0.0  # filled from cost_model defaults
    quantize_bytes_per_sec: float = 0.0
    seconds_per_time_unit: float = 1.0

    def __post_init__(self) -> None:
        names = tuple(self.strategies)
        for s in names:
            if s not in _ALL:
                raise ValueError(f"unknown strategy {s!r} (choose from {_ALL})")
        # canonical, deduplicated, baseline always present
        canon = tuple(
            s for s in _ALL if s in names or s in (STORE, RECOMPUTE)
        )
        object.__setattr__(self, "strategies", canon)
        if not self.offload_bytes_per_sec:
            object.__setattr__(
                self, "offload_bytes_per_sec", DEFAULT_HOST_BYTES_PER_SEC
            )
        if not self.quantize_bytes_per_sec:
            object.__setattr__(
                self, "quantize_bytes_per_sec", DEFAULT_QUANTIZE_BYTES_PER_SEC
            )
        if self.offload_bytes_per_sec <= 0 or self.quantize_bytes_per_sec <= 0:
            raise ValueError("strategy bandwidths must be positive")
        if self.seconds_per_time_unit <= 0:
            raise ValueError("seconds_per_time_unit must be positive")

    # ------------------------------------------------------------- identity

    @property
    def extended(self) -> bool:
        """True iff any strategy beyond the paper's binary is enabled."""
        return OFFLOAD in self.strategies or QUANTIZE in self.strategies

    def digest_token(self) -> str:
        """Content-address fragment for planner/plan-cache keys.

        Empty for the legacy binary, so every pre-existing digest is
        unchanged when this subsystem is disabled.
        """
        if not self.extended:
            return ""
        return (
            f"strat={','.join(self.strategies)}"
            f"|off={self.offload_bytes_per_sec!r}"
            f"|qz={self.quantize_bytes_per_sec!r}"
            f"|spu={self.seconds_per_time_unit!r}"
        )

    # -------------------------------------------------------------- pricing

    def node_options(self, g: Graph, v: int) -> List[Tuple[str, float, float]]:
        """Legal ``(code, device_bytes, time_tax)`` options for node ``v``.

        Canonical order (store, offload, quantize); taxes are on the
        graph's ``T_v`` axis.  Pinned nodes may be offloaded (bit-exact)
        but never quantized.
        """
        mem = g.mem_v[v]
        spu = self.seconds_per_time_unit
        out: List[Tuple[str, float, float]] = [(STORE, mem, 0.0)]
        if OFFLOAD in self.strategies:
            out.append((OFFLOAD, 0.0, 2.0 * mem / self.offload_bytes_per_sec / spu))
        if QUANTIZE in self.strategies and not g.nodes[v].must_store:
            out.append(
                (QUANTIZE, quantized_bytes(mem),
                 2.0 * mem / self.quantize_bytes_per_sec / spu)
            )
        return out

    def min_bytes_choice(self, g: Graph, v: int) -> Tuple[str, float, float]:
        """The minimal-device-bytes legal option (canonical tie-break)."""
        opts = self.node_options(g, v)
        best = opts[0]
        for o in opts[1:]:
            if o[1] < best[1]:
                best = o
        return best

    def min_device_bytes(self, g: Graph) -> List[float]:
        """Per-node minimal legal device bytes (the ``mem_eff`` vector).

        Feasibility and the minimal feasible budget only care about the
        smallest carryable footprint: a smaller carried mass never shrinks
        the feasible continuation set, so the extended feasibility problem
        is exactly the binary one with ``mem_v`` replaced by this vector.
        """
        return [self.min_bytes_choice(g, v)[1] for v in range(g.n)]


#: Default legacy config (the paper's binary).
LEGACY = StrategyConfig()


def device_bytes(g: Graph, assignment: Optional[Dict[int, str]]) -> List[float]:
    """Per-node device bytes under a plan's strategy assignment.

    Nodes absent from ``assignment`` (or assigned "store") keep ``M_v``;
    offloaded nodes charge 0; quantized nodes charge
    :func:`quantized_bytes`.  This is the single byte-pricing rule shared
    by the DP's carried mass, ``schedule``'s plan peak, ``replay``'s
    window headroom, and the verifier's re-derivation.
    """
    out = list(g.mem_v)
    if assignment:
        for v, code in assignment.items():
            if code == OFFLOAD:
                out[v] = 0.0
            elif code == QUANTIZE:
                out[v] = quantized_bytes(g.mem_v[v])
    return out


def assignment_taxes(
    g: Graph, assignment: Optional[Dict[int, str]], cfg: StrategyConfig
) -> float:
    """Total time tax of an assignment (left-folded in ascending node id)."""
    if not assignment:
        return 0.0
    total = 0.0
    for v in sorted(assignment):
        code = assignment[v]
        for c, _b, tax in cfg.node_options(g, v):
            if c == code:
                total += tax
                break
        else:
            raise ValueError(f"assignment {code!r} illegal for node {v}")
    return total


# ---------------------------------------------------------------------------
# Transition option frontiers (the DP's per-pair Minkowski sums)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransitionOption:
    """One way to cache a transition's newly cached set.

    ``m_add``/``tax`` are left folds over the set's nodes in ascending id —
    float-identical to the oracle's enumeration and to the legacy
    ``m_step`` fold when every node stores.  ``codes`` aligns with the
    ascending node ids of the newly cached mask.
    """

    m_add: float
    tax: float
    codes: Tuple[str, ...]


_OPT_MEMO: "weakref.WeakKeyDictionary[Graph, Dict[Tuple[str, int, bool], Tuple[TransitionOption, ...]]]" = (
    weakref.WeakKeyDictionary()
)


def transition_options(
    g: Graph, cfg: StrategyConfig, new_mask: int, tc: bool
) -> Tuple[TransitionOption, ...]:
    """Pareto frontier of strategy choices for one newly cached set.

    Incremental Minkowski sum over the set's nodes in ascending id.  For
    the time-centric direction (``tc``) an option is dominated when
    another has ≤ bytes and ≤ tax; pruning after every node keeps the
    frontier small and is exact because both coordinates are additive.
    The all-store option always survives with ``m_add`` bitwise equal to
    the legacy ``m_step`` fold, and the all-min-bytes option survives with
    ``m_add`` equal to the ``mem_eff`` fold — the two anchors the
    feasibility/mfb reductions rely on.

    The memory-centric direction ignores taxes (they are not part of its
    objective), so the frontier collapses to the single minimal-bytes
    assignment.
    """
    per_g = _OPT_MEMO.setdefault(g, {})
    key = (cfg.digest_token(), new_mask, tc)
    cached = per_g.get(key)
    if cached is not None:
        return cached

    if not tc:
        m_add = 0.0
        tax = 0.0
        codes: List[str] = []
        for v in mask_iter(new_mask):
            code, b, tx = cfg.min_bytes_choice(g, v)
            m_add += b
            tax += tx
            codes.append(code)
        out = (TransitionOption(m_add, tax, tuple(codes)),)
        per_g[key] = out
        return out

    acc: List[Tuple[float, float, Tuple[str, ...]]] = [(0.0, 0.0, ())]
    for v in mask_iter(new_mask):
        opts = cfg.node_options(g, v)
        nxt = [
            (m + b, tax + tx, codes + (code,))
            for (m, tax, codes) in acc
            for (code, b, tx) in opts
        ]
        # (m asc, tax asc, generation order) — keep strict-tax-improvers;
        # first-insertion wins ties, so the canonical-order combination
        # survives among float-equal ones.
        nxt.sort(key=lambda o: (o[0], o[1]))
        acc = []
        best_tax = float("inf")
        for o in nxt:
            if o[1] < best_tax:
                acc.append(o)
                best_tax = o[1]
    out = tuple(TransitionOption(m, tax, codes) for m, tax, codes in acc)
    per_g[key] = out
    return out


def assignment_of(new_mask: int, codes: Sequence[str]) -> Dict[int, str]:
    """Expand an option's code tuple into a node → strategy mapping."""
    return {v: code for v, code in zip(mask_iter(new_mask), codes)}
