"""Effect/determinism analysis: which nodes are safe to recompute? (port of
``repro/analysis/effects.py``, over the aten ops of a ``make_fx`` trace).

The paper's framework assumes every node is pure and replayable.  Real
traced workloads are not: random draws, side-effecting ops and opaque
custom ops all change meaning when re-executed during the backward pass.
This pass classifies every graph node of an :class:`~repro_torch.core.
fx_graph.FxGraph` into the reference's taint lattice

    pure  <  donated  <  prng  <  opaque  <  effectful

then propagates taint forward through the graph to the first *storable*
frontier and emits ``must_store`` pins there.  ``core.dp`` and
``core.planner`` consume the pins as hard constraints: pinned nodes are
priced store-only and never recomputed, and the pin marker enters the graph
digest, so safe and unsafe plan-cache variants never collide.

What stands in for what:

* One entry per graph node, not per equation: a node is its producing aten
  op, with its folded views and ``getitem``s (pure), as ``core.fx_graph``
  builds it.  The functionalized trace has no in-place ops.
* ``prng``: ops of ``prims.ATEN_PRNG`` (``rand*``, ``randn*``,
  ``bernoulli``, ``native_dropout``, ``normal``, ``uniform``, …), the twin
  of the reference's PRNG primitives.  Torch's generators are stateful, so
  a replay draws fresh numbers unless its lowering restores the state.
* ``opaque``: ops outside the ``aten`` and ``prims`` namespaces, and
  callables with no op schema.  The flash-attention custom op
  ``repro_torch::flash_attention`` (its own autograd formula over a
  hand-written kernel) is the twin of the reference's
  ``custom_vjp_call``/``pallas_call``.  The MoE dispatch's ops
  (``prims.MOE_OPS``) are pure: deterministic gathers whose backwards read
  only their own inputs and outputs.
* ``effectful``: ops fx lists as side-effecting, and ops whose schema
  writes an argument that is (a view of) a graph input.
* ``donated`` stays in the lattice but is never assigned: torch has no
  buffer donation.
* ``storable``: every used output has a floating (or complex) dtype —
  what the ``"fx"`` lowering's selective policy can save.  Integer and bool
  outputs (indices, masks) cannot be residuals.
"""

from __future__ import annotations

import dataclasses
import operator
from collections import deque
from typing import Any, FrozenSet, List, Tuple

import torch
from torch import fx

from ..core.fx_graph import FxGraph, is_view, op_name
from ..core.graph import Graph, Node
from ..core.prims import ATEN_PRNG, FLASH_OP, MOE_OPS, SHARD_OP, VOCAB_EMBED_OP, VOCAB_PICK_OP
from .report import Report

#: Taint lattice, least to greatest.
CLASSES = ("pure", "donated", "prng", "opaque", "effectful")
_RANK = {c: i for i, c in enumerate(CLASSES)}


@dataclasses.dataclass(frozen=True)
class EqnEffect:
    """Classification of one graph node (its producing aten op)."""

    index: int
    primitive: str  # the op's schema name (``bernoulli``, ``repro_torch::…``)
    klass: str  # one of CLASSES
    reason: str
    storable: bool  # every used output has a floating dtype (savable)

    @property
    def pure(self) -> bool:
        return self.klass == "pure"


def _used_outputs(node: fx.Node) -> List[Any]:
    """The output values of ``node`` that the trace reads."""
    val = node.meta.get("val")
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (tuple, list)):
        used = {u.args[1] for u in node.users if u.target is operator.getitem}
        return [v for i, v in enumerate(val) if i in used]
    return []


def _storable(node: fx.Node) -> bool:
    """True iff the ``"fx"`` lowering can save this node's value: every used
    output is a floating (or complex) tensor."""
    outs = _used_outputs(node)
    return bool(outs) and all(
        isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
        for t in outs)


def _writes_input(node: fx.Node) -> List[str]:
    """Names of the graph inputs an op writes (through views) per its schema."""
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return []
    hit = []
    for i, arg in enumerate(schema.arguments):
        info = arg.alias_info
        if info is None or not info.is_write:
            continue
        val = node.args[i] if i < len(node.args) else node.kwargs.get(arg.name)
        while isinstance(val, fx.Node) and is_view(val):
            val = val.args[0]
        if isinstance(val, fx.Node) and val.op == "placeholder":
            hit.append(val.name)
    return hit


def _classify(node: fx.Node) -> Tuple[str, str]:
    """(class, reason) of one producing fx node."""
    name = op_name(node.target)
    if name in ATEN_PRNG:
        return "prng", (
            f"'{name}' draws from torch's stateful generator; a replay in the "
            "backward draws fresh numbers")
    schema = getattr(node.target, "_schema", None)
    if node.target in fx.node._side_effectful_functions:
        return "effectful", f"'{name}' has side effects"
    if name == FLASH_OP:
        return "opaque", (
            f"'{name}' runs a hand-written kernel under its own autograd "
            "formula; replaying its forward is not provably consistent with "
            "the residuals its backward expects, so its outputs must be "
            "stored, not recomputed")
    if name == SHARD_OP:
        return "pure", ""  # a copy, or a collective over the mesh: replays alike
    if name in (VOCAB_EMBED_OP, VOCAB_PICK_OP):
        return "pure", ""  # a lookup, on the whole or on local shards: replays alike
    if name in MOE_OPS:
        # integer ranks and gathers in a fixed order, no atomics: a replay
        # gives the same bits, and the backward reads only the op's own
        # inputs and outputs
        return "pure", ""
    if schema is None:
        return "opaque", (
            f"'{name}' is no aten op; the taint walker cannot see into it")
    namespace = schema.name.split("::", 1)[0]
    if namespace not in ("aten", "prims"):
        return "opaque", (
            f"'{name}' is a custom op of namespace '{namespace}'; replaying it "
            "is not provably consistent with its autograd formula")
    written = _writes_input(node)
    if written:
        return "effectful", (
            f"'{name}' writes the graph input(s) {written}; replaying it writes "
            "them again")
    return "pure", ""


def classify_eqns(fxg: FxGraph) -> List[EqnEffect]:
    """Per-node classification of a traced graph, index-aligned with
    ``fxg.graph`` (one entry per graph node)."""
    out = []
    for idx, node in enumerate(fxg.nodes):
        klass, reason = _classify(node)
        out.append(EqnEffect(index=idx, primitive=op_name(node.target), klass=klass,
                             reason=reason, storable=_storable(node)))
    return out


@dataclasses.dataclass
class EffectAnalysis:
    """Result of the effect pass over one traced graph.

    ``tainted`` holds every non-pure node index; ``pins`` the
    ``must_store`` constraints — the storable forward frontier of the taint
    (a tainted storable node pins itself; unstorable taint flows to
    successors until the lowering can save something).
    """

    effects: List[EqnEffect]
    tainted: FrozenSet[int]
    pins: FrozenSet[int]
    report: Report

    @property
    def pure(self) -> bool:
        return not self.tainted


def analyze_effects(fxg: FxGraph) -> EffectAnalysis:
    """Classify ``fxg``'s nodes and derive ``must_store`` pins."""
    g = fxg.graph
    effects = classify_eqns(fxg)
    report = Report(checker="effects")
    tainted = frozenset(e.index for e in effects if not e.pure)

    for e in effects:
        if e.pure:
            continue
        report.add(
            "warning",
            f"{e.klass}-taint",
            f"{g.nodes[e.index].name}: {e.reason}",
            node=e.index,
        )

    # Forward taint propagation to the storable frontier.  A storable
    # tainted node pins itself; an unstorable one (integer draws, bool
    # masks) cannot be a residual, so its taint flows to every successor
    # until a storable node absorbs it.
    pins: set = set()
    seen: set = set()
    queue = deque(sorted(tainted))
    while queue:
        v = queue.popleft()
        if v in seen:
            continue
        seen.add(v)
        if effects[v].storable:
            pins.add(v)
            continue
        if not g.succ[v]:
            report.add(
                "warning",
                "unstorable-taint-sink",
                f"{g.nodes[v].name}: tainted, unstorable and without "
                "successors — nothing downstream can be pinned for it",
                node=v,
            )
            continue
        for w in g.succ[v]:
            queue.append(w)

    for v in sorted(pins):
        report.add(
            "info",
            "must-store-pin",
            f"{g.nodes[v].name} pinned must_store (storable frontier of "
            "tainted nodes)",
            node=v,
        )
    return EffectAnalysis(
        effects=effects,
        tainted=tainted,
        pins=frozenset(pins),
        report=report,
    )


def pin_graph(g: Graph, pins: FrozenSet[int]) -> Graph:
    """New graph with ``must_store=True`` on ``pins`` (existing pins kept).

    The pin marker enters WL colors and the canonical digest
    (``core.graph``), so pinned and unpinned variants of the same topology
    never share plan-cache entries.
    """
    if not pins and not g.store_pins_mask:
        return g
    nodes = [
        Node(
            nd.idx,
            nd.name,
            nd.time,
            nd.memory,
            nd.kind,
            must_store=nd.must_store or (nd.idx in pins),
        )
        for nd in g.nodes
    ]
    return Graph(nodes, g.edges, cost_source=getattr(g, "cost_source", ""))
