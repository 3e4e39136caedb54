"""Paper-faithful interpreter backend (§3) for both graph carriers (port of
``repro/core/lowering/interpreter.py``).

Interprets the canonical strategy step by step: the forward runs under
``torch.no_grad`` and keeps only the cached set U_k (and the loss); the
backward walks the segments last to first, recomputes each V_i \\ U_k from
detached copies of the cached values it reads, and pulls the cotangents
back through the segment with one ``torch.autograd.grad``.  Gradients are
those of plain autograd, and the per-step live set can be audited against
the plan's analytic peak.

One engine serves both granularities: a *key* is a block name
(``BlockGraph``) or an fx node (traced function); a segment evaluates its
keys in order from the keys it reads outside itself.

``track_live=True`` appends a ``[(tag, live_bytes), ...]`` trace counting
the storages of the *intermediate forward values* held at each step (graph
inputs, parameters and views of them excluded, as in §2), which the tests
hold within the plan's ``peak_memory``.

Strategy plans (``plan.strategy``), traced path: each cached value is held
by its storage strategy (``storage.Stored``) — an offloaded one in host
memory, auditing at 0 device bytes; a quantized one as its int8 payload and
block scales, auditing at their bytes — so the live-byte trace charges
what the joint DP priced (on a DeviceMesh, a DTensor's local shard: its
pinned host copy, or the global codec's payload of its elements).  Every read (a forward consumer in a later
segment, a backward recompute) sees the value replayed from storage; a
view or ``getitem`` of such a node is derived again from its replayed
base.  The backward recomputes a quantized node inside its own segment
instead of reading it, as the reference's segment vjp does, so its own
segment sees its exact value.  The block-granularity path rejects
strategy plans, as the reference does (use ``"segment"`` for
BlockGraphs).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch
import torch.utils._pytree as pytree

from ..fx_graph import FxGraph, op_name
from ..prims import ATEN_PRNG
from ..schedule import ExecutionPlan
from . import storage
from .base import (
    Lowering,
    blockgraph_value_and_grad,
    check_plan_on_mesh,
    grads_like,
    in_layout,
    local_tensor,
    mesh_aware,
    on_mesh,
    register_lowering,
    reject_donate,
    rng_restored,
    rng_snapshot,
    value_out,
)
from .carriers import BlockGraphCarrier, TracedCarrier

# a cached view or getitem of a stored node: derived again from its base
_DERIVED = object()


@dataclasses.dataclass
class SegmentProgram:
    """The static structure of one plan segment over a carrier's keys."""

    index: int
    steps: List[Any]  # keys evaluated in order (helpers first, then owned)
    owned: List[Any]  # keys whose values belong to this segment's nodes
    ext: List[Any]  # keys read from outside the segment
    outs: List[Any]  # owned keys read by later segments, or final


def _tensor_leaves(v: Any) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(v) if isinstance(t, torch.Tensor)]


def _as_leaf(v: Any, grad: bool) -> Any:
    """Detached copy of a value (pytree), floating tensors requiring grad."""
    return pytree.tree_map(
        lambda t: t.detach().requires_grad_(grad and t.is_floating_point())
        if isinstance(t, torch.Tensor) else t, v)


def _link(progs: List[SegmentProgram], is_final: Callable[[Any], bool]) -> List[SegmentProgram]:
    """Fill each segment's ``outs``: its keys that a later segment reads, or
    that are final."""
    readers: Dict[Any, Set[int]] = {}
    for p in progs:
        for k in p.ext:
            readers.setdefault(k, set()).add(p.index)
    for p in progs:
        p.outs = [k for k in p.owned
                  if is_final(k) or any(j > p.index for j in readers.get(k, ()))]
    return progs


def traced_programs(fxg: FxGraph, plan: ExecutionPlan) -> List[SegmentProgram]:
    """Per-segment fx nodes of a traced function.

    A segment's steps are the fx nodes its graph nodes own (with their
    folded views and getitems), preceded by the nodes it needs that belong
    to no graph node (views of inputs, constants), which every segment that
    reads them re-evaluates from the inputs.
    """
    owner, out_node = fxg.owner, fxg.output
    seg_of = plan.segment_of()
    order = [n for n in fxg.gm.graph.nodes if n.op in ("call_function", "get_attr")]
    owned: List[List[Any]] = [[] for _ in plan.segments]
    for n in order:
        if owner[n] is not None:
            owned[seg_of[owner[n]]].append(n)
    progs = []
    for seg, nodes in zip(plan.segments, owned):
        own = set(nodes)
        helpers: Set[Any] = set()
        stack = [a for n in nodes for a in n.all_input_nodes]
        while stack:  # nodes of no graph node that this segment needs
            a = stack.pop()
            if a.op != "placeholder" and owner.get(a) is None and a not in helpers:
                helpers.add(a)
                stack.extend(a.all_input_nodes)
        steps = [n for n in order if n in helpers] + nodes
        inside = own | helpers
        ext = list(dict.fromkeys(a for n in steps for a in n.all_input_nodes
                                 if a not in inside))
        progs.append(SegmentProgram(seg.index, steps, nodes, ext, []))
    return _link(progs, lambda n: n is out_node)


def blockgraph_programs(bg, plan: ExecutionPlan) -> List[SegmentProgram]:
    """Per-segment blocks of a BlockGraph; a block also reads its params,
    keyed ``("param", name)``."""
    progs = []
    for seg in plan.segments:
        names = [bg.blocks[v].name for v in seg.nodes]
        own = set(names)
        ext = list(dict.fromkeys(
            k for name in names
            for k in (("param", name), *bg.by_name[name].inputs) if k not in own))
        progs.append(SegmentProgram(seg.index, names, names, ext, []))
    return _link(progs, lambda name: name in bg.outputs)


def run_segment(prog: SegmentProgram, evaluate: Callable[[Any, Callable], Any],
                read: Callable[[Any], Any],
                have: Optional[Dict[Any, Any]] = None) -> Dict[Any, Any]:
    """Values of every step of a segment, reading outside keys with ``read``;
    steps whose value is in ``have`` (the caches) are taken from it, not
    evaluated again."""
    local: Dict[Any, Any] = {}
    have = have or {}

    def get(k):
        return local[k] if k in local else read(k)

    for k in prog.steps:
        local[k] = have[k] if k in have else evaluate(k, get)
    return local


def interpret(
    progs: Sequence[SegmentProgram],
    evaluate: Callable[[Any, Callable], Any],
    reads: Callable[[Any], Sequence[Any]],
    inputs: Dict[Any, Any],
    diff: Set[Any],
    keep: Set[Any],
    final: Sequence[Any],
    final_fn: Callable[..., torch.Tensor],
    track_live: bool = False,
    untracked: Set[Any] = frozenset(),
    draws: Callable[[Any], bool] = lambda k: True,
    store: Callable[[Any, Any], Any] = lambda k, v: v,
    load: Callable[[Any, Any, Callable[[Any], Any]], Any] = lambda k, v, read: v,
    rerun: Callable[[Any], bool] = lambda k: False,
) -> Tuple[torch.Tensor, Dict[Any, List[Optional[torch.Tensor]]], List[Tuple[str, int]]]:
    """The canonical strategy over segment programs.

    ``evaluate(key, get)`` computes a key's value from the values of
    ``reads(key)``; ``inputs`` are the graph inputs and parameters by key,
    ``diff`` the keys to differentiate, ``keep`` the keys of cached values,
    ``final`` the keys ``final_fn`` turns into the loss, ``untracked`` the
    keys whose values depend on no differentiated input, which plain
    autograd does not track (a dropout mask: ``bernoulli`` has no
    derivative) and the backward treats as constants, ``draws(key)``
    whether a key may draw from a random generator.  Returns (loss,
    grads of ``diff`` keys as lists aligned with their tensor leaves, live
    trace).

    The backward recomputes a segment, then pulls cotangents back key by
    key in reverse order, each through its own ``torch.autograd.grad``:
    a value read by several keys sums their cotangents in the order plain
    autograd does (latest reader first), so gradients are bitwise equal.

    A key that draws is evaluated again with the generator state it was
    first evaluated with (saved in the forward), so a recomputed random draw
    (a dropout mask) gives the forward's bits, as a ``jax.random`` key would
    in the reference (on a DeviceMesh too: ``base.rng_snapshot`` holds every
    state DTensor's draws read); the global generator state is left as the
    forward left it.

    ``store(key, value)`` is what the forward caches for a key (a
    ``storage.Stored`` box, or the value), ``load(key, cached, read)`` the
    value a read replays from it, and ``rerun(key)`` whether the backward
    recomputes a cached key of its own segment instead of loading it.
    """
    live: List[Tuple[str, int]] = []
    input_storages = {local_tensor(t).untyped_storage().data_ptr()
                      for v in inputs.values() for t in _tensor_leaves(v)}

    def snapshot(tag: str, *stores: Dict[Any, Any]) -> None:
        if not track_live:
            return
        seen = set(input_storages)
        nbytes = 0
        for values in stores:
            for v in values.values():
                for t in pytree.tree_leaves(v):
                    if isinstance(t, storage.Stored):
                        nbytes += t.device_bytes()
                    elif isinstance(t, torch.Tensor):
                        s = local_tensor(t).untyped_storage()
                        if s.data_ptr() not in seen:
                            seen.add(s.data_ptr())
                            nbytes += s.nbytes()
        live.append((tag, nbytes))

    env: Dict[Any, Any] = {}

    def read(k):
        return load(k, env[k], read) if k in env else inputs[k]

    devices = sorted({t.device.index for v in inputs.values() for t in _tensor_leaves(v)
                      if t.device.type == "cuda"})
    rng: Dict[Any, Tuple[torch.Tensor, List[torch.Tensor]]] = {}

    def first_eval(k, get):
        if draws(k):
            rng[k] = rng_snapshot(devices)
        return evaluate(k, get)

    def replay(k, get):
        if k not in rng:
            return evaluate(k, get)
        with rng_restored(rng[k], devices):
            return evaluate(k, get)

    # ---------------- forward ----------------
    with torch.no_grad():
        for p in progs:
            local = run_segment(p, first_eval, read)
            for k in p.owned:
                if k in final:
                    env[k] = local[k]
                elif k in keep:
                    env[k] = store(k, local[k])
            snapshot(f"fwd_seg{p.index}", env)

    ct: Dict[Any, List[Optional[torch.Tensor]]] = {}
    grads: Dict[Any, List[Optional[torch.Tensor]]] = {}

    def pull(outs: Any, cts: Sequence[Optional[torch.Tensor]], leaves: Dict[Any, Any]):
        """Add d(outs)·cts w.r.t. each leaf value to its key's cotangent."""
        pairs = [(t, c) for t, c in zip(_tensor_leaves(outs), cts)
                 if c is not None and t.requires_grad]
        wrt = [(k, i, t) for k, v in leaves.items()
               for i, t in enumerate(_tensor_leaves(v)) if t.requires_grad]
        if not pairs or not wrt:
            return
        gs = torch.autograd.grad([t for t, _ in pairs], [t for _, _, t in wrt],
                                 [c for _, c in pairs], allow_unused=True)
        for (k, i, t), g in zip(wrt, gs):
            if g is None:
                continue
            dest = grads if k in inputs else ct
            acc = dest.setdefault(k, [None] * len(_tensor_leaves(leaves[k])))
            acc[i] = g if acc[i] is None else acc[i] + g

    leaves = {k: _as_leaf(read(k), True) for k in final}
    with torch.enable_grad():
        loss = final_fn(*leaves.values())
    pull(loss, [torch.ones_like(loss)], leaves)

    # ---------------- backward ----------------
    for p in reversed(progs):
        with torch.no_grad():  # recompute V_i \ U_k from the caches
            have = {k: read(k) for k in p.owned if k in env and not rerun(k)}
            local = run_segment(p, replay, read, have=have)
            del have
        snapshot(f"bwd_recompute_seg{p.index}", env, local)
        for k in reversed(p.steps):
            cts = ct.pop(k, None)
            if cts is None:
                continue
            leaves = {d: _as_leaf(local[d] if d in local else read(d),
                                  d in diff or (d not in inputs and d not in untracked))
                      for d in dict.fromkeys(reads(k))}
            with torch.enable_grad():
                out = replay(k, leaves.__getitem__)
            pull(out, cts, leaves)
        del local
        for k in p.owned:  # canonical rule: this segment's values are dead
            env.pop(k, None)
            ct.pop(k, None)
            rng.pop(k, None)
        snapshot(f"bwd_done_seg{p.index}", env)
    return loss.detach(), grads, live


# ---------------------------------------------------------------------------
# Carriers
# ---------------------------------------------------------------------------


def planned_value_and_grad(bg, plan: ExecutionPlan,
                           loss_fn: Callable[..., torch.Tensor],
                           track_live: bool = False):
    """f(params, inputs) -> (loss, param grads[, live_trace]) over a
    BlockGraph, interpreting the canonical strategy block by block."""
    progs = blockgraph_programs(bg, plan)
    keep = {bg.blocks[v].name for v in plan.cached}

    def reads(name):
        return [("param", name), *bg.by_name[name].inputs]

    def evaluate(name, get):
        p, *xs = reads(name)
        return bg.by_name[name].apply(get(p), *[get(i) for i in xs])

    def run(params: Dict[str, Any], inputs: Dict[str, Any]):
        vals = {("param", b.name): params[b.name] for b in bg.blocks}
        vals.update(inputs)
        loss, grads, live = interpret(
            progs, evaluate, reads, vals, diff={("param", b.name) for b in bg.blocks},
            keep=keep, final=list(bg.outputs), final_fn=loss_fn, track_live=track_live)
        param_grads = {}
        for b in bg.blocks:
            leaves, spec = pytree.tree_flatten(params[b.name])
            got = grads.get(("param", b.name), [None] * len(leaves))
            param_grads[b.name] = pytree.tree_unflatten(
                [torch.zeros_like(t) if g is None else in_layout(g, t)
                 for t, g in zip(leaves, got)], spec)
        loss = value_out(loss)
        return (loss, param_grads, live) if track_live else (loss, param_grads)

    return mesh_aware(run)


def vanilla_value_and_grad(bg, loss_fn: Callable[..., torch.Tensor]):
    """Reference: plain autograd over the vanilla executor."""
    return blockgraph_value_and_grad(bg.apply, loss_fn)


def traced_planned_value_and_grad(carrier: TracedCarrier, plan: ExecutionPlan,
                                  track_live: bool = False):
    """Interpret the canonical strategy over a traced function's fx graph;
    ``f(*args) -> (value, grads[, live_trace])`` with grads w.r.t.
    ``carrier.argnums``.  On a DeviceMesh the live-byte audit counts each
    DTensor's local shard: per-device bytes, as the plan prices them."""
    check_plan_on_mesh(carrier, plan)
    fxg = carrier.fx
    progs = traced_programs(fxg, plan)
    keep = {n for n, v in fxg.owner.items() if v is not None and v in plan.cached}
    placeholders = [n for n in fxg.gm.graph.nodes if n.op == "placeholder"]
    strategy = plan.strategy or {}

    def code_of(n):
        return strategy.get(fxg.owner.get(n))

    def store(n, val):
        code = code_of(n)
        if code is None:
            return val
        if fxg.nodes[fxg.owner[n]] is not n:
            return _DERIVED  # a view or getitem of the stored node
        if code == storage.OFFLOAD:
            return pytree.tree_map_only(torch.Tensor, storage.offload, val)
        return pytree.tree_map_only(
            torch.Tensor, lambda t: storage.compressed(t) if storage.quantizable(t) else t, val)

    def load(n, val, read):
        if val is _DERIVED:
            return fxg.run_node(n, read)
        return storage.load(val)

    def run(*args):
        flat = carrier.flatten_args(args)
        with on_mesh(flat):
            return interpret_flat(args, flat)

    def interpret_flat(args, flat):
        inputs = dict(zip(placeholders, flat))
        diff = {n for n, t in inputs.items() if t.requires_grad}
        tracked = set(diff)
        for n in fxg.gm.graph.nodes:  # autograd's requires_grad, propagated
            if n.op == "call_function" and any(a in tracked for a in n.all_input_nodes):
                tracked.add(n)
        untracked = {n for n in fxg.owner if n not in tracked}
        loss, grads, live = interpret(
            progs, fxg.run_node, lambda n: n.all_input_nodes, inputs, diff, keep,
            [fxg.output], lambda x: x, track_live=track_live, untracked=untracked,
            draws=lambda n: op_name(n.target) in ATEN_PRNG, store=store, load=load,
            rerun=lambda n: code_of(n) == storage.QUANTIZE)
        flat_grads = [grads.get(n, [None])[0] for n in inputs]
        flat_grads = [torch.zeros_like(t) if g is None else in_layout(g, t)
                      for t, g in zip(flat, flat_grads)]
        out = (value_out(loss), carrier.grads_out(args, flat_grads))
        return out + (live,) if track_live else out

    return run


def vanilla_traced_value_and_grad(carrier: TracedCarrier,
                                  plan: Optional[ExecutionPlan] = None):
    """Reference for a traced carrier: plain autograd through ``fn``.

    With ``plan``: plain autograd through the traced nodes in the plan's
    segment order, recomputing nothing.  Autograd sums the gradient of a
    tensor read by several nodes in an order set by when those nodes ran,
    so where a plan runs nodes in another topological order than the trace
    (a non-chain graph), this, not ``fn``, is the planned twin's bitwise
    reference (ROADMAP.md §3)."""
    if plan is not None:
        fxg = carrier.fx
        progs = traced_programs(fxg, plan)
        placeholders = [n for n in fxg.gm.graph.nodes if n.op == "placeholder"]

    def run(*args):
        flat = carrier.flatten_args(args)
        with on_mesh(flat):
            if plan is None:
                loss = carrier.fn(*pytree.tree_unflatten(flat, carrier.in_spec))
            else:
                env = dict(zip(placeholders, flat))
                for prog in progs:
                    local = run_segment(prog, fxg.run_node, env.__getitem__)
                    env.update((k, local[k]) for k in prog.outs)
                loss = env[fxg.output]
            return value_out(loss), carrier.grads_out(args, grads_like(loss, flat))

    return run


# ---------------------------------------------------------------------------
# Registry glue
# ---------------------------------------------------------------------------


class InterpreterLowering(Lowering):
    """§3's canonical strategy, interpreted (validation / audit backend)."""

    name = "interpreter"

    def supports(self, carrier) -> bool:
        return isinstance(carrier, (BlockGraphCarrier, TracedCarrier))

    def lower(self, carrier, plan: ExecutionPlan, track_live: bool = False,
              donate: bool = False):
        if donate:
            reject_donate(self.name)
        check_plan_on_mesh(carrier, plan)
        if isinstance(carrier, BlockGraphCarrier):
            if plan.strategy:
                raise NotImplementedError(
                    "the block-granularity interpreter does not realize storage "
                    "strategies; lower strategy plans over BlockGraphs with "
                    "backend='segment', or trace the function (backend="
                    "'interpreter'/'fx' on a TracedCarrier)")
            return planned_value_and_grad(carrier.bg, plan, carrier.loss_fn,
                                          track_live=track_live)
        return traced_planned_value_and_grad(carrier, plan, track_live=track_live)


register_lowering(InterpreterLowering())
