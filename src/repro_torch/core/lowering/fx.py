"""The ``"fx"`` backend: a traced function's plan lowered onto autograd with
one checkpoint region per recomputing segment.

It takes the place of the reference's ``"jaxpr"`` backend
(``repro/core/lowering/policy.py``, ``JaxprLowering``), which tags every
equation and runs the whole function under one ``jax.checkpoint`` saving
exactly U_k, and leaves the schedule to XLA.  Eager PyTorch has no such
scheduler: a non-reentrant ``torch.utils.checkpoint`` recomputes its
region's forward at the first backward access to any tensor it saved and
holds every recomputed tensor until that tensor is used, so one region over
the whole function brings the backward's peak back to the vanilla one.

So this backend follows the plan's segments.  A segment with a non-empty
``recompute`` set runs as its own non-reentrant checkpoint region: it takes
the values it reads from earlier segments and returns the values that
later segments read (its ``keep`` nodes, and the loss).  Inside the region
a selective policy (the twin of ``create_selective_checkpoint_contexts``,
below) keeps the outputs of the ops of ``keep`` nodes and recomputes every
other op, keyed by the fx node the region's loop is executing; early stop
is off, so the backward recomputes exactly V_i \\ U_k, once.  A segment
that recomputes nothing runs plainly.  Loss and gradients are those of
plain autograd, bitwise on the same device.

**Storage strategies** (``plan.strategy``; the reference's
``plan_policy``/``quantized_checkpoint``).  Every segment that makes or
reads an offloaded or quantized node runs as a region, so that autograd
holds nothing of such a node outside the region's own policy:

* an **offloaded** node's op outputs are kept by the region's policy as a
  copy in pinned host memory and copied back when the backward recomputes
  the region; between segments its value is a ``storage.Stored`` in host
  memory, which each reading region copies back (and again in its
  backward).  Values are bitwise those of plain autograd.
* a **quantized** node's readers see ``straight_through_roundtrip`` of it,
  as ``quantized_checkpoint`` gives them: the region's backward recomputes
  the node's op (as XLA rematerializes the un-named value in the
  reference) and the roundtrip, and between segments its value is the int8
  payload and scales of that roundtrip, decompressed by each reader on the
  current stream.  The device keeps q and scale, never the full tensor.

**Donation** (``donate=True``; the reference jits with ``donate_argnums``).
Torch has no buffer donation: the twin drops its own reference to each
value that crosses segments once the last segment reading it has run, so
whatever autograd does not hold is freed during the forward.  Values and
grads are unchanged.  The twin carries ``donate_argnums`` and
``donation_hints`` (``lowering.donation``) as the reference's does.

**On a DeviceMesh** the twin runs node by node on DTensors (the aten
graph is global, so every op takes its global shapes), under the same
regions; the loss comes back replicated and each gradient in its input's
placements (``base.grads_like``).  A stored node keeps its local shard
(``storage``: pinned host bytes, or the global codec's int8 payload of
its elements); a functional collective's output is never copied by the
forward's policy (its buffer is not ready until waited for), so an
offloaded node's collectives rerun in the backward.  A recomputed draw
replays from checkpoint's saved CPU and CUDA generator states, which are
the states DTensor's draws read (``base.rng_snapshot``).

The twin exposes what the analysis layer reads (``repro_torch.analysis``):
``run.node_now()`` is the fx node being evaluated (None between nodes, so
ops that autograd's derivative formulas run are attributed to no node), and
``run.policy_saves(node)`` is the selective policy's decision for an fx
node of a recomputing segment (None elsewhere).
"""

from __future__ import annotations

import collections
import contextlib
import weakref
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ...optim.compression import roundtrip_with_payload
from ..fx_graph import is_view
from ..schedule import ExecutionPlan
from . import storage
from .base import (
    Lowering,
    check_plan_on_mesh,
    grads_like,
    on_mesh,
    register_lowering,
    reject_track_live,
    value_out,
)
from .carriers import TracedCarrier
from .interpreter import SegmentProgram, run_segment, traced_programs

# ops that non-reentrant checkpointing itself runs a different number of
# times in the forward and the recompute (torch's SAC_IGNORED_OPS)
_IGNORED = {torch.ops.aten.detach.default, torch.ops.prim.device.default}
_RECOMPUTE = object()
_COLLECTIVES = "_c10d_functional"
SAVE = "save"
#: keep the op's outputs only if they turn out to be outputs of the unit
#: being run (``_Keep.settle``): the ``"policy"`` backend's block outputs
PENDING = "pending"


class _Keep(TorchDispatchMode):
    """The forward of a region: each op's outputs are kept as ``decide()``
    says (``SAVE``, ``storage.OFFLOAD``, ``PENDING`` or None to recompute),
    in order of the op's calls."""

    def __init__(self, decide: Callable[[], Optional[str]], kept: Dict[Any, Any],
                 memo: Dict[int, Any]):
        super().__init__()
        self.decide, self.kept, self.memo = decide, kept, memo
        self.pending: List[Any] = []  # (deque, position, spec, weak leaves)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func not in _IGNORED:
            how = self.decide()
            entries = self.kept.setdefault(func, collections.deque())
            if how == SAVE:
                entry = pytree.tree_map_only(torch.Tensor, torch.Tensor.detach, out)
            elif how == storage.OFFLOAD and getattr(func, "namespace", "") != _COLLECTIVES:
                entry = pytree.tree_map_only(
                    torch.Tensor, lambda t: storage.offload(t.detach(), self.memo), out)
            else:  # a collective's output is not ready to copy: it is rerun
                entry = _RECOMPUTE
                if how == PENDING:  # weakly: an op's other outputs die as they would
                    leaves, spec = pytree.tree_flatten(out)
                    self.pending.append((entries, len(entries), spec, [
                        weakref.ref(t) if isinstance(t, torch.Tensor) else t for t in leaves]))
            entries.append(entry)
        return out

    def settle(self, outputs: Any) -> List[torch.Tensor]:
        """Keep the pending ops whose outputs are among ``outputs`` (the same
        tensor objects, or a DTensor's local tensor), whose other outputs
        are alive; every other pending op recomputes.  Returns the tensors
        kept."""
        want = set()
        for t in pytree.tree_leaves(outputs):
            if isinstance(t, torch.Tensor):
                want.update((id(t), id(getattr(t, "_local_tensor", t))))
        kept: List[torch.Tensor] = []
        for entries, i, spec, refs in self.pending:
            leaves = [r() if isinstance(r, weakref.ref) else r for r in refs]
            tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
            if any(t is None for t in leaves) or not any(id(t) in want for t in tensors):
                continue
            entries[i] = pytree.tree_unflatten([t.detach() if isinstance(t, torch.Tensor)
                                                else t for t in leaves], spec)
            kept.extend(tensors)
        self.pending.clear()
        return kept


class _Replay(TorchDispatchMode):
    """The backward's recompute of a region: kept outputs are returned (an
    offloaded one copied back, ``between_nodes``: the copy is no rerun of
    the node), every other op runs again."""

    def __init__(self, kept: Dict[Any, Any], between_nodes: Callable[[], Any]):
        super().__init__()
        self.kept, self.between_nodes = kept, between_nodes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in _IGNORED:
            entry = self.kept[func].popleft()
            if entry is not _RECOMPUTE:
                with self.between_nodes():
                    return pytree.tree_map_only(storage.Stored, storage.Stored.materialize,
                                                entry)
        return func(*args, **(kwargs or {}))


def selective_context(decide: Callable[[], Optional[str]], memo: Dict[int, Any],
                      between_nodes: Callable[[], Any] = contextlib.nullcontext,
                      on_keep: Callable[[_Keep], None] = lambda keep: None):
    """A ``context_fn`` for a non-reentrant checkpoint region: the forward
    keeps each op's outputs as ``decide()`` says, the recompute returns the
    kept ones and reruns the rest (the twin of torch's
    ``create_selective_checkpoint_contexts``, keyed by the caller's own
    notion of the op's node).  ``on_keep`` receives each region's forward
    mode."""

    def context_fn():
        kept: Dict[Any, Any] = {}
        keep = _Keep(decide, kept, memo)
        on_keep(keep)
        return keep, _Replay(kept, between_nodes)

    return context_fn


def fx_value_and_grad(carrier: TracedCarrier, plan: ExecutionPlan, donate: bool = False):
    """``f(*args) -> (value, grads)`` of the traced function under the plan."""
    check_plan_on_mesh(carrier, plan)
    fxg = carrier.fx
    owner, out_node = fxg.owner, fxg.output
    progs = traced_programs(fxg, plan)
    placeholders = [n for n in fxg.gm.graph.nodes if n.op == "placeholder"]
    strategy = plan.strategy or {}
    current: List[Any] = [None]  # the fx node being evaluated
    region_keep: Dict[Any, Any] = {}  # fx node of a recomputing segment -> its keep
    memo: Dict[int, Any] = {}  # host copies of the segment running

    def code_of(node) -> Optional[str]:
        return None if node is out_node else strategy.get(owner.get(node))

    def evaluate(node, get):
        current[0] = node
        try:
            val = fxg.run_node(node, get)
        finally:
            current[0] = None
        return val

    @contextlib.contextmanager
    def between_nodes():
        node, current[0] = current[0], None
        try:
            yield
        finally:
            current[0] = node

    def decide(node, keep) -> Optional[str]:
        if node is None or owner.get(node) not in keep or is_view(node):
            return None
        code = code_of(node)
        if code == storage.QUANTIZE:
            return None  # rerun by the backward; its readers replay q and scale
        return code or SAVE

    def region_for(prog: SegmentProgram, keep):
        region_keep.update(dict.fromkeys(prog.steps, keep))
        quantized = {n for n in prog.steps if code_of(n) == storage.QUANTIZE
                     and fxg.nodes[owner[n]] is n}

        context_fn = selective_context(lambda: decide(current[0], keep), memo, between_nodes)

        def region(*ext_vals):
            bases: Dict[int, Any] = {}  # roundtrip storage -> its compression

            def quantize(node, get):
                val = evaluate(node, get)
                if node in quantized:
                    val = pytree.tree_map_only(torch.Tensor, lambda t: roundtrip(t, bases), val)
                return val

            ext = {k: storage.load(v) for k, v in zip(prog.ext, ext_vals)}
            local = run_segment(prog, quantize, ext.__getitem__)
            return tuple(local[k] for k in prog.outs), bases

        return region, context_fn

    def roundtrip(t, bases):
        """``straight_through_roundtrip`` of ``t``; its payload is kept in
        ``bases`` by the storage the value will cross segments in."""
        if not storage.quantizable(t):
            return t
        y, c = roundtrip_with_payload(t)
        bases[storage.storage_key(y)] = c
        return y

    def touches_strategy(prog: SegmentProgram) -> bool:
        return any(code_of(n) for n in (*prog.steps, *prog.ext))

    regions = {
        prog.index: region_for(prog, seg.keep)
        for prog, seg in zip(progs, plan.segments)
        if seg.recompute or touches_strategy(prog)
    }

    def hold(k, val, bases):
        """A value crossing segments, held by its node's storage strategy."""
        code = code_of(k)
        if not isinstance(val, torch.Tensor) or code is None:
            return val
        if code == storage.OFFLOAD:
            return storage.offload(val, memo)
        base = bases.get(storage.storage_key(val))
        return val if base is None else storage.quantized(val, base)

    last_read: Dict[Any, int] = {}
    for prog in progs:
        for k in prog.ext:
            last_read[k] = prog.index
    dead_after: Dict[int, List[Any]] = collections.defaultdict(list)
    for k, i in last_read.items():
        if k is not out_node:
            dead_after[i].append(k)

    def forward(flat):
        # returns the loss alone: what the backward needs, autograd holds,
        # and frees as it goes, as the canonical strategy frees U_k
        env = dict(zip(placeholders, flat))
        for prog in progs:
            if prog.index in regions:
                region, context_fn = regions[prog.index]
                with set_checkpoint_early_stop(False):
                    outs, bases = checkpoint(region, *[env[k] for k in prog.ext],
                                             use_reentrant=False, context_fn=context_fn)
            else:
                local = run_segment(prog, evaluate, env.__getitem__)
                outs, bases = [local[k] for k in prog.outs], {}
            env.update((k, hold(k, v, bases)) for k, v in zip(prog.outs, outs))
            del outs, bases
            memo.clear()
            if donate:
                for k in dead_after[prog.index]:
                    env.pop(k, None)
        return env[out_node]

    def run(*args):
        flat = carrier.flatten_args(args)
        with on_mesh(flat):
            loss = forward(flat)
            return value_out(loss), carrier.grads_out(args, grads_like(loss, flat))

    run.node_now = lambda: current[0]
    run.policy_saves = lambda node: (decide(node, region_keep[node]) is not None
                                     if node in region_keep else None)
    if donate:
        from .donation import donatable_argnums, donation_hints

        run.donate_argnums = donatable_argnums(carrier)
        run.donation_hints = donation_hints(carrier.to_graph(), plan)
    return run


class FxLowering(Lowering):
    """Traced-function production path: per-segment selective checkpoints."""

    name = "fx"

    def supports(self, carrier) -> bool:
        return isinstance(carrier, TracedCarrier)

    def lower(self, carrier, plan: ExecutionPlan, track_live: bool = False,
              donate: bool = False):
        if track_live:
            reject_track_live(self.name)
        return fx_value_and_grad(carrier, plan, donate=donate)


register_lowering(FxLowering())
