"""Graph carriers: the model representations the planning pipeline accepts
(port of ``repro/core/lowering/carriers.py``).

A *carrier* pairs a computation with enough structure to (a) extract the
paper's ``core.Graph`` for the Planner and (b) be re-executed under a plan
by the lowering backends:

* :class:`BlockGraphCarrier` — a ``core.blockgraph.BlockGraph`` plus a loss
  over its outputs.  Node = block; the production lowering is ``"policy"``.
* :class:`TracedCarrier` — **any torch function** of tensors (and pytrees
  of them), traced with ``make_fx`` in fake mode (``core.fx_graph``).  Node
  = aten op; the production lowering is ``"fx"``.

Both expose ``to_graph()`` (planner input) and ``default_backend``.
``TracedCarrier.trace(..., analyze_effects=True)`` runs the effect pass
(``repro_torch.analysis.effects``) and pins its ``must_store`` frontier
into the graph, which then hashes to its own plan-cache digest.

**Sharded carriers** (``mesh=``/``in_shardings=``), as in the reference:
node ``M_v`` is per-device bytes, so the budget the planner enforces is
per-device.  ``mesh`` is a ``torch.distributed`` ``DeviceMesh`` or a plain
``{axis: size}`` dict; a dict informs the *accounting* only.  On a
``DeviceMesh`` the lowered twin runs on DTensors: :meth:`TracedCarrier.constrain`
(the reference's ``with_sharding_constraint``) distributes plain
arguments, and redistributes DTensor ones, onto the caller's placements;
the loss comes back replicated and each gradient in its input's
placements (``lowering.base.grads_like``).  Execution covers the data
axes and the model axis (tensor parallelism: the models' sharding
constraints are ``repro_torch::shard`` nodes of a trace on such a mesh);
any other axis larger than 1 raises (ROADMAP.md 'Multi-device').
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.utils._pytree as pytree

from ...parallel import sharding as sh
from ..fx_graph import FxGraph, from_graph_module, global_fakes, trace_module
from ..graph import Graph
from .base import check_executable_mesh


@dataclasses.dataclass
class BlockGraphCarrier:
    """A ``BlockGraph`` bound to abstract params/inputs and a loss.

    The lowered callables take ``(params, inputs)`` and return
    ``(loss, param_grads)``.  ``params``/``inputs`` here only give shapes
    (``plan_function`` stores them on the meta device).  With ``mesh`` (a
    ``DeviceMesh`` or an ``{axis: size}`` dict) blocks carrying an
    ``out_sharding`` annotation are budgeted at per-device bytes, and on a
    ``DeviceMesh`` the ``"policy"`` and ``"segment"`` lowerings pin those outputs onto their
    spec (``blockgraph.block_spec``).
    """

    bg: Any  # core.blockgraph.BlockGraph
    loss_fn: Callable[..., torch.Tensor]
    params: Any
    inputs: Dict[str, Any]
    cost_model: str = "paper"
    mesh: Any = None

    default_backend = "policy"

    def to_graph(self) -> Graph:
        return self.bg.to_graph(self.params, self.inputs, cost_model=self.cost_model,
                                mesh=self.mesh)


def _is_spec(x: Any) -> bool:
    """One spec (or None, or DTensor placements) rather than a pytree of
    them: every entry is None, an axis name or a non-empty tuple of names."""
    if x is None or sh.is_placements(x):
        return True
    return isinstance(x, (tuple, list)) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and e and all(isinstance(a, str) for a in e))
        for e in x)


def _leaf_spec(s: Any, leaf: Any, mesh: Any) -> sh.Spec:
    from torch.distributed.tensor import DTensor

    if s is None:
        return sh.normalize_spec(leaf) if isinstance(leaf, DTensor) else ()
    return sh.normalize_spec(s, mesh=mesh, ndim=getattr(leaf, "ndim", 0))


def _flat_arg_specs(args: Sequence[Any], in_shardings: Any, mesh: Any) -> Tuple:
    """Flatten a per-positional-arg sharding description to per-leaf specs.

    ``in_shardings`` is None (each DTensor leaf keeps its own placements,
    every other leaf is replicated) or a sequence aligned with the
    positional args; each entry is None, a single spec (a tuple of
    entries, or DTensor placements) applied to every leaf of that
    argument, or a pytree of specs matching the argument's structure.
    """
    if in_shardings is None:
        in_shardings = [None] * len(args)
    if len(in_shardings) != len(args):
        raise ValueError(
            f"in_shardings has {len(in_shardings)} entries for {len(args)} "
            "positional arguments")
    out: List[Any] = []
    for a, s in zip(args, in_shardings):
        leaves, spec = pytree.tree_flatten(a)
        if _is_spec(s):
            out.extend(_leaf_spec(s, t, mesh) for t in leaves)
            continue
        s_leaves, s_spec = pytree.tree_flatten(s, is_leaf=_is_spec)
        if s_spec != spec:
            raise ValueError("in_shardings entry does not match the argument's "
                             f"pytree structure ({s_spec} != {spec})")
        out.extend(_leaf_spec(x, t, mesh) for x, t in zip(s_leaves, leaves))
    return tuple(out)


@dataclasses.dataclass
class TracedCarrier:
    """Any torch function, traced on example arguments.

    ``fn`` must return a scalar tensor; the lowered callables take the same
    positional arguments (same pytree structure, shapes, dtypes, devices)
    and return ``(value, grads)`` w.r.t. ``argnums``.

    With ``mesh`` + ``in_shardings`` the trace is **sharding-aware**: node
    ``M_v`` is per-device bytes (specs propagated through the aten graph,
    conservative replicated fallback) and, on a ``DeviceMesh``, the twin
    runs on DTensors in the caller's placements.
    """

    fn: Callable[..., torch.Tensor]
    argnums: Union[int, Tuple[int, ...]]
    cost_model: str
    in_spec: Any  # pytree spec of the args tuple
    arg_slices: Tuple[Tuple[int, int], ...]  # flat-leaf span per position arg
    fx: FxGraph
    #: the effect analysis (``analysis.effects.EffectAnalysis``) when traced
    #: with ``analyze_effects=True``, else None
    effects: Optional[Any] = None
    mesh: Any = None  # DeviceMesh | {axis: size} dict | None
    in_specs: Optional[Tuple] = None  # flat per-leaf specs under ``mesh``

    default_backend = "fx"

    @classmethod
    def trace(
        cls,
        fn: Callable[..., torch.Tensor],
        args: Sequence[Any],
        argnums: Union[int, Tuple[int, ...]] = 0,
        cost_model: str = "paper",
        mesh: Any = None,
        in_shardings: Any = None,
        analyze_effects: bool = False,
    ) -> "TracedCarrier":
        if in_shardings is not None and mesh is None:
            raise ValueError("in_shardings= needs mesh=")
        flat, in_spec = pytree.tree_flatten(tuple(args))
        bad = [type(x).__name__ for x in flat if not isinstance(x, torch.Tensor)]
        if bad:
            raise TypeError(f"plan_function traces tensor arguments only; got {bad}")
        slices, start = [], 0
        for a in args:
            n = len(pytree.tree_leaves(a))
            slices.append((start, start + n))
            start += n

        def flat_fn(*flat_args):
            return fn(*pytree.tree_unflatten(list(flat_args), in_spec))

        in_specs = None if mesh is None else _flat_arg_specs(args, in_shardings, mesh)
        fxg = from_graph_module(trace_module(flat_fn, *global_fakes(flat), mesh=mesh),
                                cost_model=cost_model, mesh=mesh,
                                in_specs=None if in_specs is None else list(in_specs))
        val = fxg.output.meta.get("val")
        if not isinstance(val, torch.Tensor) or val.shape != ():
            raise TypeError(
                "plan_function requires a scalar-output function "
                "(torch.autograd.grad semantics); got "
                f"{getattr(val, 'shape', type(val).__name__)}"
            )
        effects = None
        if analyze_effects:
            # classify the nodes, derive must_store pins on the storable
            # frontier of any taint, and rebuild the graph with the pins so
            # the planner treats them as store-only (and the plan-cache
            # digest differs from the unpinned variant's)
            from ...analysis.effects import analyze_effects as _analyze, pin_graph

            effects = _analyze(fxg)
            if effects.pins:
                fxg = dataclasses.replace(fxg, graph=pin_graph(fxg.graph, effects.pins))
        return cls(fn=fn, argnums=argnums, cost_model=cost_model, in_spec=in_spec,
                   arg_slices=tuple(slices), fx=fxg, effects=effects, mesh=mesh,
                   in_specs=in_specs)

    def to_graph(self) -> Graph:
        return self.fx.graph

    def node_names(self) -> List[str]:
        return [nd.name for nd in self.fx.graph.nodes]

    @property
    def argnum_tuple(self) -> Tuple[int, ...]:
        return (self.argnums,) if isinstance(self.argnums, int) else tuple(self.argnums)

    def flatten_args(self, args: Sequence[Any]) -> List[torch.Tensor]:
        """Flatten call-time args, checking the traced structure; leaves of
        ``argnums`` become detached tensors that require grad."""
        flat, spec = pytree.tree_flatten(tuple(args))
        if spec != self.in_spec:
            raise TypeError(
                f"argument structure differs from the traced example ({spec} != "
                f"{self.in_spec})"
            )
        diff = {j for a in self.argnum_tuple for j in range(*self.arg_slices[a])}
        return [t.detach().requires_grad_(j in diff and t.is_floating_point())
                for j, t in enumerate(self.constrain(flat))]

    def constrain(self, flat: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Pin flat args to the caller's shardings: on a ``DeviceMesh`` a
        plain tensor is distributed (each rank keeps its own slice of its
        copy: nothing is sent) and a DTensor redistributed onto the leaf's
        placements.  Identity without a ``DeviceMesh`` — a plain axis-size
        dict carries no devices, so it informs the accounting only."""
        if not sh.is_device_mesh(self.mesh):
            return list(flat)
        check_executable_mesh(self.mesh)
        return [sh.place(t, self.mesh, sp) for t, sp in zip(flat, self.in_specs)]

    def grads_out(self, args: Sequence[Any], flat_grads: Sequence[torch.Tensor]) -> Any:
        """Flat input grads → the grads of ``argnums`` in the args' structure."""
        grads = []
        for a in self.argnum_tuple:
            lo, hi = self.arg_slices[a]
            grads.append(pytree.tree_unflatten(list(flat_grads[lo:hi]),
                                               pytree.tree_structure(args[a])))
        return grads[0] if isinstance(self.argnums, int) else tuple(grads)


def abstract_signature(args: Sequence[Any]) -> Tuple:
    """Hashable (pytree spec, (shape, dtype, device) per leaf) key of a
    call's arguments — the memo key under which ``plan_function`` caches one
    traced and planned lowering."""
    from torch.distributed.tensor import DTensor

    flat, spec = pytree.tree_flatten(tuple(args))
    leaves = tuple(
        (tuple(x.shape), str(x.dtype), str(x.device),
         (repr(x.device_mesh), repr(x.placements)) if isinstance(x, DTensor) else None)
        if isinstance(x, torch.Tensor) else (type(x).__name__, x)
        for x in flat
    )
    return (repr(spec), leaves)
