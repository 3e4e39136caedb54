"""Graph carriers: the model representations the planning pipeline accepts
(port of ``repro/core/lowering/carriers.py``).

A *carrier* pairs a computation with enough structure to (a) extract the
paper's ``core.Graph`` for the Planner and (b) be re-executed under a plan
by the lowering backends:

* :class:`BlockGraphCarrier` — a ``core.blockgraph.BlockGraph`` plus a loss
  over its outputs.  Node = block; the production lowering is ``"segment"``.
* :class:`TracedCarrier` — **any torch function** of tensors (and pytrees
  of them), traced with ``make_fx`` in fake mode (``core.fx_graph``).  Node
  = aten op; the production lowering is ``"fx"``.

Both expose ``to_graph()`` (planner input) and ``default_backend``.
``TracedCarrier.trace(..., analyze_effects=True)`` runs the effect pass
(``repro_torch.analysis.effects``) and pins its ``must_store`` frontier
into the graph, which then hashes to its own plan-cache digest.
Sharded carriers (``mesh=``/``in_shardings=``) wait for ROADMAP.md module
queue, item 'Multi-device'.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.utils._pytree as pytree

from ..fx_graph import FxGraph, from_graph_module, trace_module
from ..graph import Graph
from .base import not_ported


def reject_mesh(mesh: Any, in_shardings: Any) -> None:
    if mesh is not None or in_shardings is not None:
        raise not_ported("mesh= / in_shardings= (sharded planning)", "Multi-device")


@dataclasses.dataclass
class BlockGraphCarrier:
    """A ``BlockGraph`` bound to abstract params/inputs and a loss.

    The lowered callables take ``(params, inputs)`` and return
    ``(loss, param_grads)``.  ``params``/``inputs`` here only give shapes
    (``plan_function`` stores them on the meta device).
    """

    bg: Any  # core.blockgraph.BlockGraph
    loss_fn: Callable[..., torch.Tensor]
    params: Any
    inputs: Dict[str, Any]
    cost_model: str = "paper"

    default_backend = "segment"

    def to_graph(self) -> Graph:
        return self.bg.to_graph(self.params, self.inputs, cost_model=self.cost_model)


@dataclasses.dataclass
class TracedCarrier:
    """Any torch function, traced on example arguments.

    ``fn`` must return a scalar tensor; the lowered callables take the same
    positional arguments (same pytree structure, shapes, dtypes, devices)
    and return ``(value, grads)`` w.r.t. ``argnums``.
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
        reject_mesh(mesh, in_shardings)
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

        fxg = from_graph_module(trace_module(flat_fn, *flat), cost_model=cost_model)
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
                   arg_slices=tuple(slices), fx=fxg, effects=effects)

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
                for j, t in enumerate(flat)]

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
    flat, spec = pytree.tree_flatten(tuple(args))
    leaves = tuple(
        (tuple(x.shape), str(x.dtype), str(x.device)) if isinstance(x, torch.Tensor)
        else (type(x).__name__, x)
        for x in flat
    )
    return (repr(spec), leaves)
