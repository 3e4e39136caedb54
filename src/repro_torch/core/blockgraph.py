"""BlockGraph — a model as a DAG of named blocks (port of
``repro/core/blockgraph.py``).

Each block is a pure ``apply(params, *inputs) -> tensor`` over tensors,
with an ``init(generator, *input_shapes)``.  From a BlockGraph the framework
derives, without running the model on real data, the paper's ``Graph``
(``M_v`` from fake-mode output shapes, ``T_v`` from the 10/1 model or
analytic FLOPs) and runs it vanilla or under a plan (``core.lowering``).
A block's ``out_sharding`` annotation budgets it at per-device bytes under
a mesh, as in the reference, and the ``"policy"`` and ``"segment"`` lowerings pin the
output onto it on a ``DeviceMesh`` (``parallel.sharding.shard``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode

from .fx_graph import tensor_bytes
from .graph import Graph, Node


@dataclasses.dataclass(frozen=True)
class Block:
    """One node of the model DAG.

    apply(params, *inputs) -> output tensor (or pytree of tensors).
    init(generator, *input_shapes) -> params pytree (possibly empty {}).
    inputs: names of producer blocks or graph inputs.
    heavy: paper cost model — True → T_v = 10, else 1.
    flops: optional analytic FLOPs for the "flops" cost model.
    out_sharding: optional sharding of the block's output — a spec tuple
      of mesh axes, or a tuple of logical axis names (``"batch"``, …)
      resolved under the active ``parallel.sharding`` rules.
    """

    name: str
    apply: Callable[..., Any]
    inputs: Tuple[str, ...]
    init: Optional[Callable[..., Any]] = None
    heavy: bool = True
    flops: Optional[float] = None
    out_sharding: Optional[Tuple[Any, ...]] = None


def block_spec(block: Block, shape: Tuple[int, ...], axis_sizes: Dict[str, int]) -> Tuple:
    """A Block's ``out_sharding`` annotation → a concrete spec: logical
    names resolve under the rules; a mesh axis that is no logical name
    (``"data"``, ``"pod"``) names itself, as in a ``PartitionSpec``."""
    from ..parallel.sharding import get_rules, resolve_spec

    sh = block.out_sharding
    if sh is None:
        return ()
    rules = dict(get_rules())
    for a in axis_sizes:
        rules.setdefault(a, a)
    return resolve_spec(tuple(sh), axis_sizes, shape=shape, rules=rules)


def fake_values(mode: FakeTensorMode, tree: Any) -> Any:
    """The tensors of ``tree`` as fake tensors of ``mode`` (same shapes,
    dtypes and devices; nothing allocated)."""
    return pytree.tree_map(
        lambda t: mode.from_tensor(t) if isinstance(t, torch.Tensor) else t, tree)


class BlockGraph:
    def __init__(
        self,
        blocks: Sequence[Block],
        graph_inputs: Sequence[str],
        outputs: Sequence[str],
    ):
        self.blocks: List[Block] = list(blocks)
        self.graph_inputs: Tuple[str, ...] = tuple(graph_inputs)
        self.outputs: Tuple[str, ...] = tuple(outputs)
        names = [b.name for b in self.blocks]
        if len(set(names)) != len(names):
            raise ValueError("duplicate block names")
        self.by_name: Dict[str, Block] = {b.name: b for b in self.blocks}
        known = set(self.graph_inputs)
        for b in self.blocks:
            for i in b.inputs:
                if i not in known and i not in self.by_name:
                    raise ValueError(f"block {b.name}: unknown input {i!r}")
            known.add(b.name)
        for o in self.outputs:
            if o not in self.by_name:
                raise ValueError(f"unknown output {o!r}")

    # ------------------------------------------------------------------ init

    def init(self, generator: torch.Generator,
             input_shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, Any]:
        """Initialize all block params from ``generator``; ``input_shapes``
        maps graph inputs to shapes (f32)."""
        shapes: Dict[str, Any] = dict(input_shapes)
        params: Dict[str, Any] = {}
        for b in self.blocks:
            in_shapes = [shapes[i] for i in b.inputs]
            params[b.name] = b.init(generator, *in_shapes) if b.init else {}
            with FakeTensorMode() as mode:
                out = b.apply(fake_values(mode, params[b.name]),
                              *[torch.empty(s) for s in in_shapes])
            shapes[b.name] = tuple(out.shape)
        return params

    # ----------------------------------------------------------- vanilla run

    def apply(self, params: Dict[str, Any], inputs: Dict[str, Any]) -> Any:
        """Vanilla execution: topological sweep, everything live for autograd."""
        values: Dict[str, Any] = dict(inputs)
        for b in self.blocks:
            values[b.name] = b.apply(params[b.name], *[values[i] for i in b.inputs])
        outs = tuple(values[o] for o in self.outputs)
        return outs[0] if len(outs) == 1 else outs

    # --------------------------------------------------------- planner input

    def to_graph(self, params: Dict[str, Any], inputs: Dict[str, Any],
                 cost_model: str = "paper", mesh: Any = None) -> Graph:
        """Export the paper's G=(V,E) with fake-mode M_v and the chosen T_v.

        With ``mesh`` (a ``DeviceMesh`` or ``{axis: size}`` dict), blocks
        annotated with ``out_sharding`` are budgeted at **per-device**
        bytes through ``parallel.sharding``."""
        if cost_model not in ("paper", "flops"):
            raise ValueError(cost_model)
        axis_sizes = None
        if mesh is not None:
            from ..parallel.sharding import axis_sizes_of

            axis_sizes = axis_sizes_of(mesh)
        nodes: List[Node] = []
        edges: List[Tuple[int, int]] = []
        idx_of: Dict[str, int] = {}
        with FakeTensorMode() as mode:
            values: Dict[str, Any] = fake_values(mode, dict(inputs))
            fparams = fake_values(mode, params)
            for b in self.blocks:
                out = b.apply(fparams[b.name], *[values[i] for i in b.inputs])
                if cost_model == "flops" and b.flops:
                    t = float(b.flops)
                else:
                    t = 10.0 if b.heavy else 1.0
                idx = len(nodes)
                mem = tensor_bytes(out)
                if axis_sizes is not None and b.out_sharding is not None:
                    from ..parallel.sharding import sharded_aval_bytes

                    mem = sum(sharded_aval_bytes(t, block_spec(b, tuple(t.shape), axis_sizes),
                                                 axis_sizes)
                              for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor))
                nodes.append(Node(idx, b.name, t, float(max(mem, 1)), "block"))
                idx_of[b.name] = idx
                for i in b.inputs:
                    if i in idx_of:
                        edges.append((idx_of[i], idx))
                values[b.name] = out
        return Graph(nodes, edges)
