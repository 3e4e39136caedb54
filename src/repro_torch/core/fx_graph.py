"""Extract the paper's graph ``G = (V, E)`` from a torch function traced with
``make_fx`` (port of ``repro/core/jaxpr_graph.py``; the aten graph takes the
place of the jaxpr).

The function is traced with ``make_fx(tracing_mode="fake")``: every tensor
is a fake tensor with shape, dtype and device only, so tracing a model at
full width allocates nothing on the card.  One graph node per aten op that
allocates, ``M_v`` = the bytes of its outputs; an edge (v, w) when w reads
an output of v.  Graph inputs (parameters, batch) are not nodes (§2).

Rules, and where they differ from the reference:

* The trace is functionalized (``torch.func.functionalize``, mutations
  removed), as a jaxpr is functional: an in-place op becomes its
  out-of-place twin (dropout's ``bernoulli_`` becomes ``bernoulli``), so
  every node owns its value and recomputing one never writes a cached one.
  A write to an input becomes a ``copy_`` into its placeholder at the end
  of the graph, which the effect analysis classes effectful.  Functions
  that mutate nothing trace to the same graph either way.

* ``getitem`` folds into its multi-output producer, whose ``M_v`` is the sum
  of its outputs: one node per equation, as in the reference.
* **Divergence.**  Aliasing views (``view``, ``_unsafe_view``, ``t``,
  ``transpose``, ``permute``, ``expand``, ``unsqueeze``, ``slice``, …;
  ``prims.ATEN_VIEW_OPS``) fold into the node of their base: they share its
  storage, so storing one costs no bytes and recomputing one costs no work.
  The reference keeps ``reshape``/``transpose`` as nodes.  A view of a graph
  input is no node either.
* Ops that allocate nothing (``prims.ATEN_NO_ALLOC``) are no nodes.
* ``kind`` is the reference's primitive name where ``prims.ATEN_KINDS``
  maps the op (``mm`` → ``dot_general``, ``sum`` → ``reduce_sum``, …), so a
  torch twin of a JAX function has the same ``graph_digest``; other ops
  keep their aten name.  The flash-attention custom op is one node of kind
  ``flash_attention``.

Cost models, as in the reference: ``"paper"`` (T_v = 10 for the matmul/conv
family and the flash op, 1 otherwise) and ``"flops"`` (matmul 2·M·N·K,
convolution 2·out·Cin·k, flash attention 4·B·H·Sq·Sk·D, halved when causal,
elementwise = output elements).

``M_v`` is **per device** when a mesh and input shardings are given (the
paper's budget B is the memory of one accelerator, §3), as in the
reference: specs are propagated through the aten graph
(``repro_torch.parallel.sharding.propagate_node_specs``, conservative
replicated fallback) and each node's bytes are its outputs' ceil-divided
shard bytes; under ``"flops"`` the same shard count divides ``T_v``.  The
mesh is a ``DeviceMesh`` or a plain ``{axis: size}`` dict (no process
group needed for planning).  The trace itself is always of the global
function: DTensor arguments are traced as fake tensors of their global
shape.
"""

from __future__ import annotations

import contextvars
import dataclasses
import operator
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch import fx
from torch.fx.experimental.proxy_tensor import make_fx

from .graph import Graph, Node
from .prims import (ATEN_HEAVY, ATEN_KINDS, ATEN_NO_ALLOC, ATEN_VIEW_OPS, FLASH_BWD_OP, FLASH_OP,
                    SHARD_OP, VOCAB_EMBED_OP, VOCAB_PICK_OP)


def op_name(target: Any) -> str:
    """Schema name of an op: ``mm`` for ``aten::mm``, the qualified name for
    other namespaces, the Python name for other callables."""
    schema = getattr(target, "_schema", None)
    if schema is None:
        return getattr(target, "__name__", str(target))
    name = schema.name
    return name[len("aten::"):] if name.startswith("aten::") else name


def _tensors(val: Any) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(val) if isinstance(t, torch.Tensor)]


def tensor_bytes(val: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(val))


def node_flops(node: fx.Node) -> float:
    """Analytic FLOPs of one aten op, from the fake values of the trace."""
    name = op_name(node.target)
    out = _tensors(node.meta.get("val"))
    args = [a.meta.get("val") if isinstance(a, fx.Node) else a for a in node.args]
    if name in ("mm", "bmm", "addmm"):
        lhs = args[1] if name == "addmm" else args[0]
        return float(2 * out[0].numel() * lhs.shape[-1])
    if name == "convolution":
        w = args[1]
        return float(2 * out[0].numel() * (w.numel() // w.shape[0]))
    if name in (FLASH_OP, FLASH_BWD_OP):
        # the forward's two (Sq, Sk) products; the backward's five (S and
        # dP recomputed, dV, dQ, dK); a causal mask halves each
        q, k, causal = args[0], args[1], args[3 if name == FLASH_OP else 7]
        B, Sq, H, D = q.shape
        flops = (4 if name == FLASH_OP else 10) * B * H * Sq * k.shape[1] * D
        return float(flops // 2 if causal else flops)
    return float(max(1, sum(t.numel() for t in out)))


def fx_totals(gm: fx.GraphModule) -> Dict[str, float]:
    """Global FLOPs and byte traffic of a traced step, the twin of the
    reference's ``jaxpr_totals``: each op's :func:`node_flops` and its
    input and output bytes (``getitem`` is no op).  ``heavy_flops`` is the
    share of the matmuls, convolutions and flash attention."""
    flops = nbytes = heavy = 0.0
    for node in gm.graph.nodes:
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        f = node_flops(node)
        flops += f
        if op_name(node.target) in ATEN_HEAVY or op_name(node.target) == FLASH_BWD_OP:
            heavy += f
        ins = [a.meta.get("val") for a in node.all_input_nodes]
        nbytes += sum(tensor_bytes(v) for v in ins) + tensor_bytes(node.meta.get("val"))
    return {"flops": flops, "bytes": nbytes, "heavy_flops": heavy}


@dataclasses.dataclass
class FxGraph:
    """The extracted graph plus the mapping back to the fx trace."""

    graph: Graph
    nodes: List[fx.Node]  # graph node idx → the fx node that computes it
    gm: fx.GraphModule
    #: every fx node → the graph node it belongs to (folded views and
    #: getitems map to their base's node; inputs and views of inputs to None)
    owner: Dict[fx.Node, Optional[int]]
    #: per-graph-node output specs when traced under a mesh (aligned with
    #: ``nodes``; None for an unsharded trace)
    node_specs: Optional[List[Tuple]] = None
    #: mesh axis name → size of a sharded trace ({} otherwise): lets the
    #: verifier re-derive per-device bytes
    axis_sizes: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def output(self) -> fx.Node:
        """The fx node the traced function returns (a scalar for planning)."""
        out = next(n for n in self.gm.graph.nodes if n.op == "output")
        return pytree.tree_leaves(out.args[0])[0]

    def run_node(self, node: fx.Node, read: Callable[[fx.Node], Any]) -> Any:
        """Execute one fx node, reading its operands with ``read`` (a
        sharding constraint through ``parallel.constraint.constrain``,
        which redistributes a DTensor, a vocab lookup through
        ``parallel.vocab``, which runs on a DTensor's local shards, and the
        flash op through ``kernels.ops.flash_attention_on_mesh``, which
        brings GQA's whole KV heads to q's split ones)."""
        if node.op == "get_attr":
            return operator.attrgetter(node.target)(self.gm)
        args, kwargs = fx.node.map_arg((node.args, node.kwargs), read)
        name = op_name(node.target)
        if name == SHARD_OP:
            from ..parallel.constraint import constrain

            return constrain(*args, **kwargs)
        if name == FLASH_OP:
            from ..kernels.ops import flash_attention_on_mesh

            return flash_attention_on_mesh(*args, **kwargs)
        if name in (VOCAB_EMBED_OP, VOCAB_PICK_OP):
            from ..parallel import vocab

            return (vocab.embed_rows if name == VOCAB_EMBED_OP else vocab.pick)(*args, **kwargs)
        return node.target(*args, **kwargs)


def is_view(node: fx.Node) -> bool:
    """Whether an fx node aliases its first operand (a view op or getitem)."""
    return node.target is operator.getitem or op_name(node.target) in ATEN_VIEW_OPS


def node_memory(val: Any, specs: Optional[Tuple] = None,
                axis_sizes: Optional[Dict[str, int]] = None) -> Tuple[int, int]:
    """(M_v, shard count) of a node's output values: whole bytes, or with
    ``specs`` the per-device bytes and the largest number of devices any
    output is split across."""
    if specs is None:
        return tensor_bytes(val) or 1, 1
    from ..parallel import sharding as sh

    mem, shards = 0, 1
    for t, sp in zip(_tensors(val), specs):
        mem += sh.sharded_aval_bytes(t, sp, axis_sizes)
        shards = max(shards, sh.num_shards(tuple(t.shape), sp, axis_sizes))
    return mem or 1, shards


def from_graph_module(gm: fx.GraphModule, cost_model: str = "paper", mesh: Any = None,
                      in_specs: Optional[List[Tuple]] = None) -> FxGraph:
    """Build the paper's G=(V,E) from a make_fx GraphModule; with ``mesh``,
    ``in_specs`` (one spec per placeholder, None: all replicated) makes
    ``M_v`` per-device bytes."""
    if cost_model not in ("paper", "flops"):
        raise ValueError(f"unknown cost_model {cost_model!r}")
    fx_specs, axis_sizes = None, {}
    if mesh is not None:
        from ..parallel import sharding as sh

        axis_sizes = sh.axis_sizes_of(mesh)
        n_in = sum(1 for n in gm.graph.nodes if n.op == "placeholder")
        fx_specs = sh.propagate_node_specs(gm, in_specs or [()] * n_in, axis_sizes)
    node_specs: Optional[List[Tuple]] = [] if fx_specs is not None else None
    owner: Dict[fx.Node, Optional[int]] = {}
    nodes: List[Node] = []
    producers: List[fx.Node] = []
    edges: List[Tuple[int, int]] = []
    for n in gm.graph.nodes:
        if n.op in ("placeholder", "get_attr"):
            owner[n] = None
            continue
        if n.op != "call_function":
            continue
        if is_view(n):
            owner[n] = owner[n.args[0]]
            continue
        name = op_name(n.target)
        if name in ATEN_NO_ALLOC:
            owner[n] = None
            continue
        idx = len(nodes)
        specs = fx_specs[n] if fx_specs is not None else None
        mem, shards = node_memory(n.meta.get("val"), specs, axis_sizes)
        if node_specs is not None:
            node_specs.append(specs)
        if cost_model == "paper":
            t = 10.0 if name in ATEN_HEAVY else 1.0
        else:
            # per-shard FLOPs: an output split k ways costs each device 1/k
            t = max(node_flops(n) / shards, 1.0) if shards > 1 else node_flops(n)
        kind = ATEN_KINDS.get(name, name)
        nodes.append(Node(idx=idx, name=f"{idx}:{kind}", time=t, memory=float(mem),
                          kind=kind))
        producers.append(n)
        owner[n] = idx
        for a in n.all_input_nodes:
            src = owner.get(a)
            if src is not None:
                edges.append((src, idx))
    return FxGraph(graph=Graph(nodes, edges), nodes=producers, gm=gm, owner=owner,
                   node_specs=node_specs, axis_sizes=axis_sizes)


#: True while ``trace_module`` traces.  Model code that places its own
#: ``torch.utils.checkpoint`` leaves it out then (``models.layers.
#: checkpointed``): the plan decides what the traced graph recomputes, and
#: functionalization has no rule for the autograd.Function that a
#: non-reentrant checkpoint applies in some torch versions (2.11 raises
#: "NYI: Functionalize rule for custom_function_call").
_TRACING: contextvars.ContextVar[bool] = contextvars.ContextVar("fx_tracing", default=False)


def tracing() -> bool:
    """Whether ``trace_module`` is tracing in this context."""
    return _TRACING.get()


def trace_module(fn: Callable[..., Any], *example_args: Any, mesh: Any = None) -> fx.GraphModule:
    """``make_fx`` in fake mode (shapes, dtypes and devices only) of the
    functionalized ``fn``.  With a ``mesh`` that splits more than the batch,
    the models' sharding constraints (``parallel.sharding.shard``) are
    traced as ``repro_torch::shard`` nodes."""
    from ..parallel.sharding import tracing_on

    functional = torch.func.functionalize(fn, remove="mutations")
    token = _TRACING.set(True)
    try:
        with tracing_on(mesh):
            return make_fx(functional, tracing_mode="fake")(*example_args)
    finally:
        _TRACING.reset(token)


def global_fakes(args: Any) -> Any:
    """DTensor leaves of ``args`` → fake tensors of their global shape on
    their local device (the function is traced globally, as the reference
    traces global avals); other leaves unchanged."""
    from torch.distributed.tensor import DTensor

    if not any(isinstance(t, DTensor) for t in pytree.tree_leaves(args)):
        return args
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(t):
        if isinstance(t, DTensor):
            with mode:
                return torch.empty(t.shape, dtype=t.dtype, device=t.device)
        return mode.from_tensor(t) if isinstance(t, torch.Tensor) else t

    return pytree.tree_map(fake, args)


def trace(fn: Callable[..., Any], *example_args: Any, cost_model: str = "paper",
          mesh: Any = None, in_shardings: Optional[List[Any]] = None) -> FxGraph:
    """Trace ``fn`` on example tensors (or pytrees of them).

    With ``mesh`` (a ``DeviceMesh`` or an ``{axis: size}`` dict),
    ``in_shardings`` is one spec per flat tensor leaf of ``example_args``
    (None: all replicated) and node ``M_v`` becomes per-device bytes."""
    gm = trace_module(fn, *global_fakes(example_args), mesh=mesh)
    return from_graph_module(gm, cost_model=cost_model, mesh=mesh,
                             in_specs=None if in_shardings is None
                             else [tuple(s or ()) for s in in_shardings])
