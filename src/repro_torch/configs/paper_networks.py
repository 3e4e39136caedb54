"""Graph abstractions of the paper's seven benchmark networks (§5, Table 1),
a copy of the reference's ``benchmarks/networks.py``, and their executable
torch twin.

The builders are the reference's, node for node (``graph_digest`` equal):
each architecture's connectivity (residual blocks, dense blocks, U-skips,
inception branches, pyramid pooling), ``T_v`` the paper's 10/1 conv cost
model, ``M_v`` the activation bytes at the paper's input resolutions and
batch sizes (``SETTINGS``, Table 1's Batch column).  ``PAPER_NODE_COUNTS``
is Table 1's #V column; as in the reference, densenet161 and pspnet build
478 and 196 nodes against its 568 and 385.

:func:`executable_twin` is the torch twin of the reference's
``executable_twin``: the same topology on ``(batch, width)`` f32
activations.  :func:`twin_value_and_grad` runs it as a ``BlockGraph`` of
one block per abstract node, named as the node, either as plain autograd
or under an abstract plan through the ``"policy"`` backend
(``core.lowering.policy``): the plan's cached set becomes the policy's
names, as the reference's ``checkpoint_name`` tags and
``save_only_these_names`` carry it, with no planning of the twin itself.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.graph import Graph, Node

# (input_hw, batch) per Table 1
SETTINGS = {
    "vgg19": (224, 64),
    "resnet50": (224, 96),
    "resnet152": (224, 48),
    "densenet161": (224, 32),
    "googlenet": (224, 256),
    "unet": (572, 8),
    "pspnet": (713, 2),
}


class _B:
    """Tiny builder: nodes carry (kind, channels, hw); M_v = 4·B·C·H·W."""

    def __init__(self, batch: int):
        self.batch = batch
        self.nodes: List[Node] = []
        self.edges: List[Tuple[int, int]] = []

    def add(self, kind: str, c: int, hw: float, *preds: int) -> int:
        idx = len(self.nodes)
        mem = 4.0 * self.batch * c * hw * hw
        t = 10.0 if kind == "conv" else 1.0
        self.nodes.append(Node(idx, f"{idx}:{kind}", t, max(mem, 1.0), kind))
        for p in preds:
            self.edges.append((p, idx))
        return idx

    def cbr(self, c: int, hw: float, *preds: int) -> int:
        """conv → bn → relu (the paper's node granularity: each op a node)."""
        conv = self.add("conv", c, hw, *preds)
        bn = self.add("bn", c, hw, conv)
        return self.add("relu", c, hw, bn)

    def graph(self) -> Graph:
        return Graph(self.nodes, self.edges)


def vgg19() -> Graph:
    """16 conv + 3 FC with relu/pool interleaved → 46 nodes, pure chain."""
    b = _B(SETTINGS["vgg19"][1])
    plan = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]
    hw = 224
    prev = b.add("input_stem", 3, hw)
    for c, reps in plan:
        for _ in range(reps):
            conv = b.add("conv", c, hw, prev)
            prev = b.add("relu", c, hw, conv)
        hw //= 2
        prev = b.add("pool", c, hw, prev)
    for i, c in enumerate((4096, 4096, 1000)):
        fc = b.add("conv", c, 1, prev)  # FC ~ heavy
        prev = b.add("relu", c, 1, fc) if i < 2 else fc
    g = b.graph()
    return g


def _resnet(layers: Tuple[int, ...], name: str) -> Graph:
    batch = SETTINGS[name][1]
    b = _B(batch)
    hw = 56
    prev = b.add("conv", 64, 112)  # stem
    prev = b.add("pool", 64, hw, prev)
    c_in = 64
    for stage, blocks in enumerate(layers):
        c = 64 * (2**stage)
        for blk in range(blocks):
            if blk == 0 and stage > 0:
                hw //= 2
            identity = prev
            x = b.cbr(c, hw, prev)
            x = b.cbr(c, hw, x)
            x = b.add("conv", c * 4, hw, x)
            x = b.add("bn", c * 4, hw, x)
            # projection shortcut on first block of each stage
            if blk == 0:
                identity = b.add("conv", c * 4, hw, identity)
                identity = b.add("bn", c * 4, hw, identity)
            add = b.add("add", c * 4, hw, x, identity)
            prev = b.add("relu", c * 4, hw, add)
    return b.graph()


def resnet50() -> Graph:
    return _resnet((3, 4, 6, 3), "resnet50")


def resnet152() -> Graph:
    return _resnet((3, 8, 36, 3), "resnet152")


def densenet161() -> Graph:
    """Dense blocks: every layer consumes the concat of all previous ones."""
    b = _B(SETTINGS["densenet161"][1])
    hw = 56
    prev = b.add("conv", 96, 112)
    prev = b.add("pool", 96, hw, prev)
    growth = 48
    c = 96
    for stage, n_layers in enumerate((6, 12, 36, 24)):
        block_feats = [prev]
        for _ in range(n_layers):
            bn1 = b.add("bn", c, hw, *block_feats)  # reads the concat
            r1 = b.add("relu", c, hw, bn1)
            cv1 = b.add("conv", 4 * growth, hw, r1)  # 1x1
            bn2 = b.add("bn", 4 * growth, hw, cv1)
            r2 = b.add("relu", 4 * growth, hw, bn2)
            new = b.add("conv", growth, hw, r2)  # 3x3
            block_feats.append(new)
            c += growth
        if stage < 3:
            trans = b.add("conv", c // 2, hw, *block_feats)
            hw //= 2
            prev = b.add("pool", c // 2, hw, trans)
            c = c // 2
        else:
            prev = b.add("pool", c, 1, *block_feats)  # global pool
    b.add("conv", 1000, 1, prev)
    return b.graph()


def googlenet() -> Graph:
    """Inception modules: 4 parallel branches re-joined by concat."""
    b = _B(SETTINGS["googlenet"][1])
    hw = 28
    prev = b.add("conv", 64, 112)
    prev = b.add("conv", 192, 56, prev)
    prev = b.add("pool", 192, hw, prev)
    inception = [(64, 128, 32, 32), (128, 192, 96, 64), None,  # pool
                 (192, 208, 48, 64), (160, 224, 64, 64), (128, 256, 64, 64),
                 (112, 288, 64, 64), (256, 320, 128, 128), None,
                 (256, 320, 128, 128), (384, 384, 128, 128)]
    for spec in inception:
        if spec is None:
            hw //= 2
            prev = b.add("pool", 480, hw, prev)
            continue
        c1, c3, c5, cp = spec
        br1 = b.cbr(c1, hw, prev)
        br3a = b.cbr(c3 // 2, hw, prev)
        br3 = b.cbr(c3, hw, br3a)
        br5a = b.cbr(c5 // 2, hw, prev)
        br5 = b.cbr(c5, hw, br5a)
        brp_p = b.add("pool", 192, hw, prev)
        brp = b.cbr(cp, hw, brp_p)
        prev = b.add("concat", c1 + c3 + c5 + cp, hw, br1, br3, br5, brp)
    prev = b.add("pool", 1024, 1, prev)
    b.add("conv", 1000, 1, prev)
    return b.graph()


def unet() -> Graph:
    """Contracting path + expanding path with long skip connections."""
    b = _B(SETTINGS["unet"][1])
    hw = 568
    prev = None
    skips = []
    chans = (64, 128, 256, 512)
    # down
    for c in chans:
        cv = b.add("conv", c, hw, *( [prev] if prev is not None else [] ))
        prev = b.add("relu", c, hw, cv)
        cv = b.add("conv", c, hw, prev)
        prev = b.add("relu", c, hw, cv)
        skips.append(prev)
        hw //= 2
        prev = b.add("pool", c, hw, prev)
    # bottom
    cv = b.add("conv", 1024, hw, prev)
    prev = b.add("relu", 1024, hw, cv)
    cv = b.add("conv", 1024, hw, prev)
    prev = b.add("relu", 1024, hw, cv)
    # up
    for c, skip in zip(reversed(chans), reversed(skips)):
        hw *= 2
        up = b.add("conv", c, hw, prev)  # up-conv
        cat = b.add("concat", 2 * c, hw, up, skip)
        cv = b.add("conv", c, hw, cat)
        prev = b.add("relu", c, hw, cv)
        cv = b.add("conv", c, hw, prev)
        prev = b.add("relu", c, hw, cv)
    b.add("conv", 2, hw, prev)
    return b.graph()


def pspnet() -> Graph:
    """ResNet50 dilated backbone + pyramid pooling with global skips."""
    batch = SETTINGS["pspnet"][1]
    b = _B(batch)
    hw = 90  # 713/8 dilated output stride
    prev = b.add("conv", 64, 357)
    prev = b.add("pool", 64, 179, prev)
    c_in = 64
    for stage, blocks in enumerate((3, 4, 6, 3)):
        c = 64 * (2**stage)
        s_hw = 90 if stage >= 1 else 179
        for blk in range(blocks):
            identity = prev
            x = b.cbr(c, s_hw, prev)
            x = b.cbr(c, s_hw, x)
            x = b.add("conv", c * 4, s_hw, x)
            x = b.add("bn", c * 4, s_hw, x)
            if blk == 0:
                identity = b.add("conv", c * 4, s_hw, identity)
                identity = b.add("bn", c * 4, s_hw, identity)
            add = b.add("add", c * 4, s_hw, x, identity)
            prev = b.add("relu", c * 4, s_hw, add)
    backbone = prev
    # pyramid pooling: 4 scales, each pool→conv→upsample, concat with backbone
    pools = []
    for scale in (1, 2, 3, 6):
        p = b.add("pool", 2048, scale, backbone)
        cv = b.cbr(512, scale, p)
        up = b.add("upsample", 512, 90, cv)
        pools.append(up)
    cat = b.add("concat", 2048 + 4 * 512, 90, backbone, *pools)
    x = b.cbr(512, 90, cat)
    x = b.add("conv", 150, 90, x)
    b.add("upsample", 150, 713, x)
    # aux head off stage-3 (extra cross edge, as in the real PSPNet)
    return b.graph()


def executable_twin(g: Graph, batch: int = 4, width: int = 16, device=None):
    """A small *runnable* torch twin of an abstract benchmark graph.

    Same topology, toy shapes: every node carries a ``(batch, width)`` f32
    activation.  A node first takes its input ``h``: ``x · (1 + 0.003 v)``
    for a source, its predecessor's output for one predecessor, the mean of
    the stacked outputs (``torch.stack(...).mean(0)``) for several.  A
    ``conv`` node then applies ``h @ params[str(v)]``, a ``(width, width)``
    ``torch.matmul`` (one heavy op each, mirroring the 10/1 cost model);
    every other node ``tanh(h) · (1 + 0.003 v)``.  The loss is Σ over the
    sinks of ``sum(h²)``.  Per-node distinct constants keep sibling
    branches distinct, as in the reference.

    Returns ``(fwd, (params, x), byte_graph)``: ``fwd(params, x)`` the loss
    with the nodes in index order; concrete example arguments on ``device``
    (the CPU by default) drawn from a ``torch.Generator`` of that device
    seeded 0 (standard normal, the weights scaled by ``width ** -0.5``);
    and the abstract topology re-priced so every node's ``M_v`` is the
    twin's activation bytes ``4 · batch · width`` — the graph to evaluate
    analytic peaks on when comparing against the twin's measured memory.
    """
    import torch

    dev = torch.device(device if device is not None else "cpu")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {str(v): torch.randn(width, width, generator=gen, device=dev) * width ** -0.5
              for v in range(g.n) if g.nodes[v].kind == "conv"}
    x = torch.randn(batch, width, generator=gen, device=dev)
    nbytes = 4.0 * batch * width
    byte_nodes = [Node(nd.idx, nd.name, nd.time, nbytes, nd.kind) for nd in g.nodes]
    return _twin_forward(g, range(g.n)), (params, x), Graph(byte_nodes, g.edges)


def _node_fn(g: Graph, v: int, now: List[Optional[int]]) -> Callable[..., Any]:
    """Node ``v`` as one autograd op, ``apply(weight, *inputs)`` (its input
    is ``x`` for a source, its weight None unless a ``conv``).

    Its backward reads what the paper's node reads, its inputs and its
    weight: the op saves only those and makes again in its backward what
    it made inside (the mean of several inputs, the tanh under the scale),
    as the reference's twin lets XLA rematerialize every untagged value.
    The derivative formulas are torch's own for the same ops (``mm``'s,
    ``tanh_backward``, the scale's product, the mean's expand-and-divide),
    so the gradients are bitwise those of the ops under plain autograd.
    ``now[0]`` is ``v`` while the op that makes the node's value runs —
    the value the reference tags with ``checkpoint_name``."""
    import torch

    kind, k = g.nodes[v].kind, len(g.pred[v])
    c = 1.0 + 0.003 * v

    def mix(ins):
        if k == 0:
            return ins[0] * c
        return ins[0] if k == 1 else torch.stack(ins).mean(0)

    class NodeOp(torch.autograd.Function):
        @staticmethod
        def forward(ctx, w, *ins):
            h = mix(ins)
            if kind != "conv":
                h = torch.tanh(h)
            ctx.save_for_backward(w, *ins)
            now[0] = v
            try:
                return torch.matmul(h, w) if kind == "conv" else h * c
            finally:
                now[0] = None

        @staticmethod
        def backward(ctx, gy):
            w, *ins = ctx.saved_tensors
            need_w, need_in = ctx.needs_input_grad[0], any(ctx.needs_input_grad[1:])
            h = mix(ins)
            gw = gh = None
            if kind == "conv":
                gw = h.t().mm(gy) if need_w else None
                gh = gy.mm(w.t()) if need_in else None
            elif need_in:
                gh = torch.ops.aten.tanh_backward(gy * c, torch.tanh(h))
            if gh is not None:
                gh = gh * c if k == 0 else gh if k == 1 else gh / k
            return (gw, *[gh if need else None for need in ctx.needs_input_grad[1:]])

    def apply(w, *ins):
        return NodeOp.apply(w if kind == "conv" else None, *ins)

    return apply


def _loss(*sinks: Any) -> Any:
    out = 0.0
    for h in sinks:
        out = out + (h * h).sum()
    return out


def _twin_forward(g: Graph, order: Sequence[int],
                  now: Optional[List[Optional[int]]] = None) -> Callable[..., Any]:
    """The twin's loss ``fwd(params, x)``, its nodes made in ``order``."""
    now = [None] if now is None else now
    fns = [_node_fn(g, v, now) for v in range(g.n)]
    sinks = [v for v in range(g.n) if not g.succ[v]]

    def fwd(params, x):
        vals: Dict[int, Any] = {}
        for v in order:
            vals[v] = fns[v](params.get(str(v)), *([vals[p] for p in g.pred[v]] or [x]))
        return _loss(*[vals[s] for s in sinks])

    return fwd


def twin_blockgraph(g: Graph) -> Tuple[Any, List[Optional[int]]]:
    """The twin as a ``BlockGraph``: one block per abstract node, named as
    the node (input ``"x"`` for a source; parameter the node's weight for a
    ``conv``, ``{}`` else), the sinks as outputs.  Returns ``(bg, now)``,
    ``now[0]`` the node whose value is being made (None between values)."""
    from repro_torch.core.blockgraph import Block, BlockGraph

    now: List[Optional[int]] = [None]
    blocks = [Block(name=nd.name, apply=_node_fn(g, v, now),
                    inputs=tuple(g.nodes[p].name for p in g.pred[v]) or ("x",),
                    heavy=nd.kind == "conv")
              for v, nd in enumerate(g.nodes)]
    return BlockGraph(blocks, ["x"], [nd.name for nd in g.nodes if not g.succ[nd.idx]]), now


def plan_order(plan: Any) -> List[int]:
    """The nodes in the order a plan's forward makes them, segment by
    segment."""
    return [v for seg in plan.segments for v in seg.nodes]


def twin_value_and_grad(g: Graph, plan: Any = None,
                        order: Optional[Sequence[int]] = None) -> Callable[..., Any]:
    """``f(params, x) -> (loss, grads)`` of :func:`executable_twin`'s loss,
    the grads keyed as ``params``.

    With ``plan`` (an ``ExecutionPlan`` of ``g``) the twin runs as
    :func:`twin_blockgraph` and the plan is lowered by the ``"policy"``
    backend (``core.lowering.policy.apply_with_policy``):
    one selective checkpoint region a segment keeps the values of the
    plan's cached nodes and reruns everything else in the backward.
    ``f.node_now()`` is the node whose value the twin is making, the hook
    by which ``analysis.census.analyze_twin`` attributes recompute: a
    cached node's value is handed back by the policy and its op never runs
    again, while the ops before it (the tanh under its scale, the mean of
    its inputs) rerun, as the reference's policy rematerializes every
    untagged value.

    Without ``plan``: plain autograd, the nodes made in ``order`` (default
    index order).  Plain autograd in :func:`plan_order` is the planned
    twin's bitwise reference: autograd sums a gradient that several readers
    send in the order of their forward ops.
    """
    import torch

    from repro_torch.core.lowering.base import blockgraph_value_and_grad
    from repro_torch.core.lowering.policy import apply_with_policy

    if plan is None:
        now: List[Optional[int]] = [None]
        fwd = _twin_forward(g, range(g.n) if order is None else order, now)

        def run(params, x):
            leaves = {k: w.detach().requires_grad_() for k, w in params.items()}
            loss = fwd(leaves, x)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            return loss.detach(), dict(zip(leaves, grads))
    else:
        bg, now = twin_blockgraph(g)
        planned = blockgraph_value_and_grad(
            lambda p, inputs: apply_with_policy(bg, p, inputs, plan), _loss)
        names = [nd.name for nd in g.nodes]

        def run(params, x):
            loss, grads = planned({names[v]: params.get(str(v), {}) for v in range(g.n)},
                                  {"x": x})
            return loss, {k: grads[names[int(k)]] for k in params}

    run.node_now = lambda: now[0]
    return run


NETWORKS = {
    "vgg19": vgg19,
    "resnet50": resnet50,
    "resnet152": resnet152,
    "densenet161": densenet161,
    "googlenet": googlenet,
    "unet": unet,
    "pspnet": pspnet,
}

PAPER_NODE_COUNTS = {
    "pspnet": 385, "unet": 60, "resnet50": 176, "resnet152": 516,
    "vgg19": 46, "densenet161": 568, "googlenet": 134,
}
