"""Logical-axis sharding rules (DP/TP/EP/SP over ("pod", "data", "model")):
port of ``repro/parallel/sharding.py``.

Models name tensor dims by *logical* axis; a rules table maps them to mesh
axes.  A partition spec is a plain tuple with one entry per dim (``None``,
an axis name, or a tuple of axis names), the entries of the reference's
``PartitionSpec``.  Two halves:

* **Bytes** (no devices): the rules table, ``resolve_spec``, the
  per-device byte accounting (``local_shape``/``local_bytes``) and the
  conservative spec propagation over an aten fx graph
  (:func:`propagate_node_specs`, the twin of ``propagate_eqn_specs``).
  The planners price per-device ``M_v`` through these, on a plain
  ``{axis: size}`` dict or a ``DeviceMesh``.
* **Placements** (a concrete ``torch.distributed`` ``DeviceMesh``): a spec
  becomes one DTensor placement per mesh dim (:func:`spec_to_placements`:
  ``Shard(d)`` for the dim an axis shards, ``Replicate()`` otherwise), and
  back (:func:`normalize_spec`); :func:`shard` is the reference's
  sharding constraint, a DTensor ``redistribute``; :func:`named_sharding_tree`
  gives a parameter tree's placements, as the reference's
  ``NamedSharding`` tree.
"""

from __future__ import annotations

import contextlib
import contextvars
import operator
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

#: A partition spec: one entry per dim — None, an axis name, or a tuple.
Spec = Tuple[Any, ...]

Rules = Dict[str, Any]  # logical name -> mesh axis (str | tuple | None)

DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": "data",
    "seq_act": "model",  # Megatron-style sequence parallelism: the residual
    #                      stream between layer groups lives S/tp per device
    "model": None,
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "experts": "model",
    "expert_cap": "model",  # fallback: shard expert capacity rows when the
    #                         expert count doesn't divide the model axis
    "vocab": "model",
    "state": None,
}

# §Perf hillclimb alternative: NO tensor parallelism — the "model" mesh axis
# joins data parallelism and params are fully sharded (ZeRO-3).  For models
# whose per-chip matmul shards would be tiny under tp=16 (≤ ~4B params at 256
# chips), this removes every activation-cotangent all-reduce and replaces it
# with per-layer weight all-gathers an order of magnitude smaller.
DP_ONLY_RULES: Rules = {
    **DEFAULT_RULES,
    "batch": ("pod", "data", "model"),
    "seq_act": None,
    "heads": None,
    "kv_heads": None,
    "ffn": None,
    "experts": None,
    "expert_cap": None,
    "vocab": None,
}

# MoE hybrid: attention/dense parts ZeRO-sharded over data (no TP — their
# per-chip shards are tiny next to the experts), experts stay EP over the
# model axis with the all-to-all schedule.
DP_ATTN_RULES: Rules = {
    **DEFAULT_RULES,
    "seq_act": None,
    "heads": None,
    "kv_heads": None,
    "ffn": None,
    # vocab stays TP over "model": un-sharding it makes every chip hold the
    # full (B_loc, S, V) logits — 40 GB/chip at this cell's shape.
}

# Active rules — module-level as in the reference; the launchers read them.
_ACTIVE_RULES: Rules = dict(DEFAULT_RULES)


def set_rules(rules: Rules) -> None:
    global _ACTIVE_RULES
    _ACTIVE_RULES = dict(rules)


def get_rules() -> Rules:
    return dict(_ACTIVE_RULES)


def resolve_spec(
    logical: Sequence[Optional[str]],
    axis_sizes: Dict[str, int],
    shape: Optional[Sequence[int]] = None,
    rules: Optional[Rules] = None,
    pad_dims: Sequence[int] = (),
) -> Spec:
    """Logical names → partition spec under ``rules`` and abstract axis sizes.

    The mesh-free core of the reference's ``resolve``, shared with the
    planners' byte accounting (``launch.plan`` budgets per-device bytes
    through this exact function).  The spec is a plain tuple with one entry
    per dim (``None``, an axis name, or a tuple of axis names), the same
    entries as the reference's ``PartitionSpec``.

    With ``shape``, divisibility is checked inline so an axis rejected on one
    dim (e.g. "model" on 40 experts) stays available for a later dim (e.g.
    the expert-capacity fallback) instead of being consumed and dropped.
    Dims listed in ``pad_dims`` skip the divisibility check — GSPMD pads
    those (sequence dims at odd lengths), and ``local_shape``'s ceil
    division accounts the padded shard.
    """
    rules = _ACTIVE_RULES if rules is None else rules
    axes = set(axis_sizes)
    pad = set(pad_dims)
    used: set = set()
    spec = []
    for i, name in enumerate(logical):
        if name is None:
            spec.append(None)
            continue
        target = rules.get(name)
        if target is None:
            spec.append(None)
            continue
        if isinstance(target, str):
            target = (target,)
        eff = []
        dim = shape[i] if shape is not None and i < len(shape) else None
        prod = 1
        for a in target:
            if a not in axes or a in used:
                continue
            if (dim is not None and i not in pad
                    and dim % (prod * axis_sizes.get(a, 1)) != 0):
                continue  # this axis would not divide — leave it available
            eff.append(a)
            prod *= axis_sizes.get(a, 1)
        used.update(eff)
        eff = tuple(eff)
        spec.append(eff if len(eff) > 1 else (eff[0] if eff else None))
    return tuple(spec)


def axis_sizes_of(mesh) -> Dict[str, int]:
    """Axis-name → size for a ``DeviceMesh``, or a dict passed through.

    Accepting a plain ``{"data": 8, "model": 2}`` dict lets the byte
    accounting (and with it the whole planning pipeline) run without any
    process group — only the lowerings need a concrete ``DeviceMesh``.
    """
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(
            f"expected an {{axis: size}} dict or a DeviceMesh with dim names, "
            f"got {type(mesh).__name__}")
    return {str(n): int(k) for n, k in zip(names, mesh.shape)}


def is_device_mesh(mesh: Any) -> bool:
    """Whether ``mesh`` is a concrete ``DeviceMesh`` (a dict is not)."""
    return mesh is not None and not isinstance(mesh, dict) and hasattr(mesh, "mesh_dim_names")


def _entry_shards(entry, axis_sizes: Dict[str, int]) -> int:
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    k = 1
    for a in axes:
        k *= max(1, int(axis_sizes.get(a, 1)))
    return k


def local_shape(
    shape: Sequence[int], spec, axis_sizes: Dict[str, int]
) -> Tuple[int, ...]:
    """Per-device shard shape of a global ``shape`` under ``spec``.

    GSPMD semantics: each sharded dim is ceil-divided by the product of its
    mesh axis sizes (padding counts — padded shards still occupy HBM).
    """
    entries = tuple(spec) if spec is not None else ()
    entries = entries + (None,) * (len(shape) - len(entries))
    return tuple(
        -(-int(d) // _entry_shards(e, axis_sizes))
        for d, e in zip(shape, entries)
    )


def num_shards(shape: Sequence[int], spec, axis_sizes: Dict[str, int]) -> int:
    """Effective #devices a tensor is split across: global/local elems."""
    loc = local_shape(shape, spec, axis_sizes)
    g = l = 1
    for d, ld in zip(shape, loc):
        g *= max(1, int(d))
        l *= max(1, int(ld))
    return max(1, g // max(1, l))


def local_bytes(
    shape: Sequence[int], spec, axis_sizes: Dict[str, int], itemsize: int
) -> int:
    """Per-device bytes of one tensor (ceil-divided shard × itemsize)."""
    n = 1
    for d in local_shape(shape, spec, axis_sizes):
        n *= max(1, int(d))
    return n * int(itemsize)


def resolve(
    logical: Sequence[Optional[str]],
    mesh: Any = None,
    shape: Optional[Sequence[int]] = None,
) -> Spec:
    """Logical names → partition spec under the active rules and ``mesh``'s
    axes (a ``DeviceMesh`` or an ``{axis: size}`` dict).  The reference
    reads an ambient mesh; the port has none, so without ``mesh`` every
    logical axis resolves to ``None``."""
    return resolve_spec(logical, axis_sizes_of(mesh), shape=shape)


def drop_indivisible(spec: Spec, shape: Sequence[int], axis_sizes: Dict[str, int]) -> Spec:
    """Replicate any dim the mesh axes don't divide evenly (e.g. kv_heads=8
    on a 16-way model axis, or an odd vocab).  GSPMD *would* pad, but padded
    shards waste memory/compute — replication is the perf-correct fallback."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        total = 1
        for a in axes:
            total *= axis_sizes.get(a, 1)
        out.append(entry if total > 0 and dim % total == 0 else None)
    return tuple(out)


# ---------------------------------------------------------------------------
# Specs and DTensor placements on a concrete DeviceMesh
# ---------------------------------------------------------------------------


def spec_to_placements(spec: Spec, mesh: Any) -> List[Any]:
    """A partition spec → one DTensor placement per mesh dim: ``Shard(d)``
    for the tensor dim ``d`` whose entry names that mesh dim, else
    ``Replicate()``.  An axis the mesh lacks is dropped, as the reference's
    ``resolve`` drops it."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(tuple(spec or ())):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                dim_of[a] = d
    return [Shard(dim_of[n]) if n in dim_of else Replicate()
            for n in mesh.mesh_dim_names]


def placements_to_spec(placements: Sequence[Any], dim_names: Sequence[str],
                       ndim: int) -> Spec:
    """DTensor placements (one per mesh dim) → a partition spec of a rank
    ``ndim`` tensor; ``Replicate`` and ``Partial`` mesh dims shard nothing."""
    from torch.distributed.tensor import Shard

    entries: List[List[str]] = [[] for _ in range(ndim)]
    for name, p in zip(dim_names, placements):
        if isinstance(p, Shard):
            entries[p.dim % ndim].append(name)
    return tuple(None if not e else (e[0] if len(e) == 1 else tuple(e))
                 for e in entries)


def is_placements(x: Any) -> bool:
    """Whether ``x`` is a non-empty sequence of DTensor placements."""
    if not isinstance(x, (tuple, list)) or not x:
        return False
    from torch.distributed.tensor import Placement

    return all(isinstance(p, Placement) for p in x)


def normalize_spec(sharding: Any, mesh: Any = None, ndim: Optional[int] = None) -> Spec:
    """None | a spec tuple or list | a DTensor | DTensor placements → a spec.

    Placements need ``mesh`` (their dim names) and ``ndim``; a DTensor
    carries both."""
    if sharding is None:
        return ()
    from torch.distributed.tensor import DTensor

    if isinstance(sharding, DTensor):
        return placements_to_spec(sharding.placements,
                                  sharding.device_mesh.mesh_dim_names, sharding.ndim)
    if is_placements(sharding):
        if mesh is None or ndim is None:
            raise ValueError("DTensor placements need the mesh and the tensor's rank")
        return placements_to_spec(sharding, mesh.mesh_dim_names, ndim)
    if isinstance(sharding, (tuple, list)):
        return tuple(tuple(e) if isinstance(e, list) else e for e in sharding)
    raise TypeError(
        f"expected a spec tuple/list, DTensor placements or None, got "
        f"{type(sharding).__name__}")


#: Mesh axes that only split the batch.  A sharding constraint on a mesh
#: whose other axes all have size 1 agrees with what the batch's own
#: sharding propagates, so ``shard`` leaves the tensor alone there.
BATCH_AXES = ("pod", "data")

#: Axis sizes of the mesh a ``core.fx_graph`` trace prices ({} otherwise).
_TRACE_MESH: contextvars.ContextVar[Dict[str, int]] = contextvars.ContextVar(
    "trace_mesh", default={})


@contextlib.contextmanager
def tracing_on(mesh: Any) -> Iterator[None]:
    """Within this block ``shard`` records its constraint in the traced
    graph when ``mesh`` (a ``DeviceMesh`` or an ``{axis: size}`` dict)
    splits more than the batch."""
    token = _TRACE_MESH.set(axis_sizes_of(mesh))
    try:
        yield
    finally:
        _TRACE_MESH.reset(token)


def model_parallel(x: Any) -> bool:
    """Whether ``x`` lives on (or is traced for) a mesh that splits more
    than the batch, the model axis of tensor parallelism: an axis beyond
    ``BATCH_AXES`` larger than 1 on a DTensor's mesh, else on the mesh
    being traced."""
    mesh = getattr(x, "device_mesh", None)
    sizes = axis_sizes_of(mesh) if mesh is not None else _TRACE_MESH.get()
    return any(n not in BATCH_AXES and k > 1 for n, k in sizes.items())


def logical_shards(x: Any, name: str) -> int:
    """How many ways the logical axis ``name`` splits on ``x``'s mesh (a
    DTensor's, else the mesh being traced), divisibility aside."""
    mesh = getattr(x, "device_mesh", None)
    sizes = axis_sizes_of(mesh) if mesh is not None else _TRACE_MESH.get()
    return _entry_shards(resolve_spec((name,), sizes)[0], sizes)


def shard(x: Any, *logical: Optional[str]) -> Any:
    """The reference's sharding constraint by logical axis names.

    On a mesh that splits more than the batch (a DTensor's, or the mesh a
    ``core.fx_graph`` trace prices) it is ``constraint.constrain``: in a
    trace the custom op ``repro_torch::shard``, one node priced at the
    resolved spec's per-device bytes; on a DTensor a redistribution onto
    that spec (its backward constrains the cotangent alike, as the
    transpose of ``with_sharding_constraint`` does).  On a data-only mesh
    a DTensor is redistributed where the spec differs on an axis larger
    than 1 (the models' constraints never do: the batch's own sharding
    gives their layout there, and the trace holds no node for them).  A
    plain tensor off any traced mesh passes through unchanged."""
    if model_parallel(x):
        from .constraint import constrain

        return constrain(x, encode_logical(logical))
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    want = spec_to_placements(resolve(logical, mesh, shape=tuple(x.shape)), mesh)
    if all(p == w or k == 1 for p, w, k in zip(x.placements, want, mesh.shape)):
        return x
    return x.redistribute(mesh, want)


def encode_logical(logical: Sequence[Optional[str]]) -> str:
    """Logical names as the constraint op's string argument: one comma
    separated entry per dim, empty for None."""
    return ",".join(name or "" for name in logical)


def decode_logical(text: str) -> Tuple[Optional[str], ...]:
    return tuple(name or None for name in text.split(","))


# ---------------------------------------------------------------------------
# Parameter sharding: map a parameter name to a spec.
# ---------------------------------------------------------------------------


def _path_parts(path: str) -> List[str]:
    return path.replace(".", "/").split("/")


def param_spec(path: str, shape: Tuple[int, ...]) -> Spec:
    """Sharding rule for one parameter, keyed on its name.

    ``path`` is a reference tree path (``layers/attn/wq``) or a port
    parameter name (``layers.0.b0_attn_mlp.attn.wq``): the port keeps the
    reference's leaf names (``weights.py``), so one rule table serves both.

      embed / unembed   : (vocab, d_model)          → vocab over "model"
      wq/wk/wv          : (d_model, heads·dh)       → out dim over "model"
      wo                : (heads·dh, d_model)       → in dim over "model"
      w_gate/w_up       : (d_model, d_ff)           → d_ff over "model"
      w_down            : (d_ff, d_model)           → d_ff over "model"
      experts.*         : (E, …)                    → E over "model"
      norms / biases / scalars                      → replicated
    """
    rules = _ACTIVE_RULES

    def ax(name):
        return rules.get(name)

    if len(shape) == 0 or min(shape) == 0:
        return ()
    last = _path_parts(path)[-1]
    if "expert" in path:
        # stacked experts: leading E axis
        return (ax("experts"),) + (None,) * (len(shape) - 1)
    if last in ("embed", "unembed", "lm_head"):
        return (ax("vocab"), None) if len(shape) == 2 else ()
    if last in ("wq", "wk", "wv", "wqkv"):
        return (None, ax("heads")) if len(shape) >= 2 else (ax("heads"),)
    if last == "wo":
        return (ax("heads"), None)
    if last in ("w_gate", "w_up", "w13"):
        return (None, ax("ffn"))
    if last in ("w_down", "w2"):
        return (ax("ffn"), None)
    if last in ("in_proj", "x_proj", "dt_proj"):
        return (None, ax("ffn")) if len(shape) == 2 else ()
    if last == "out_proj":
        return (ax("ffn"), None) if len(shape) == 2 else ()
    return (None,) * len(shape)


def stacked_param_spec(path: str, shape: Tuple[int, ...]) -> Spec:
    """Same, for layer-stacked params with a leading [n_layers] axis."""
    return (None, *param_spec(path, shape[1:]))


def _map_tree(tree: Any, fn, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def _stacked(path: str, shape: Tuple[int, ...], prefixes: Sequence[str]) -> bool:
    """A reference-layout leaf under a stacked prefix carries the unit axis;
    a port parameter (``layers.{i}.…``, one module per unit) does not."""
    parts = _path_parts(path)
    return (len(shape) >= 1 and any(path.startswith(p) for p in prefixes)
            and not (len(parts) > 1 and parts[1].isdigit()))


def _leaf_param_spec(path: str, leaf: Any, stacked_prefixes: Sequence[str]) -> Spec:
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
    if _stacked(path, shape, stacked_prefixes):
        return stacked_param_spec(path, shape)
    return param_spec(path, shape)


def tree_param_specs(params: Any, stacked_prefixes: Sequence[str] = ("layers",)) -> Any:
    """A spec per leaf of a parameter tree: nested dicts (the reference's
    layout) or a flat ``{name: tensor}`` dict of port parameter names."""
    return _map_tree(params, lambda path, leaf: _leaf_param_spec(path, leaf, stacked_prefixes))


def fsdp_extend(spec: Spec, shape: Tuple[int, ...], axis_sizes: Dict[str, int],
                fsdp_axis: str = "data", min_elems: int = 1 << 16) -> Spec:
    """ZeRO-3/FSDP: additionally shard the largest still-replicated dim of a
    big tensor over the data axis.  Keeps small tensors (norms, biases)
    replicated."""
    n = 1
    for d in shape:
        n *= d
    if n < min_elems or fsdp_axis not in axis_sizes:
        return spec
    entries = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
    # never reuse an axis that already shards some dim
    for e in entries:
        taken = e if isinstance(e, tuple) else (e,)
        if fsdp_axis in taken:
            return spec
    size = axis_sizes[fsdp_axis]
    # largest unsharded, divisible dim
    best, best_dim = -1, -1
    for i, (d, e) in enumerate(zip(shape, entries)):
        if e is None and d % size == 0 and d > best_dim:
            best, best_dim = i, d
    if best < 0:
        return spec
    entries[best] = fsdp_axis
    return tuple(entries)


def spec_tree(params: Any, axis_sizes: Dict[str, int], fsdp: bool = False,
              fsdp_axes: Tuple[str, ...] = ("data",),
              stacked_prefixes: Sequence[str] = ("layers",)) -> Any:
    """A spec per leaf of a parameter tree under ``axis_sizes``: the rule of
    ``param_spec``, the divisibility guard and (when asked) the FSDP
    extension, as the reference's ``named_sharding_tree`` lays them out."""

    def one(path, leaf):
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        p = drop_indivisible(_leaf_param_spec(path, leaf, stacked_prefixes), shape,
                             axis_sizes)
        if fsdp:
            for ax in fsdp_axes:
                p = fsdp_extend(p, shape, axis_sizes, fsdp_axis=ax)
        return p

    return _map_tree(params, one)


def named_sharding_tree(params: Any, mesh: Any, fsdp: bool = False,
                        fsdp_axes: Tuple[str, ...] = ("data",), **kw) -> Any:
    """DTensor placements (a list, one per mesh dim) for every leaf of a
    parameter tree on ``mesh``, with the divisibility guard (and the FSDP
    extension when asked): the reference's ``NamedSharding`` tree."""
    specs = spec_tree(params, axis_sizes_of(mesh), fsdp, fsdp_axes,
                      kw.get("stacked_prefixes", ("layers",)))
    return map_specs(specs, lambda spec: spec_to_placements(spec, mesh))


def map_specs(tree: Any, fn) -> Any:
    """``fn`` on every spec of a (nested dict) tree of specs: unlike a
    parameter tree's, a spec's own tuple is a leaf."""
    if isinstance(tree, dict):
        return {k: map_specs(v, fn) for k, v in tree.items()}
    return fn(tree)


def sharded_aval_bytes(val: Any, spec: Spec, axis_sizes: Dict[str, int]) -> int:
    """Per-device bytes of one (fake) tensor under ``spec`` (replicated:
    global)."""
    if not hasattr(val, "shape") or not hasattr(val, "dtype"):
        return 1
    return local_bytes(tuple(val.shape), spec, axis_sizes, val.element_size())


# ---------------------------------------------------------------------------
# Conservative sharding propagation over an aten fx graph.
#
# The traced carrier needs a per-node output spec to emit per-device M_v.
# DTensor's own propagation runs only on live DTensors; here the specs are
# followed through the ops whose propagation is unambiguous (same-shape,
# transpose, broadcast, reductions, matmuls, the flash-attention op) and
# fall back to **replicated** everywhere else.  Replicated is the
# conservative direction for a memory planner: per-device bytes are over-,
# never under-estimated, so a plan that fits the modeled budget fits the
# machine.  Views get specs too (a transpose's spec is its input's,
# permuted), although they fold into their base's graph node.
#
# Beyond the reference's rules (which replicate at every reshape and
# gather, so a traced LM loses its batch sharding at the embedding): a
# reshape keeps a dim's sharding where that dim leads its merged or split
# group and the shard count divides it (DTensor's own view rule),
# ``embedding`` takes its indices' specs, and ``slice``/``select``/
# ``unsqueeze``/``split``/``cat`` keep the dims they do not cut.  On the
# reference's test functions (no such ops) the specs are the reference's.
# ---------------------------------------------------------------------------

_REDUCE_OPS = frozenset({"sum", "mean", "amax", "amin", "argmax", "argmin", "prod",
                         "logsumexp"})
_RESHAPE_OPS = frozenset({"view", "_unsafe_view", "reshape"})
_MATMUL_OPS = frozenset({"mm", "addmm", "bmm"})


def _spec_entries(spec: Optional[Spec], ndim: int) -> Tuple:
    entries = tuple(spec) if spec is not None else ()
    return entries + (None,) * (ndim - len(entries))


def _val_tensors(val: Any) -> List[Any]:
    import torch
    import torch.utils._pytree as pytree

    return [t for t in pytree.tree_leaves(val) if isinstance(t, torch.Tensor)]


def propagate_node_specs(gm: Any, in_specs: Sequence[Spec],
                         axis_sizes: Dict[str, int]) -> Dict[Any, Tuple[Spec, ...]]:
    """Per-fx-node output specs of a make_fx GraphModule (the twin of the
    reference's ``propagate_eqn_specs``).

    ``in_specs`` aligns with the graph's placeholders.  Returns a dict from
    every fx node to a tuple of specs aligned with the tensors it returns.
    Unknown ops propagate by the same-shape passthrough, and else
    replicated (see the note above).
    """
    from ..core.fx_graph import op_name

    env: Dict[Any, Tuple[Spec, ...]] = {}
    placeholders = iter(in_specs)

    def spec_of(arg: Any) -> Spec:
        if not hasattr(arg, "op"):
            return ()  # a constant
        specs = env.get(arg, ())
        return specs[0] if specs else ()

    for n in gm.graph.nodes:
        if n.op == "placeholder":
            env[n] = (tuple(next(placeholders, ())),)
            continue
        if n.op != "call_function":
            env[n] = tuple(() for _ in _val_tensors(n.meta.get("val")))
            continue
        specs = _rule(n, op_name(n.target), spec_of, env, axis_sizes)
        if specs is None:
            specs = tuple(_same_shape_spec(t, n, spec_of)
                          for t in _val_tensors(n.meta.get("val")))
        env[n] = specs
    return env


def _shape(arg: Any) -> Tuple[int, ...]:
    return tuple(arg.meta["val"].shape)


def _rule(n: Any, name: str, spec_of, env, axis_sizes) -> Optional[Tuple[Spec, ...]]:
    args = n.args
    if n.target is operator.getitem:  # specs align with the parent's tensors
        import torch

        parent = args[0].meta.get("val")
        if not isinstance(parent, (list, tuple)) or not isinstance(parent[args[1]],
                                                                   torch.Tensor):
            return None
        return (env[args[0]][len(_val_tensors(parent[:args[1]]))],)
    if name in _RESHAPE_OPS:
        ent = _spec_entries(spec_of(args[0]), len(_shape(args[0])))
        return (_reshape_spec(_shape(args[0]), _shape(n), ent, axis_sizes),)
    if name == "embedding":  # (V, D) weight, indices: out = indices' dims + D
        w_ent = _spec_entries(spec_of(args[0]), 2)
        return (_spec_entries(spec_of(args[1]), len(_shape(args[1]))) + (w_ent[1],),)
    if name in ("slice", "select", "unsqueeze", "split", "split_with_sizes", "cat"):
        return _cut_rule(n, name, spec_of)
    if name in _MATMUL_OPS:
        lhs, rhs = (args[1], args[2]) if name == "addmm" else (args[0], args[1])
        return (_matmul_spec(name, lhs, rhs, spec_of),)
    if name in ("t", "transpose", "permute"):
        ent = _spec_entries(spec_of(args[0]), len(_shape(args[0])))
        if name == "permute":
            perm = [p % len(ent) for p in args[1]]
        else:
            perm = list(range(len(ent)))
            if len(ent) >= 2:
                d0, d1 = ((0, 1) if name == "t" else (args[1] % len(ent), args[2] % len(ent)))
                perm[d0], perm[d1] = perm[d1], perm[d0]
        return (tuple(ent[p] for p in perm),)
    if name == "expand":
        return (_broadcast_spec(args[0], _shape(n), spec_of),)
    if name in _REDUCE_OPS:
        src = args[0]
        nd = len(_shape(src))
        dims = n.kwargs.get("dim", args[1] if len(args) > 1 else None)
        keep = n.kwargs.get("keepdim", args[2] if len(args) > 2 else False)
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            dims = range(nd)
        elif isinstance(dims, int):
            dims = [dims]
        axes = {d % nd for d in dims} if nd else set()
        ent = _spec_entries(spec_of(src), nd)
        out = tuple(None if i in axes else e for i, e in enumerate(ent)
                    if keep or i not in axes)
        return (out,)
    from ..core.prims import FLASH_OP, SHARD_OP, VOCAB_EMBED_OP, VOCAB_PICK_OP

    if name == SHARD_OP:  # the constraint's own spec
        return (resolve_spec(decode_logical(args[1]), axis_sizes, shape=_shape(n)),)
    if name == VOCAB_EMBED_OP:  # indices' dims + D, a partial sum over the vocab shards
        return (_spec_entries(spec_of(args[1]), len(_shape(args[1]))) + (None,),)
    if name == VOCAB_PICK_OP:  # the labels' dims
        return (_spec_entries(spec_of(args[1]), len(_shape(args[1]))),)
    if name == FLASH_OP:  # q (B, Sq, H, D): batch and heads shard, Sq and D not
        ent = _spec_entries(spec_of(args[0]), 4)
        return ((ent[0], None, ent[2], None), (ent[0], ent[2], None))
    return None


def _same_shape_spec(t: Any, n: Any, spec_of) -> Spec:
    """Shape-preserving passthrough: adopt the most-sharded operand whose
    shape equals the output's; replicated otherwise."""
    shape = tuple(t.shape)
    best, best_k = (), 1
    for a in n.all_input_nodes:
        val = a.meta.get("val")
        if not hasattr(val, "shape") or tuple(val.shape) != shape:
            continue
        s = spec_of(a)
        # rank operands by how many ways they split the tensor
        k = num_shards(shape, s, {ax: 2 for ax in _spec_axes(s)})
        if k > best_k:
            best, best_k = s, k
    return best


def _spec_axes(spec: Spec) -> List[str]:
    axes: List[str] = []
    for e in tuple(spec):
        if e is None:
            continue
        axes.extend(e if isinstance(e, tuple) else (e,))
    return axes


def _matmul_spec(name: str, lhs: Any, rhs: Any, spec_of) -> Spec:
    """dot_general's rule for ``mm``/``addmm`` (M,K)@(K,N) and ``bmm``
    (B,M,K)@(B,K,N): batch and free dims keep their operand's sharding
    (the batch dim the lhs's), contracted dims disappear."""
    l_ent = _spec_entries(spec_of(lhs), len(_shape(lhs)))
    r_ent = _spec_entries(spec_of(rhs), len(_shape(rhs)))
    out = [l_ent[0], l_ent[1], r_ent[2]] if name == "bmm" else [l_ent[0], r_ent[1]]
    # one mesh axis must not shard two output dims (lhs/rhs may both carry it)
    seen: set = set()
    clean = []
    for e in out:
        axes = e if isinstance(e, tuple) else ((e,) if e is not None else ())
        if any(a in seen for a in axes):
            clean.append(None)
            continue
        seen.update(axes)
        clean.append(e)
    return tuple(clean)


def _broadcast_spec(src: Any, out_shape: Tuple[int, ...], spec_of) -> Spec:
    """``expand``: dims aligned from the right keep their entry where the
    size is unchanged."""
    in_shape = _shape(src)
    ent = _spec_entries(spec_of(src), len(in_shape))
    lead = len(out_shape) - len(in_shape)
    out = [None] * len(out_shape)
    for i, d in enumerate(in_shape):
        if d == out_shape[lead + i]:
            out[lead + i] = ent[i]
    return tuple(out)


def like(t: Any, ref: Any) -> Any:
    """``t`` in ``ref``'s DTensor placements (redistributed where they
    differ); ``t`` itself when ``ref`` is no DTensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(ref, DTensor) or list(t.placements) == list(ref.placements):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


def local_shape_and_offset(shape: Sequence[int], mesh: Any, placements: Sequence[Any]):
    """This rank's shard shape and global offset of a tensor of ``shape``
    in ``placements`` (DTensor's ``compute_local_shape_and_global_offset``,
    run outside any fake-tensor mode: torch 2.13 computes the offsets with
    tensors, whose values a fake mode does not hold)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    with unset_fake_temporarily():
        return compute_local_shape_and_global_offset(shape, mesh, placements)


def place(t: Any, mesh: Any, spec: Spec) -> Any:
    """``t`` on ``mesh`` in ``spec``'s placements: a DTensor is
    redistributed (a no-op in those placements already), a plain tensor is
    distributed from each rank's own copy (``src_data_rank=None``: no
    communication; every rank must hold the same global tensor)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    want = spec_to_placements(spec, mesh)
    if isinstance(t, DTensor):
        return t if list(t.placements) == want else t.redistribute(mesh, want)
    return distribute_tensor(t, mesh, want, src_data_rank=None)


def _reshape_spec(in_shape: Tuple[int, ...], out_shape: Tuple[int, ...], ent: Tuple,
                  axis_sizes: Dict[str, int]) -> Spec:
    """A reshape's output spec: dims are matched in groups of equal
    products; a group keeps the entry of its leading input dim on its
    leading output dim longer than 1, when the shard count divides both.
    Anything else in a group is replicated: DTensor gathers another dim's
    shards before it merges them (the sequence-parallel residual's
    ``S`` shards when (B, S, D) flattens for a matmul)."""
    out: List[Any] = [None] * len(out_shape)
    i = j = 0
    while i < len(in_shape) and j < len(out_shape):
        gi, gj = [i], [j]
        pi, pj = in_shape[i], out_shape[j]
        while pi != pj:
            if pi < pj and i + 1 < len(in_shape):
                i += 1
                gi.append(i)
                pi *= in_shape[i]
            elif pj < pi and j + 1 < len(out_shape):
                j += 1
                gj.append(j)
                pj *= out_shape[j]
            else:
                return tuple(out)
        lead = next((d for d in gi if in_shape[d] > 1), gi[0])
        dest = next((d for d in gj if out_shape[d] > 1), gj[0])
        e = ent[lead]
        k = _entry_shards(e, axis_sizes)
        if e is not None and in_shape[lead] % k == 0 and out_shape[dest] % k == 0:
            out[dest] = e
        i += 1
        j += 1
    return tuple(out)


def _cut_rule(n: Any, name: str, spec_of) -> Tuple[Spec, ...]:
    """``slice``/``select``/``unsqueeze``/``split``/``cat``: dims the op
    does not cut keep their entries, the cut dim is replicated (removed by
    ``select``, inserted by ``unsqueeze``)."""
    args = n.args
    if name == "cat":
        tensors = args[0]
        specs = {_spec_entries(spec_of(t), len(_shape(t))) for t in tensors}
        if len(specs) != 1:  # differently sharded operands: replicated
            return ((),)
        ent = list(specs.pop())
        ent[(args[1] if len(args) > 1 else 0) % len(ent)] = None
        return (tuple(ent),)
    ent = list(_spec_entries(spec_of(args[0]), len(_shape(args[0]))))
    if name == "unsqueeze":
        d = args[1] % (len(ent) + 1)
        return (tuple(ent[:d] + [None] + ent[d:]),)
    dim = (args[1] if name == "select" else
           (args[2] if len(args) > 2 else 0) if name in ("split", "split_with_sizes") else
           (args[1] if len(args) > 1 else 0)) % len(ent)
    if name == "select":
        return (tuple(e for i, e in enumerate(ent) if i != dim),)
    outs = _val_tensors(n.meta.get("val"))
    in_len = _shape(args[0])[dim]
    return tuple(tuple(None if (i == dim and t.shape[dim] != in_len) else e
                       for i, e in enumerate(ent)) for t in outs)
