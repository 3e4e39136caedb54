"""Shape stand-ins and shardings for every (arch × shape) cell (port of
``repro/launch/specs.py``).

``input_specs``, ``params_specs``, ``opt_specs`` and ``cache_specs`` build
the trees a step consumes on the ``meta`` device: shapes and dtypes, no
allocation (the reference's ``ShapeDtypeStruct``s through ``eval_shape``).
Parameter trees are in the reference's layout (nested dicts, the
``"layers"``, ``"encoder"`` and ``"decoder"`` leaves stacked along a unit
axis: ``weights.params_to_jax``'s), so the specs compare leaf for leaf.

``batch_axes``, ``input_shardings``, ``cache_shardings``,
``param_shardings`` and ``replicated`` map those trees onto a mesh under
the active logical rules with the divisibility guard
(``parallel.sharding``).  A mesh is a ``DeviceMesh`` or an ``{axis:
size}`` dict: a dict gives spec tuples (the entries of the reference's
``PartitionSpec``: None, an axis name or a tuple of names), a
``DeviceMesh`` DTensor placements (one per mesh dim).  ``param_shardings`` also takes the port's flat
``{name: tensor}`` parameters (``model.named_parameters()``), the tree
``Trainer(in_shardings=)`` reads.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.parallel import sharding as sh
from repro_torch.weights import _stacked_key

#: The memory the reference's ``needs_fsdp`` rule compares static state
#: with (its ``launch.plan.HBM_BYTES``), so the FSDP choice is its own.
from repro_torch.launch.mesh import REFERENCE_HBM_BYTES


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_axes(mesh: Any) -> Tuple[str, ...]:
    """The mesh axes the logical ``"batch"`` axis maps onto, in rule order."""
    rule = sh.get_rules().get("batch", ("pod", "data"))
    if isinstance(rule, str):
        rule = (rule,)
    names = tuple(sh.axis_sizes_of(mesh))
    return tuple(a for a in rule if a in names)


# --------------------------------------------------------------------- inputs


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The step-function batch for one cell (meta tensors only)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _sds((B, S), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = _sds((B, S), torch.int32)
        if cfg.encoder_decoder:
            batch["frames"] = _sds((B, cfg.frontend_seq, cfg.d_model), torch.bfloat16)
        elif cfg.frontend != "none":
            batch["extra_embeds"] = _sds((B, cfg.frontend_seq, cfg.d_model), torch.bfloat16)
        return batch
    # decode: one new token against a seq_len-deep cache
    return {"tokens": _sds((B, 1), torch.int32), "positions": _sds((B,), torch.int32)}


@functools.lru_cache(maxsize=32)
def _meta_model(cfg: ModelConfig):
    """The config's model on the ``meta`` device (built once a config: its
    parameters are read, never written)."""
    from repro_torch.models import build_model

    return build_model(cfg, device="meta")


def _reference_tree(named: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Port parameter names → the reference's nested tree, stacked leaves
    regaining their unit axis (meta tensors, as ``weights.params_to_jax``
    does with arrays)."""
    flat: Dict[str, Any] = {}
    stacked: Dict[str, Dict[int, torch.Tensor]] = {}
    for name, t in named.items():
        top = _stacked_key(name)
        if top:
            idx, rest = name[len(top) + 1:].split(".", 1)
            stacked.setdefault(f"{top}.{rest}", {})[int(idx)] = t
        else:
            flat[name] = _sds(t.shape, t.dtype)
    for name, parts in stacked.items():
        # a chain of unlike units stacks each kind's leaf over its own units
        one = next(iter(parts.values()))
        flat[name] = _sds((len(parts), *one.shape), one.dtype)
    tree: Dict[str, Any] = {}
    for name, t in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def params_specs(cfg: ModelConfig, serving: bool = False) -> Dict[str, Any]:
    """The parameter tree (f32 masters); ``serving=True`` casts floating
    leaves to the activation dtype (bf16 inference weights)."""
    tree = _reference_tree(dict(_meta_model(cfg).named_parameters()))
    if not serving:
        return tree
    act = cfg.activation_dtype
    return pytree.tree_map(
        lambda t: _sds(t.shape, act) if t.is_floating_point() else t, tree)


def opt_specs(params: Any) -> Dict[str, Any]:
    """AdamW's state for ``params``: the step and two f32 moments."""
    f32 = pytree.tree_map(lambda t: _sds(t.shape, torch.float32), params)
    return {"step": _sds((), torch.int32), "mu": f32,
            "nu": pytree.tree_map(lambda t: _sds(t.shape, torch.float32), params)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The decode caches (meta tensors: whisper's encoder runs on meta
    frames to give its cross K/V)."""
    model = _meta_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    with torch.device("meta"):
        if cfg.encoder_decoder:
            frames = _sds((B, cfg.frontend_seq, cfg.d_model), torch.bfloat16)
            return model.init_caches(frames, S)
        return model.init_caches(B, S)


# ------------------------------------------------------------------ shardings


def _out(spec: sh.Spec, mesh: Any):
    """Placements on a ``DeviceMesh``, the spec itself on a dict."""
    return sh.spec_to_placements(spec, mesh) if sh.is_device_mesh(mesh) else spec


def _canonical(spec: Tuple) -> sh.Spec:
    """Entries as the reference's ``PartitionSpec`` reads them: a one-axis
    tuple is that axis, an empty one None."""
    out = []
    for e in spec:
        if isinstance(e, tuple):
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    return tuple(out)


def input_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh: Any) -> Dict[str, Any]:
    """Each batch tensor's leading dim over the batch axes (replicated
    where they do not divide it)."""
    sizes = sh.axis_sizes_of(mesh)
    ba = batch_axes(mesh)

    def one(t: torch.Tensor) -> Any:
        spec = sh.drop_indivisible((ba,) + (None,) * (t.dim() - 1), tuple(t.shape), sizes)
        return _out(_canonical(spec), mesh)

    return {k: one(v) for k, v in input_specs(cfg, shape).items()}


def cache_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh: Any, caches: Any) -> Any:
    """Decode caches: batch → the batch axes; long-context (B = 1) instead
    shards the sequence over "data" (SP); heads / KV heads → "model"."""
    sizes = sh.axis_sizes_of(mesh)
    ba = batch_axes(mesh)
    long_ctx = shape.global_batch == 1
    model = sizes.get("model", 1)

    def leaf_spec(path: str, t: torch.Tensor) -> Any:
        shp = tuple(t.shape)
        nd = len(shp)
        spec = [None] * nd
        # the leading axis is the unit/layer stack of every cache leaf
        if nd >= 2:
            spec[1] = None if long_ctx else ba
        last = path.split("/")[-1]
        if last in ("k", "v", "xk", "xv") and nd == 5:
            # (L, B, S, KV, D): KV heads over "model", else the sequence
            if long_ctx:
                spec[2] = "data"
            if shp[3] % model == 0:
                spec[3] = "model"
            elif shp[2] % model == 0 and spec[2] is None:
                spec[2] = "model"
        elif last in ("ssm", "C") and nd == 5:  # (L, B, H, P, N)
            spec[2] = "model"
        elif last == "n" and nd == 5:
            spec[2] = "model"
        elif last == "conv" and nd == 4:
            spec[3] = "model"
        return _out(_canonical(sh.drop_indivisible(tuple(spec), shp, sizes)), mesh)

    def walk(tree: Any, prefix: str) -> Any:
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
        return leaf_spec(prefix[:-1], tree)

    return walk(caches, "")


def param_shardings(cfg: ModelConfig, mesh: Any, params: Optional[Any] = None) -> Any:
    """A spec per parameter leaf: tensor parallelism over "model" by
    ``sharding.param_spec``, plus FSDP over "data" (``fsdp_extend``) when
    the reference's ``needs_fsdp`` asks (the TP-only f32 state above 0.35
    of the reference's 16 GiB); under ``DP_ONLY_RULES`` ZeRO-3 over both axes, under
    ``DP_ATTN_RULES`` over "data".  ``params`` is the reference-layout tree
    (default: ``params_specs(cfg)``) or the port's flat ``{name: tensor}``
    dict."""
    from repro_torch.launch.plan import needs_fsdp

    if params is None:
        params = params_specs(cfg)
    sizes = sh.axis_sizes_of(mesh)
    rules = sh.get_rules()
    if rules.get("heads") is None and rules.get("experts") is None:
        fsdp, axes = True, ("data", "model")  # dp_only: ZeRO-3 over both axes
    elif rules.get("heads") is None:
        fsdp, axes = True, ("data",)  # dp_attn: ZeRO dense parts, EP experts
    else:
        fsdp, axes = needs_fsdp(cfg, sizes.get("model", 1), REFERENCE_HBM_BYTES), ("data",)
    return sh.map_specs(sh.spec_tree(params, sizes, fsdp=fsdp, fsdp_axes=axes),
                        lambda spec: _out(spec, mesh))


def replicated(mesh: Any) -> Any:
    """Every dim replicated."""
    return _out((), mesh)


def state_bytes_per_device(cfg: ModelConfig, mesh: Any) -> int:
    """Per-device bytes of the f32 parameters and both AdamW moments under
    ``param_shardings`` (shapes only: nothing is allocated)."""
    params = params_specs(cfg)
    sizes = sh.axis_sizes_of(mesh)
    specs = param_shardings(cfg, sizes, params)
    total = [0]

    def add(t, spec):
        total[0] += 3 * sh.local_bytes(tuple(t.shape), spec, sizes, 4)

    def walk(p, s):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], s[k])
        else:
            add(p, s)

    walk(params, specs)
    return total[0]
