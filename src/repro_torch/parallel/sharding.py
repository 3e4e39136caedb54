"""Logical-axis sharding rules: the byte half of ``repro/parallel/sharding.py``.

Models name tensor dims by *logical* axis; a rules table maps them to mesh
axes ("pod", "data", "model").  On one card nothing is sharded, but the
planners price per-device bytes through these functions, so the port keeps
the rules table, ``resolve_spec`` and the per-device byte accounting as
copies of the reference, with ``PartitionSpec`` replaced by a plain tuple.
The reference's ``shard()`` (a GSPMD sharding constraint) has no
counterpart on one card; the torch half (DeviceMesh/DTensor placements)
waits for ROADMAP.md module queue, item 'Multi-device'.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

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
    """Axis-name → size for a ``{"data": 8, "model": 2}`` dict.

    One card has no mesh object; the byte accounting (and with it the whole
    planning pipeline) runs on plain axis-size dicts.
    """
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    raise TypeError(
        f"expected an {{axis: size}} dict, got {type(mesh).__name__}"
    )


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
