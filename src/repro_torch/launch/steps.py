"""The launchers' planning step and the decode step's shardings (port of
``repro/launch/steps.py``).

The reference's step builders (``build_train_step`` and friends) return
jitted, sharded step functions; in the port the training step is the
``Trainer``'s eager loop (sharded over a ``DeviceMesh`` with
``Trainer(mesh=)``) and the decode step the ``serving.Engine``'s (sharded
with ``Engine(mesh=, step_shardings=)``), so ``segment_plan`` comes across,
and of ``build_decode_step`` its shardings (``decode_shardings``,
``logits_sharding``).  The reference
reads the data/model axis sizes off a jax ``Mesh``; the port takes them as
an ``{axis: size}`` dict (``parallel.sharding.axis_sizes_of`` of a
``DeviceMesh``: the launcher passes its host mesh's under ``torchrun``), by
default ``{"data": 1, "model": 1}`` (one card).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import specs
from repro_torch.launch.plan import plan_with_microbatching
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import get_rules

ONE_CARD: Dict[str, int] = {"data": 1, "model": 1}


def _dp_shards(axis_sizes: Dict[str, int]) -> int:
    return axis_sizes.get("pod", 1) * axis_sizes.get("data", 1)


def _seq_shards(axis_sizes: Dict[str, int], shape: ShapeConfig) -> int:
    if shape.global_batch > 1:
        return 1
    return axis_sizes.get("data", 1)


def segment_plan(cfg: ModelConfig, shape: ShapeConfig,
                 axis_sizes: Optional[Dict[str, int]] = None,
                 objective: Optional[str] = None,
                 model_shards_override: Optional[int] = None,
                 hbm_bytes: Optional[float] = None, device: str = "cuda"):
    """The paper's technique, applied: DP-plan the remat segmentation, with
    the smallest feasible gradient-accumulation factor (§5.1's minimal-budget
    protocol turned inside out for a fixed per-device memory).

    ``hbm_bytes=None`` budgets against the CUDA card's memory; ``device``
    is profiled when ``REPRO_MEASURED_COSTS`` asks for measured costs.

    Returns (SegmentPlan, DPResult)."""
    if cfg.remat_method == "none":
        return None, None
    sizes = dict(ONE_CARD if axis_sizes is None else axis_sizes)
    obj = objective or cfg.remat_objective
    ms = model_shards_override or sizes.get("model", 1)
    dp = _dp_shards(sizes)
    if model_shards_override == 1:  # dp_only: "model" joins the batch axes
        dp *= sizes.get("model", 1)
    return plan_with_microbatching(
        cfg, shape, dp, _seq_shards(sizes, shape),
        model_shards=ms, objective=obj, rules=get_rules(),
        hbm_bytes=hbm_bytes, device=device,
    )


# --------------------------------------------------------------------- decode


def logits_sharding(cfg: ModelConfig, global_batch: int, mesh: Any) -> Any:
    """Logits (B, S, V): batch over the data axes, vocab over "model", each
    dropped where it does not divide (granite's 49155 and whisper's 51865
    vocabularies) and the batch replicated at B = 1 (long context)."""
    ba = specs.batch_axes(mesh)
    spec = (None if global_batch == 1 else ba, None, "model")
    spec = sh.drop_indivisible(spec, (global_batch, 1, cfg.vocab_size), sh.axis_sizes_of(mesh))
    return specs._out(specs._canonical(spec), mesh)


def decode_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh: Any,
                     caches: Any = None) -> Tuple[Any, Any, Any, Any]:
    """The decode step's input shardings in ``serving.Engine``'s order,
    ``(params, tokens, caches, positions)``, as the reference's
    ``build_decode_step`` lays them out: the parameters by
    ``specs.param_shardings`` (a dict keyed by the port's parameter names:
    the reference's tree of ``params_specs(serving=True)`` leaf for leaf,
    the serving cast changing no spec), the caches by
    ``specs.cache_shardings`` (``caches``: the cache tree, by default
    ``specs.cache_specs``), the tokens (B, 1) and positions (B,) over the
    batch axes, replicated at B = 1.  Spec tuples on an ``{axis: size}``
    dict, DTensor placements on a ``DeviceMesh``."""
    if caches is None:
        caches = specs.cache_specs(cfg, shape)
    ba = None if shape.global_batch == 1 else specs.batch_axes(mesh)
    return (_by_port_name(cfg, mesh),
            specs._out(specs._canonical((ba, None)), mesh),
            specs.cache_shardings(cfg, shape, mesh, caches),
            specs._out(specs._canonical((ba,)), mesh))



def _by_port_name(cfg: ModelConfig, mesh: Any) -> Dict[str, Any]:
    """``specs.param_shardings`` over the reference's serving tree, keyed by
    the port's parameter names: a unit's parameter takes its ``"layers"``
    leaf's spec without the unit axis.  The reference's rule reads only
    ``"layers"`` as stacked, so on whisper's ``"encoder"``/``"decoder"``
    stacks it splits the layer axis or d_model; the port lays each of
    those layers out by the per-layer rule (``specs.param_shardings`` on
    the port's names: heads and ffn over ``model``), as its Trainer does."""
    from repro_torch.weights import _stacked_key

    sizes = sh.axis_sizes_of(mesh)
    named = dict(specs._meta_model(cfg).named_parameters())
    per_layer = specs.param_shardings(cfg, sizes, named)
    # the serving tree's shapes (its bf16 cast changes no spec)
    tree = specs.param_shardings(cfg, sizes, specs._reference_tree(named))
    out: Dict[str, Any] = {}
    for name in named:
        top = _stacked_key(name)
        if top in ("encoder", "decoder"):
            spec = per_layer[name]
        else:
            path = ([top, *name[len(top) + 1:].split(".", 1)[1].split(".")] if top
                    else name.split("."))
            spec = tree
            for key in path:
                spec = spec[key]
            spec = tuple(spec[1:]) if top else spec
        out[name] = specs._out(spec, mesh)
    return out
