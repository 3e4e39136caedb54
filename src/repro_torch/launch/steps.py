"""Step builders: the functions the dry run traces and the launchers run
(port of ``repro/launch/steps.py``).

``build_train_step``, ``build_prefill_step``, ``build_decode_step`` and
``build_step`` (the dispatch on the shape's kind) are the reference's names
and return its ``(fn, in_shardings, out_shardings, example)``.  Where the
reference returns a pure function for ``jax.jit``, the port's ``fn`` is a
thin wrapper over what the port runs eagerly:

* train: ``fn(trainer, batch)`` is one ``Trainer`` step with no host sync
  (``Trainer.step_tensors``: forward and backward segmented by
  :func:`segment_plan`, ``n_micro`` microbatches, AdamW), on the Trainer
  ``fn.trainer(model)`` builds from the cell's decisions;
* prefill: ``fn(model, batch)`` is ``LM.forward`` (whisper: ``encode``
  then ``decode_train``);
* decode: ``fn(model, caches, tokens, positions)`` is ``decode_step``.

The shardings are the reference's in its argument order: the parameters
keyed by the port's names, each with its reference leaf's spec (a stacked
leaf's without the unit axis; :func:`decode_shardings`), the AdamW state
``{"step", "mu", "nu"}``, the batch, the caches.  Spec tuples on an
``{axis: size}`` dict, DTensor placements on a ``DeviceMesh``.  ``example``
holds ``meta`` stand-ins of the arguments (global shapes), laid out by
``launch.specs``.

``opts`` takes the reference's knobs.  ``"dp_only"`` and ``"dp_attn"``
select the rules tables (``parallel.sharding``), which the builders set as
the reference's do: module-wide, so a prefill cell after them keeps them.
``"mp"`` runs the loss on a bf16 compute copy of the f32 masters, cast once
before it (``TrainConfig.mixed_precision``), so FSDP gathers move bf16.
``"rs"`` keeps each gradient in its parameter's layout, which the Trainer
always does: DTensor's backward of an FSDP weight's Shard → Replicate
gather is a reduce-scatter onto the shard (``Trainer._value_and_grad``).
``"ws"`` (decode) swaps in ``{**DEFAULT_RULES, "model": "data"}``: the
residual's feature axis over ``data`` where the batch leaves it free
(``resolve_spec`` drops an axis a tensor already uses), so FSDP'd weights
are used in place and the activations' partial sums all-reduced.

The data and model axis sizes come off a ``DeviceMesh`` or an ``{axis:
size}`` dict (``parallel.sharding.axis_sizes_of``); :func:`segment_plan`
takes the dict, by default ``{"data": 1, "model": 1}`` (one card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.planner import get_default_planner
from repro_torch.launch import specs
from repro_torch.launch.plan import plan_with_microbatching
from repro_torch.optim import adamw
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

    Returns (SegmentPlan, DPResult).  While recording (``repro_torch.obs``)
    the plan counts its seconds, ``planner.plan_s``, and the plan cache's
    ``hits``, ``misses`` and ``disk_hits`` over it as ``planner.<tier>``."""
    if cfg.remat_method == "none":
        return None, None
    sizes = dict(ONE_CARD if axis_sizes is None else axis_sizes)
    obj = objective or cfg.remat_objective
    ms = model_shards_override or sizes.get("model", 1)
    dp = _dp_shards(sizes)
    if model_shards_override == 1:  # dp_only: "model" joins the batch axes
        dp *= sizes.get("model", 1)
    cache = get_default_planner().cache
    tiers = {k: getattr(cache, k) for k in ("hits", "misses", "disk_hits")}
    with obs.timed("planner.plan_s"):
        out = plan_with_microbatching(
            cfg, shape, dp, _seq_shards(sizes, shape),
            model_shards=ms, objective=obj, rules=get_rules(),
            hbm_bytes=hbm_bytes, device=device,
        )
    for k, n in tiers.items():
        obs.count(f"planner.{k}", getattr(cache, k) - n)
    return out


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


# ---------------------------------------------------------------- the builders


def set_step_rules(shape: ShapeConfig, opts: Tuple[str, ...]) -> None:
    """The rules table a builder of ``shape``'s kind sets for ``opts``: a
    train step's ``"dp_only"`` or ``"dp_attn"`` table (else the default),
    a decode step's ``"ws"`` table; a prefill step, and a decode step
    without ``"ws"``, keep the active one."""
    if shape.kind == "train":
        sh.set_rules(sh.DP_ONLY_RULES if "dp_only" in opts
                     else sh.DP_ATTN_RULES if "dp_attn" in opts else sh.DEFAULT_RULES)
    elif shape.kind == "decode" and "ws" in opts:
        sh.set_rules({**sh.DEFAULT_RULES, "model": "data"})


def _param_meta(cfg: ModelConfig, dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """The model's parameters by port name, ``meta`` tensors (cast to
    ``dtype`` for serving)."""
    named = dict(specs._meta_model(cfg).named_parameters())
    if dtype is None:
        return {n: p.detach() for n, p in named.items()}
    return {n: specs._sds(p.shape, dtype) if p.is_floating_point() else p.detach()
            for n, p in named.items()}


@dataclasses.dataclass
class TrainStep:
    """One cell's train step: ``step(trainer, batch)`` runs
    ``trainer.step_tensors(batch)``; :meth:`trainer` builds that Trainer for
    a model (on ``mesh``, laid out by the cell's shardings, with its
    segment plan, microbatches and knobs)."""

    mesh: Any
    segment_sizes: Optional[Tuple[int, ...]]
    segment_remat: Optional[Tuple[bool, ...]]
    n_micro: int
    mixed_precision: bool
    optimizer: adamw.AdamWConfig
    param_shardings: Dict[str, Any]
    batch_shardings: Dict[str, Any]

    def loss(self, model, batch):
        return model.loss(batch, segment_sizes=self.segment_sizes,
                          segment_remat=self.segment_remat)

    def trainer(self, model, device: Any = "cpu"):
        from repro_torch.train import TrainConfig, Trainer

        tcfg = TrainConfig(total_steps=1, log_every=0, n_micro=self.n_micro,
                           mixed_precision=self.mixed_precision, optimizer=self.optimizer)
        if not sh.is_device_mesh(self.mesh):
            return Trainer(self.loss, model, tcfg, device=device)
        return Trainer(self.loss, model, tcfg, device=device, mesh=self.mesh,
                       in_shardings=(self.param_shardings, self.batch_shardings))

    def __call__(self, trainer, batch) -> Dict[str, Any]:
        return trainer.step_tensors(batch)


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Any,
                     opt: Optional[adamw.AdamWConfig] = None,
                     segment_sizes: Optional[Tuple[int, ...]] = None,
                     n_micro: Optional[int] = None, opts: Tuple[str, ...] = (),
                     hbm_bytes: Optional[float] = None, device: str = "cuda",
                     segment_remat: Optional[Tuple[bool, ...]] = None):
    """The reference's ``build_train_step``: the rules its knobs select, the
    segment plan (:func:`segment_plan`, with ``"dp_only"``'s model axis
    joining the batch) unless ``segment_sizes`` (and ``segment_remat``,
    by default none rematerialized) is given, and the step
    (:class:`TrainStep`).  ``hbm_bytes`` is the memory the plan budgets
    (None: the CUDA card's)."""
    set_step_rules(shape, opts)
    sizes = sh.axis_sizes_of(mesh)
    model_shards = 1 if "dp_only" in opts else sizes.get("model", 1)
    if segment_sizes is None:
        sp, _ = segment_plan(cfg, shape, sizes, model_shards_override=model_shards,
                             hbm_bytes=hbm_bytes, device=device)
        if sp is not None:
            segment_sizes, segment_remat = sp.sizes, sp.remat
            n_micro = n_micro or sp.n_micro
    p_sh = _by_port_name(cfg, mesh)
    o_sh = {"step": specs.replicated(mesh), "mu": p_sh, "nu": p_sh}
    b_sh = specs.input_shardings(cfg, shape, mesh)
    rep = specs.replicated(mesh)
    step = TrainStep(mesh, segment_sizes, segment_remat, n_micro or 1, "mp" in opts,
                     opt or adamw.AdamWConfig(), p_sh, b_sh)
    params = _param_meta(cfg)
    f32 = {n: specs._sds(p.shape, torch.float32) for n, p in params.items()}
    example = (params, {"step": specs._sds((), torch.int32), "mu": f32, "nu": dict(f32)},
               specs.input_specs(cfg, shape))
    return (step, (p_sh, o_sh, b_sh),
            (p_sh, o_sh, {"grad_norm": rep, "lr": rep, "loss": rep}), example)


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Any,
                       segment_sizes: Optional[Tuple[int, ...]] = None):
    """The reference's ``build_prefill_step``: the forward's logits (its
    rules are whatever is active, as the reference's)."""
    if cfg.encoder_decoder:

        def prefill(model, batch):
            return model.decode_train(batch["tokens"], model.encode(batch["frames"]))

    else:

        def prefill(model, batch):
            return model.forward(batch["tokens"], batch.get("extra_embeds"),
                                 segment_sizes=segment_sizes)

    p_sh = _by_port_name(cfg, mesh)
    b_sh = specs.input_shardings(cfg, shape, mesh)
    example = (_param_meta(cfg, cfg.activation_dtype), specs.input_specs(cfg, shape))
    return (prefill, (p_sh, b_sh), logits_sharding(cfg, shape.global_batch, mesh), example)


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Any,
                      opts: Tuple[str, ...] = ()):
    """The reference's ``build_decode_step``: ``decode_step`` on the caches,
    shardings in its order ``(params, caches, tokens, positions)``;
    ``"ws"`` sets the weight-stationary rules (the module docstring)."""
    set_step_rules(shape, opts)

    def serve_step(model, caches, tokens, positions):
        return model.decode_step(tokens, caches, positions)

    caches = specs.cache_specs(cfg, shape)
    p_sh, tok_sh, c_sh, pos_sh = decode_shardings(cfg, shape, mesh, caches)
    inputs = specs.input_specs(cfg, shape)
    example = (_param_meta(cfg, cfg.activation_dtype), caches, inputs["tokens"],
               inputs["positions"])
    return (serve_step, (p_sh, c_sh, tok_sh, pos_sh),
            (logits_sharding(cfg, shape.global_batch, mesh), c_sh), example)


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Any,
               opts: Tuple[str, ...] = (), **kw) -> Tuple[Callable, Any, Any, Any]:
    """Dispatch on the shape kind: train / prefill / decode."""
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, opts=opts, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, **kw)
    return build_decode_step(cfg, shape, mesh, opts=opts)
