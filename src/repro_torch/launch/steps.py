"""The launchers' planning step (port of ``repro/launch/steps.py``).

The reference's step builders (``build_train_step`` and friends) return
jitted, sharded step functions; in the port the training step is the
``Trainer``'s eager loop, so only ``segment_plan`` comes across.  The
reference reads the data/model axis sizes off a jax ``Mesh``; one card has
no mesh, so the port takes them as an ``{axis: size}`` dict, by default
``{"data": 1, "model": 1}`` (one card).
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.plan import plan_with_microbatching
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
                 hbm_bytes: Optional[float] = None):
    """The paper's technique, applied: DP-plan the remat segmentation, with
    the smallest feasible gradient-accumulation factor (§5.1's minimal-budget
    protocol turned inside out for a fixed per-device memory).

    ``hbm_bytes=None`` budgets against the CUDA card's memory.

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
        hbm_bytes=hbm_bytes,
    )
