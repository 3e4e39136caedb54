"""``repro_torch::shard``: the reference's ``with_sharding_constraint`` as a
custom op (``sharding.shard`` calls it on a mesh that splits more than the
batch).

Being one registered operator, the constraint survives ``make_fx``: the
traced graph holds it as a node whose output spec is the resolved logical
spec (``sharding.propagate_node_specs``), so the planner prices the
constrained layout (the sequence-parallel residual, the vocab-sharded
logits).  Its plain implementation is a copy.  A DTensor never reaches the
op: :func:`constrain` (which ``sharding.shard`` and the replay of a traced
node, ``core.fx_graph.FxGraph.run_node``, call) redistributes it onto the
spec resolved on its own mesh, a copy when the placements already agree,
in an autograd function whose backward constrains the cotangent to the
same spec, as the transpose of ``with_sharding_constraint`` does.  That
keeps the op off DTensor's dispatcher, whose hooks for custom ops differ
between torch versions.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from . import sharding as sh


@torch.library.custom_op("repro_torch::shard", mutates_args=())
def shard_op(x: torch.Tensor, logical: str) -> torch.Tensor:
    """``x`` constrained to the logical axes ``logical`` (see
    ``sharding.encode_logical``): on a plain tensor, a copy."""
    return x.clone()


@shard_op.register_fake
def _(x, logical):
    return torch.empty_like(x)


def _setup_context(ctx, inputs, output):
    ctx.logical = inputs[1]


def _backward(ctx, g):
    return constrain(g, ctx.logical), None


shard_op.register_autograd(_backward, setup_context=_setup_context)


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed onto the logical spec, and its cotangent
    likewise."""

    @staticmethod
    def forward(ctx, x: DTensor, logical: str) -> DTensor:
        ctx.logical = logical
        mesh = x.device_mesh
        spec = sh.resolve(sh.decode_logical(logical), mesh, shape=tuple(x.shape))
        want = sh.spec_to_placements(spec, mesh)
        if list(x.placements) == want:
            return x.clone()  # an op's output never aliases its input
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, g):
        return constrain(g, ctx.logical), None


def constrain(x: torch.Tensor, logical: str) -> torch.Tensor:
    """The constraint on a DTensor (redistributed) or any other tensor (the
    op: recorded by a trace, a copy when run)."""
    if isinstance(x, DTensor):
        return _Constrain.apply(x, logical)
    return shard_op(x, logical)
