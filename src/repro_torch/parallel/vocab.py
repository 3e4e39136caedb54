"""Lookups along a vocab-sharded dim: the embedding's rows and the loss's
gold logit on a model-parallel mesh (``models.layers.embed`` and
``softmax_xent`` call them there).

Each is a custom op, so that a ``core.fx_graph`` trace on such a mesh holds
it as one node (``sharding.propagate_node_specs`` prices it at its indices'
batch shards), with a plain implementation (``F.embedding``, a ``gather``)
and that implementation's gradient.  A DTensor never reaches the op:
:func:`embed_rows` and :func:`pick` (which the models and the replay of a
traced node, ``core.fx_graph.FxGraph.run_node``, call) run an autograd
function on the local shards instead, as Megatron's vocab-parallel
embedding does: each rank looks up the indices that fall in its slice of
the vocabulary, writes zeros for the others and returns a ``Partial`` sum
over the model axis, which the models' next sharding constraint reduces.
The backward scatters the cotangent into the rank's own slice, so the
table's gradient stays ``Shard(0)`` over the model axis (and ``Partial``
over the batch axes, reduced where the gradient meets its parameter's
placements) and no rank builds a V-wide one-hot.

A DTensor whose vocab dim is not sharded over the model axis (the vocab
does not divide it) takes the plain lookup, which DTensor runs locally.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


@torch.library.custom_op("repro_torch::vocab_embed", mutates_args=())
def vocab_embed_op(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of ``table`` (V, D): on a plain tensor, ``F.embedding``."""
    return F.embedding(tokens, table)


@vocab_embed_op.register_fake
def _(table, tokens):
    return table.new_empty((*tokens.shape, table.shape[1]))


def _embed_setup(ctx, inputs, output):
    table, tokens = inputs
    ctx.rows = table.shape[0]
    ctx.save_for_backward(tokens)


def _embed_backward(ctx, g):
    (tokens,) = ctx.saved_tensors
    return torch.ops.aten.embedding_dense_backward(g, tokens, ctx.rows, -1, False), None


vocab_embed_op.register_autograd(_embed_backward, setup_context=_embed_setup)


@torch.library.custom_op("repro_torch::vocab_pick", mutates_args=())
def vocab_pick_op(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]`` (..., V) → (...): on a plain tensor, a gather."""
    return logits.gather(-1, labels[..., None])[..., 0]


@vocab_pick_op.register_fake
def _(logits, labels):
    return logits.new_empty(labels.shape)


def _pick_setup(ctx, inputs, output):
    logits, labels = inputs
    ctx.shape = tuple(logits.shape)
    ctx.save_for_backward(labels)


def _pick_backward(ctx, g):
    (labels,) = ctx.saved_tensors
    grad = g.new_zeros(ctx.shape).scatter_(-1, labels[..., None], g[..., None])
    return grad, None


vocab_pick_op.register_autograd(_pick_backward, setup_context=_pick_setup)


def _model_dim(x: DTensor) -> int:
    from .sharding import BATCH_AXES

    names = x.device_mesh.mesh_dim_names or ()
    dims = [i for i, n in enumerate(names) if n not in BATCH_AXES]
    if len(dims) != 1:
        raise ValueError(f"a vocab lookup needs one model axis, got mesh {names}")
    return dims[0]


def _local_slice(index: torch.Tensor, size: int, mesh, dim: int):
    """(in-slice mask, local index) of ``index`` against this rank's slice
    of ``size`` entries along mesh dim ``dim``."""
    lo = mesh.get_local_rank(dim) * size
    inside = (index >= lo) & (index < lo + size)
    return inside, torch.where(inside, index - lo, torch.zeros_like(index))


def _indices(index: DTensor, mi: int) -> DTensor:
    """The indices replicated over the model axis (their batch shards kept)."""
    want = [Replicate() if i == mi else p for i, p in enumerate(index.placements)]
    return index if list(index.placements) == want else index.redistribute(
        index.device_mesh, want)


def _partial_over(index: DTensor, mi: int) -> list:
    return [Partial() if i == mi else p for i, p in enumerate(index.placements)]


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


class _LocalEmbed(torch.autograd.Function):
    """Rows of a table ``Shard(0)`` over the model axis and replicated over
    the others, at indices replicated over the model axis."""

    @staticmethod
    def forward(ctx, table: DTensor, tokens: DTensor, mi: int) -> DTensor:
        mesh, local = table.device_mesh, table.to_local()
        inside, idx = _local_slice(tokens.to_local(), local.shape[0], mesh, mi)
        out = F.embedding(idx, local).masked_fill(~inside[..., None], 0)
        ctx.save_for_backward(idx, inside)
        ctx.mi, ctx.rows, ctx.shape = mi, local.shape[0], tuple(table.shape)
        ctx.tok_placements = tuple(tokens.placements)
        shape = (*tokens.shape, table.shape[1])
        return DTensor.from_local(out, mesh, _partial_over(tokens, mi), run_check=False,
                                  shape=torch.Size(shape), stride=_contiguous_stride(shape))

    @staticmethod
    def backward(ctx, g: DTensor):
        idx, inside = ctx.saved_tensors
        mesh, mi = g.device_mesh, ctx.mi
        want = [Replicate() if i == mi else p for i, p in enumerate(ctx.tok_placements)]
        gl = (g if list(g.placements) == want else g.redistribute(mesh, want)).to_local()
        gl = gl.masked_fill(~inside[..., None], 0)
        grad = torch.ops.aten.embedding_dense_backward(gl, idx, ctx.rows, -1, False)
        # a sum over this rank's batch shard: Partial over the batch axes
        placements = [Shard(0) if i == mi else (Replicate() if p.is_replicate() else Partial())
                      for i, p in enumerate(ctx.tok_placements)]
        return DTensor.from_local(grad, mesh, placements, run_check=False,
                                  shape=torch.Size(ctx.shape),
                                  stride=_contiguous_stride(ctx.shape)), None, None


class _LocalPick(torch.autograd.Function):
    """``logits[..., labels]`` of logits sharded over the model axis on
    their last dim, at labels replicated over it; the other mesh dims
    shard logits and labels alike."""

    @staticmethod
    def forward(ctx, logits: DTensor, labels: DTensor, mi: int) -> DTensor:
        mesh, local = logits.device_mesh, logits.to_local()
        inside, idx = _local_slice(labels.to_local(), local.shape[-1], mesh, mi)
        out = local.gather(-1, idx[..., None])[..., 0].masked_fill(~inside, 0)
        ctx.save_for_backward(idx, inside)
        ctx.mi, ctx.local_shape = mi, tuple(local.shape)
        ctx.shape, ctx.placements = tuple(logits.shape), tuple(logits.placements)
        ctx.lab_placements = tuple(labels.placements)
        return DTensor.from_local(out, mesh, _partial_over(labels, mi), run_check=False,
                                  shape=labels.shape, stride=_contiguous_stride(labels.shape))

    @staticmethod
    def backward(ctx, g: DTensor):
        idx, inside = ctx.saved_tensors
        mesh, mi = g.device_mesh, ctx.mi
        want = [Replicate() if i == mi else p for i, p in enumerate(ctx.lab_placements)]
        gl = (g if list(g.placements) == want else g.redistribute(mesh, want)).to_local()
        grad = gl.new_zeros(ctx.local_shape).scatter_(
            -1, idx[..., None], gl.masked_fill(~inside, 0)[..., None])
        return DTensor.from_local(grad, mesh, list(ctx.placements), run_check=False,
                                  shape=torch.Size(ctx.shape),
                                  stride=_contiguous_stride(ctx.shape)), None, None


def _vocab_sharded(x: DTensor, mi: int, dim: int) -> bool:
    p = x.placements[mi]
    return p.is_shard() and p.dim % x.ndim == dim % x.ndim


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of ``table`` (V, D): the op on a plain tensor (in a
    trace, a node), the local lookup on a vocab-sharded DTensor."""
    if not isinstance(table, DTensor):
        return vocab_embed_op(table, tokens)
    mi = _model_dim(table)
    if not _vocab_sharded(table, mi, 0):
        return F.embedding(tokens, table)
    # gather the table over every other axis first (FSDP's data shards):
    # its gradient is then reduced there in the table's own dtype
    want = [Shard(0) if i == mi else Replicate() for i in range(table.device_mesh.ndim)]
    if list(table.placements) != want:
        table = table.redistribute(table.device_mesh, want)
    return _LocalEmbed.apply(table, _indices(tokens, mi), mi)


def pick(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``: the op on a plain tensor (in a trace, a
    node), the local pick on logits vocab-sharded over the model axis."""
    if not isinstance(logits, DTensor):
        return vocab_pick_op(logits, labels)
    mi = _model_dim(logits)
    if not _vocab_sharded(logits, mi, -1):
        return logits.gather(-1, labels[..., None])[..., 0]
    labels = _indices(labels, mi)
    if any(a != b for i, (a, b) in enumerate(zip(logits.placements, labels.placements))
           if i != mi):
        raise ValueError(f"logits {logits.placements} and labels {labels.placements} "
                         "differ off the model axis")
    return _LocalPick.apply(logits, labels, mi)
