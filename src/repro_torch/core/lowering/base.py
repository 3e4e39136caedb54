"""The ``Lowering`` interface: one plan, many executable forms (port of
``repro/core/lowering/base.py``).

A *lowering backend* turns ``(carrier, ExecutionPlan)`` into a runnable
value-and-grad twin of the carried computation on PyTorch autograd.
Backends register under a short name (``"interpreter"``, ``"segment"``,
``"fx"``); ``resolve_backend(name, carrier)`` picks one, with ``"auto"``
selecting each carrier's production path.

Every backend runs on DTensors too (a carrier traced on a ``DeviceMesh``):
:func:`on_mesh` runs the twin with plain tensors made inside it (an
``arange``, a mask) taken as replicated, :func:`grads_like` returns each
gradient in its input's placements (a replicated parameter's
``Partial(sum)`` gradient is all-reduced there) and :func:`value_out` the
loss replicated.
"""

from __future__ import annotations

import abc
import contextlib
import functools
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from ..schedule import ExecutionPlan


class InfeasibleBudgetError(ValueError):
    """No canonical strategy fits the requested budget (typed, so callers
    can distinguish infeasibility from configuration errors)."""


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md module queue, item {item!r}"
    )


#: The mesh axes a twin can run sharded over: the data axes and the model
#: axis of tensor parallelism.  Any other axis of a concrete mesh must have
#: size 1.
EXECUTABLE_AXES = ("pod", "data", "model")


def check_executable_mesh(mesh: Any) -> None:
    """Raise for a mesh (a ``DeviceMesh`` or an ``{axis: size}`` dict) with
    an axis larger than 1 that no twin runs sharded over."""
    from ...parallel.sharding import axis_sizes_of

    for name, size in axis_sizes_of(mesh).items():
        if name not in EXECUTABLE_AXES and size > 1:
            raise not_ported(f"execution over mesh axis {name!r} of size {size}",
                             "Multi-device")


def check_plan_on_mesh(carrier: Any, plan: ExecutionPlan) -> None:
    """What a twin cannot run on DTensors raises here, naming ROADMAP.md
    'Multi-device', instead of running unsharded: a mesh axis other than
    ``pod``, ``data`` and ``model`` (:func:`check_executable_mesh`).
    Storage strategies hold a DTensor's local shard (``storage``), and a
    recomputed random draw replays the generator states DTensor's draws
    read (:func:`rng_snapshot`)."""
    from ...parallel.sharding import is_device_mesh

    mesh = getattr(carrier, "mesh", None)
    if is_device_mesh(mesh):
        check_executable_mesh(mesh)


def rng_snapshot(devices: Sequence[int]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The generator states a random draw reads: the CPU's and each CUDA
    device's.  DTensor's draws read them too: on a CUDA mesh its
    ``OffsetBasedRNGTracker`` (``torch.distributed.tensor._random``) offsets
    the CUDA generator by the shard's place and keeps no state of its own
    (torch 2.11 and 2.13), and a CPU mesh takes no tracker."""
    return torch.get_rng_state(), [torch.cuda.get_rng_state(d) for d in devices]


@contextlib.contextmanager
def rng_restored(state: Tuple[torch.Tensor, List[torch.Tensor]],
                 devices: Sequence[int]) -> Iterator[None]:
    """Run with the generators set to ``state``; the global state is left as
    it was on entry (``torch.utils.checkpoint``'s ``preserve_rng_state``)."""
    with torch.random.fork_rng(devices=devices):
        torch.set_rng_state(state[0])
        for d, s in zip(devices, state[1]):
            torch.cuda.set_rng_state(s, d)
        yield


def is_dtensor(t: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The tensor this process holds: a DTensor's local shard (a view, so
    in-place updates show through), any other tensor itself."""
    return t.to_local() if is_dtensor(t) else t


@contextlib.contextmanager
def on_mesh(leaves: Sequence[Any]) -> Iterator[None]:
    """Run with DTensor's implicit replication when any leaf is a DTensor:
    a plain tensor the traced function makes itself (``arange``, a mask)
    then meets DTensors as a replicated value, as a constant does under
    GSPMD."""
    if any(is_dtensor(t) for t in leaves):
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            yield
    else:
        yield


def mesh_aware(run: Callable[..., Any]) -> Callable[..., Any]:
    """``run`` under :func:`on_mesh` of its arguments' tensor leaves."""

    @functools.wraps(run)
    def wrapped(*args):
        with on_mesh(pytree.tree_leaves(args)):
            return run(*args)

    return wrapped


def value_out(loss: torch.Tensor) -> torch.Tensor:
    """The twin's returned value: detached and, on a mesh, replicated (a
    mean over a sharded batch is ``Partial(avg)`` until then)."""
    loss = loss.detach()
    if is_dtensor(loss) and not all(p.is_replicate() for p in loss.placements):
        from torch.distributed.tensor import Replicate

        loss = loss.redistribute(loss.device_mesh, [Replicate()] * loss.device_mesh.ndim)
    return loss


def in_layout(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A gradient in its input's DTensor placements (``Partial`` → the
    input's ``Replicate``/``Shard``: the all-reduce or reduce-scatter)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(like.placements):
        return g.redistribute(like.device_mesh, like.placements)
    return g


def reject_track_live(backend_name: str) -> None:
    """Shared guard for the autograd-owned backends (no audit trail)."""
    raise ValueError(
        f"track_live is interpreter-only (autograd owns the saved tensors "
        f"under the {backend_name!r} backend)"
    )


def reject_donate(backend_name: str) -> None:
    """Shared guard for the backends that hold no residual of their own to
    release early (the reference: no XLA jit boundary to hint)."""
    raise ValueError(
        f"donate=True releases the residuals a lowering holds itself; the "
        f"{backend_name!r} backend keeps only U_k already (use 'fx' or 'segment')"
    )


def diff_leaves(tree: Any) -> Tuple[List[torch.Tensor], Any]:
    """Detached copies of a pytree's tensor leaves, floating ones requiring
    grad (the twin never extends the caller's autograd graph)."""
    leaves, spec = pytree.tree_flatten(tree)
    out = [t.detach().requires_grad_(t.is_floating_point()) for t in leaves]
    return out, spec


def grads_like(loss: torch.Tensor, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d leaves, with zeros for leaves the loss does not reach."""
    wanted = [t for t in leaves if t.requires_grad]
    got = iter(torch.autograd.grad(loss, wanted, allow_unused=True) if wanted else ())
    out = []
    for t in leaves:
        g = next(got) if t.requires_grad else None
        out.append(torch.zeros_like(t) if g is None else in_layout(g, t))
    return out


def blockgraph_value_and_grad(fwd: Callable[..., Any],
                              loss_fn: Callable[..., torch.Tensor]):
    """Value and parameter grads of ``loss_fn`` over a BlockGraph forward
    ``fwd(params, inputs)`` (tuple or single value)."""

    def f(params, inputs):
        leaves, spec = diff_leaves(params)
        out = fwd(pytree.tree_unflatten(leaves, spec), inputs)
        loss = loss_fn(*out) if isinstance(out, tuple) else loss_fn(out)
        grads = grads_like(loss, leaves)
        return value_out(loss), pytree.tree_unflatten(grads, spec)

    return mesh_aware(f)


class Lowering(abc.ABC):
    """One way of executing an :class:`ExecutionPlan`.

    ``lower`` returns a callable with the carrier's calling convention:

    * BlockGraph carrier — ``f(params, inputs) -> (loss, param_grads)``;
    * traced carrier     — ``f(*args) -> (value, grads)`` (grads w.r.t.
      ``argnums``, like ``jax.value_and_grad``).

    ``track_live=True`` (interpreter only) appends a live-byte trace:
    ``f(...) -> (loss, grads, [(tag, bytes), ...])``.

    ``donate=True`` (``"fx"``, ``"segment"``) drops the twin's own
    references to values that cross segments once no later segment reads
    them, and attaches ``donate_argnums`` and the per-segment dead-at-peak
    ``donation_hints`` (see ``lowering.donation``); values and gradients
    are unchanged.
    """

    #: registry name, e.g. "interpreter"
    name: str = "?"

    @abc.abstractmethod
    def supports(self, carrier: Any) -> bool:
        """Whether this backend can lower plans for ``carrier``."""

    @abc.abstractmethod
    def lower(self, carrier: Any, plan: ExecutionPlan, track_live: bool = False,
              donate: bool = False) -> Callable[..., Any]:
        """Lower ``plan`` over ``carrier`` into a value-and-grad callable."""


_REGISTRY: Dict[str, Lowering] = {}


def register_lowering(backend: Lowering) -> Lowering:
    """Register a backend instance under ``backend.name`` (last wins)."""
    _REGISTRY[backend.name] = backend
    return backend


def get_lowering(name: str) -> Lowering:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown lowering backend {name!r}; "
            f"available: {sorted(_REGISTRY)}"
        ) from None


def available_backends(carrier: Any = None) -> List[str]:
    """Registered backend names (optionally those supporting ``carrier``)."""
    if carrier is None:
        return sorted(_REGISTRY)
    return sorted(n for n, b in _REGISTRY.items() if b.supports(carrier))


def resolve_backend(name: str, carrier: Any) -> Lowering:
    """``name`` or the carrier's production default for ``"auto"``."""
    if name == "auto":
        name = carrier.default_backend
    backend = get_lowering(name)
    if not backend.supports(carrier):
        raise ValueError(
            f"backend {name!r} does not support {type(carrier).__name__}; "
            f"use one of {available_backends(carrier)}"
        )
    return backend
