"""The ``Lowering`` interface: one plan, many executable forms (port of
``repro/core/lowering/base.py``).

A *lowering backend* turns ``(carrier, ExecutionPlan)`` into a runnable
value-and-grad twin of the carried computation on PyTorch autograd.
Backends register under a short name (``"interpreter"``, ``"segment"``,
``"fx"``); ``resolve_backend(name, carrier)`` picks one, with ``"auto"``
selecting each carrier's production path.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, List, Sequence, Tuple

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
        out.append(torch.zeros_like(t) if g is None else g)
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
        return loss.detach(), pytree.tree_unflatten(grads, spec)

    return f


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
