"""The benchmark's weights: every parameter of a configuration, drawn from
the run's seed on the device in a few large calls.

Both the program (loaded into the port's model by name) and the plain
reference get their initial weights from :func:`generate`, so neither
takes the other's.  Which leaves there are, their names, shapes and
scales, is the configuration's model module's (``leaves`` of the module
under ``perfbench/reference/`` that the configuration names; ``lm``'s:
matrices N(0, 1/fan_in), the embedding N(0, 1), norm scales ones).
:func:`leaves` is that list, named as the port's model names its
parameters; the harness checks it against the model's, name for name and
shape for shape.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch

#: elements drawn by one ``torch.randn`` call (1 GiB of float32)
CHUNK = 1 << 28

Leaf = Tuple[str, Tuple[int, ...], Optional[float]]  # scale None: ones


def leaves(config: dict) -> List[Leaf]:
    """Every parameter of ``config``, as its model module's ``leaves``
    lists them (``perfbench.reference.model``)."""
    from perfbench.reference import model

    return model(config).leaves(config)


def numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def generate(config: dict, seed: int, device, chunk: int = CHUNK
             ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, float32 tensor) once for every leaf of :func:`leaves`: norm
    scales as they come, the random leaves a draw at a time.  They are cut from ``torch.randn`` draws of up to ``chunk``
    elements of one generator on ``device`` seeded with ``seed``, so the
    same seed gives the same weights on the same device."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    pending: List[Leaf] = []

    def flush():
        total = sum(numel(s) for _, s, _ in pending)
        draw = torch.randn(total, generator=gen, device=device)
        at = 0
        for name, shape, scale in pending:
            n = numel(shape)
            yield name, (draw[at:at + n] * scale).view(shape)
            at += n
        pending.clear()

    for leaf in leaves(config):
        name, shape, scale = leaf
        if scale is None:
            yield name, torch.ones(shape, device=device)
            continue
        if pending and sum(numel(s) for _, s, _ in pending) + numel(shape) > chunk:
            yield from flush()
        pending.append(leaf)
    if pending:
        yield from flush()
