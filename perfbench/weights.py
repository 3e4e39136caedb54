"""The benchmark's weights: every parameter of a configuration, drawn from
the run's seed on the device in a few large calls.

Both the program (loaded into the port's model by name) and the plain
reference get their initial weights from :func:`generate`, so neither
takes the other's.  Matrices are N(0, 1/fan_in) (fan_in: the dimension a
product contracts), the embedding N(0, 1), norm scales ones; a table tied
to the output head is the head's matrix too and draws N(0, 1/d_model).  Leaves are
named as the port's ``LM`` names its parameters; :func:`leaves` is the
list and the harness checks it against the model's, name for name and
shape for shape.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch

#: elements drawn by one ``torch.randn`` call (1 GiB of float32)
CHUNK = 1 << 28

Leaf = Tuple[str, Tuple[int, ...], Optional[float]]  # scale None: ones


def leaves(config: dict) -> List[Leaf]:
    p, moe = config["port"], config.get("moe")
    V, d, H, KV, Dh = p["vocab_size"], p["d_model"], p["n_heads"], p["n_kv_heads"], p["d_head"]
    out: List[Leaf] = [("embedding.embed", (V, d), d ** -0.5 if p["tie_embeddings"] else 1.0)]
    for u in range(p["n_layers"]):
        pre = f"layers.{u}.b0_attn_moe." if moe else f"layers.{u}.b0_attn_mlp."
        out += [
            (pre + "ln1.scale", (d,), None),
            (pre + "attn.wq", (d, H * Dh), d ** -0.5),
            (pre + "attn.wk", (d, KV * Dh), d ** -0.5),
            (pre + "attn.wv", (d, KV * Dh), d ** -0.5),
            (pre + "attn.wo", (H * Dh, d), (H * Dh) ** -0.5),
            (pre + "ln2.scale", (d,), None),
        ]
        if moe:
            E, F = moe["num_experts"], moe["d_ff_expert"]
            out += [
                (pre + "moe.router", (d, E), d ** -0.5),
                (pre + "moe.experts.w_gate", (E, d, F), d ** -0.5),
                (pre + "moe.experts.w_up", (E, d, F), d ** -0.5),
                (pre + "moe.experts.w_down", (E, F, d), F ** -0.5),
            ]
        else:
            F = p["d_ff"]
            out += [
                (pre + "mlp.w_gate", (d, F), d ** -0.5),
                (pre + "mlp.w_up", (d, F), d ** -0.5),
                (pre + "mlp.w_down", (F, d), F ** -0.5),
            ]
    out.append(("final_norm.scale", (d,), None))
    if not p["tie_embeddings"]:
        out.append(("head.unembed", (V, d), d ** -0.5))
    return out


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
