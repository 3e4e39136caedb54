"""Moving parameters between the reference's tree and the port's modules.

The reference's ``LM.init`` returns a nested dict whose ``"layers"`` leaves
are stacked along a leading unit axis (``WhisperModel.init``: its
``"encoder"`` and ``"decoder"`` leaves, along the layer axis); the port
keeps one module per unit (``layers.{i}.…``, ``encoder.{i}.…``).  Leaves
outside those keys (the embedding, the head, the hybrid's one
``shared_attn`` param set, whisper's positional tables) keep their shapes;
a stacked leaf loses its unit axis (an MoE expert leaf (units, E, D, F)
becomes rank 3).  ``params_from_jax`` turns the reference tree, as numpy
arrays, into a state dict for ``LM.load_state_dict``; ``params_to_jax`` is
its inverse.  The parity tests use both, so the two packages run on the
same weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

STACKED = ("layers", "encoder", "decoder")


def _stacked_key(name: str) -> Optional[str]:
    """The stacked top-level key a parameter name lies under, if any."""
    top = name.split(".", 1)[0]
    return top if top in STACKED and "." in name else None


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def params_from_jax(np_tree: Mapping[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    """Reference param tree (numpy leaves) → the port's state dict."""
    state: Dict[str, torch.Tensor] = {}
    for name, leaf in _flatten(np_tree).items():
        arr = np.asarray(leaf)
        top = _stacked_key(name)
        if top:
            rest = name[len(top) + 1:]
            for i in range(arr.shape[0]):
                state[f"{top}.{i}.{rest}"] = torch.tensor(arr[i], device=device)
        else:
            state[name] = torch.tensor(arr, device=device)
    return state


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict → the reference's nested tree (numpy leaves)."""
    flat: Dict[str, Any] = {}
    stacked: Dict[str, Dict[int, np.ndarray]] = {}
    for name, t in state.items():
        arr = t.detach().cpu().numpy()
        top = _stacked_key(name)
        if top:
            idx, rest = name[len(top) + 1:].split(".", 1)
            stacked.setdefault(f"{top}.{rest}", {})[int(idx)] = arr
        else:
            flat[name] = arr
    for name, parts in stacked.items():
        flat[name] = np.stack([parts[i] for i in sorted(parts)])
    tree: Dict[str, Any] = {}
    for name, arr in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def reference_ndim(name: str, t: torch.Tensor) -> int:
    """Rank of the reference leaf a port parameter comes from: per-unit
    parameters gain the stacked unit axis."""
    return t.dim() + (1 if _stacked_key(name) else 0)
