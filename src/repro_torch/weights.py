"""Moving parameters between the reference's tree and the port's modules.

The reference's ``LM.init`` returns a nested dict whose ``"layers"`` leaves
are stacked along a leading unit axis; the port keeps one module per unit
(``layers.{i}.…``).  ``params_from_jax`` turns the reference tree, as numpy
arrays, into a state dict for ``LM.load_state_dict``; ``params_to_jax`` is
its inverse.  The parity tests use both, so the two packages run on the
same weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

STACKED = "layers"


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
        if name.startswith(STACKED + "."):
            rest = name[len(STACKED) + 1:]
            for i in range(arr.shape[0]):
                state[f"{STACKED}.{i}.{rest}"] = torch.tensor(arr[i], device=device)
        else:
            state[name] = torch.tensor(arr, device=device)
    return state


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict → the reference's nested tree (numpy leaves)."""
    flat: Dict[str, Any] = {}
    stacked: Dict[str, Dict[int, np.ndarray]] = {}
    for name, t in state.items():
        arr = t.detach().cpu().numpy()
        if name.startswith(STACKED + "."):
            idx, rest = name[len(STACKED) + 1:].split(".", 1)
            stacked.setdefault(rest, {})[int(idx)] = arr
        else:
            flat[name] = arr
    for rest, parts in stacked.items():
        flat[f"{STACKED}.{rest}"] = np.stack([parts[i] for i in sorted(parts)])
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
    return t.dim() + (1 if name.startswith(STACKED + ".") else 0)
