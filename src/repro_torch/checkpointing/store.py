"""Crash-safe JSON persistence: the port's copy of the JSON half of
``repro/checkpointing/store.py`` (``atomic_write_json``/``read_json``).

The reference module imports jax for its tensor-tree checkpoints, so the
port keeps its own copy of the two functions the plan cache needs.  The
tensor save/restore half waits for ROADMAP.md module queue, item
'Checkpointing'.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional


def atomic_write_json(path: str, obj: Any) -> None:
    """Crash-safe JSON write: temp file + atomic rename (shared with
    core.plan_cache's disk store)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_json(path: str) -> Optional[Any]:
    """Read a JSON file; None when missing or torn (partial/corrupt write).

    ValueError covers both JSONDecodeError and the UnicodeDecodeError a
    non-UTF-8 corrupted file raises before the JSON parser even runs.
    """
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
