"""Checkpointing of the port (``repro/checkpointing`` restated for torch)."""

from .store import (
    AsyncCheckpointer,
    atomic_write_json,
    latest_step,
    read_json,
    restore,
    retain,
    save,
)

__all__ = [
    "AsyncCheckpointer",
    "atomic_write_json",
    "latest_step",
    "read_json",
    "restore",
    "retain",
    "save",
]
