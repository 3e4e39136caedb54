"""Persistence helpers of the port (JSON half only)."""

from .store import atomic_write_json, read_json

__all__ = ["atomic_write_json", "read_json"]
