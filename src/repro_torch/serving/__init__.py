"""Serving (port of ``repro/serving``): the slot-based continuous-batching
engine over the dense LM's decode step."""

from .engine import Engine, Request

__all__ = ["Engine", "Request"]
