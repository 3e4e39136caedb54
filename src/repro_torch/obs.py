"""Spans and counters of the port's layers, on the profiler's clock.

The program's layers mark where their work happens with :func:`span` and
count what they do with :func:`count` and :func:`count_device`.  Both are
off unless an operator turns them on with :func:`recording`; off, a span is
one shared no-op context manager (nothing allocated, no clock read) and a
count does nothing.  On, a span is a ``torch.profiler.record_function``
named ``"repro." + name``, so under ``torch.profiler.profile`` it is an
event of the profiler's own timeline, on the clock of the device's kernel
records::

    with obs.recording(), torch.profiler.profile(activities=[CPU, CUDA]) as prof:
        trainer.train_step(batch)
    table = obs.span_table(prof)   # one row per span name, and "(outside)"
    counts = obs.counters()

A span's arguments become part of its event's name (``remat.recompute
[index=3,units=2,remat=True]``: the profiler keeps no record function
arguments); :func:`span_table` groups by the name before the bracket.
Spans and counters are no-ops while ``core.fx_graph`` traces, so a
``make_fx`` trace (its node counts, plan digests and cache keys) does not
depend on whether recording is on.

This is the only module of the port that touches the profiler.
"""

from __future__ import annotations

import contextlib
import heapq
import threading
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import torch

PREFIX = "repro."
#: the row of kernels and idle time no span owns
OUTSIDE = "(outside)"
#: the profiler's name of a backward node's evaluation
BACKWARD = "autograd::engine::evaluate_function: "

_NOOP = contextlib.nullcontext()
_on = False
_lock = threading.Lock()
_host: Dict[str, float] = {}
_device: Dict[str, torch.Tensor] = {}


def enabled() -> bool:
    """Whether spans and counters record here: recording is on and no
    ``core.fx_graph`` trace is running in this context."""
    if not _on:
        return False
    from repro_torch.core.fx_graph import tracing

    return not tracing()


def span(name: str, **args: Any):
    """A context manager marking ``name``'s work: a profiler record function
    while recording, else one shared no-op."""
    if not enabled():
        return _NOOP
    if args:
        name += "[" + ",".join(f"{k}={v}" for k, v in args.items()) + "]"
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Turn spans and counters on (on every thread, so the backward's
    recompute records too), with the counters cleared."""
    global _on
    with _lock:
        _host.clear()
        _device.clear()
    before, _on = _on, True
    try:
        yield
    finally:
        _on = before


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the host counter ``name`` (while recording)."""
    if enabled():
        with _lock:
            _host[name] = _host.get(name, 0) + n


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the device scalar ``t`` into the device counter ``name`` (while
    recording), with no host read; a DTensor counts this rank's part."""
    if not enabled():
        return
    t = t.detach()
    if hasattr(t, "to_local"):
        t = t.to_local()
    with _lock:
        acc = _device.get(name)
        _device[name] = t.clone() if acc is None else acc.add_(t)


@contextlib.contextmanager
def timed(name: str) -> Iterator[None]:
    """Count the seconds spent in the block under ``name`` (while
    recording; no clock is read otherwise)."""
    if not enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        count(name, time.perf_counter() - t0)


def counters() -> Dict[str, float]:
    """Every counter since :func:`recording` began: host numbers as they
    are, device counters read in one sync."""
    with _lock:
        out = dict(_host)
        names = list(_device)
        vals = [_device[n] for n in names]
    if vals:
        got = torch.stack([v.to(device=vals[0].device, dtype=torch.float64)
                           for v in vals]).tolist()
        for n, v, g in zip(names, vals, got):
            out[n] = int(g) if not v.dtype.is_floating_point else g
    return out


# ------------------------------------------------------------------ the table


def _base(name: str) -> str:
    return name[len(PREFIX):].split("[", 1)[0]


def _is_device(e) -> bool:
    return e.device_type != torch.autograd.DeviceType.CPU


def _innermost_span(e) -> Optional[Any]:
    while e is not None and not e.name.startswith(PREFIX):
        e = e.cpu_parent
    return e


def _under_backward(e) -> bool:
    while e is not None:
        if e.name.startswith(BACKWARD):
            return True
        e = e.cpu_parent
    return False


def owners(events: Iterable) -> Dict[int, Tuple[str, str]]:
    """``id(event)`` → (span name, ``"self"`` or ``"bwd"``) for every host
    event: the innermost program span the event runs under on its thread
    (``"self"``), unless a backward node is nearer, whose time goes to the
    innermost span of its forward op (``"bwd"``, matched by the node's
    ``sequence_nr`` and ``fwd_thread``).  A span nested in a backward node
    (a checkpoint's re-run) owns its own ops.  Unowned: ``OUTSIDE``."""
    host = [e for e in events if not _is_device(e)]
    forward: Dict[Tuple[int, int], Any] = {}
    for e in host:
        if e.sequence_nr >= 0 and not _under_backward(e):
            forward.setdefault((e.thread, e.sequence_nr), e)
    out: Dict[int, Tuple[str, str]] = {}
    for e in host:
        p, got = e, (OUTSIDE, "self")
        while p is not None:
            if p.name.startswith(PREFIX):
                got = (_base(p.name), "self")
                break
            if p.name.startswith(BACKWARD):
                f = forward.get((p.fwd_thread, p.sequence_nr))
                s = _innermost_span(f)
                if s is not None:
                    got = (_base(s.name), "bwd")
                    break
            p = p.cpu_parent
        out[id(e)] = got
    return out


def _busy(device_events: List) -> List[List[float]]:
    merged: List[List[float]] = []
    for e in sorted(device_events, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def table(events: Iterable) -> Dict[str, Dict[str, Any]]:
    """:func:`span_table` of a profiler's events (``FunctionEvent``s, or
    objects with the same fields)."""
    events = list(events)
    device = [e for e in events if _is_device(e)]
    mirrors = {e.name for e in device if getattr(e, "is_user_annotation", False)}
    kernels = [e for e in device if e.name not in mirrors]
    host = [e for e in events if not _is_device(e)]

    # the profiler hands a launch's kernels to the op and again to runtime
    # events nested in it that share its correlation (``Command Buffer
    # Full``, module loading): a kernel an ancestor holds counts there
    held = {id(e): {(k.name, k.duration) for k in e.kernels} for e in host if e.kernels}
    launched: Dict[int, float] = {}

    def own(e) -> float:  # us of the kernels ``e`` launched itself
        if id(e) not in launched:
            us = 0.0
            for k in e.kernels:
                p = e.cpu_parent
                while p is not None and (k.name, k.duration) not in held.get(id(p), ()):
                    p = p.cpu_parent
                if p is None and k.name not in mirrors:
                    us += k.duration
            launched[id(e)] = us
        return launched[id(e)]

    memo: Dict[int, float] = {}

    def subtree(e) -> float:
        if id(e) not in memo:
            memo[id(e)] = own(e) + sum(subtree(c) for c in e.cpu_children)
        return memo[id(e)]

    def row() -> Dict[str, Any]:
        return {"calls": 0, "host_ms": 0.0, "device_ms": 0.0, "self_device_ms": 0.0,
                "bwd_device_ms": 0.0, "idle_ms": 0.0, "bwd_nodes": {}}

    rows: Dict[str, Dict[str, Any]] = {}
    spans = [e for e in host if e.name.startswith(PREFIX)]
    for e in spans:
        r = rows.setdefault(_base(e.name), row())
        r["calls"] += 1
        r["host_ms"] += (e.time_range.end - e.time_range.start) / 1e3
        r["device_ms"] += subtree(e) / 1e3
    rows[OUTSIDE] = row()
    who = owners(host)
    for e in host:
        name, kind = who[id(e)]
        r = rows[name]
        if kind == "bwd" and e.name.startswith(BACKWARD):
            node = e.name[len(BACKWARD):]
            r["bwd_nodes"][node] = r["bwd_nodes"].get(node, 0) + 1
        us = own(e)
        if us:
            r["self_device_ms" if kind == "self" else "bwd_device_ms"] += us / 1e3
    # each idle gap of the device goes to the innermost span open on the
    # host when it began (the latest begun among those open, any thread)
    busy = _busy(kernels)
    order = sorted(spans, key=lambda e: e.time_range.start)
    opened: List = []
    at = 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        while at < len(order) and order[at].time_range.start <= a:
            s = order[at]
            heapq.heappush(opened, (-s.time_range.start, s.time_range.end, at))
            at += 1
        while opened and opened[0][1] < a:
            heapq.heappop(opened)
        name = _base(order[opened[0][2]].name) if opened else OUTSIDE
        rows[name]["idle_ms"] += (b - a) / 1e3
    return rows


def span_table(prof) -> Dict[str, Dict[str, Any]]:
    """One row per span name of a finished ``torch.profiler.profile``:
    ``calls``; ``host_ms``; ``device_ms``, the kernels launched under the
    span's events on their thread, nested spans included; ``self_device_ms``,
    those of them no nested span or backward node owns; ``bwd_device_ms``,
    the kernels of the backward nodes whose forward op ran under the span
    (less the spans nested in them, such as a checkpoint's re-run), with
    ``bwd_nodes`` counting those nodes by name; ``idle_ms``, the device's
    idle gaps that began while the span was the innermost one open.  Row
    ``OUTSIDE`` holds what no span owns.  Each kernel is counted once
    across the ``self_device_ms`` and ``bwd_device_ms`` columns; ms are
    summed over the profiled steps."""
    return table(prof.events())
