"""Analytic per-op cost model: the port's copy of ``repro/core/cost_model.py``.

§3 of the paper: "We can either directly measure T_v … or use some form of
approximation."  This copy keeps the analytic half of the reference: the
``OpProfile`` rates, ``DEFAULT_PROFILE``, ``node_seconds``,
``measured_times``, ``calibrated_graph`` and ``roofline_seconds``, with the
logic unchanged.  Three rates price a node:

* ``sec_per_flop_matmul``     — compute-bound ops priced by their FLOPs;
* ``sec_per_flop_attention``  — attention-kind nodes;
* ``sec_per_byte_elementwise``— everything else priced by its output bytes.

``calibrated_graph`` maps a FLOP-carrying graph (``launch.plan.chain_graph``
whose interior nodes carry unit FLOPs) to seconds, then feeds the result
through ``dp.quantize_times``.  Calibration changes ``T_v`` and therefore
the graph digest, so plans priced by different profiles never alias.

The measured half (``profile_ops``/``load_or_profile``, which time ops on
the device) raises ``NotImplementedError`` until its torch twin is written.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .dp import quantize_times
from .graph import Graph, Node
from .prims import ATTENTION_KINDS, MATMUL_KINDS  # shared tables (core.prims)

# Host-link (PCIe-gen4-x16-class) and int8 block-codec throughputs pricing
# the "offload"/"quantize" storage strategies.  Defined in core.strategies
# (import-light) and re-exported here as the cost-model surface; a measured
# OpProfile can override them per backend.
from .strategies import (  # noqa: F401  (re-export)
    DEFAULT_HOST_BYTES_PER_SEC,
    DEFAULT_QUANTIZE_BYTES_PER_SEC,
)

PROFILE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class OpProfile:
    """Measured throughput rates for one backend (seconds per unit work)."""

    sec_per_flop_matmul: float
    sec_per_flop_attention: float
    sec_per_byte_elementwise: float
    backend: str = "unknown"
    jax_version: str = "unknown"
    #: Host-link (PCIe/ICI) bandwidth for offloaded residuals; defaulted so
    #: profiles serialized before the strategy lattice existed still load.
    host_bytes_per_sec: float = DEFAULT_HOST_BYTES_PER_SEC
    #: int8 block-codec throughput for quantized residuals.
    quantize_bytes_per_sec: float = DEFAULT_QUANTIZE_BYTES_PER_SEC
    #: Where the rates came from: "measured" (microbenchmarks, the default),
    #: "analytic" (DEFAULT_PROFILE's roofline constants), or "compiled"
    #: (XLA cost_analysis per-segment numbers, see
    #: ``compiled_calibrated_graph``).  Non-measured sources are suffixed
    #: into ``profile_key`` so differently-sourced calibrations never share
    #: a cache identity.
    source: str = "measured"

    def profile_key(self) -> str:
        base = f"{self.backend}-{self.jax_version}-v{PROFILE_VERSION}"
        return base if self.source == "measured" else f"{base}-{self.source}"


#: Analytical fallback (rough TPU-v5e-class numbers) used when profiling is
#: disabled or fails — keeps calibration total-order-correct without timing.
DEFAULT_PROFILE = OpProfile(
    sec_per_flop_matmul=1.0 / 100e12,
    sec_per_flop_attention=1.0 / 50e12,
    sec_per_byte_elementwise=1.0 / 500e9,
    backend="analytic",
    jax_version="-",
    source="analytic",
)


def profile_ops(*args: Any, **kwargs: Any) -> OpProfile:
    """Time representative ops on the current device and fit the rates.

    The reference times jax ops and the Pallas kernel; the port's twin
    (timed with torch on the card, keyed by torch version + device) is not
    written yet.
    """
    raise NotImplementedError(
        "profile_ops is not ported yet: ROADMAP.md module queue, "
        "item 'Measured cost profile'"
    )


def load_or_profile(cache_dir: Optional[str] = None,
                    profiler: Any = profile_ops) -> OpProfile:
    """Load the device's profile from ``cache_dir`` or measure and store it."""
    raise NotImplementedError(
        "load_or_profile is not ported yet: ROADMAP.md module queue, "
        "item 'Measured cost profile'"
    )


# ---------------------------------------------------------------------------
# Applying a profile to a graph.
# ---------------------------------------------------------------------------


def node_seconds(nd: Node, profile: OpProfile) -> float:
    """Calibrated wall-clock estimate for one node.

    Compute-bound kinds read FLOPs from ``time``; all other kinds are priced
    memory-bound from their output bytes (``memory``).  The floor keeps
    Graph's positive-cost invariant.
    """
    if nd.kind in MATMUL_KINDS:
        sec = nd.time * profile.sec_per_flop_matmul
    elif nd.kind in ATTENTION_KINDS:
        sec = nd.time * profile.sec_per_flop_attention
    else:
        sec = nd.memory * profile.sec_per_byte_elementwise
    return max(sec, 1e-12)


def measured_times(g: Graph, profile: OpProfile) -> Graph:
    """New graph with ``T_v`` = calibrated seconds (topology/memory kept)."""
    nodes = [
        Node(nd.idx, nd.name, node_seconds(nd, profile), nd.memory, nd.kind,
             must_store=nd.must_store)
        for nd in g.nodes
    ]
    return Graph(nodes, g.edges,
                 cost_source=f"profile:{profile.profile_key()}")


def calibrated_graph(g: Graph, profile: OpProfile, levels: int = 64) -> Graph:
    """Measured seconds → integer DP t-axis (``dp.quantize_times``).

    This is the drop-in replacement for ``quantize_times(flop_graph)``: same
    output contract (small positive integer ``T_v``), hardware-true ratios.
    """
    return quantize_times(measured_times(g, profile), levels=levels)


# ---------------------------------------------------------------------------
# Roofline estimate.
# ---------------------------------------------------------------------------


def roofline_seconds(flops: float, nbytes: float, profile: OpProfile) -> float:
    """Roofline wall-clock estimate: max of compute and memory time."""
    return max(
        flops * profile.sec_per_flop_matmul,
        nbytes * profile.sec_per_byte_elementwise,
        1e-12,
    )
