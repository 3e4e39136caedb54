"""Per-op cost model: profiled T_v instead of FLOP proxies (port of
``repro/core/cost_model.py``).

§3 of the paper: "We can either directly measure T_v … or use some form of
approximation."  Three rates price a node:

* ``sec_per_flop_matmul``     — compute-bound ops priced by their FLOPs;
* ``sec_per_flop_attention``  — attention-kind nodes;
* ``sec_per_byte_elementwise``— everything else priced by its output bytes.

``profile_ops`` measures them on a device, at the reference's shapes: a
512³ f32 matmul, a 2²² f32 elementwise chain, and the port's
``repro_torch::flash_attention`` custom op (the reference times its Pallas
kernel).  On CUDA each op is timed with CUDA events after a warm-up call,
on the CPU with the host clock; the median of ``repeats`` calls is kept.
``load_or_profile`` keeps one profile per device and torch version on disk
(``checkpointing.store``'s atomic JSON), so a process profiles at most once
per device, ever.  The reference keys its profile by ``jax_version``; the
port keeps that field's name (and its JSON key) and fills it with
``torch.__version__``.

``calibrated_graph`` maps a FLOP-carrying graph (``launch.plan.chain_graph``
whose interior nodes carry unit FLOPs) to seconds, then feeds the result
through ``dp.quantize_times``.  ``compiled_calibrated_graph`` re-prices a
graph from per-segment FLOPs and bytes (``analysis.costs``, the port's twin
of XLA's ``cost_analysis()``).  Calibration changes ``T_v`` and therefore
the graph digest, so plans priced by different profiles never alias.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional, Sequence, Union

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
    #: the framework version: the reference's field (and JSON key), which
    #: holds ``torch.__version__`` in the port
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


def _median(xs: Sequence[float]) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _time_call(fn: Any, *args: Any, device: "torch.device", repeats: int = 3) -> float:
    """Median seconds of ``fn(*args)`` after a warm-up call: CUDA events on
    a card, the host clock on the CPU."""
    import torch

    fn(*args)  # warm-up: kernel builds, cuBLAS handles, workspaces
    ts = []
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    return max(_median(ts), 1e-9)


def _profile_device(device: Union[str, "torch.device"]) -> "torch.device":
    """The device a profile is measured on; CUDA without a card raises."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device to profile; pass device='cpu' to profile the CPU")
    return dev


def device_key(device: "torch.device") -> str:
    """The profile's ``backend``: ``cpu``, or ``cuda-<card name>``."""
    import torch

    if device.type == "cuda":
        return "cuda-" + torch.cuda.get_device_name(device).replace(" ", "_")
    return device.type


def profile_ops(
    matmul_dim: int = 512,
    elem_elems: int = 1 << 22,
    attn_shape: tuple = (1, 128, 2, 32),
    repeats: int = 3,
    include_attention: bool = True,
    device: Union[str, "torch.device"] = "cuda",
) -> OpProfile:
    """Time representative ops on ``device`` and fit the rates.

    The shapes are the reference's: small, since this runs inside tests and
    cold starts.  At them the flash op in f32 takes the SIMT kernels
    (``kernels.flash_attention.tensor_core_route``), not the bf16 tensor-core
    kernels a bf16 model runs, and on a card the 512³ matmul is bound by its
    launch; the DP consumes the rates' ratios after quantization.
    """
    import torch

    dev = _profile_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)

    # --- matmul: 2·n³ FLOPs --------------------------------------------------
    a = torch.randn(matmul_dim, matmul_dim, device=dev, generator=gen)
    b = torch.randn(matmul_dim, matmul_dim, device=dev, generator=gen)
    t_mm = _time_call(torch.matmul, a, b, device=dev, repeats=repeats)
    sec_per_flop_mm = t_mm / (2.0 * matmul_dim**3)

    # --- elementwise chain: memory-bound, ~4 passes over the array -----------
    x = torch.randn(elem_elems, device=dev, generator=gen)
    t_ew = _time_call(lambda v: torch.tanh(v * 1.5 + 0.5) * v, x, device=dev,
                      repeats=repeats)
    sec_per_byte = t_ew / (4.0 * elem_elems * 4)

    # --- attention kernel ----------------------------------------------------
    sec_per_flop_attn = sec_per_flop_mm * 2.0  # fallback: half matmul rate
    if include_attention:
        from ..kernels.ops import flash_attention

        B, S, H, D = attn_shape
        q = torch.randn(B, S, H, D, device=dev, generator=gen)
        t_fa = _time_call(lambda qq: flash_attention(qq, qq, qq, causal=True), q,
                          device=dev, repeats=max(1, repeats - 1))
        attn_flops = 4.0 * B * H * S * S * D  # qk^T + pv
        sec_per_flop_attn = t_fa / attn_flops

    return OpProfile(
        sec_per_flop_matmul=float(sec_per_flop_mm),
        sec_per_flop_attention=float(sec_per_flop_attn),
        sec_per_byte_elementwise=float(sec_per_byte),
        backend=device_key(dev),
        jax_version=torch.__version__,
    )


# ---------------------------------------------------------------------------
# Disk-cached profiles (one timing run per device, ever).
# ---------------------------------------------------------------------------


def _profile_path(cache_dir: str, backend: str, version: str) -> str:
    name = f"op_profile_{backend}_{version}_v{PROFILE_VERSION}.json"
    return os.path.join(cache_dir, "profiles", name.replace("/", "_"))


def load_or_profile(
    cache_dir: Optional[str] = None,
    profiler: Any = profile_ops,
    device: Union[str, "torch.device"] = "cuda",
) -> OpProfile:
    """Load ``device``'s profile from ``cache_dir`` or measure and store it.

    With ``cache_dir=None`` the plan cache's directory is used when attached
    (so plans and the profile that priced them live side by side); without
    either, the profile is measured fresh.  The file is keyed by the device
    (``device_key``) and the torch version.
    """
    import torch

    from ..checkpointing.store import atomic_write_json, read_json
    from .plan_cache import default_cache

    dev = _profile_device(device)
    cache_dir = cache_dir or default_cache().cache_dir
    path = _profile_path(cache_dir, device_key(dev), torch.__version__) if cache_dir else None

    if path:
        raw = read_json(path)
        if raw and raw.get("version") == PROFILE_VERSION:
            try:
                return OpProfile(
                    sec_per_flop_matmul=float(raw["sec_per_flop_matmul"]),
                    sec_per_flop_attention=float(raw["sec_per_flop_attention"]),
                    sec_per_byte_elementwise=float(raw["sec_per_byte_elementwise"]),
                    backend=str(raw["backend"]),
                    jax_version=str(raw["jax_version"]),
                    source=str(raw.get("source", "measured")),
                )
            except (KeyError, TypeError, ValueError):
                pass  # torn/stale file → re-profile

    prof = profiler(device=dev)
    if path:
        try:
            atomic_write_json(path, {"version": PROFILE_VERSION, **dataclasses.asdict(prof)})
        except OSError:
            pass  # unusable store → just re-profile next process
    return prof


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


def compiled_calibrated_graph(
    g: Graph,
    plan: Any,
    seg_costs: Sequence[Dict[str, float]],
    profile: Optional[OpProfile] = None,
    levels: int = 64,
) -> Graph:
    """Re-price ``T_v`` from per-segment FLOPs / bytes accessed.

    ``seg_costs`` is ``analysis.costs.extract_segment_costs`` output: one
    ``{"flops", "bytes"}`` dict per ``plan.segments`` entry (the reference
    asks XLA's ``cost_analysis()`` of each compiled segment; the port counts
    FLOPs with ``FlopCounterMode`` and bytes from the trace).  Each segment's
    roofline seconds are distributed over its nodes proportionally to their
    analytic ``T_v``, then quantized for the DP.  The result carries
    ``cost_source="compiled:<profile key>"`` so compiled-calibrated plans
    never collide with flops- or microbenchmark-priced ones in the plan
    cache.
    """
    if profile is None:
        profile = dataclasses.replace(DEFAULT_PROFILE, source="compiled")
    secs = list(g.time_v)
    for seg, cost in zip(plan.segments, seg_costs):
        seg_sec = roofline_seconds(
            float(cost.get("flops", 0.0)), float(cost.get("bytes", 0.0)), profile
        )
        total = sum(g.time_v[v] for v in seg.nodes) or 1.0
        for v in seg.nodes:
            secs[v] = max(seg_sec * (g.time_v[v] / total), 1e-12)
    nodes = [
        Node(nd.idx, nd.name, secs[nd.idx], nd.memory, nd.kind,
             must_store=nd.must_store)
        for nd in g.nodes
    ]
    priced = Graph(nodes, g.edges,
                   cost_source=f"compiled:{profile.profile_key()}")
    return quantize_times(priced, levels=levels)
