"""Dispatch truth: heavy-op census and memory-drift gate over the planned twin
(the port's twin of ``repro/analysis/hlo.py`` and ``hlo_text.py``).

The reference checks the *compiled* planned twin: it counts heavy ops in
XLA's optimized HLO and reads ``compiled.memory_analysis()``.  Eager torch
compiles nothing, so "compiler truth" becomes "dispatch truth": what the
twin really runs, watched as it runs.

1. **Heavy-op census** — the planned twin and plain ``autograd.grad`` each
   run once under a counting ``TorchDispatchMode`` (:class:`CountOps`),
   which counts the ops of ``prims.ATEN_HEAVY`` (``mm``, ``bmm``,
   ``addmm``, ``convolution`` and the flash-attention op; each heavy graph
   node is one of them).  Planned minus vanilla must equal the heavy nodes
   of ``V \\ U_k``.  The band allows the ``"fx"`` lowering's documented
   divergence — it reruns only what a backward reads: a checkpoint region
   whose ops save nothing is never unpacked, so its nodes never rerun
   (:func:`unpacked_recompute` finds the regions that are) — as the
   reference's band allows XLA's CSE:

       heavy(V \\ U_k in unpacked regions)  ≤  planned − vanilla  ≤  heavy(V \\ U_k)

   The census also attributes every op that runs inside the backward while
   the twin evaluates an fx node (``run.node_now()``) to that node: a cached
   node that reruns is an eq. (1) breach however the counts add up.
2. **Memory drift** — ``temp_bytes`` is ``torch.cuda.max_memory_allocated()``
   over one call of the twin, minus ``memory_allocated()`` at entry, minus
   the bytes of the returned value and grads: the nearest twin of XLA's
   ``temp_size_in_bytes``, which excludes arguments and outputs.  It is held
   against the plan's analytic peak by the copied :func:`drift_findings`
   (``ok`` / ``remat-elided`` / ``drift``), with plain autograd's
   ``temp_bytes`` as the vanilla ceiling.  The CPU allocator keeps no
   statistics, so there the gate only warns ``memory-analysis-unavailable``.

3. **Collective counter** — :class:`CountCollectives` records every
   ``_c10d_functional`` collective a step issues (the all-reduce of a
   replicated parameter's ``Partial`` gradient, the loss's reduction, a
   DTensor reshard), by op: calls, payload bytes (what one rank hands the
   collective) and ring wire bytes per rank (``ring_wire_bytes``: an
   all-reduce sends 2(n−1)/n of its payload, an all-gather, reduce-scatter
   or all-to-all (n−1)/n of the full tensor).  It is the port's source of
   the reference's ``hlo_comm_bytes`` (``core.replay``), which reads the
   optimized HLO's collectives.  It passes DTensor ops through to DTensor's
   own dispatch (returning ``NotImplemented``, as torch's
   ``CommDebugMode`` does), so the collectives DTensor issues inside an op
   are counted too.

What has no twin: the HLO-text helpers (``hlo_text.py``: computation
splitting, trip counts, ``reduce_precision`` save markers) — there is no
HLO to parse.  The compiled cost extraction (``extract_segment_costs``)
lives in ``analysis.costs``.  Finding codes are the reference's without the
``hlo-`` prefix where they named the HLO.

Entry points: :func:`check_hlo` / :func:`analyze_hlo` for a
``TracedCarrier`` + plan (the ``plan_function(verify_hlo=True)`` and
``REPRO_VERIFY_PLANS=hlo`` hook), :func:`analyze_twin` for an explicitly
lowered twin.  The runs fork the RNG, so the caller's draws are unchanged.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
from typing import Any, Callable, Dict, FrozenSet, Mapping, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.fx_graph import op_name
from ..core.prims import ATEN_HEAVY, ATEN_KINDS, ATEN_VIEW_OPS
from ..core.schedule import ExecutionPlan
from .report import Report

#: Node kinds the plan-side census treats as heavy: the kinds
#: ``core.fx_graph`` gives the ops of ``prims.ATEN_HEAVY``, plus the chain
#: and BlockGraph kinds.
HEAVY_NODE_KINDS = frozenset(ATEN_KINDS.get(n, n) for n in ATEN_HEAVY) | frozenset(
    {"conv", "matmul"})

#: Default drift tolerance: relative band around the analytic peak plus an
#: absolute slack for allocator rounding and scratch.
DRIFT_REL = 0.5
DRIFT_ABS_SLACK = 256 * 1024


class CountOps(TorchDispatchMode):
    """Counts the allocating aten ops dispatched, by the reference's kind,
    and the heavy ones (``prims.ATEN_HEAVY``) apart.

    With ``node_now`` (an ``"fx"`` twin's ``run.node_now``) it also counts,
    by fx node, the allocating ops that run inside the backward while the
    twin evaluates that node: its recompute (a cached value handed back by
    the selective policy dispatches at most a ``detach``).  Ops of autograd's derivative
    formulas run while the twin evaluates no node and are not attributed.
    """

    def __init__(self, node_now: Optional[Callable[[], Any]] = None):
        super().__init__()
        self.counts: collections.Counter = collections.Counter()
        self.heavy = 0
        self.node_now = node_now
        self.rerun: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = op_name(func)
        if name not in ATEN_VIEW_OPS:
            self.counts[ATEN_KINDS.get(name, name)] += 1
            if self.node_now is not None and torch._C._current_graph_task_id() != -1:
                node = self.node_now()
                if node is not None:
                    self.rerun[node] += 1
        self.heavy += name in ATEN_HEAVY
        return func(*args, **(kwargs or {}))


def storage_key(t: torch.Tensor) -> int:
    """The address of the storage ``t`` lives in on this device (a
    DTensor's local shard, read without dispatching an op)."""
    local = getattr(t, "_local_tensor", None)
    return (t if local is None else local).untyped_storage().data_ptr()


#: ``_c10d_functional`` collectives and how many times (n−1)/n of the
#: relevant tensor's bytes a ring sends per rank
_COLLECTIVES = {
    "all_reduce": 2.0, "all_reduce_coalesced": 2.0,
    "all_gather_into_tensor": 1.0, "all_gather_into_tensor_coalesced": 1.0,
    "reduce_scatter_tensor": 1.0, "reduce_scatter_tensor_coalesced": 1.0,
    "all_to_all_single": 1.0, "broadcast": 1.0,
}


def ring_wire_bytes(op: str, payload: int, out_bytes: int, group: int) -> float:
    """Bytes one rank sends in a ring implementation of ``op``: an
    all-reduce 2(n−1)/n of its payload; an all-gather (n−1)/n of its output
    (the gathered tensor); a reduce-scatter, all-to-all or broadcast
    (n−1)/n of its input."""
    if group <= 1:
        return 0.0
    full = out_bytes if op.startswith("all_gather") else payload
    return _COLLECTIVES[op] * (group - 1) / group * full


def _group_size(group_name: Any) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name).size()


#: The reference's HLO names of the collectives (``hlo_text.COLLECTIVES``)
#: for the ``_c10d_functional`` ops
HLO_NAMES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}


class CountCollectives(TorchDispatchMode):
    """Counts the ``_c10d_functional`` collectives dispatched while active:
    ``stats[op] = {"calls", "payload_bytes", "output_bytes",
    "wire_bytes"}`` per rank, and the same split by process group
    (``by_group[group_name][op]``; :meth:`by_axis` names a mesh's groups by
    their mesh dims).  Group sizes are read off the group, a fake one's
    too; :meth:`collective_bytes` is the reference's summary."""

    def __init__(self):
        super().__init__()
        self.stats: Dict[str, Dict[str, float]] = {}
        self.by_group: Dict[str, Dict[str, Dict[str, float]]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            return NotImplemented  # let DTensor desugar the op into collectives
        out = func(*args, **(kwargs or {}))
        ns = getattr(func, "namespace", "")
        op = op_name(func).split("::")[-1]
        if ns == "_c10d_functional" and op in _COLLECTIVES:
            kwargs = kwargs or {}
            group = kwargs.get("group_name", args[-1])
            payload = sum(t.numel() * t.element_size()
                          for t in pytree.tree_leaves(args[0]) if isinstance(t, torch.Tensor))
            out_bytes = sum(t.numel() * t.element_size()
                            for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor))
            wire = ring_wire_bytes(op, payload, out_bytes, _group_size(group))
            for table in (self.stats, self.by_group.setdefault(str(group), {})):
                rec = table.setdefault(op, {"calls": 0, "payload_bytes": 0, "output_bytes": 0,
                                            "wire_bytes": 0.0})
                rec["calls"] += 1
                rec["payload_bytes"] += payload
                rec["output_bytes"] += out_bytes
                rec["wire_bytes"] += wire
        return out

    def total(self, key: str = "payload_bytes") -> float:
        return sum(r[key] for r in self.stats.values())

    def collective_bytes(self) -> Dict[str, Any]:
        """The counts under the keys of the reference's
        ``analysis.hlo_text.collective_bytes``: per collective (its HLO
        name) the bytes of its outputs on this rank and its calls.  An eager
        step has no static program, so ``static_counts`` are the calls
        (``dynamic_counts``), a microbatch loop's once per iteration."""
        per_op = {name: 0 for name in ("all-gather", "all-reduce", "reduce-scatter",
                                       "all-to-all", "collective-permute")}
        counts = dict(per_op)
        for op, rec in self.stats.items():
            name = HLO_NAMES[op]
            per_op[name] = per_op.get(name, 0) + rec["output_bytes"]
            counts[name] = counts.get(name, 0) + rec["calls"]
        return {"bytes_per_chip": per_op, "dynamic_counts": counts,
                "static_counts": dict(counts), "total_bytes_per_chip": sum(per_op.values())}

    def by_axis(self, mesh: Any) -> Dict[str, Dict[str, Dict[str, float]]]:
        """``by_group`` keyed by ``mesh``'s dim names (a group of no dim of
        ``mesh`` keeps its group name)."""
        names = {mesh.get_group(i).group_name: n for i, n in enumerate(mesh.mesh_dim_names)}
        return {names.get(g, g): ops for g, ops in self.by_group.items()}


def unpacked_recompute(carrier: Any, plan: ExecutionPlan, args: Sequence[Any]) -> FrozenSet[int]:
    """The plan's recomputed nodes that sit in checkpoint regions the
    backward unpacks.

    A region recomputes when the backward unpacks a tensor that one of its
    ops saved; a region whose ops save nothing (a lone loss reduction) is
    never unpacked, and nothing of it reruns.  The ops that save are found
    by running the function plainly, segment by segment, under
    ``saved_tensors_hooks``.  Each segment's outputs are kept detached
    (requiring grad as they did), so only one segment's autograd graph is
    alive at a time: the run needs about the plan's cached set plus one
    segment, not plain autograd's peak.  The pack hook keeps nothing (the
    graph is never run backward): a hook that returned the tensor itself
    would tie each op's saved output to its own ``grad_fn``, a cycle
    through C++ that Python's collector cannot free, and every value the
    run made would outlive it.
    """
    from ..core.lowering.interpreter import run_segment, traced_programs

    fxg = carrier.fx
    env = dict(zip([n for n in fxg.gm.graph.nodes if n.op == "placeholder"],
                   carrier.flatten_args(args)))
    saved = [0]

    def pack(t):
        saved[0] += 1

    out: set = set()
    for prog, seg in zip(traced_programs(fxg, plan), plan.segments):
        saved[0] = 0
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(pack, lambda _: None):
            local = run_segment(prog, lambda n, get: fxg.run_node(n, get), env.__getitem__)
        env.update((k, pytree.tree_map(_detached, local[k])) for k in prog.outs)
        del local
        if seg.recompute and saved[0]:
            out |= seg.recompute
    return frozenset(out)


def _detached(v: Any) -> Any:
    return (v.detach().requires_grad_(v.requires_grad)
            if isinstance(v, torch.Tensor) else v)


def example_args(carrier: Any, device: Any = None) -> Any:
    """Concrete arguments of the carrier's traced signature: floating leaves
    standard normal (seed 0), others zeros (in range as indices), on the
    traced device or ``device``."""
    placeholders = [n for n in carrier.fx.gm.graph.nodes if n.op == "placeholder"]
    gen = torch.Generator().manual_seed(0)
    flat = []
    for n in placeholders:
        v = n.meta["val"]
        dev = device if device is not None else v.device
        if v.is_floating_point():
            t = torch.randn(tuple(v.shape), generator=gen, dtype=torch.float32)
            flat.append(t.to(device=dev, dtype=v.dtype))
        else:
            flat.append(torch.zeros(tuple(v.shape), dtype=v.dtype, device=dev))
    return tuple(pytree.tree_unflatten(flat, carrier.in_spec))


def _device_of(args: Any) -> torch.device:
    leaves = [t for t in pytree.tree_leaves(args) if isinstance(t, torch.Tensor)]
    return leaves[0].device if leaves else torch.device("cpu")


@contextlib.contextmanager
def _forked_rng(dev: torch.device):
    """Run the checks without moving the caller's generators."""
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        yield


def free_device_bytes(dev: torch.device) -> Optional[int]:
    """Bytes the caching allocator can still hand out on ``dev``: the
    driver's free memory plus what the allocator holds unused.  None off
    CUDA."""
    if dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    return int(free + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev))


def temp_bytes(fn: Callable[..., Any], args: Sequence[Any]) -> Optional[int]:
    """Device bytes one call of ``fn`` needs beyond its arguments and its
    outputs: ``max_memory_allocated()`` over the call minus
    ``memory_allocated()`` at entry minus the returned tensors' bytes.
    None off CUDA (the CPU allocator keeps no statistics)."""
    dev = _device_of(args)
    if dev.type != "cuda":
        return None
    gc.collect()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    storages = {storage_key(t): getattr(t, "_local_tensor", t).untyped_storage().nbytes()
                for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)}
    del out
    return int(peak - base - sum(storages.values()))


@dataclasses.dataclass(frozen=True)
class HeavyCensus:
    """Heavy-op counts of one planned twin against plain autograd.

    ``vanilla`` / ``planned``: heavy ops dispatched by one forward+backward
    of each; ``plan_recompute``: heavy nodes in the plan's ``V \\ U_k``;
    ``unpacked_recompute``: those of them in regions the backward unpacks
    (what ``"fx"`` reruns); ``rerun``: graph nodes whose ops ran again
    inside the planned backward.
    """

    vanilla: Optional[int]  # None when plain autograd was not run
    planned: int
    plan_recompute: int
    unpacked_recompute: int
    rerun: FrozenSet[int] = frozenset()

    @property
    def extra(self) -> Optional[int]:
        """Heavy ops the planned twin runs beyond plain autograd."""
        return None if self.vanilla is None else self.planned - self.vanilla

    @property
    def expected(self) -> Optional[int]:
        """Heavy ops a twin recomputing all of ``V \\ U_k`` runs."""
        return None if self.vanilla is None else self.vanilla + self.plan_recompute


def drift_findings(
    report: Report,
    *,
    analytic_peak: float,
    temp_bytes: float,
    rel: float = DRIFT_REL,
    abs_slack: float = DRIFT_ABS_SLACK,
    ceiling: Optional[float] = None,
) -> str:
    """Memory-drift gate: compare the twin's temp bytes to the analytic peak.

    Returns the drift status (``"ok"`` / ``"remat-elided"`` / ``"drift"``)
    and appends the matching finding.  ``ceiling`` is plain autograd's temp
    bytes: temp within the vanilla band means the planned recompute bought
    no memory (on XLA CPU, barrier-early CSE; here a lowering that saved
    what the plan recomputes) — a warning, never silence.
    """
    band = analytic_peak * (1.0 + rel) + abs_slack
    if temp_bytes <= band:
        report.add(
            "info",
            "memory-drift-ok",
            f"measured temp {temp_bytes:.4g} B within the plan band "
            f"{band:.4g} B (analytic peak {analytic_peak:.4g} B, "
            f"rel={rel:g}, slack={abs_slack:.4g} B)",
        )
        return "ok"
    if ceiling is not None and temp_bytes <= ceiling * (1.0 + rel) + abs_slack:
        report.add(
            "warning",
            "memory-drift-remat-elided",
            f"measured temp {temp_bytes:.4g} B exceeds the plan band "
            f"{band:.4g} B but stays within the vanilla ceiling "
            f"{ceiling:.4g} B — the twin held what the plan recomputes, so "
            "the plan's savings did not reach the device",
        )
        return "remat-elided"
    report.add(
        "error",
        "memory-drift",
        f"measured temp {temp_bytes:.4g} B exceeds the plan band "
        f"{band:.4g} B by {temp_bytes - band:.4g} B "
        f"(analytic peak {analytic_peak:.4g} B"
        + (f", vanilla ceiling {ceiling:.4g} B" if ceiling is not None else "")
        + ") — the twin does not respect the planned budget",
    )
    return "drift"


@dataclasses.dataclass
class HloAnalysis:
    """Report plus the machine-readable drift record (one JSON row); the
    name is the reference's."""

    report: Report
    drift: Dict[str, Any]
    census: Optional[HeavyCensus] = None


def analyze_twin(
    fn_grad: Callable[..., Any],
    args: Sequence[Any],
    *,
    recompute: FrozenSet[int],
    owner: Mapping[Any, Optional[int]],
    plan_heavy_recompute: int,
    unpacked_heavy_recompute: int,
    analytic_peak: float,
    vanilla_grad: Optional[Callable[..., Any]] = None,
    vanilla_peak: Optional[float] = None,
    rel: float = DRIFT_REL,
    abs_slack: float = DRIFT_ABS_SLACK,
) -> HloAnalysis:
    """Run the census and the drift gate on an explicitly lowered twin.

    ``fn_grad`` is a planned twin with a ``node_now`` hook that attributes
    recompute: an ``"fx"`` twin's fx nodes, or the node whose value a
    paper network's ``"policy"`` twin is making
    (``configs.paper_networks.twin_value_and_grad``); ``owner`` maps those
    to graph nodes.  ``args`` are concrete arguments.  ``recompute`` is the plan's ``V \\ U_k``;
    ``plan_heavy_recompute`` its heavy nodes and
    ``unpacked_heavy_recompute`` those the twin's backward can rerun (the
    band's low end); ``analytic_peak`` the plan's liveness-tight peak in
    bytes.  With ``vanilla_grad`` (plain autograd) the census has its
    baseline and the drift gate its ceiling.  Plain autograd needs its own
    peak on the device: when ``vanilla_peak`` (its analytic peak in bytes)
    exceeds what the device can still allocate, the vanilla runs are
    skipped with the warning ``vanilla-run-skipped`` — the census then has
    no baseline and the gate no ceiling — so a plan that fits only because
    it recomputes can still be checked.
    """
    report = Report(checker="hlo")
    record: Dict[str, Any] = {"analytic_peak_bytes": float(analytic_peak)}
    dev = _device_of(args)
    node_now = getattr(fn_grad, "node_now", None)
    if node_now is None:
        report.add(
            "error",
            "lowering-untraceable",
            "the callable is not an \"fx\" twin (no node_now hook): the census "
            "cannot attribute its ops to graph nodes",
        )
        return HloAnalysis(report, record)

    free = free_device_bytes(dev) if vanilla_grad is not None else None
    if vanilla_peak is not None and free is not None and vanilla_peak > free:
        report.add(
            "warning",
            "vanilla-run-skipped",
            f"plain autograd's analytic peak {vanilla_peak:.4g} B exceeds the "
            f"{free:.4g} B the device can still allocate: no vanilla census "
            "baseline and no drift ceiling",
        )
        vanilla_grad = None
    with _forked_rng(dev):
        fn_grad(*args)  # warm-up: one-time workspaces stay out of the counts
        with CountOps(node_now) as planned:
            fn_grad(*args)
        vanilla = None
        if vanilla_grad is not None:
            with CountOps() as vanilla:
                vanilla_grad(*args)
        rerun = frozenset(owner.get(n) for n in planned.rerun) - {None}
        census = HeavyCensus(
            vanilla=vanilla.heavy if vanilla is not None else None,
            planned=planned.heavy,
            plan_recompute=plan_heavy_recompute,
            unpacked_recompute=unpacked_heavy_recompute,
            rerun=rerun,
        )
        record.update(heavy_vanilla=census.vanilla, heavy_planned=census.planned,
                      heavy_recompute_planned=plan_heavy_recompute,
                      heavy_recompute_unpacked=unpacked_heavy_recompute,
                      nodes_rerun=len(rerun),
                      # the reference's names: heavy ops run, and the most
                      # the plan's eq. (1) allows (None without a baseline)
                      heavy_measured=census.planned, heavy_expected=census.expected)

        beyond = sorted(rerun - recompute)
        if beyond:
            report.add(
                "error",
                "recompute-exceeds-eq1",
                f"the twin reruns cached node(s) {beyond[:8]} in the backward "
                "— eq. (1) overhead accounting no longer matches the lowering",
                node=beyond[0],
            )
        if vanilla is not None:
            extra, low, high = census.extra, unpacked_heavy_recompute, plan_heavy_recompute
            if extra > high:
                report.add(
                    "error",
                    "recompute-exceeds-eq1",
                    f"the twin runs {extra} heavy ops beyond plain autograd but "
                    f"the plan's recompute set V \\ U_k holds only {high} heavy "
                    "nodes — the twin's overhead exceeds the plan's eq. (1) claim",
                )
            elif extra < low:
                report.add(
                    "error",
                    "heavy-multiplicity-mismatch",
                    f"the twin runs {extra} heavy ops beyond plain autograd, below "
                    f"the eq. (1) band [{low}, {high}] — forward or backward heavy "
                    "work vanished, the twin no longer computes the same function",
                )
            elif extra < high:
                report.add(
                    "info",
                    "recompute-elided",
                    f"the twin reruns {extra} of the plan's {high} heavy recompute "
                    "nodes: the rest sit in checkpoint regions whose ops save "
                    "nothing, which the backward never unpacks (within the eq. (1) "
                    f"band [{low}, {high}])",
                )
            else:
                report.add(
                    "info",
                    "heavy-multiplicity-ok",
                    f"the twin's heavy-op count {census.planned} equals plain "
                    f"autograd's {census.vanilla} plus the plan's {high} heavy "
                    "recompute nodes — eq. (1) recompute counts hold",
                )

        # ---- memory drift ---------------------------------------------------
        temp = temp_bytes(fn_grad, args)
        if temp is None:
            report.add(
                "warning",
                "memory-analysis-unavailable",
                f"the {dev.type} allocator keeps no peak statistics — drift gate "
                "skipped",
            )
        else:
            ceiling: Optional[float] = None
            if vanilla_grad is not None:
                vtemp = temp_bytes(vanilla_grad, args)
                ceiling = float(vtemp)
                record["vanilla_temp_bytes"] = int(vtemp)
            record["temp_bytes"] = int(temp)
            record["drift_rel"] = rel
            record["drift_abs_slack"] = abs_slack
            record["drift_status"] = drift_findings(
                report, analytic_peak=analytic_peak, temp_bytes=float(temp),
                rel=rel, abs_slack=abs_slack, ceiling=ceiling)

    if report.ok and not report.warnings():
        report.add(
            "info",
            "census-conformant",
            f"the twin conforms: {census.planned} heavy ops, no cached node "
            "rerun, within the eq. (1) band and the memory tolerance",
        )
    return HloAnalysis(report, record, census)


def analyze_hlo(
    carrier: Any,
    plan: ExecutionPlan,
    *,
    args: Optional[Sequence[Any]] = None,
    rel: float = DRIFT_REL,
    abs_slack: float = DRIFT_ABS_SLACK,
    use_vanilla_ceiling: bool = True,
    lowered: Optional[Callable[..., Any]] = None,
    donate: bool = False,
) -> HloAnalysis:
    """Census and drift gate for a ``TracedCarrier`` + plan (the front-door
    hook).

    Lowers the plan through the ``"fx"`` backend (with ``donate``, as the
    front door lowers it; or inspects ``lowered``)
    and runs :func:`analyze_twin` on ``args`` (default: :func:`example_args`
    on the traced device) with the plan's own recompute set (its quantized
    nodes included: their ops rerun in the backward) and analytic peak.  ``use_vanilla_ceiling=False`` drops the vanilla run: no census
    baseline and a strict drift gate, which corruption tests want.

    What the checks need on the device: the planned twin's own peak (three
    runs of it), the unpacked-region probe's cached set plus one segment,
    and — unless skipped because it does not fit (``vanilla-run-skipped``)
    — plain autograd's peak for the baseline and the ceiling.
    """
    from ..core.lowering.carriers import TracedCarrier
    from ..core.lowering.fx import fx_value_and_grad
    from ..core.lowering.interpreter import vanilla_traced_value_and_grad
    from ..core.liveness import vanilla_peak

    if not isinstance(carrier, TracedCarrier):
        report = Report(checker="hlo")
        report.add(
            "info",
            "not-applicable",
            f"the census needs a traced carrier (got {type(carrier).__name__})",
        )
        return HloAnalysis(report, {})

    g = carrier.to_graph()
    args = tuple(args) if args is not None else example_args(carrier)
    # a quantized node's op reruns in the backward by design (its readers
    # replay q and scale; ``core/lowering/fx.py``), as a recomputed one does
    quantized = frozenset(v for v, c in (plan.strategy or {}).items() if c == "quantize")
    recompute = (frozenset(range(g.n)) - plan.cached) | quantized
    heavy = frozenset(v for v in recompute if g.nodes[v].kind in HEAVY_NODE_KINDS)
    with _forked_rng(_device_of(args)):
        unpacked = unpacked_recompute(carrier, plan, args) | quantized
    return analyze_twin(
        lowered if lowered is not None else fx_value_and_grad(carrier, plan, donate=donate),
        args,
        recompute=recompute,
        owner=carrier.fx.owner,
        plan_heavy_recompute=len(heavy),
        unpacked_heavy_recompute=len(heavy & unpacked),
        analytic_peak=plan.peak_memory,
        vanilla_grad=vanilla_traced_value_and_grad(carrier) if use_vanilla_ceiling else None,
        vanilla_peak=vanilla_peak(g) if use_vanilla_ceiling else None,
        rel=rel,
        abs_slack=abs_slack,
    )


def check_hlo(
    carrier: Any,
    plan: ExecutionPlan,
    *,
    args: Optional[Sequence[Any]] = None,
    rel: float = DRIFT_REL,
    abs_slack: float = DRIFT_ABS_SLACK,
    use_vanilla_ceiling: bool = True,
    lowered: Optional[Callable[..., Any]] = None,
    donate: bool = False,
) -> Report:
    """Report-only wrapper over :func:`analyze_hlo` (same contract)."""
    return analyze_hlo(carrier, plan, args=args, rel=rel, abs_slack=abs_slack,
                       use_vanilla_ceiling=use_vanilla_ceiling, lowered=lowered,
                       donate=donate).report


__all__: Tuple[str, ...] = (
    "DRIFT_ABS_SLACK",
    "DRIFT_REL",
    "HEAVY_NODE_KINDS",
    "CountCollectives",
    "CountOps",
    "HeavyCensus",
    "HloAnalysis",
    "analyze_hlo",
    "analyze_twin",
    "check_hlo",
    "drift_findings",
    "example_args",
    "free_device_bytes",
    "temp_bytes",
    "unpacked_recompute",
)
