"""Multi-pod dry run: every (arch × shape × mesh) cell's step, run on fake
tensors over a fake process group (port of ``repro/launch/dryrun.py``).

Per cell this module

1. starts a fake process group of 256 or 512 ranks in this process and
   builds the production mesh on it (``launch.mesh.make_production_mesh``:
   ``{data: 16, model: 16}`` single-pod, ``{pod: 2, data: 16, model: 16}``
   multi-pod);
2. builds the step and its shardings (``launch.steps.build_step``) with the
   paper's DP remat plan applied (``segment_plan``, its ``n_micro``
   microbatches);
3. runs the step once as rank 0 of the group: the model's parameters, the
   AdamW moments, the batch and the caches are DTensors whose local shards
   are fake tensors (shapes only, nothing allocated), the collectives return
   at once, and the flash ops run their fake implementations;
4. records, as one JSON object: the planning fields of the shared
   sharding-aware accounting (``launch.plan.plan_inputs`` through
   ``parallel.sharding``), rank 0's argument bytes (the local shards of the
   parameters, optimizer state, batch and caches; in all and by kind,
   ``argument_bytes``), its output and aliased
   bytes, the peak of its fake allocations above the arguments during the
   step (``temp_size_in_bytes``), its collectives
   (``analysis.census.CountCollectives``, under the reference's
   ``collective_bytes`` keys, and by mesh axis), the global FLOPs and bytes
   of the step traced without a mesh (``core.fx_graph.fx_totals``), and the
   seconds it took (``trace_s``, in place of ``lower_s``).

Nothing is compiled, so the reference's ``compile_s``, ``hlo_flops``,
``hlo_transcendentals``, ``hlo_bytes_accessed``, ``hlo_lines`` and
``generated_code_size_in_bytes`` have no counterpart and are left out.
Every cell runs at full width and full depth.  The budget is the H100's
memory (``--hbm-bytes``, default ``launch.mesh.H100_HBM_BYTES``); at the
reference's 16 GiB (``REFERENCE_HBM_BYTES``) the planning fields are the
reference's.  An error in a cell is a bug in the system: the record says
``"status": "error"`` with its traceback and ``main`` exits 1.

On a ``"cpu"`` mesh DTensor sends a shard-to-shard redistribution as an
all-gather and a chunk, not an all-to-all; a ``"cuda"`` mesh (where there is
a card) sends the all-to-all.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import H100_HBM_BYTES
from repro_torch.parallel import sharding as sh

#: The reference's reasons for the cells it skips (``dryrun.py:63-70``)
SKIP_LONG = "full-attention arch at 500k ctx (DESIGN.md §Arch-applicability)"
SKIP_ENC_DEC = "enc-dec 500k decode inapplicable"


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Why the reference skips the cell, or None."""
    from repro_torch.configs import shape_applicable

    if not shape_applicable(cfg, shape):
        return SKIP_LONG
    if cfg.encoder_decoder and shape.kind == "decode" and shape.seq_len > 32_768:
        return SKIP_ENC_DEC
    return None


def planning_fields(cfg: ModelConfig, shape: ShapeConfig, mesh: Any,
                    hbm_bytes: float) -> Dict[str, Any]:
    """The reference's planning fields of a train cell, from the same
    accounting: ``segment_plan`` on the mesh's sizes (the reference's
    ``run_cell`` passes no override, whatever its ``opts``) and
    ``plan_inputs`` at its ``n_micro`` under the active rules."""
    from repro_torch.launch.plan import plan_inputs
    from repro_torch.launch.steps import _dp_shards, _seq_shards, segment_plan

    sizes = sh.axis_sizes_of(mesh)
    sp, res = segment_plan(cfg, shape, sizes, hbm_bytes=hbm_bytes, device="cpu")
    if sp is None:
        return {}
    pi = plan_inputs(cfg, shape, _dp_shards(sizes), _seq_shards(sizes, shape),
                     sizes.get("model", 1), n_micro=sp.n_micro, hbm_bytes=hbm_bytes,
                     rules=sh.get_rules())
    return {
        "segment_sizes": list(sp.sizes),
        "segment_remat": [bool(r) for r in sp.remat],
        "n_micro": sp.n_micro,
        "plan_feasible": bool(res.feasible),
        "plan_overhead_T": res.overhead if res.feasible else None,
        "plan_peak_M": res.peak_memory if res.feasible else None,
        "budget_per_device": pi.budget,
        "bytes_interior_per_device": pi.bytes_interior,
        "bytes_boundary_per_device": pi.bytes_boundary,
    }


# ------------------------------------------------------------- rank 0's bytes


def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)


def _storages(tree: Any) -> Dict[int, int]:
    """Storage key → bytes of the local tensors in ``tree`` (each storage
    once: views share theirs)."""
    out: Dict[int, int] = {}
    for t in pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = _local(t).untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagator is on the stack: it builds
    global-shape fake tensors to infer an op's output metadata, which are
    no rank's memory.  torch offers no hook for this, so the test reads the
    propagator's file name off the stack (``_sharding_prop.py``): it is
    tied to torch's file layout (ROADMAP.md §3)."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        frame = frame.f_back
    return False


class LiveBytes(TorchDispatchMode):
    """The bytes of storages allocated while active and still alive, and
    their peak: each op's outputs on this rank (a DTensor's local ops), a
    storage counted from the op that makes it until it is freed.  Outputs
    that alias an input (views, in-place ops) allocate nothing, nor do
    ``meta`` tensors or the tensors of DTensor's sharding propagation."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen: set = set()

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        schema = getattr(func, "_schema", None)
        if schema is not None and any(r.alias_info is not None for r in schema.returns):
            return out
        if _in_sharding_propagation():
            return out
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and not t.is_meta:  # meta: shapes only
                st = t.untyped_storage()
                key = st._cdata
                if key not in self._seen:
                    self._seen.add(key)
                    n = st.nbytes()
                    self.live += n
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(st, self._free, key, n)
        return out


# ------------------------------------------------------------- global totals


def _global_totals(cfg: ModelConfig, shape: ShapeConfig, step: Any, opts: Tuple[str, ...],
                   device: str) -> Dict[str, float]:
    """``fx_totals`` of the step traced with ``make_fx`` on global fake
    tensors and no mesh: a train step as ``n_micro`` forward-and-backward
    passes of a microbatch (each accumulated) and one AdamW update."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.core.fx_graph import fx_totals
    from repro_torch.launch import specs
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.loop import functional_loss
    from repro_torch.weights import reference_ndim

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        model = build_model(cfg, device=device)
    named = dict(model.named_parameters())

    def fake(t: torch.Tensor) -> torch.Tensor:
        with mode:
            return torch.zeros(t.shape, dtype=t.dtype, device=device)

    if shape.kind != "train":
        fn = step
        params = {n: fake(p.to(cfg.activation_dtype) if p.is_floating_point() else p)
                  for n, p in named.items()}
        if shape.kind == "prefill":
            args = ({k: fake(v) for k, v in specs.input_specs(cfg, shape).items()},)
        else:
            inputs = specs.input_specs(cfg, shape)
            args = (pytree.tree_map(fake, specs.cache_specs(cfg, shape)),
                    fake(inputs["tokens"]), fake(inputs["positions"]))

        def run(params, *args):
            with torch.no_grad():
                return fn(_Swapped(model, params), *args)

        return fx_totals(make_fx(run, tracing_mode="fake")(params, *args))

    loss_fn, _ = functional_loss(step.loss, model)
    n = step.n_micro
    micro = ShapeConfig(shape.name, shape.seq_len, max(1, shape.global_batch // n), "train")
    batch = {k: fake(v) for k, v in specs.input_specs(cfg, micro).items()}
    params = {"model." + k: fake(p).requires_grad_() for k, p in named.items()}
    acc = [fake(p) for p in named.values()]

    def forward_backward(params, acc, batch):
        use = params
        if "mp" in opts:
            use = {k: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
                   for k, p in params.items()}
        loss = loss_fn(use, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss, grads if n == 1 else [a + g.float() for a, g in zip(acc, grads)]

    decay = [reference_ndim(k, p) >= 2 for k, p in named.items()]

    def update(params, mu, nu, grads):
        adamw.update(step.optimizer, grads, adamw.AdamWState(0, mu, nu), params, decay=decay)
        return params

    one = fx_totals(make_fx(forward_backward, tracing_mode="fake")(params, acc, batch))
    plain = [fake(p) for p in named.values()]
    upd = fx_totals(make_fx(update, tracing_mode="fake")(
        plain, [fake(p) for p in plain], [fake(p) for p in plain], [fake(p) for p in plain]))
    return {k: n * one[k] + upd[k] for k in one}


class _Swapped:
    """A module whose methods run on other parameter values (each call
    under ``torch.nn.utils.stateless``' reparametrization, as
    ``torch.func.functional_call`` runs ``forward``)."""

    def __init__(self, module: torch.nn.Module, params: Dict[str, torch.Tensor]):
        self._module, self._params = module, params

    def __getattr__(self, name: str):
        method = getattr(self._module, name)
        if not callable(method):
            return method

        def call(*args, **kwargs):
            with torch.nn.utils.stateless._reparametrize_module(self._module, self._params):
                return method(*args, **kwargs)

        return call


# ---------------------------------------------------------------- one cell


def _fake_local(global_t: torch.Tensor, mesh: Any, spec: Any, device: str) -> Any:
    """A DTensor of ``global_t``'s shape in ``spec`` on ``mesh``, its local
    shard a fake zeros tensor."""
    from torch.distributed.tensor import DTensor

    placements = spec if sh.is_placements(spec) else sh.spec_to_placements(spec, mesh)
    local_shape, _ = sh.local_shape_and_offset(tuple(global_t.shape), mesh, placements)
    local = torch.zeros(tuple(local_shape), dtype=global_t.dtype, device=device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=global_t.shape, stride=global_t.stride())


def _place_model(model: torch.nn.Module, mesh: Any, shardings: Dict[str, Any],
                 dtype: torch.dtype) -> None:
    """Swap each parameter for a DTensor in its placements, floating ones
    cast to ``dtype`` (the serving weights; no grad)."""
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        spec = sh.normalize_spec(shardings[name], mesh, p.dim())
        t = p.detach().to(dtype) if p.is_floating_point() else p.detach()
        mod._parameters[leaf] = torch.nn.Parameter(sh.place(t, mesh, spec),
                                                   requires_grad=False)


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Any, opts: Sequence[str] = (),
               hbm_bytes: float = H100_HBM_BYTES, totals: bool = True,
               **step_kw: Any) -> Dict[str, Any]:
    """One cell's step on rank 0 of ``mesh`` (a ``DeviceMesh`` over a fake
    group, or over real ranks: then it runs on their fake shards), any
    config and mesh: its bytes, collectives, global totals (``totals``) and
    ``trace_s``; a train cell also records the plan the step applied
    (``n_micro_applied``, ``segment_sizes_applied``: ``"dp_only"``'s joins
    the model axis to the batch, which the reference's recorded plan does
    not).  ``step_kw`` goes to ``build_step`` (``segment_sizes``,
    ``n_micro`` for a train cell)."""
    from repro_torch.models.attention import CHUNKED_THRESHOLD

    # the flash op at any length: the fake tensors stand in for the card's,
    # whatever the mesh's device type
    token = CHUNKED_THRESHOLD.set(math.inf)
    try:
        return _trace_cell(cfg, shape, mesh, tuple(opts), hbm_bytes, totals, step_kw)
    finally:
        CHUNKED_THRESHOLD.reset(token)


def _trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Any, opts: Tuple[str, ...],
                hbm_bytes: float, totals: bool, step_kw: Dict[str, Any]) -> Dict[str, Any]:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.census import CountCollectives
    from repro_torch.core.lowering.base import on_mesh
    from repro_torch.launch.steps import build_step
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    if shape.kind == "train":
        step_kw = dict(hbm_bytes=hbm_bytes, device="cpu", **step_kw)
    fn, in_sh, out_sh, example = build_step(cfg, shape, mesh, opts=opts, **step_kw)
    rec: Dict[str, Any] = {}
    if shape.kind == "train":
        rec.update(n_micro_applied=fn.n_micro, segment_sizes_applied=list(fn.segment_sizes or ()))
    device = mesh.device_type
    # the model, the state and the inputs are made fake; the step runs with
    # no fake mode active (ops on fake tensors take their own mode), so that
    # DTensor's sharding propagation computes on real index tensors
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = build_model(cfg, device=device)
        if shape.kind == "train":
            trainer = fn.trainer(model, device=device)
            batch = {k: _fake_local(v, mesh, in_sh[2][k], device).to_local()
                     for k, v in example[2].items()}
            args = (trainer.params, trainer.opt_state.mu, trainer.opt_state.nu, batch)
            call = lambda: fn(trainer, batch)  # noqa: E731
            outs = lambda res: (trainer.params, trainer.opt_state.mu,  # noqa: E731
                                trainer.opt_state.nu, res)
        else:
            _place_model(model, mesh, in_sh[0], cfg.activation_dtype)
            params = [p for p in model.parameters()]
            if shape.kind == "prefill":
                batch = {k: _fake_local(v, mesh, in_sh[1][k], device)
                         for k, v in example[1].items()}
                args = (params, batch)
                call = lambda: fn(model, batch)  # noqa: E731
            else:
                caches = pytree.tree_map(lambda t, s: _fake_local(t, mesh, s, device),
                                         example[1], in_sh[1],
                                         is_leaf=lambda x: sh.is_placements(x))
                tokens = _fake_local(example[2], mesh, in_sh[2], device)
                positions = _fake_local(example[3], mesh, in_sh[3], device)
                args = (params, caches, tokens, positions)
                call = lambda: fn(model, caches, tokens, positions)  # noqa: E731
            outs = lambda res: res  # noqa: E731
    arg_bytes = _storages(args)
    rec["argument_size_in_bytes"] = sum(arg_bytes.values())
    parts = dict(zip(("params", "opt_state", "batch") if shape.kind == "train" else
                     ("params", "batch") if shape.kind == "prefill" else
                     ("params", "caches", "tokens", "positions"),
                     (args[0], args[1:3], args[3]) if shape.kind == "train" else args))
    rec["argument_bytes"] = {k: sum(_storages(v).values()) for k, v in parts.items()}
    live = LiveBytes()
    with CountCollectives() as counted, live, on_mesh(pytree.tree_leaves(args)):
        if shape.kind == "train":
            res = call()
        else:
            with torch.no_grad():
                res = call()
    out_bytes = _storages(outs(res))
    rec["output_size_in_bytes"] = sum(out_bytes.values())
    rec["alias_size_in_bytes"] = sum(n for k, n in out_bytes.items() if k in arg_bytes)
    rec["temp_size_in_bytes"] = live.peak
    if totals:
        tot = _global_totals(cfg, shape, fn, opts, device)
        rec["jaxpr_flops_global"] = tot["flops"]
        rec["jaxpr_bytes_global"] = tot["bytes"]
    rec["collectives"] = counted.collective_bytes()
    rec["collectives_by_axis"] = counted.by_axis(mesh)
    rec["trace_s"] = round(time.perf_counter() - t0, 2)
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, objective: Optional[str] = None,
             opts: Sequence[str] = (), hbm_bytes: float = H100_HBM_BYTES,
             trace: bool = True) -> Dict[str, Any]:
    """The reference's ``run_cell``: skip the cells it skips, else build
    the production mesh over a fake group, record the planning fields
    (train cells) and, with ``trace``, :func:`trace_cell`'s.
    ``objective`` is accepted and unused, as in the reference."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, fake_group, make_production_mesh
    from repro_torch.launch.steps import set_step_rules

    cfg, shape = get_config(arch), SHAPES[shape_name]
    reason = skip_reason(cfg, shape)
    if reason is not None:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "skipped",
                "reason": reason}
    multi = mesh_kind == "multi"
    dims, names = MULTI_POD if multi else SINGLE_POD
    sizes = dict(zip(names, dims))
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                           "devices": math.prod(dims)}
    if opts:
        rec["opts"] = list(opts)
    if trace:
        with fake_group(math.prod(dims)):
            body = trace_cell(cfg, shape, make_production_mesh(multi_pod=multi), opts,
                              hbm_bytes=hbm_bytes)
    else:  # the builder's side effect only: the rules its knobs select
        set_step_rules(shape, tuple(opts))
        body = {}
    if shape.kind == "train":
        rec.update(planning_fields(cfg, shape, sizes, hbm_bytes))
    rec.update(body)
    rec["status"] = "ok"
    return rec


def _list(text: Optional[str], every: Sequence[str]) -> Sequence[str]:
    return list(every) if text is None else [t for t in text.split(",") if t]


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS, SHAPES

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="an arch id (or a comma-separated list)")
    ap.add_argument("--shape", default=None, help="a shape name (or a comma-separated list)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="all (arch × shape) cells")
    ap.add_argument("--out", default=None, help="directory for per-cell JSON")
    ap.add_argument("--objective", default=None,
                    choices=[None, "time_centric", "memory_centric"])
    ap.add_argument("--opts", default="", help="comma-separated knobs (mp, rs, ws, dp_only, "
                    "dp_attn)")
    ap.add_argument("--hbm-bytes", type=float, default=H100_HBM_BYTES,
                    help="per-device memory the plans budget (default: the H100's)")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opts.split(",") if o)
    archs = ARCH_IDS if args.all else _list(args.arch, ARCH_IDS)
    shapes = list(SHAPES) if args.all else _list(args.shape, SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                try:
                    rec = run_cell(arch, shape, mk, objective=args.objective, opts=opts,
                                   hbm_bytes=args.hbm_bytes)
                except Exception as e:  # a failure here is a bug in the system
                    rec = {"arch": arch, "shape": shape, "mesh": mk, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()}
                    failures += 1
                line = {k: v for k, v in rec.items() if k != "traceback"}
                print(json.dumps(line), flush=True)
                if rec["status"] == "error":
                    print(rec["traceback"], file=sys.stderr, flush=True)
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    suffix = ("__" + "_".join(opts)) if opts else ""
                    fname = f"{arch}__{shape}__{mk}{suffix}.json".replace("/", "_")
                    with open(os.path.join(args.out, fname), "w") as f:
                        json.dump(rec, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
