"""Multi-process CPU workers for the port's sharded tests (imports no JAX).

The tests hold the port's DTensor execution on a ``torch.distributed`` mesh
of gloo ranks on the CPU.  :func:`spawn` starts one process per rank
(``python torch_dist_workers.py <case> <rank> <world> <dir>``), each joining
a process group through a ``FileStore`` in ``dir`` (no port is opened), and
waits for all of them under a deadline; past it every rank is killed and
the test fails.  Inputs come from the parent as ``dir/in.npz`` (the tests
compute the JAX reference values in the parent, on the same numpy arrays),
and each rank writes its results to ``dir/out<rank>.npz``: numpy arrays,
booleans for the checks made inside the ranks.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np

DEADLINE = 120.0  # seconds for one spawn of all ranks, set-up included
ROOT = Path(__file__).resolve().parents[1]


def spawn(case: str, world: int, tmp: Path, inputs: Dict[str, np.ndarray],
          deadline: float = DEADLINE, meanwhile: Callable[[], object] = None
          ) -> List[Dict[str, np.ndarray]]:
    """Run ``case`` on ``world`` gloo ranks; returns each rank's results.
    ``meanwhile`` (the parent's reference computations) runs while the
    ranks do.  Fails (AssertionError) on a rank's error or at the
    deadline."""
    tmp = Path(tmp)
    (tmp / "store").unlink(missing_ok=True)  # a FileStore must start empty
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [open(tmp / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, case, str(r), str(world), str(tmp)],
                              env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    end = time.monotonic() + deadline
    try:
        if meanwhile is not None:
            meanwhile()
        for p in procs:
            p.wait(timeout=max(0.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read()[-4000:])
        f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (f"{case}: rank {r} exited {p.returncode} (killed at the "
                                   f"{deadline:.0f} s deadline if negative)\n{texts[r]}")
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(world)]


# --------------------------------------------------------------------- cases


def _mlp(params, x):
    import torch

    h = x
    for w in params:
        h = torch.tanh(h @ w)
    return torch.sum(h * h)


def _attention(params, x):
    """A position term made inside the function (a plain tensor the twin
    meets as replicated), a projection, the flash-attention custom op over
    2 heads, a loss."""
    import torch

    from repro_torch.kernels.ops import flash_attention

    wq, wk, wv = params
    B, S, D = x.shape
    x = x + 0.01 * torch.arange(S, dtype=x.dtype, device=x.device)[None, :, None]
    q, k, v = ((x @ w).reshape(B, S, 2, D // 2) for w in (wq, wk, wv))
    out = flash_attention(q, k, v, causal=True)
    return torch.sum(out * out)


def _bits(a, b) -> bool:
    """Bitwise equality of two pytrees of (D)Tensors, on the local shards."""
    import torch
    import torch.utils._pytree as pytree

    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        type(x) is type(y) and getattr(x, "placements", None) == getattr(y, "placements", None)
        and torch.equal(getattr(x, "_local_tensor", x), getattr(y, "_local_tensor", y))
        for x, y in zip(la, lb))


def _full_t(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()


def _full(t) -> np.ndarray:
    return _full_t(t).numpy()


def case_sharding(inp, rank, world):
    """DTensor placements of the torch half of ``parallel/sharding.py``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel import sharding as sh

    m41 = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model"))
    m22 = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("data", "model"))
    x = torch.tensor(inp["x"])
    out = {}
    d = sh.place(x, m41, ("data", None))
    out["place_shards_dim0"] = (list(d.placements) == [Shard(0), Replicate()]
                                and tuple(d.to_local().shape) == (8 // world, 6)
                                and torch.equal(d.full_tensor(), x))
    out["normalize_spec_of_dtensor"] = sh.normalize_spec(d) == ("data", None)
    out["normalize_spec_of_placements"] = sh.normalize_spec(
        [Replicate(), Shard(1)], mesh=m22, ndim=2) == (None, "model")
    r = sh.shard(d, None, None)
    out["shard_replicates"] = (all(p.is_replicate() for p in r.placements)
                               and torch.equal(r.to_local(), x))
    b = sh.shard(sh.place(x, m41, ()), "batch", None)
    out["shard_batch_over_data"] = list(b.placements) == [Shard(0), Replicate()]
    out["shard_passes_plain_tensors"] = sh.shard(x, "batch", None) is x
    both = sh.place(x, m22, ("data", "model"))
    out["place_two_axes"] = (list(both.placements) == [Shard(0), Shard(1)]
                             and sh.normalize_spec(both) == ("data", "model")
                             and torch.equal(both.full_tensor(), x))
    joint = sh.place(x, m22, (("data", "model"), None))
    out["place_joint_axes"] = (sh.normalize_spec(joint) == (("data", "model"), None)
                               and torch.equal(joint.full_tensor(), x))
    params = {"layers.0.attn.wq": torch.zeros(64, 128), "layers.0.attn.wo": torch.zeros(128, 64),
              "embedding.embed": torch.zeros(255, 64), "layers.0.ln1.scale": torch.zeros(64),
              "layers.0.mlp.w_down": torch.zeros(512, 512)}
    tree = sh.named_sharding_tree(params, m22)
    out["named_sharding_tree"] = tree == {
        "layers.0.attn.wq": [Replicate(), Shard(1)], "layers.0.attn.wo": [Replicate(), Shard(0)],
        "embedding.embed": [Replicate(), Replicate()],  # 255 rows: indivisible
        "layers.0.ln1.scale": [Replicate(), Replicate()],
        "layers.0.mlp.w_down": [Replicate(), Shard(0)]}
    fsdp = sh.named_sharding_tree(params, m22, fsdp=True)
    out["named_sharding_tree_fsdp"] = (fsdp["layers.0.mlp.w_down"] == [Shard(1), Shard(0)]
                                       and fsdp["layers.0.attn.wq"] == [Replicate(), Shard(1)])
    return {k: np.array(bool(v)) for k, v in out.items()}


def case_planning(inp, rank, world):
    """Sharded planned twins against sharded vanilla autograd, bitwise, on
    the four backends; grads in the inputs' placements; conformance on the
    concrete mesh; a strategy plan and a recomputed draw on it; what raises
    on a DeviceMesh."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    import repro_torch
    from repro_torch.analysis import check_lowering
    from repro_torch.core import PlanCache, Planner
    from repro_torch.core.blockgraph import Block, BlockGraph
    from repro_torch.core.fx_graph import trace
    from repro_torch.core.liveness import vanilla_peak
    from repro_torch.core.lowering import TracedCarrier, vanilla_traced_value_and_grad
    from repro_torch.core.lowering.base import check_plan_on_mesh
    from repro_torch.core.lowering.fx import fx_value_and_grad
    from repro_torch.core.lowering.interpreter import vanilla_value_and_grad
    from repro_torch.core.schedule import make_plan
    from repro_torch.parallel import sharding as sh

    mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model"))
    n = len([k for k in inp if k[0] == "w"])
    params = [torch.tensor(inp[f"w{i}"]) for i in range(n)]
    x = torch.tensor(inp["x"])
    specs = (None, ("data", None))
    out: Dict[str, np.ndarray] = {}

    g_sh = trace(_mlp, params, x, mesh=mesh, in_shardings=[()] * n + [("data", None)]).graph
    g = trace(_mlp, params, x).graph
    out["per_device_mv"] = np.array(g_sh.mem_v)
    budget = vanilla_peak(g_sh, liveness=False) / 2
    for backend in ("fx", "interpreter"):
        pf = repro_torch.plan_function(_mlp, budget, mesh=mesh, in_shardings=specs,
                                       backend=backend, planner=Planner(cache=PlanCache()))
        low = pf.lowered_for(params, x)
        got = pf(params, x)
        ref = vanilla_traced_value_and_grad(low.carrier)(params, x)
        out[f"{backend}_recomputes"] = np.array(low.plan.overhead > 0
                                                and low.plan.peak_memory <= budget)
        out[f"{backend}_bitwise_vanilla"] = np.array(_bits(got, ref))
        out[f"{backend}_placements"] = np.array(
            all(p.is_replicate() for p in got[0].placements)
            and all(list(gw.placements) == [Replicate(), Replicate()] for gw in got[1]))
        out[f"{backend}_loss"] = _full(got[0])
        for i, gw in enumerate(got[1]):
            out[f"{backend}_g{i}"] = _full(gw)
    audited = repro_torch.plan_function(_mlp, budget, mesh=mesh, in_shardings=specs,
                                        track_live=True, planner=Planner(cache=PlanCache()))
    *_, live = audited(params, x)
    out["live_bytes_within_per_device_peak"] = np.array(
        0 < max(b for _, b in live) <= audited.lowered_for(params, x).plan.peak_memory)
    out["sharded_plan_differs"] = np.array(
        repro_torch.plan_function(_mlp, budget, mesh=mesh, in_shardings=specs)
        .lowered_for(params, x).plan.peak_memory <= budget < vanilla_peak(g, liveness=False))

    # grads w.r.t. the sharded argument come back in its placements
    pf = repro_torch.plan_function(_mlp, None, argnums=1, mesh=mesh, in_shardings=specs,
                                   planner=Planner(cache=PlanCache()))
    loss, gx = pf(params, x)
    ref = vanilla_traced_value_and_grad(pf.lowered_for(params, x).carrier)(params, x)
    out["gx_keeps_input_placements"] = np.array(list(gx.placements) == [Shard(0), Replicate()])
    out["gx_bitwise_vanilla"] = np.array(_bits((loss, gx), ref))

    # conformance on the concrete-mesh twin, and drift against a stale lowering
    carrier = TracedCarrier.trace(_mlp, (params, x), mesh=mesh, in_shardings=specs)
    planner = Planner(cache=PlanCache())
    cg = carrier.to_graph()
    tight = planner.plan(cg, planner.min_feasible_budget(cg)).plan
    out["check_lowering_ok"] = np.array(check_lowering(carrier, tight).ok)
    roomy = planner.plan(cg, vanilla_peak(cg, liveness=True)).plan
    stale = fx_value_and_grad(carrier, tight)
    out["check_lowering_catches_drift"] = np.array(
        roomy.cached == tight.cached or not check_lowering(carrier, roomy, lowered=stale).ok)

    # a BlockGraph on the "segment" backend, outputs pinned to ("batch", None)
    def mk(name, src):
        return Block(name, lambda p, h: torch.tanh(h @ p["w"]), (src,),
                     out_sharding=("batch", None))

    nb = len([k for k in inp if k.startswith("bw")])
    bg = BlockGraph([mk(f"b{i}", "x" if i == 0 else f"b{i-1}") for i in range(nb)],
                    ["x"], [f"b{nb - 1}"])
    bparams = {f"b{i}": {"w": sh.place(torch.tensor(inp[f"bw{i}"]), mesh, ())}
               for i in range(nb)}
    binputs = {"x": sh.place(torch.tensor(inp["bx"]), mesh, ("data", None))}

    def sq(o):
        return torch.sum(o * o)

    pf = repro_torch.plan_function(bg, None, backend="segment", loss_fn=sq, mesh=mesh,
                                   planner=Planner(cache=PlanCache()))
    low = pf.lowered_for(bparams, binputs)
    got = pf(bparams, binputs)
    ref = vanilla_value_and_grad(bg, sq)(bparams, binputs)
    out["segment_bitwise_vanilla"] = np.array(_bits(got, ref))
    out["segment_per_device_mv"] = np.array(low.carrier.to_graph().mem_v)
    out["segment_loss"] = _full(got[0])
    for i in range(nb):
        out[f"segment_g{i}"] = _full(got[1][f"b{i}"]["w"])

    # the flash-attention custom op under its DTensor sharding rule
    aparams = [torch.tensor(inp[f"aw{i}"]) for i in range(3)]
    ax = torch.tensor(inp["ax"])
    pf = repro_torch.plan_function(_attention, None, mesh=mesh, in_shardings=specs,
                                   planner=Planner(cache=PlanCache()))
    got = pf(aparams, ax)
    ref = vanilla_traced_value_and_grad(pf.lowered_for(aparams, ax).carrier)(aparams, ax)
    out["attention_bitwise_vanilla"] = np.array(_bits(got, ref))
    out["attention_loss"] = _full(got[0])
    for i in range(3):
        out[f"attention_g{i}"] = _full(got[1][i])

    # what raises on a DeviceMesh, naming ROADMAP.md 'Multi-device'
    def raises(fn: Callable[[], object], match: str) -> bool:
        try:
            fn()
        except (NotImplementedError, RuntimeError) as e:  # DTensor may wrap it
            return match in str(e) and "Multi-device" in str(e)
        return False

    # on the model axis: flash attention whose q, k and v arrive in layouts
    # other than GQA's (q's heads split, k's and v's whole), here k's and
    # v's batch split over data while q's is whole
    from repro_torch.kernels.ops import flash_attention

    m22 = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("data", "model"))
    qkv = torch.tensor(inp["ax"]).reshape(2, -1, 2, 4)
    out["model_axis_raises"] = np.array(raises(
        lambda: flash_attention(sh.place(qkv, m22, (None, None, "model", None)),
                                sh.place(qkv, m22, ("data",)), sh.place(qkv, m22, ("data",))),
        "differing layouts"))
    # the keys of the two checks below are kept from when both raised: a
    # strategy plan (every cached node offloaded) and a plan that recomputes a
    # random draw now run, bitwise sharded vanilla (the draw's in the plan's
    # node order); a mesh axis no twin runs over still raises
    every = make_plan(cg, [frozenset(range(cg.n))])
    offloaded = dataclasses.replace(tight, strategy={v: "offload" for v in tight.cached})
    out["strategy_raises"] = np.array(bool(offloaded.strategy) and _bits(
        fx_value_and_grad(carrier, offloaded)(params, x),
        vanilla_traced_value_and_grad(carrier)(params, x)))

    def dropout_loss(params, x):
        return torch.sum(torch.nn.functional.dropout(x @ params[0], 0.5, training=True) ** 2)

    drop = TracedCarrier.trace(dropout_loss, (params, x), mesh=mesh, in_shardings=specs)
    dg = drop.to_graph()
    redraw = make_plan(dg, [frozenset(range(dg.n))])
    torch.manual_seed(5)
    got = fx_value_and_grad(drop, redraw)(params, x)
    torch.manual_seed(5)
    want = vanilla_traced_value_and_grad(drop, redraw)(params, x)
    out["redraw_raises"] = np.array(_bits(got, want))
    staged = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("data", "stage"))
    out["stage_axis_raises"] = np.array(raises(
        lambda: check_plan_on_mesh(types.SimpleNamespace(mesh=staged), every),
        "mesh axis 'stage'"))

    # the "policy" backend (the BlockGraph default) on the pinned blocks
    pf = repro_torch.plan_function(bg, None, loss_fn=sq, mesh=mesh,
                                   planner=Planner(cache=PlanCache()))
    out["policy_bitwise_vanilla"] = np.array(
        pf.lowered_for(bparams, binputs).backend == "policy"
        and _bits(pf(bparams, binputs), vanilla_value_and_grad(bg, sq)(bparams, binputs)))
    return out


def case_train(inp, rank, world):
    """The reduced LM's Trainer on ``{data: world}``: plain, planned
    (bitwise the plain one) and with compressed gradients, 3 steps each,
    on this rank's slice of each global batch; then the launcher under the
    group."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.loop import functional_loss

    mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(reduced(get_config("stablelm-3b")), dtype="float32")
    state = {k[len("p:"):]: torch.tensor(v) for k, v in inp.items() if k.startswith("p:")}
    steps, seq, batch = int(inp["steps"]), int(inp["seq"]), int(inp["batch"])
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                                  num_hosts=world, host_id=rank))
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)

    def model():
        m = build_model(cfg, device="cpu")
        m.load_state_dict(state, strict=True)
        return m

    def loss_fn(m, b):
        return m.loss(b)

    def run(**kw):
        tr = Trainer(loss_fn, model(), TrainConfig(total_steps=steps, log_every=0,
                                                   optimizer=opt, **kw), device="cpu",
                     mesh=mesh)
        res = tr.run(data.batch(i) for i in range(steps))
        return tr, res

    out: Dict[str, np.ndarray] = {}
    plain, res = run()
    out["losses"], out["grad_norms"] = np.array(res["losses"]), np.array(res["grad_norms"])
    ar = plain.comm_stats["all_reduce"]
    out["all_reduce_calls"] = np.array(ar["calls"])
    out["all_reduce_payload"] = np.array(ar["payload_bytes"])
    out["all_reduce_wire"] = np.array(ar["wire_bytes"])
    out["param_bytes"] = np.array(sum(p.to_local().numel() * 4 for p in plain.params))
    out["n_params"] = np.array(len(plain.params))

    # the planned step at the minimal per-device budget of its own trace
    fn, by_key = functional_loss(loss_fn, plain.model)
    b0 = {k: torch.as_tensor(v) for k, v in data.batch(0).items()}
    probe = repro_torch.plan_function(fn, None, mesh=mesh,
                                      in_shardings=(None, ("data", None)))
    budget = probe.lowered_for(by_key, plain._place_batch(b0)).plan.peak_memory
    planned, pres = run(plan_budget=budget)
    low = planned.planned.lowered_for(planned._by_key, planned._place_batch(b0))
    out["planned_recomputes"] = np.array(low.plan.overhead > 0)
    out["planned_bitwise"] = np.array(
        pres["losses"] == res["losses"] and pres["grad_norms"] == res["grad_norms"]
        and all(torch.equal(a.to_local(), b.to_local())
                for a, b in zip(planned.params, plain.params)))
    _, cres = run(compress_grads=True)
    out["compressed_losses"] = np.array(cres["losses"])

    # per-device pricing against what DTensor holds: each graph node's local
    # bytes on this rank, from a node-by-node run of the trace on the mesh,
    # within its priced M_v; the interpreter's live-byte audit within the
    # plan's peak
    import torch.utils._pytree as pytree

    from repro_torch.core.lowering.base import local_tensor, on_mesh

    carrier = probe.lowered_for(by_key, plain._place_batch(b0)).carrier
    fxg, mem_v = carrier.fx, carrier.to_graph().mem_v
    flat = carrier.flatten_args((by_key, plain._place_batch(b0)))
    env, args = {}, iter(flat)
    with on_mesh(flat), torch.no_grad():
        for nd in fxg.gm.graph.nodes:
            if nd.op == "placeholder":
                env[nd] = next(args)
            elif nd.op in ("call_function", "get_attr"):
                env[nd] = fxg.run_node(nd, env.__getitem__)
    local = [sum(local_tensor(t).numel() * local_tensor(t).element_size()
                 for t in pytree.tree_leaves(env[nd]) if isinstance(t, torch.Tensor))
             for nd in fxg.nodes]
    out["local_bytes"], out["priced_mem_v"] = np.array(local), np.array(mem_v)
    del env
    audited = repro_torch.plan_function(fn, budget, mesh=mesh, backend="interpreter",
                                        in_shardings=(None, ("data", None)), track_live=True)
    *_, live = audited(by_key, plain._place_batch(b0))
    out["live_peak"] = np.array(max(b for _, b in live))
    out["plan_peak"] = np.array(audited.lowered_for(by_key, plain._place_batch(b0))
                                .plan.peak_memory)

    # the launcher joins the existing group (WORLD_SIZE set, as under torchrun)
    # and checkpoints every step (rank 0 writes); with the last two steps'
    # checkpoints gone, the same command resumes from step 1 on every rank
    import shutil

    import torch.distributed as dist

    from repro_torch.checkpointing import latest_step
    from repro_torch.launch import train as launcher

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK="0")
    ckpt = os.path.join(str(inp["dir"]), "ckpt")
    cmd = ["--reduced", "--steps", "3", "--batch", str(batch), "--seq", str(seq),
           "--device", "cpu", "--ckpt-dir", ckpt, "--ckpt-every", "1"]
    lout = launcher.main(cmd)
    out["launcher_losses"] = np.array(lout["losses"])
    out["launcher_all_reduce_payload"] = np.array(lout["comm"]["all_reduce"]["payload_bytes"])
    out["ckpt_dirs"] = np.array(sorted(os.listdir(ckpt)))
    out["ckpt_latest"] = np.array(latest_step(ckpt))
    dist.barrier()
    if rank == 0:
        for s in (2, 3):
            shutil.rmtree(os.path.join(ckpt, f"step_{s:09d}"))
    dist.barrier()
    again = launcher.main(cmd)
    out["resumed_losses"] = np.array(again["losses"])
    out["resumed_grad_norms"] = np.array(again["grad_norms"])
    out["launcher_grad_norms"] = np.array(lout["grad_norms"])
    return out


class FlashLayouts:
    """A dispatch mode that records the DTensor placements of the flash
    ops' tensor arguments (forward and backward) and lets DTensor run
    them; the local q shapes the kernels' wrappers receive are recorded by
    wrapping the plain versions."""

    def __init__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        seen = self.placements = []
        self.local_q, self.local_k = [], []
        flash = {torch.ops.repro_torch.flash_attention.default,
                 torch.ops.repro_torch.flash_attention_bwd.default}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func in flash:
                    seen.append([tuple(a.placements) for a in args
                                 if hasattr(a, "placements")])
                if any(getattr(t, "__name__", "") == "DTensor" for t in types):
                    return NotImplemented  # DTensor runs it on the local shards
                return func(*args, **(kwargs or {}))

        self.mode = Mode()
        fa = sys.modules["repro_torch.kernels.flash_attention"]
        for name in ("flash_attention_fwd", "flash_attention_bwd"):
            orig = getattr(fa, name)

            def wrapped(q, k, *a, _orig=orig, **kw):
                self.local_q.append(tuple(q.shape))
                self.local_k.append(tuple(k.shape))
                return _orig(q, k, *a, **kw)

            setattr(fa, name, wrapped)


def case_model_axis(inp, rank, world):
    """The reduced dense LM on ``{data: 2, model: 2}``: tensor-parallel
    loss and grads (eager, and the ``"fx"`` and ``"interpreter"`` planned
    twins against their traced vanilla), priced against local bytes, the
    flash ops' layouts; then the tensor-parallel Trainer's collectives, the
    FSDP Trainer, ``remesh``, a checkpoint restart and compressed
    gradients."""
    import shutil

    import torch
    import torch.distributed as dist
    import torch.utils._pytree as pytree
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    import repro_torch
    from repro_torch.analysis.census import CountCollectives
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import PlanCache, Planner
    from repro_torch.core.lowering import vanilla_traced_value_and_grad
    from repro_torch.core.lowering.base import local_tensor, on_mesh
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.launch import specs
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.loop import functional_loss

    mesh = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("data", "model"))
    data_rank = rank // (world // 2)
    # the reduced LM (d_model 64) for the loss, the twins and the pricing;
    # d_model 256 for the Trainers, wide enough for fsdp_extend's floor
    cfgs = {w: dataclasses.replace(reduced(get_config("stablelm-3b"), d_model=w),
                                   dtype="float32") for w in (64, 256)}
    states = {w: {k[len(f"p{w}:"):]: torch.tensor(v) for k, v in inp.items()
                  if k.startswith(f"p{w}:")} for w in cfgs}
    steps, seq, batch = int(inp["steps"]), int(inp["seq"]), int(inp["batch"])
    cfg = cfgs[64]
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                                  num_hosts=2, host_id=data_rank))
    out: Dict[str, np.ndarray] = {}

    def model(width=64):
        m = build_model(cfgs[width], device="cpu")
        m.load_state_dict(states[width], strict=True)
        return m

    def loss_fn(m, b):
        return m.loss(b)

    # tensor parallelism: the loss and its grads on head-, ffn- and
    # vocab-sharded parameters and this rank's slice of the global batch
    m = model()
    fn, params = functional_loss(loss_fn, m)
    tp = specs.param_shardings(cfg, mesh, {k[len("model."):]: v for k, v in params.items()})
    dparams = {k: sh.place(v.detach(), mesh, sh.normalize_spec(tp[k[len("model."):]], mesh,
                                                                v.dim())).requires_grad_()
               for k, v in params.items()}
    db = {k: DTensor.from_local(torch.as_tensor(v), mesh, [Shard(0), Replicate()],
                                run_check=False) for k, v in data.batch(0).items()}
    layouts = FlashLayouts()
    with layouts.mode, on_mesh(list(dparams.values())):
        loss = fn(dparams, db)
        grads = torch.autograd.grad(loss, list(dparams.values()))
    out["loss"] = _full(loss)
    for k, g in zip(dparams, grads):
        out["g:" + k] = _full(g)
    # the wrappers take (B, H, S, D): H/2 heads on each rank
    out["flash_local_heads"] = np.array(
        bool(layouts.local_q) and all(q[1] == cfg.n_heads // 2 for q in layouts.local_q))
    out["flash_local_q"] = np.array(layouts.local_q)
    # every tensor a flash op receives splits its heads over "model" (mesh
    # dim 1: dim 2 of (B, S, H, D), dim 1 of lse): DTensor gathers nothing
    out["flash_heads_layout"] = np.array(bool(layouts.placements) and all(
        p[1] in (Shard(2), Shard(1)) for call in layouts.placements for p in call))
    # the flash op forward and backward at those layouts sends nothing
    qkv = sh.place(torch.randn(2, 8, cfg.n_heads, cfg.head_dim,
                               generator=torch.Generator().manual_seed(0)),
                   mesh, ("data", None, "model", None)).requires_grad_()
    with CountCollectives() as counted:
        torch.autograd.grad(flash_attention(qkv, qkv, qkv).sum(), qkv)
    out["attention_collectives"] = np.array(counted.total())

    # the planned twins on two backends, bitwise sharded vanilla; the
    # per-device pricing against the local bytes of a node-by-node run
    for backend in ("fx", "interpreter"):
        pf = repro_torch.plan_function(fn, None, mesh=mesh, in_shardings=(None, None),
                                       backend=backend, planner=Planner(cache=PlanCache()))
        low = pf.lowered_for(dparams, db)
        got = pf(dparams, db)
        ref = vanilla_traced_value_and_grad(low.carrier)(dparams, db)
        out[f"{backend}_recomputes"] = np.array(low.plan.overhead > 0)
        out[f"{backend}_bitwise_vanilla"] = np.array(_bits(got, ref))
        out[f"{backend}_loss"] = _full(got[0])
        out[f"{backend}_grads_in_param_placements"] = np.array(all(
            tuple(got[1][k].placements) == tuple(p.placements) for k, p in dparams.items()))
    carrier = low.carrier
    fxg, mem_v = carrier.fx, carrier.to_graph().mem_v
    out["constraint_nodes"] = np.array(sum(
        1 for nd in fxg.nodes if "repro_torch.shard" in str(nd.target)))
    flat = carrier.flatten_args((dparams, db))
    env, args = {}, iter(flat)
    with on_mesh(flat), torch.no_grad():
        for nd in fxg.gm.graph.nodes:
            if nd.op == "placeholder":
                env[nd] = next(args)
            elif nd.op in ("call_function", "get_attr"):
                env[nd] = fxg.run_node(nd, env.__getitem__)
    out["local_bytes"] = np.array([
        sum(local_tensor(t).numel() * local_tensor(t).element_size()
            for t in pytree.tree_leaves(env[nd]) if isinstance(t, torch.Tensor))
        for nd in fxg.nodes])
    out["priced_mem_v"] = np.array(mem_v)
    del env

    # Trainers on the mesh: tensor parallel plus FSDP over "data"
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    cfg = cfgs[256]
    named = {n: p for n, p in model(256).named_parameters()}
    fsdp = sh.named_sharding_tree(named, mesh, fsdp=True)
    tp = specs.param_shardings(cfg, mesh, named)
    out["fsdp_leaves"] = np.array(sum(1 for p in fsdp.values() if isinstance(p[0], Shard)))

    def run(tr, n=steps, start=0):
        return tr.run(data.batch(i) for i in range(start, start + n))

    def trainer(mesh_=mesh, shardings=fsdp, **kw):
        kw.setdefault("total_steps", steps)
        return Trainer(loss_fn, model(256), TrainConfig(log_every=0, optimizer=opt, **kw),
                       device="cpu", mesh=mesh_,
                       in_shardings=None if mesh_ is None else (shardings, None))

    # one step of the tensor-parallel Trainer: its collectives by axis
    tpt = trainer(shardings=tp, total_steps=1)
    run(tpt, 1)
    for axis, ops in tpt.comm_by_axis.items():
        for op, rec in ops.items():
            out[f"tp_comm:{axis}:{op}"] = np.array(rec["payload_bytes"])
            out[f"tp_calls:{axis}:{op}"] = np.array(rec["calls"])
    out["tp_local_param_bytes"] = np.array(sum(p.to_local().numel() * 4 for p in tpt.params))
    out["tp_model_sharded_leaves"] = np.array(sum(
        1 for p in tpt.params if not p.placements[1].is_replicate()))
    del tpt

    tr = trainer()
    res = run(tr)
    out["fsdp_losses"], out["fsdp_grad_norms"] = (np.array(res["losses"]),
                                                 np.array(res["grad_norms"]))
    out["fsdp_params_sharded"] = np.array(all(
        tuple(p.placements) == tuple(fsdp[n]) for n, p in zip(tr.names, tr.params)))
    out["fsdp_local_param_bytes"] = np.array(sum(p.to_local().numel() * 4 for p in tr.params))
    for axis, ops in (tr.comm_by_axis or {}).items():
        for op, rec in ops.items():
            out[f"comm:{axis}:{op}"] = np.array(rec["payload_bytes"])
    b0 = {k: torch.as_tensor(v) for k, v in data.batch(0).items()}
    fn2, by_key = functional_loss(loss_fn, tr.model)
    probe = repro_torch.plan_function(fn2, None, mesh=mesh, in_shardings=(None, None))
    budget = probe.lowered_for(by_key, tr._place_batch(b0)).plan.peak_memory
    planned = trainer(plan_budget=budget)
    pres = run(planned)
    out["fsdp_planned_bitwise"] = np.array(
        pres["losses"] == res["losses"] and pres["grad_norms"] == res["grad_norms"]
        and all(torch.equal(a.to_local(), b.to_local())
                for a, b in zip(planned.params, tr.params)))

    # remesh(shardings=): from no mesh, and from the TP-only layout, onto
    # the FSDP layout before any step: bitwise a Trainer built there
    for name, src in (("none", dict(mesh_=None)), ("tp", dict(shardings=tp))):
        moved = trainer(**src)
        moved.remesh(mesh, shardings=fsdp)
        mres = run(moved)
        out[f"remesh_{name}_bitwise"] = np.array(
            mres["losses"] == res["losses"] and mres["grad_norms"] == res["grad_norms"]
            and all(torch.equal(a.to_local(), b.to_local())
                    for a, b in zip(moved.params, tr.params)))

    # a checkpoint restart on sharded parameters: full arrays on disk,
    # written by rank 0; with steps 2 and 3 gone a new Trainer resumes at 1
    ckpt = os.path.join(str(inp["dir"]), "ckpt")
    first = trainer(ckpt_dir=ckpt, ckpt_every=1)
    fres = run(first)
    first.close()
    dist.barrier()
    if rank == 0:
        from repro_torch.checkpointing.store import read_json

        manifest = read_json(os.path.join(ckpt, f"step_{steps:09d}", "MANIFEST.json"))
        out["ckpt_full_shapes"] = np.array(all(
            tuple(manifest["leaves"][f"params/{n}"]["shape"]) == tuple(p.shape)
            for n, p in named.items()))
        for s_ in range(2, steps + 1):
            shutil.rmtree(os.path.join(ckpt, f"step_{s_:09d}"))
    dist.barrier()
    again = trainer(ckpt_dir=ckpt, ckpt_every=1)
    out["ckpt_restored"] = np.array(again.maybe_restore() and again.step == 1)
    ares = run(again, steps - 1, 1)
    again.close()
    out["ckpt_resumed_bitwise"] = np.array(
        ares["losses"] == fres["losses"][1:] and ares["grad_norms"] == fres["grad_norms"][1:]
        and all(torch.equal(a.to_local(), b.to_local())
                for a, b in zip(again.params, first.params)))

    # compressed gradients on the FSDP layout (the key is kept from when this
    # raised): 3 steps within the codec's noise of the plain FSDP run, the
    # error feedback in the parameters' placements
    ctr = trainer(compress_grads=True)
    cres = run(ctr)
    out["compress_raises"] = np.array(
        np.allclose(cres["losses"], res["losses"], rtol=1e-2)
        and all(tuple(e.placements) == tuple(p.placements)
                for e, p in zip(ctr.err_fb, ctr.params)))
    del ctr
    # GQA whose one KV head the model axis does not divide: q's heads
    # split, k's and v's whole; the flash ops' forward and backward send
    # only the dk and dv sums over model, (B_l, S, KV, D) f32 each
    gq = sh.place(torch.randn(2, 8, 4, 16, generator=torch.Generator().manual_seed(1)),
                  mesh, ("data", None, "model", None)).requires_grad_()
    gkv = sh.place(torch.randn(2, 8, 1, 16, generator=torch.Generator().manual_seed(2)),
                   mesh, ("data", None, None, None)).requires_grad_()
    layouts.local_q.clear()
    layouts.local_k.clear()
    with CountCollectives() as counted:
        grads_ = torch.autograd.grad(flash_attention(gq, gkv, gkv).square().sum(), (gq, gkv))
    for axis, ops in counted.by_axis(mesh).items():
        for op, rec in ops.items():
            out[f"gqa_comm:{axis}:{op}:calls"] = np.array(rec["calls"])
            out[f"gqa_comm:{axis}:{op}:payload"] = np.array(rec["payload_bytes"])
    out["gqa_local_q"], out["gqa_local_k"] = np.array(layouts.local_q), np.array(layouts.local_k)
    out["gqa_out"] = _full(flash_attention(gq, gkv, gkv))
    out["gqa_dq"], out["gqa_dkv"] = _full(grads_[0]), _full(grads_[1])
    out["gqa_kv_placements"] = np.array(str(list(grads_[1].placements)))

    # every other family on the model axis: loss and grads on its specs'
    # layout and this rank's slice of the global batch; one Trainer step
    # there and its per-device parameter + AdamW bytes
    for arch in [str(a) for a in inp["family_archs"]]:
        fcfg = _family_config(arch)
        fm = build_model(fcfg, device="cpu")
        fm.load_state_dict({k[len(f"{arch}:p:"):]: torch.tensor(v) for k, v in inp.items()
                            if k.startswith(f"{arch}:p:")}, strict=True)
        named = dict(fm.named_parameters())
        layout = specs.param_shardings(fcfg, mesh, named)
        ffn, fparams = functional_loss(loss_fn, fm)
        fd = {k: sh.place(v.detach(), mesh, sh.normalize_spec(layout[k[len("model."):]], mesh,
                                                               v.dim())).requires_grad_()
              for k, v in fparams.items()}
        half = len(inp[f"{arch}:b:tokens"]) // 2
        rows = slice(data_rank * half, (data_rank + 1) * half)
        local = {k[len(f"{arch}:b:"):]: torch.tensor(v[rows]) for k, v in inp.items()
                 if k.startswith(f"{arch}:b:")}
        fb = {k: DTensor.from_local(v, mesh, [Shard(0), Replicate()], run_check=False)
              for k, v in local.items()}
        layouts.local_q.clear()
        layouts.local_k.clear()
        with on_mesh(list(fd.values())):
            floss = ffn(fd, fb)
            fgrads = torch.autograd.grad(floss, list(fd.values()))
        out[f"{arch}:loss"] = _full(floss)
        for k, g in zip(fd, fgrads):
            out[f"{arch}:g:{k[len('model.'):]}"] = _full(g)
        out[f"{arch}:flash_local_heads"] = np.array(sorted({q[1] for q in layouts.local_q}))
        out[f"{arch}:flash_local_kv_heads"] = np.array(sorted({k[1] for k in layouts.local_k}))
        tr = Trainer(loss_fn, fm, TrainConfig(log_every=0, total_steps=1, optimizer=opt),
                     device="cpu", mesh=mesh, in_shardings=(layout, None))
        res = tr.train_step(local)
        out[f"{arch}:trainer_loss"] = np.array(res["loss"])
        out[f"{arch}:state_bytes"] = np.array(3 * sum(p.to_local().numel() * 4
                                                      for p in tr.params))
        out[f"{arch}:specs_state_bytes"] = np.array(specs.state_bytes_per_device(
            fcfg, sh.axis_sizes_of(mesh)))
        out[f"{arch}:model_sharded_leaves"] = np.array(sum(
            1 for p in tr.params if not p.placements[1].is_replicate()))
        for axis, ops in tr.comm_by_axis.items():
            for op, rec in ops.items():
                out[f"{arch}:comm:{axis}:{op}"] = np.array(rec["payload_bytes"])
                out[f"{arch}:calls:{axis}:{op}"] = np.array(rec["calls"])
    return out

#: the DTensor codec's cases: (name, global shape, placements over {data:
#: 2, model: 2}); the aligned ones (each rank's runs of the global
#: flattening hold whole 256-element blocks) send nothing
CODEC_CASES = (
    ("shard0", (8, 128), ("S0", "R"), True),
    ("shard1", (6, 512), ("R", "S1"), True),
    ("shard0_straddle", (10, 77), ("S0", "R"), False),
    ("shard1_straddle", (6, 100), ("R", "S1"), False),
    ("both", (12, 200), ("S0", "S1"), False),
    ("same_dim", (16, 40), ("S0", "S0"), False),
    ("replicated", (5, 300), ("R", "R"), True),
)


def case_mesh_codec(inp, rank, world):
    """On ``{data: 2, model: 2}``: the global int8 codec on DTensors (each
    rank's payload and values against ``compress`` of the full tensor, and
    the collectives it sends), the error-feedback round-trip; Trainers with
    ``compress_grads`` on FSDP and tensor-parallel layouts (their step-1
    codec against the global codec of the gathered gradient); strategy
    plans and a dropout plan that recomputes its draws on the reduced LM
    and a dropout MLP; ``hierarchical_psum`` on ``{pod: 2, data: 2}``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    import repro_torch
    from repro_torch.analysis.census import CountCollectives
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import PlanCache, Planner
    from repro_torch.core.fx_graph import op_name
    from repro_torch.core.lowering import fx as fx_lowering
    from repro_torch.core.lowering import vanilla_traced_value_and_grad
    from repro_torch.core.prims import ATEN_PRNG
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import specs
    from repro_torch.models import build_model
    from repro_torch.optim import compression as comp
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train import loop as train_loop
    from repro_torch.train.loop import functional_loss

    mesh = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("data", "model"))
    data_rank = rank // (world // 2)
    out: Dict[str, np.ndarray] = {}
    kinds = {"R": Replicate(), "S0": Shard(0), "S1": Shard(1)}

    def global_restricted(c: "comp.Compressed", layout) -> tuple:
        """The global codec's payload and values at this rank's elements."""
        box = tuple(slice(o, o + n) for o, n in zip(layout.offset, layout.local_shape))
        n = int(np.prod(layout.shape))
        q = c.q.reshape(-1)[:n].reshape(layout.shape)[box]
        return q, comp.decompress(c)[box]

    # 1. the codec on DTensors, bitwise the global codec restricted
    for name, shape, placements, _ in CODEC_CASES:
        x = torch.tensor(inp[f"codec:{name}"])
        dx = DTensor.from_local(x, mesh, [Replicate(), Replicate()], run_check=False)
        dx = dx.redistribute(mesh, [kinds[p] for p in placements])
        layout = comp.shard_layout(dx)
        with CountCollectives() as counted:
            c = comp.compress_shard(dx.to_local(), layout)
        q, vals = global_restricted(comp.compress(x), layout)
        out[f"codec:{name}:bitwise"] = np.array(
            torch.equal(comp.local_payload(c), q)
            and torch.equal(comp.decompress_shard(c), vals))
        out[f"codec:{name}:aligned"] = np.array(layout.aligned())
        out[f"codec:{name}:bytes"] = np.array(counted.total())
        out[f"codec:{name}:calls"] = np.array(sum(r["calls"] for r in counted.stats.values()))
        out[f"codec:{name}:q"] = comp.local_payload(c).numpy()
        out[f"codec:{name}:offset"] = np.array(layout.offset)
        # the error-feedback round-trip and the straight-through value
        e = torch.tensor(inp[f"codec:{name}:e"])
        de = DTensor.from_local(e, mesh, [Replicate(), Replicate()], run_check=False)
        de = de.redistribute(mesh, dx.placements)
        g2, e2 = comp.roundtrip_leaf_with_feedback(dx, de)
        wg, we = comp.roundtrip_leaf_with_feedback(x, e)
        rt = comp.straight_through_roundtrip(dx)
        out[f"codec:{name}:feedback_bitwise"] = np.array(
            tuple(g2.placements) == tuple(dx.placements)
            and torch.equal(g2.full_tensor(), wg) and torch.equal(e2.full_tensor(), we)
            and torch.equal(rt.full_tensor(), comp.straight_through_roundtrip(x)))
    # a Partial tensor: its global value is the sum, reduced before the codec
    x = torch.tensor(inp["codec:both"])
    part = DTensor.from_local(x / 2, mesh, [Partial(), Replicate()], run_check=False)
    out["codec:partial_bitwise"] = np.array(torch.equal(
        comp.straight_through_roundtrip(part).full_tensor(),
        comp.straight_through_roundtrip(part.full_tensor())))

    # 2. compress_grads on sharded parameters: FSDP over data and tensor
    # parallel over model; the step-1 codec against the global codec of the
    # gathered gradient and error feedback, leaf by leaf
    cfg = dataclasses.replace(reduced(get_config("stablelm-3b"), d_model=256), dtype="float32")
    state = {k[len("p256:"):]: torch.tensor(v) for k, v in inp.items() if k.startswith("p256:")}
    steps, seq, batch = int(inp["steps"]), int(inp["seq"]), int(inp["batch"])
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                                  num_hosts=2, host_id=data_rank))
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)

    def model():
        m = build_model(cfg, device="cpu")
        m.load_state_dict(state, strict=True)
        return m

    def loss_fn(m, b):
        return m.loss(b)

    named = dict(model().named_parameters())
    layouts = {"fsdp": sh.named_sharding_tree(named, mesh, fsdp=True),
               "tp": specs.param_shardings(cfg, mesh, named)}
    codec = train_loop.roundtrip_leaf_with_feedback
    for tag, layout_ in layouts.items():
        checks: List[bool] = []

        def watched(g, e, _checks=checks):
            got = codec(g, e)
            if tr.step == 0:
                want = codec(g.full_tensor(), e.full_tensor())
                _checks.append(all(
                    torch.equal(a.to_local(), sh.place(b, mesh, sh.normalize_spec(a)).to_local())
                    for a, b in zip(got, want)))
            return got

        tr = Trainer(loss_fn, model(), TrainConfig(log_every=0, optimizer=opt,
                                                   total_steps=steps, compress_grads=True),
                     device="cpu", mesh=mesh, in_shardings=(layout_, None))
        train_loop.roundtrip_leaf_with_feedback = watched
        try:
            res = tr.run(data.batch(i) for i in range(steps))
        finally:
            train_loop.roundtrip_leaf_with_feedback = codec
        out[f"compress_{tag}:losses"] = np.array(res["losses"])
        out[f"compress_{tag}:sharded_leaves"] = np.array(sum(
            1 for p in tr.params if not all(q.is_replicate() for q in p.placements)))
        out[f"compress_{tag}:step1_codec_bitwise"] = np.array(
            len(checks) == len(tr.params) and all(checks))
        out[f"compress_{tag}:feedback_placements"] = np.array(all(
            tuple(e.placements) == tuple(p.placements) for e, p in zip(tr.err_fb, tr.params)))

    # 3. strategy plans on the reduced LM's tensor-parallel loss: offload
    # bitwise the mesh's vanilla (the "fx" and "interpreter" twins), a
    # quantizing plan's int8 payloads bitwise the global codec's
    lcfg = dataclasses.replace(reduced(get_config("stablelm-3b")), dtype="float32")
    lm = build_model(lcfg, device="cpu")
    lm.load_state_dict({k[len("p64:"):]: torch.tensor(v) for k, v in inp.items()
                        if k.startswith("p64:")}, strict=True)
    fn, params = functional_loss(loss_fn, lm)
    tp = specs.param_shardings(lcfg, mesh, {k[len("model."):]: v for k, v in params.items()})
    dparams = {k: sh.place(v.detach(), mesh, sh.normalize_spec(tp[k[len("model."):]], mesh,
                                                                v.dim())).requires_grad_()
               for k, v in params.items()}
    ldata = SyntheticLM(DataConfig(vocab_size=lcfg.vocab_size, seq_len=seq, global_batch=batch,
                                   num_hosts=2, host_id=data_rank))
    db = {k: DTensor.from_local(torch.as_tensor(v), mesh, [Shard(0), Replicate()],
                                run_check=False) for k, v in ldata.batch(0).items()}
    for backend in ("fx", "interpreter"):
        pf = repro_torch.plan_function(fn, None, mesh=mesh, in_shardings=(None, None),
                                       backend=backend, strategies=("offload",),
                                       planner=Planner(cache=PlanCache()))
        low = pf.lowered_for(dparams, db)
        got = pf(dparams, db)
        ref = vanilla_traced_value_and_grad(low.carrier)(dparams, db)
        out[f"offload_{backend}:nodes"] = np.array(sum(
            1 for c in (low.plan.strategy or {}).values() if c == "offload"))
        out[f"offload_{backend}:bitwise_vanilla"] = np.array(_bits(got, ref))
    captured = []
    roundtrip = fx_lowering.roundtrip_with_payload

    def capture(t):
        y, c = roundtrip(t)
        captured.append((comp.reduce_partial(t).full_tensor().detach(), c))
        return y, c

    fx_lowering.roundtrip_with_payload = capture
    try:
        pf = repro_torch.plan_function(fn, None, mesh=mesh, in_shardings=(None, None),
                                       strategies=("quantize",),
                                       planner=Planner(cache=PlanCache()))
        low = pf.lowered_for(dparams, db)
        got = pf(dparams, db)
    finally:
        fx_lowering.roundtrip_with_payload = roundtrip
    ref = vanilla_traced_value_and_grad(low.carrier)(dparams, db)
    out["quantize:nodes"] = np.array(sum(
        1 for c in (low.plan.strategy or {}).values() if c == "quantize"))
    out["quantize:captured"] = np.array(len(captured))
    ok = []
    for i, (full, c) in enumerate(captured):
        q, _ = global_restricted(comp.compress(full), c.layout)
        ok.append(torch.equal(comp.local_payload(c), q))
        if i < 3:  # a few for the parent, against the reference's codec
            out[f"quantize:{i}:full"] = full.numpy()
            out[f"quantize:{i}:q"] = comp.local_payload(c).numpy()
            out[f"quantize:{i}:offset"] = np.array(c.layout.offset)
    out["quantize:payloads_bitwise"] = np.array(bool(ok) and all(ok))
    out["quantize:loss"], out["quantize:vanilla_loss"] = _full(got[0]), _full(ref[0])
    out["quantize:grad_rel_l2"] = np.array(max(
        float((_full_t(got[1][k]) - _full_t(ref[1][k])).norm()
              / max(float(_full_t(ref[1][k]).norm()), 1e-30)) for k in ref[1]))

    # 4. a dropout MLP whose default plan recomputes its bernoulli draws,
    # bitwise the mesh's plain autograd through the traced nodes (each drawn
    # once), on both traced backends; eager F.dropout on a sharded DTensor
    # dispatches native_dropout, which draws in another order than the
    # traced bernoulli
    def dropout_mlp(ws, x):
        h = x
        for w in ws:
            h = torch.nn.functional.dropout(torch.tanh(h @ w), 0.5, training=True)
        return torch.sum(h * h)

    ws = [torch.tensor(inp[f"drop:w{i}"]) for i in range(int(inp["drop:n"]))]
    dx = torch.tensor(inp["drop:x"])
    for backend in ("fx", "interpreter"):
        pf = repro_torch.plan_function(dropout_mlp, None, mesh=mesh,
                                       in_shardings=(None, ("data", None)), backend=backend,
                                       planner=Planner(cache=PlanCache()))
        low = pf.lowered_for(ws, dx)
        fxg = low.carrier.fx
        redrawn = [v for seg in low.plan.segments for v in seg.recompute
                   if op_name(fxg.nodes[v].target) in ATEN_PRNG]
        torch.manual_seed(11)
        got = pf(ws, dx)
        torch.manual_seed(11)
        ref = vanilla_traced_value_and_grad(low.carrier, low.plan)(ws, dx)
        out[f"dropout_{backend}:redrawn"] = np.array(len(redrawn))
        out[f"dropout_{backend}:bitwise_vanilla"] = np.array(_bits(got, ref))

    # 5. hierarchical_psum on {pod: 2, data: 2} over the same ranks, and
    # with no pod axis (a plain all-reduce over data)
    pod_mesh = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("pod", "data"))
    hx = torch.tensor(inp[f"psum:x{rank}"])
    with CountCollectives() as counted:
        hy = comp.hierarchical_psum(hx, pod_mesh)
    out["psum:y"] = hy.numpy()
    for axis, ops in counted.by_axis(pod_mesh).items():
        for op, rec in ops.items():
            out[f"psum:comm:{axis}:{op}:calls"] = np.array(rec["calls"])
            out[f"psum:comm:{axis}:{op}:payload"] = np.array(rec["payload_bytes"])
    out["psum:nopod_y"] = comp.hierarchical_psum(hx, mesh).numpy()
    return out



def case_expert_parallel(inp, rank, world):
    """The MoE layer on ``{data: 2, model: 2}`` for each case of the test:
    its output and the gradients of ``sum(y · cot)`` (full values), and the
    collectives its forward and backward send, by mesh axis."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.analysis.census import CountCollectives
    from repro_torch.configs import MoEConfig
    from repro_torch.core.lowering.base import on_mesh
    from repro_torch.models.moe import moe_apply
    from repro_torch.parallel import sharding as sh

    mesh = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("data", "model"))
    out: Dict[str, np.ndarray] = {}
    for case in [str(c) for c in inp["cases"]]:
        E, K, F_, cf = inp[f"{case}:moe"].tolist()
        cfg = MoEConfig(num_experts=int(E), top_k=int(K), d_ff_expert=int(F_),
                        capacity_factor=cf)
        x = torch.tensor(inp[f"{case}:x"])
        cot = torch.tensor(inp[f"{case}:cot"])
        B, S, _ = x.shape
        # the layer's own token layout (batch over data, the sequence over
        # model where each divides), so no collective enters at its boundary
        x_spec = ("data" if B % 2 == 0 else None, "model" if S % (world // 2) == 0 else None,
                  None)
        xd = sh.place(x, mesh, x_spec).requires_grad_()
        params = {"router": torch.tensor(inp[f"{case}:router"])}
        params["experts"] = {k: torch.tensor(inp[f"{case}:{k}"])
                             for k in ("w_gate", "w_up", "w_down")}
        pd = {"router": sh.place(params["router"], mesh, ()).requires_grad_(),
              "experts": {k: sh.place(w, mesh, sh.drop_indivisible(
                  ("model", None, None), tuple(w.shape), {"model": world // 2})
              ).requires_grad_() for k, w in params["experts"].items()}}
        leaves = [xd, pd["router"], *pd["experts"].values()]
        with CountCollectives() as counted, on_mesh(leaves):
            y = moe_apply(pd, xd, cfg)
            grads = torch.autograd.grad(y, leaves, sh.place(cot, mesh, sh.normalize_spec(y)))
        out[f"{case}:y"] = _full(y)
        for name, g in zip(("x", "router", "w_gate", "w_up", "w_down"), grads):
            out[f"{case}:g:{name}"] = _full(g)
        for axis, ops in counted.by_axis(mesh).items():
            for op, rec in ops.items():
                out[f"{case}:comm:{axis}:{op}:calls"] = np.array(rec["calls"])
                out[f"{case}:comm:{axis}:{op}:payload"] = np.array(rec["payload_bytes"])
        out[f"{case}:y_placements"] = np.array(str(list(y.placements)))
    return out


def _family_config(arch: str, **changes):
    """The reduced f32 config of ``arch``, as the tests build the
    reference's (granite with its own 1 KV head, which a model axis of 2
    does not divide)."""
    from repro_torch.configs import get_config, reduced

    return dataclasses.replace(reduced(get_config(arch)), dtype="float32", **changes)


def case_sharded_decode(inp, rank, world):
    """``Engine(mesh=, step_shardings=)`` on ``{data: 2, model: 2}`` for each
    family: every request's tokens and every step's full logits; the cache
    layouts; a one-slot engine whose caches split their sequence over
    ``data``; ``plan_scoring(in_shardings=)`` against ``plan_function``."""
    import torch
    import torch.utils._pytree as pytree
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    import repro_torch
    from repro_torch.analysis.census import CountCollectives
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import PlanCache, Planner
    from repro_torch.launch.steps import build_decode_step
    from repro_torch.models import build_model
    from repro_torch.parallel import sharding as sh
    from repro_torch.serving import Engine

    mesh = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("data", "model"))
    out: Dict[str, np.ndarray] = {}
    slots, max_seq, new = int(inp["slots"]), int(inp["max_seq"]), int(inp["new_tokens"])
    prompts = [[int(t) for t in p if t >= 0] for p in inp["prompts"]]

    def serve(tag, arch, n_slots, prompts_, opts=()):
        cfg = _family_config(arch)
        model = build_model(cfg, device="cpu")
        model.load_state_dict({k[len(f"{arch}:p:"):]: torch.tensor(v) for k, v in inp.items()
                               if k.startswith(f"{arch}:p:")}, strict=True)
        shape = ShapeConfig("decode", max_seq, n_slots, "decode")
        frames = inp.get(f"{arch}:frames")
        # build_decode_step's shardings (in the reference's order) set the
        # rules its opts select, module-wide, for the engine's steps
        p_sh, c_sh, tok_sh, pos_sh = build_decode_step(cfg, shape, mesh, opts=opts)[1]
        eng = Engine(model, max_slots=n_slots, max_seq=max_seq, frames=frames, mesh=mesh,
                     step_shardings=(p_sh, tok_sh, c_sh, pos_sh))
        for prompt in prompts_:
            eng.submit(prompt, max_new_tokens=new)
        with CountCollectives() as counted:
            eng.step()
        for axis, ops in counted.by_axis(mesh).items():
            for op, rec in ops.items():
                out[f"{tag}:comm:{axis}:{op}:calls"] = np.array(rec["calls"])
        logits = [eng.last_logits]
        while eng.pending or any(r is not None for r in eng.slot_req):
            eng.step()
            logits.append(eng.last_logits)
        done = eng.completed
        out[f"{tag}:tokens"] = np.array([t for q in sorted(done, key=lambda q: q.uid)
                                         for t in [q.uid, *q.output, -1]])
        out[f"{tag}:logits"] = np.stack(logits)
        out[f"{tag}:params_sharded"] = np.array(sum(
            1 for p in model.parameters() if any(isinstance(pl, Shard) for pl in p.placements)))
        out[f"{tag}:step_collectives"] = np.array(counted.total())
        return eng

    for arch in [str(a) for a in inp["archs"]]:
        eng = serve(arch, arch, slots, prompts)
        # every cache leaf keeps the rows of its data rank: (L, B, ...) dim 1
        out[f"{arch}:cache_rows_split"] = np.array(all(
            t.placements[0] == Shard(1) and t.to_local().shape[1] == slots // 2
            for t in pytree.tree_leaves(eng.caches)))
    # one slot, one long sequence: the caches split their sequence over data
    eng = serve("long", "stablelm-3b", 1, prompts[:2])
    out["long:cache_seq_split"] = np.array(all(
        t.placements[0] == Shard(2) and t.to_local().shape[2] == max_seq // 2
        for t in pytree.tree_leaves(eng.caches)))
    # weight-stationary: one slot leaves data free, so the residual's
    # features split over it and the activations' partial sums reduce there
    serve("ws", "stablelm-3b", 1, prompts[:2], opts=("ws",))
    out["ws:rules_model"] = np.array(str(sh.get_rules()["model"]))
    sh.set_rules(sh.DEFAULT_RULES)

    # plan_scoring on the engine's mesh: plan_function(mesh=, in_shardings=)'s twin
    params = [torch.tensor(inp[f"w{i}"]) for i in range(3)]
    x = torch.tensor(inp["x"])
    specs_ = (None, ("data", None))
    twin = eng.plan_scoring(_mlp, None, in_shardings=specs_,
                            planner=Planner(cache=PlanCache()))
    direct = repro_torch.plan_function(_mlp, None, mesh=mesh, in_shardings=specs_,
                                       objective="wallclock", planner=Planner(cache=PlanCache()))
    got, want = twin(params, x), direct(params, x)
    out["scoring_bitwise"] = np.array(_bits(got, want))
    out["scoring_loss"] = _full(got[0])
    for i, g in enumerate(got[1]):
        out[f"scoring_g{i}"] = _full(g)
    return out


CASES = {"sharding": case_sharding, "planning": case_planning, "train": case_train,
         "model_axis": case_model_axis, "mesh_codec": case_mesh_codec,
         "expert_parallel": case_expert_parallel, "sharded_decode": case_sharded_decode}


def main() -> None:
    case, rank, world, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}", rank=rank,
                            world_size=world)
    try:
        inp = dict(np.load(tmp / "in.npz"), dir=np.array(str(tmp)))
        res = CASES[case](inp, rank, world)
        np.savez(tmp / f"out{rank}.npz", **res)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
