"""Training loop (port of ``repro/train/loop.py``).

Ported responsibilities:

* **the step** — ``loss_fn(model, batch)`` (the launchers hand in a loss
  whose remat segmentation is the DP plan), ``torch.autograd.grad`` over
  the model's parameters, then an in-place AdamW update;
* **NaN guard** — a non-finite loss or grad-norm skips the parameter update
  (parameters and optimizer state stay as they were) and increments a skip
  counter; the run never poisons its weights;
* **straggler mitigation** — per-step wall-times feed an EWMA; steps slower
  than ``straggler_factor``× the EWMA are counted and surfaced through
  ``on_straggler``;
* **checkpoint/restart** — committed checkpoints every ``ckpt_every``
  steps and at the end of a run (``checkpointing.AsyncCheckpointer``, the
  reference's format); ``maybe_restore`` resumes from the latest committed
  step.  The state is the parameters, the AdamW moments and the step, so a
  restarted run continues bitwise.  In a process group rank 0 writes
  and every rank restores, the ranks meeting at a barrier once the write
  has committed;
* **plan cache** — ``plan_cache_dir`` attaches the on-disk recomputation-plan
  store (core.plan_cache), so a restarted job recovers its remat plan as a
  lookup instead of a re-solve;
* **planned steps** — with ``plan_budget`` the step's loss and gradients
  come from ``repro_torch.plan_function`` applied to the loss over
  ``torch.func.functional_call`` of the model: traced with ``make_fx``,
  planned under the budget and lowered by the default backend (``"fx"``),
  once per batch signature (later steps neither re-trace nor re-plan);
* **microbatches and mixed precision** — ``n_micro`` accumulates the
  gradients of equal microbatches of each rank's rows (the reference's
  ``build_train_step``), ``mixed_precision`` runs the loss on a bf16 copy
  of the f32 masters cast once a step (its ``"mp"`` knob);
  :meth:`Trainer.step_tensors` is the step's body (``train_step`` adds
  the NaN guard's host read; the dry run steps fake tensors without it);
* **gradient compression** — ``compress_grads`` runs the reference's int8
  error-feedback round-trip (``optim.compression``) on the gradients
  before the update; on a mesh each gradient and its error feedback keep
  their parameter's placements and the codec quantizes the global
  gradient's 256-element blocks, each rank its own elements;
* **sharded steps** — ``Trainer(mesh=DeviceMesh, in_shardings=)``: the
  model's parameters, the AdamW moments and the error feedback become
  DTensors on the mesh, laid out by ``in_shardings = (param_shardings,
  batch_shardings)`` as the reference's are: ``param_shardings`` maps a
  parameter name to a spec or DTensor placements
  (``launch.specs.param_shardings``: tensor parallelism over ``model``,
  FSDP over ``data`` where ``fsdp_extend`` asks), None replicates every
  parameter; ``batch_shardings`` maps a batch key to its spec, None
  shards each batch tensor's leading dim over the data axes.  The step
  (plain autograd or the planned twin of ``plan_function(mesh=,
  in_shardings=)``, which budgets per-device bytes) returns every gradient
  in its parameter's placements (a replicated parameter's ``Partial``
  gradient is all-reduced there, an FSDP shard's reduce-scattered); DTensor
  gathers an FSDP-sharded weight where it is used.  The clip's norm is the
  global one (``adamw.global_norm``); the update runs on the local
  tensors.  Checkpoints hold full arrays: each sharded leaf is gathered by
  every rank, one at a time, and written by rank 0; a restore hands each
  rank its shard;
* **elastic re-mesh** — ``remesh(new_mesh, shardings=)`` moves the live
  parameters, moments and error feedback onto the new mesh in the given
  parameter shardings (None: replicated), or off any mesh, and rebuilds
  the step; the planned step re-plans under the new per-device bytes (a
  new digest).

The reference jits a step that donates a private copy of the params; the
port trains the given module in place (a copy would double 11 GB of f32
masters at stablelm-3b width), so a checkpoint is copied to the host
before the next step updates it.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch import nn
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import obs
from repro_torch.checkpointing import AsyncCheckpointer, latest_step, restore
from repro_torch.core.lowering.base import (
    check_executable_mesh,
    in_layout,
    on_mesh,
    value_out,
)
from repro_torch.core.lowering.base import local_tensor as _local
from repro_torch.optim import adamw
from repro_torch.optim.compression import init_error_feedback, roundtrip_leaf_with_feedback
from repro_torch.parallel import sharding as sh
from repro_torch.weights import reference_ndim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1
    compress_grads: bool = False
    # On-disk recomputation-plan cache (core.plan_cache); None keeps the
    # cache in memory only.
    plan_cache_dir: Optional[str] = None
    # Per-device activation-byte budget of the DP recomputation plan: when
    # set, the step's value and grads are ``plan_function(loss, plan_budget,
    # mesh=, in_shardings=)`` with the Trainer's mesh.  None keeps plain
    # autograd (losses whose remat the launcher already planned through
    # segment_sizes stay on that path).
    plan_budget: Optional[float] = None
    optimizer: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig
    )
    # Gradient accumulation: the batch (each rank's rows) in n_micro equal
    # microbatches, one forward and backward each; the step's loss and
    # gradients are their means (the reference's build_train_step scan).
    n_micro: int = 1
    # The reference's "mp" knob: the loss runs on a bf16 compute copy of the
    # f32 masters, cast once a step before it, so the FSDP gathers of the
    # weights move bf16; the gradients reach the masters in f32.
    mixed_precision: bool = False


class _LossModule(nn.Module):
    def __init__(self, loss_fn, model: nn.Module):
        super().__init__()
        self.loss_fn = loss_fn
        self.model = model

    def forward(self, batch):
        return self.loss_fn(self.model, batch)


def functional_loss(loss_fn, model: nn.Module):
    """``loss_fn(model, batch)`` as a pure ``fn(params, batch)`` over
    ``torch.func.functional_call``, and the model's trainable parameters
    as the dict ``fn`` reads, keyed ``"model." + name``.  The dict holds the
    parameters themselves, so an in-place update shows through it."""
    holder = _LossModule(loss_fn, model)

    def fn(params, batch):
        return torch.func.functional_call(holder, params, (batch,))

    params = {"model." + n: p for n, p in model.named_parameters() if p.requires_grad}
    return fn, params


def _full(t: torch.Tensor) -> torch.Tensor:
    """The whole value of ``t``: a replicated DTensor's local tensor, a
    sharded one gathered (a collective: every rank calls it)."""
    t = t.detach()
    if isinstance(t, DTensor):
        return t.to_local() if all(p.is_replicate() for p in t.placements) else t.full_tensor()
    return t


def _onto(t: torch.Tensor, mesh: Any, spec: sh.Spec = ()) -> torch.Tensor:
    """``t``'s whole value laid out on ``mesh`` in ``spec`` (each rank keeps
    its own slice of its copy: nothing is sent beyond gathering a sharded
    ``t``), or plain without a mesh."""
    full = _full(t)
    return full if mesh is None else sh.place(full, mesh, spec)


def _micro_batches(batch: Dict[str, torch.Tensor], n: int):
    """``batch`` in ``n`` equal microbatches of its rows: a DTensor's local
    rows are split on each rank (every microbatch keeps the batch's
    placements), a plain tensor's rows whole."""
    parts: Dict[str, Any] = {}
    for k, t in batch.items():
        local = t.to_local() if isinstance(t, DTensor) else t
        if local.shape[0] % n:
            raise ValueError(f"{local.shape[0]} rows of {k!r} do not split into "
                             f"{n} microbatches")
        chunks = local.chunk(n)
        if isinstance(t, DTensor):
            chunks = [DTensor.from_local(c, t.device_mesh, t.placements, run_check=False)
                      for c in chunks]
        parts[k] = chunks
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _sharded(t: torch.Tensor) -> bool:
    return isinstance(t, DTensor) and not all(p.is_replicate() for p in t.placements)


class Trainer:
    def __init__(
        self,
        loss_fn: Callable[[nn.Module, Dict[str, torch.Tensor]], torch.Tensor],
        model: nn.Module,
        cfg: TrainConfig,
        device="cuda",
        mesh: Any = None,
        in_shardings: Any = None,
    ):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.model = model
        self.device = torch.device(device)
        if cfg.plan_cache_dir:
            from repro_torch.core.plan_cache import set_default_cache_dir

            set_default_cache_dir(cfg.plan_cache_dir)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.decay = [reference_ndim(n, p) >= 2 for n, p in named]
        self.opt_state = self.err_fb = None  # made in their parameters' layout
        self.mesh = None
        param_shardings, self.batch_shardings = in_shardings or (None, None)
        if mesh is None and in_shardings is not None:
            raise ValueError("in_shardings= needs mesh=")
        self._set_mesh(mesh, param_shardings)
        self.planned = None
        self._build_step()
        self.step = 0
        self.skipped = 0
        self.straggler_steps = 0
        self._ewma: Optional[float] = None
        self.on_straggler: Optional[Callable[[int, float, float], None]] = None
        # in a process group only rank 0 writes: the ranks' states are one
        # state, and writers sharing a directory would race
        writes = not dist.is_initialized() or dist.get_rank() == 0
        self._ckpt = (AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.ckpt_keep)
                      if cfg.ckpt_dir and writes else None)
        self._saved_step: Optional[int] = None
        #: on a mesh, the collectives of the first step (``census.
        #: CountCollectives.stats``: calls, payload and ring wire bytes per
        #: op), and the same per mesh axis (``{"data": {op: ...}, "model": ...}``)
        self.comm_stats: Optional[Dict[str, Dict[str, float]]] = None
        self.comm_by_axis: Optional[Dict[str, Dict[str, Dict[str, float]]]] = None

    # ------------------------------------------------------------- the mesh

    def _set_mesh(self, mesh: Any, param_shardings: Any = None) -> None:
        """Lay the parameters, moments and error feedback out on ``mesh`` in
        ``param_shardings`` (a name → spec or placements dict; None:
        replicated), or back to plain tensors (``mesh=None``).  A new
        Trainer's moments are made after its parameters are placed, so no
        process holds the whole of them."""
        specs = [()] * len(self.params)
        if mesh is not None:
            check_executable_mesh(mesh)
            if not sh.is_device_mesh(mesh):
                raise ValueError("Trainer(mesh=) runs on a torch.distributed DeviceMesh; "
                                 "an {axis: size} dict only prices plans (plan_function)")
            if param_shardings is not None:
                specs = [sh.normalize_spec(param_shardings.get(n), mesh, p.dim())
                         for n, p in zip(self.names, self.params)]
        if mesh is not None or self.mesh is not None:
            self._replace_params([_onto(p, mesh, s) for p, s in zip(self.params, specs)])
        self.mesh = mesh
        st = self.opt_state
        if st is None:  # a new Trainer: zero moments made on each rank's shards
            self.opt_state = adamw.init(self.params)
            if self.cfg.compress_grads:
                self.err_fb = init_error_feedback(self.params)
            return
        st.mu = [_onto(m, mesh, s) for m, s in zip(st.mu, specs)]
        st.nu = [_onto(v, mesh, s) for v, s in zip(st.nu, specs)]
        if self.err_fb is not None:
            self.err_fb = [_onto(e, mesh, s) for e, s in zip(self.err_fb, specs)]

    def _batch_spec(self, key: str, t: torch.Tensor) -> sh.Spec:
        """The batch tensor's spec from ``batch_shardings``, by default
        ``Shard(0)`` over the data axes (the logical ``"batch"`` axis)."""
        given = (self.batch_shardings or {}).get(key)
        if given is not None:
            return sh.normalize_spec(given, self.mesh, t.dim())
        return tuple(sh.resolve(("batch",) + (None,) * (t.dim() - 1), self.mesh, shape=None))

    def _replace_params(self, tensors) -> None:
        """Swap the model's trainable parameters for ``tensors`` (new
        ``nn.Parameter`` objects, in ``self.names`` order)."""
        params = []
        for name, t in zip(self.names, tensors):
            mod_name, _, leaf = name.rpartition(".")
            mod = self.model.get_submodule(mod_name)
            p = nn.Parameter(t, requires_grad=True)
            mod._parameters[leaf] = p
            params.append(p)
        self.params = params

    def _build_step(self) -> None:
        """The step's planned twin (``plan_budget``), under the current mesh."""
        self.planned = None
        if self.cfg.plan_budget is None:
            return
        if self.cfg.mixed_precision:
            raise ValueError("mixed_precision runs the plain step; plan_budget plans the "
                             "f32 loss")
        from repro_torch.core.lowering import plan_function

        step_loss, self._by_key = functional_loss(self.loss_fn, self.model)
        kw = {} if self.mesh is None else dict(mesh=self.mesh, in_shardings=(None, None))
        self.planned = plan_function(step_loss, self.cfg.plan_budget, **kw)

    def remesh(self, new_mesh: Any, shardings: Any = None) -> None:
        """Elastic re-mesh: move the live parameters, AdamW moments and
        error feedback onto ``new_mesh`` in the parameter ``shardings``
        (None: replicated), or off any mesh (``new_mesh=None``), and rebuild
        the step.  A planned step re-plans under the new per-device bytes,
        so its plan-cache digest is new."""
        self._set_mesh(new_mesh, shardings)
        self._build_step()
        self.comm_stats = self.comm_by_axis = None

    # ------------------------------------------------------------- step fn

    def _place_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """On a mesh, each plain batch tensor is this process's slice of the
        global batch (the pipeline's ``host_id`` slice, in rank order along
        the data axes) and becomes a DTensor in its batch spec; a DTensor is
        redistributed onto it."""
        if self.mesh is None:
            return batch
        out = {}
        for k, t in batch.items():
            want = sh.spec_to_placements(self._batch_spec(k, t), self.mesh)
            if isinstance(t, DTensor):
                out[k] = t if list(t.placements) == want else t.redistribute(self.mesh, want)
            else:
                out[k] = DTensor.from_local(t, self.mesh, want, run_check=False)
        return out

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """One step; returns loss, grad_norm, lr (floats) and ok (bool).  On
        a mesh the first step also records its collectives
        (``comm_stats``)."""
        if self.mesh is not None and self.comm_stats is None:
            from repro_torch.analysis.census import CountCollectives

            with CountCollectives() as counted:
                out = self._step(batch)
            self.comm_stats = counted.stats
            self.comm_by_axis = counted.by_axis(self.mesh)
            return out
        return self._step(batch)

    def _step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        out = self.step_tensors(batch, nan_guard=True)
        return {**out, "loss": float(out["loss"]), "grad_norm": float(out["grad_norm"])}

    def step_tensors(self, batch: Dict[str, torch.Tensor],
                     nan_guard: bool = False) -> Dict[str, Any]:
        """One step; the loss and the grad norm stay tensors.  With
        ``nan_guard`` (``train_step``'s) both are read on the host and the
        update is skipped when either is non-finite (``ok``); without it
        nothing is read on the host and the update is applied whatever they
        hold (the dry run steps fake tensors so)."""
        with obs.span("trainer.step", step=self.opt_state.step):
            with obs.span("trainer.grads"):
                loss, grads, gnorm = self._grads(batch)
            loss = _local(loss)
            ok = True
            if nan_guard:
                with obs.span("trainer.nan_guard"):
                    ok = math.isfinite(float(loss)) and math.isfinite(float(gnorm))
            if ok:
                with obs.span("trainer.update"):
                    lr = self._update(grads, gnorm)
            else:
                lr = adamw.lr_schedule(self.cfg.optimizer, self.opt_state.step + 1)
        return {"loss": loss, "grad_norm": gnorm, "lr": lr, "ok": ok}

    def _value_and_grad(self, batch: Dict[str, torch.Tensor]):
        """One (micro)batch's loss and gradients, each gradient in its
        parameter's placements (``"rs"``: an FSDP shard's ``Partial``
        gradient is reduce-scattered onto it, a replicated one's
        all-reduced)."""
        if self.planned is not None:
            loss, by_key = self.planned(self._by_key, batch)
            return loss, [by_key[k] for k in self._by_key]
        if self.cfg.mixed_precision:
            fn, _ = functional_loss(self.loss_fn, self.model)
            loss = fn({"model." + n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
                       for n, p in zip(self.names, self.params)}, batch)
        else:
            loss = self.loss_fn(self.model, batch)
        grads = [in_layout(g, p) for g, p in
                 zip(torch.autograd.grad(loss, self.params), self.params)]
        return value_out(loss), grads

    def _grads(self, batch: Dict[str, torch.Tensor]):
        """The step's loss, local gradients (after the error-feedback codec)
        and global gradient norm; over ``n_micro`` microbatches the mean
        loss and the mean of the gradients, accumulated in f32."""
        batch = self._place_batch(batch)
        n = self.cfg.n_micro
        with on_mesh(self.params):
            if n == 1:
                loss, grads = self._value_and_grad(batch)
            else:
                loss = grads = None
                for mb in _micro_batches(batch, n):
                    with obs.span("trainer.micro"):
                        l_, g_ = self._value_and_grad(mb)
                    if grads is None:
                        loss, grads = l_, [g.float() for g in g_]
                    else:
                        loss = loss + l_
                        grads = [a + g.float() for a, g in zip(grads, g_)]
                    del l_, g_
                loss, grads = loss / n, [g / n for g in grads]
        if self.err_fb is not None:
            # leaf by leaf, so the codec holds one leaf's temporaries, not a
            # second and third copy of every gradient; on a mesh each
            # gradient in its parameter's placements, quantized in the
            # global gradient's blocks (``optim.compression``)
            for i, e in enumerate(self.err_fb):
                grads[i], new_err = roundtrip_leaf_with_feedback(grads[i], e)
                with torch.no_grad():
                    _local(e).copy_(_local(new_err))
                del new_err
        # the global norm: each leaf's local squares reduced over the mesh
        # dims that shard it (a replicated leaf's local value is whole)
        gnorm = adamw.global_norm(grads)
        return loss, [_local(g) for g in grads], gnorm

    def _update(self, grads, gnorm) -> float:
        """AdamW on the local tensors, in place; returns the step's lr."""
        st = self.opt_state
        local_state = adamw.AdamWState(st.step, [_local(m) for m in st.mu],
                                       [_local(v) for v in st.nu])
        lr = adamw.update(self.cfg.optimizer, grads, local_state,
                          [_local(p) for p in self.params], decay=self.decay,
                          gnorm=gnorm)["lr"]
        st.step = local_state.step
        return lr

    # --------------------------------------------------------- run control

    def state(self) -> Dict[str, Any]:
        """The checkpointed state, in the reference's tree layout:
        ``{"params": ..., "opt": {"step", "mu", "nu"}}``, keyed by parameter
        name (on a mesh, the local values)."""
        st = self.opt_state

        def named(ts):
            return {n: _local(t) for n, t in zip(self.names, ts)}

        return {"params": named(self.params),
                "opt": {"step": st.step, "mu": named(st.mu), "nu": named(st.nu)}}

    def _full_state(self) -> Optional[Dict[str, Any]]:
        """The state as full arrays on the host, for the checkpoint: each
        sharded leaf is gathered (a collective, so every rank gathers, on
        this thread, leaf by leaf) and kept by the writing rank only; the
        others get None."""
        writes = self._ckpt is not None
        st = self.opt_state

        def named(ts):
            out = {}
            for n, t in zip(self.names, ts):
                full = _full(t)
                if writes:
                    out[n] = full.to("cpu", copy=True)
                del full
            return out

        tree = {"params": named(self.params),
                "opt": {"step": st.step, "mu": named(st.mu), "nu": named(st.nu)}}
        return tree if writes else None

    def maybe_restore(self) -> bool:
        """Resume from the latest committed checkpoint, if any: parameters
        and moments are overwritten in place, and the step is restored."""
        if not self.cfg.ckpt_dir:
            return False
        self._sync_checkpoints()
        s = latest_step(self.cfg.ckpt_dir)
        if s is None:
            return False
        st = self.opt_state
        live = {"params": dict(zip(self.names, self.params)),
                "opt": {"step": st.step, "mu": dict(zip(self.names, st.mu)),
                        "nu": dict(zip(self.names, st.nu))}}
        got = restore(self.cfg.ckpt_dir, s, live)
        with torch.no_grad():
            for dst, src in zip(pytree.tree_leaves(live), pytree.tree_leaves(got)):
                if isinstance(dst, DTensor):  # this rank's shard of the full array
                    src = sh.place(src.to(dst.device), dst.device_mesh,
                                   sh.normalize_spec(dst))
                if isinstance(dst, torch.Tensor):
                    _local(dst).copy_(_local(src))
        self.opt_state.step = int(got["opt"]["step"])
        self.step = s
        return True

    def save(self, wait: bool = False) -> None:
        """Checkpoint the state at the current step (copied to the host
        before this returns; written on the checkpointer's thread, rank 0's
        in a process group).  A step already saved is not written again (the
        final save of a run that ends on a periodic one).  ``wait`` returns
        once the write has committed, on every rank."""
        if not self.cfg.ckpt_dir:
            return
        if self._saved_step != self.step:
            if any(_sharded(t) for t in self.params):
                tree = self._full_state()  # every rank gathers
                if tree is not None:
                    self._ckpt.save_async(self.step, tree)
            elif self._ckpt:
                self._ckpt.save_async(self.step, self.state())
        self._saved_step = self.step
        if wait:
            self._sync_checkpoints()

    def _sync_checkpoints(self) -> None:
        """Wait for this rank's writes, then (in a process group of more
        than one rank) for every rank: past this, rank 0's saves have
        committed and each rank may read them."""
        if self._ckpt:
            self._ckpt.wait()
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()

    def close(self) -> None:
        if self._ckpt:
            self._ckpt.close()

    def _track_time(self, dt: float) -> None:
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.cfg.straggler_factor * self._ewma:
            self.straggler_steps += 1
            if self.on_straggler:
                self.on_straggler(self.step, dt, self._ewma)
        a = self.cfg.ewma_alpha
        self._ewma = (1 - a) * self._ewma + a * dt

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def run(
        self,
        batches,
        log: Callable[[str], None] = print,
    ) -> Dict[str, Any]:
        """Run to total_steps; ``batches`` is an iterable of host batches."""
        c = self.cfg
        it = iter(batches)
        losses, grad_norms, seconds = [], [], []
        while self.step < c.total_steps:
            batch = self._to_device(next(it))
            t0 = time.perf_counter()
            m = self.train_step(batch)  # ends in a host sync (loss, grad-norm)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self._track_time(dt)
            if not m["ok"]:
                self.skipped += 1
            self.step += 1
            losses.append(m["loss"])
            grad_norms.append(m["grad_norm"])
            seconds.append(dt)
            if c.log_every and self.step % c.log_every == 0:
                log(
                    f"step {self.step:6d}  loss {m['loss']:.4f}  "
                    f"gnorm {m['grad_norm']:.3f}  lr {m['lr']:.2e}  "
                    f"{dt*1e3:.0f} ms"
                    + (f"  [skipped={self.skipped}]" if self.skipped else "")
                )
            if c.ckpt_dir and self.step % c.ckpt_every == 0:
                self.save()
        if c.ckpt_dir:
            self.save(wait=True)
        return {
            "final_loss": losses[-1] if losses else float("nan"),
            "losses": losses,
            "grad_norms": grad_norms,
            "step_seconds": seconds,
            "skipped": self.skipped,
            "straggler_steps": self.straggler_steps,
            "step": self.step,
        }


