"""Batched serving engine (port of ``repro/serving/engine.py``): slot-based
continuous batching over the LM's decode step.

* a fixed pool of ``max_slots`` sequence slots, each with a position counter;
  every step decodes the full (B=slots) batch, and empty slots decode
  garbage that the host ignores;
* admission: new requests claim free slots, whose caches are zeroed; the
  prompt is prefilled token by token through the same decode step;
* sampling: greedy or temperature, per request, on the host with the
  reference's numpy code and generator, so equal logits give equal tokens;
* termination: eos token, ``max_new_tokens``, or a full cache.

The engine runs on its model's device (CUDA unless the model was built on
the CPU); a step moves only the (slots, V) f32 logits to the host.  It
serves every family the port builds: a reused slot's KV and recurrent
states are zeroed.  An encoder-decoder model (whisper) takes ``frames``
(slots, T, D), one clip a slot: its caches come from
``model.init_caches(frames, max_seq)``, which runs the encoder once, and a
reused slot zeroes its self-attention KV and keeps its cross-attention
K/V, as in the reference.

**Sharded decode** (``Engine(mesh=DeviceMesh, step_shardings=)``, every
process of the group running the same engine): ``step_shardings`` is the
4-tuple ``(params, tokens, caches, positions)`` of
``launch.steps.decode_shardings`` (its default for the engine's slots and
cache length when only ``mesh`` is given).  The parameters and the caches
are laid out once, the tokens and positions every step, and
``model.decode_step`` runs on DTensors (each rank writes and attends on
its shard of the caches).  Every rank ends each step holding the same
full (slots, V) f32 logits (``full_tensor()``) and samples from them with
the same numpy generator, so every process admits, samples and retires
the same requests: a rank that decided otherwise would feed the next
collective other shapes or skip it, and the group would deadlock.  A
reused slot is zeroed on the ranks whose shard holds its row.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.core.lowering.base import on_mesh
from repro_torch.parallel import sharding as sh


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 → greedy
    eos_id: Optional[int] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    """Continuous batching over ``model.decode_step``.

    ``model`` is the port's ``LM`` or ``WhisperModel``, whose parameters
    live on its device; ``params``, when given, is a state dict loaded into
    it first.  On a mesh the engine swaps the model's parameters for
    DTensors in ``step_shardings[0]`` (each process must hold the same
    model).
    ``step_seconds`` holds the host-clock time of each engine step, which
    ends with the logits' copy to the host; ``last_logits`` the last
    step's (slots, V) f32 logits there.
    """

    def __init__(
        self,
        model,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        max_slots: int = 8,
        max_seq: int = 512,
        rng_seed: int = 0,
        frames: Any = None,
        plan_cache_dir: Optional[str] = None,
        plan_remote: Optional[str] = None,
        prewarm_shapes: Optional[List[Any]] = None,
        mesh: Any = None,
        step_shardings: Any = None,
    ):
        if mesh is not None and not sh.is_device_mesh(mesh):
            raise ValueError("Engine(mesh=) serves on a torch.distributed DeviceMesh; an "
                             "{axis: size} dict prices bytes only")
        if step_shardings is not None and mesh is None:
            raise ValueError("step_shardings= needs mesh=")
        # Attaching the trainers' plan store makes any planning this process
        # does a content-addressed lookup; ``plan_remote`` adds the fleet
        # tier, through which replicas read plans the first one solved.
        if plan_cache_dir:
            from repro_torch.core.plan_cache import set_default_cache_dir

            set_default_cache_dir(plan_cache_dir)
        if plan_remote:
            from repro_torch.core.plan_cache import set_default_remote_store

            set_default_remote_store(plan_remote)
        if params is not None:
            model.load_state_dict(params)
        self.model = model
        self.device = model.embedding.embed.device
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.mesh = mesh
        self._rng = np.random.default_rng(rng_seed)
        if mesh is not None:
            if step_shardings is None:
                from repro_torch.configs.base import ShapeConfig
                from repro_torch.launch.steps import decode_shardings

                shape = ShapeConfig("engine", max_seq, max_slots, "decode")
                step_shardings = decode_shardings(model.cfg, shape, mesh)
            self._place_params(step_shardings[0])
        self.step_shardings = step_shardings
        self.caches = self._plain_caches(frames)
        if mesh is not None:
            self.caches = self._place(self.caches, step_shardings[2])
        self.positions = np.zeros((max_slots,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * max_slots
        self.pending: List[Request] = []
        self.next_uid = 0
        self.completed: List[Request] = []
        self.step_seconds: List[float] = []
        self.last_logits: Optional[np.ndarray] = None
        # Boot-time sweep pre-warm: the first planned step at these shapes
        # is then a frontier lookup.
        if prewarm_shapes:
            self.prewarm_plans(prewarm_shapes)

    # ----------------------------------------------------------------- mesh

    def _plain_caches(self, frames: Any) -> Dict:
        """The model's caches (an encoder-decoder runs its encoder on
        ``frames``: on the mesh, on its rank's batch and head shards)."""
        model = self.model
        if not model.cfg.encoder_decoder:
            return model.init_caches(self.max_slots, self.max_seq)
        if frames is None:
            raise ValueError("encoder-decoder serving needs `frames`")
        frames = torch.as_tensor(frames, device=self.device)
        if self.mesh is None:
            return model.init_caches(frames, self.max_seq)
        spec = (tuple(sh.resolve(("batch",), self.mesh, shape=tuple(frames.shape[:1])))
                + (None, None))
        frames = sh.place(frames, self.mesh, spec)
        with on_mesh([frames]):
            return model.init_caches(frames, self.max_seq)

    def _place(self, tree: Any, shardings: Any) -> Any:
        """Each leaf of ``tree`` in the placements (or spec) of the
        matching leaf of ``shardings``."""
        if isinstance(tree, dict):
            return {k: self._place(v, shardings[k]) for k, v in tree.items()}
        spec = sh.normalize_spec(shardings, self.mesh, tree.dim())
        return sh.place(tree, self.mesh, spec)

    def _place_params(self, shardings: Mapping[str, Any]) -> None:
        """Swap each parameter for a DTensor in its sharding (replicated
        where ``shardings`` names none); each rank keeps its slice."""
        from torch import nn

        for name, p in list(self.model.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = self.model.get_submodule(mod_name)
            spec = sh.normalize_spec(shardings.get(name), self.mesh, p.dim())
            mod._parameters[leaf] = nn.Parameter(sh.place(p.detach(), self.mesh, spec),
                                                 requires_grad=False)

    # ------------------------------------------------------------- planning

    def prewarm_plans(self, shapes: List[Any], dp_shards: int = 1,
                      seq_shards: int = 1, model_shards: int = 1,
                      **kw: Any) -> Dict[str, bool]:
        """Pre-warm the plan cache for the expected batch-shape signatures
        (``repro_torch.configs.ShapeConfig``s) through
        ``launch.plan.prewarm_unit_plans`` on the process-default planner,
        budgeted as the training launcher budgets: the card's memory on
        CUDA, the reference's per-device memory on the CPU.  Returns
        ``{shape.name: already_warm}``."""
        from repro_torch.launch.mesh import planning_hbm_bytes
        from repro_torch.launch.plan import prewarm_unit_plans

        kw.setdefault("hbm_bytes", planning_hbm_bytes(self.device))
        kw.setdefault("device", self.device.type)
        return prewarm_unit_plans(self.model.cfg, shapes, dp_shards, seq_shards,
                                  model_shards, **kw)

    def plan_scoring(self, loss_fn, budget: Optional[float],
                     in_shardings: Any = None, objective: str = "wallclock",
                     **kw: Any):
        """A planned value-and-grad twin of ``loss_fn``, sharing this
        process's plan cache and this engine's mesh:
        ``repro_torch.plan_function(loss_fn, budget, mesh=self.mesh,
        in_shardings=in_shardings, objective=objective, ...)``, whose
        budget is per device on a mesh.

        Scoring steps steal time from decode, so the default objective is
        ``"wallclock"``: plans at the budget are ranked by the replay
        simulator's step time, and each lowered twin's
        ``report.replayed_seconds`` is the chosen plan's predicted step
        seconds.
        """
        from repro_torch.core.lowering import plan_function

        return plan_function(loss_fn, budget, mesh=self.mesh, in_shardings=in_shardings,
                             objective=objective, **kw)

    # ------------------------------------------------------------ admission

    def submit(self, prompt: List[int], **kw: Any) -> int:
        req = Request(uid=self.next_uid, prompt=list(prompt), **kw)
        self.next_uid += 1
        self.pending.append(req)
        return req.uid

    def _reset_slot(self, slot: int) -> None:
        """Zero the slot in every leaf of the cache tree on reuse (units on
        axis 0, slots on 1): KV is masked by position anyway, but recurrent
        (Mamba2, xLSTM) states would otherwise leak between requests.  An
        encoder-decoder engine zeroes only the self-attention KV and keeps
        the cross-attention K/V (the slot's encoded clip).  On a mesh each
        rank zeroes the slot in its local shard where that shard holds the
        slot's row (indexing a slot of a batch-sharded DTensor would
        gather it)."""
        from repro_torch.parallel.sharding import local_shape_and_offset

        tree = self.caches["self"] if self.model.cfg.encoder_decoder else self.caches
        for t in pytree.tree_leaves(tree):
            if self.mesh is None:
                t[:, slot].zero_()
                continue
            shape, offset = local_shape_and_offset(t.shape, t.device_mesh, t.placements)
            if offset[1] <= slot < offset[1] + shape[1]:
                t.to_local()[:, slot - offset[1]].zero_()

    def _admit(self) -> None:
        for slot in range(self.max_slots):
            if self.slot_req[slot] is not None or not self.pending:
                continue
            self.slot_req[slot] = self.pending.pop(0)
            self.positions[slot] = 0
            self._reset_slot(slot)

    # ----------------------------------------------------------------- step

    def _next_token_for(self, slot: int) -> int:
        """Next *input* token for this slot (prompt feed or last sampled)."""
        req = self.slot_req[slot]
        if req is None:
            return 0
        pos = self.positions[slot]
        if pos < len(req.prompt):
            return req.prompt[pos]
        return req.output[-1] if req.output else 0

    def step(self) -> int:
        """One engine step = one batched decode step.  Returns #active slots."""
        self._admit()
        active = [s for s in range(self.max_slots) if self.slot_req[s] is not None]
        if not active:
            return 0
        t0 = time.perf_counter()
        tokens = torch.tensor([[self._next_token_for(s)] for s in range(self.max_slots)],
                              device=self.device)
        position = torch.from_numpy(self.positions).to(self.device, torch.int64)
        if self.mesh is None:
            logits, self.caches = self.model.decode_step(tokens, self.caches, position)
            logits = logits[:, -1, :]
        else:  # every rank holds the same tokens and positions: each keeps its slice
            tokens = self._place(tokens, self.step_shardings[1])
            position = self._place(position, self.step_shardings[3])
            with on_mesh([tokens]):
                logits, self.caches = self.model.decode_step(tokens, self.caches, position)
                logits = logits[:, -1, :].full_tensor()  # the same on every rank
        logits = self.last_logits = logits.cpu().numpy()  # (slots, V)
        self.step_seconds.append(time.perf_counter() - t0)

        for s in active:
            req = self.slot_req[s]
            pos = int(self.positions[s])
            self.positions[s] = pos + 1
            if pos + 1 < len(req.prompt):
                continue  # still prefilling the prompt
            if req.temperature > 0:
                z = logits[s] / req.temperature
                z = z - z.max()
                p = np.exp(z) / np.exp(z).sum()
                tok = int(self._rng.choice(len(p), p=p))
            else:
                tok = int(np.argmax(logits[s]))
            req.output.append(tok)
            hit_eos = req.eos_id is not None and tok == req.eos_id
            full = self.positions[s] >= self.max_seq - 1
            if len(req.output) >= req.max_new_tokens or hit_eos or full:
                req.done = True
                self.completed.append(req)
                self.slot_req[s] = None
        return len(active)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive until every submitted request completes."""
        for _ in range(max_steps):
            if not self.pending and all(r is None for r in self.slot_req):
                break
            self.step()
        return self.completed
