#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-cuts   # the front doors' size cuts, timed
    python3 chip_smoke.py --gqa-designs # the GQA shards' two local designs, timed

Phases (each prints its lines; a failing phase makes the script exit
non-zero and print no result):

0. (before phase build) the dry run's full-depth cells of two configs one
             card cannot hold start on ``{data: 16, model: 16}``, each in a
             subprocess (``PRODUCTION_DRYRUNS``: qwen3-moe-30b-a3b at
             train_4k, mistral-large-123b at decode_32k with ``ws``);
1. build   — compile the flash-attention kernels from the sources with nvcc;
             print each kernel's registers, spills and its count of wgmma
             (HGMMA) and TMA-load (UTMALDG) instructions from
             ``cuobjdump -sass``; fail if the bf16 tensor-core kernels have
             none (the build itself fails if they are not built at the
             registers a thread that their register split assumes);
2. kernels — each CUDA kernel against its plain PyTorch version on the
             training shape (B 2, H 32, S 1024, D 80, bf16), granite's
             (B 2, H 24, KV 8, S 1024, D 64), one model-axis rank's shard
             of the training shape (B 1, H 16), whisper-small's encoder
             (B 8, H 12, S 1500, D 64, non-causal), cross-attention (448
             queries against 1500 frames, non-causal) and decoder (448,
             causal), phi-3-vision-4.2b's (B 2, H 32, S 1600, D 96; all
             timed too), a GQA shape, a
             ragged length, rows that see no key (Sq > Sk), the reduced
             config's head (D 16), a bf16 head off the tensor-core route
             (D 40, SIMT) and an f32 shape, and ``ops.flash_attention`` in
             the model layout (B, S, H, D) at the training shape, forward
             and autograd backward, against the plain forward differentiated
             by autograd; checks that dq is bitwise the same over two calls;
             times each kernel, its plain version and the library's
             yardsticks (``scaled_dot_product_attention`` for the forward,
             aten's flash backward for dq and dk/dv together; never used by
             the port) as device time, replayed from a CUDA graph;
2b. production_dryrun — the dry-run cells started before phase build,
             collected before any phase that prints a host-clock step time:
             status ``ok``, exit 0, parameters and AdamW a device exactly
             ``launch.specs.state_bytes_per_device``, bytes and ``trace_s``;
3. launcher — ``repro_torch.launch.train`` at full stablelm-3b width for 3
             steps (batch 2, seq 1024), budgeted from the card's memory,
             with the launch counts of the three kernels over the run, under
             ``REPRO_VERIFY_PLANS=1`` (the plan verifier checks its plan);
4. witness — the same launcher run with the attention through the plain
             ``dense_attention`` instead of the kernels: step 1 (same
             weights and batch) must agree, and the losses of all three
             steps are printed side by side;
5. profile — one more step of the launcher's Trainer on its plan, under
             ``torch.profiler``: device time by kind of kernel, idle share;
6. trade   — the paper's trade on the card: the same width at 8 units, one
             forward+backward with a DP remat plan at half the all-cached
             peak and one without; same loss, lower measured peak;
7. planned — the front door at the same width and depth:
             ``repro_torch.plan_function`` traces the loss with ``make_fx``
             (one node per aten op, flash attention one opaque node), plans
             it at the exact minimal feasible budget and lowers the plan onto
             autograd (``"fx"``); against plain autograd on the same function:
             same loss and grads, the plan's extra ``flash_fwd`` launches,
             lower measured peak; then two ``Trainer(plan_budget=...)`` steps
             beside two unplanned ones from the same weights and batches
             (same losses and grad norms, re-planning nothing);
7b. policy — the ``"policy"`` backend, the BlockGraph default: stablelm-3b
             at full width, ``POLICY_UNITS`` units, as a BlockGraph of the
             embedding, one block a unit and the head with the loss
             (``lm_blockgraph``), planned at the exact minimal budget;
             ``"policy"``, ``"segment"`` and plain autograd: loss and grads
             bitwise, each peak above resident state beside the DP's
             (``"policy"``'s at or below ``"segment"``'s), ``flash_fwd``
             launches against the design's count, step time;
8. mesh    — sharded planning and data parallelism: the same loss at batch
             16 over an ``{data: 8}`` dict mesh (per-device all-cached peak
             and minimal budget against phase planned's, digests apart
             from ``{data: 4}``'s); on a one-rank NCCL group the sharded
             planned twin on DTensors (bitwise sharded vanilla and phase
             planned's twin, the kernels' launches), the Trainer on the
             mesh plain and with ``compress_grads`` (losses, peaks,
             collectives) and ``remesh`` from no mesh (the next step
             bitwise a Trainer built on the mesh); the launcher under
             ``torchrun --nproc_per_node 1`` (losses bitwise phase
             launcher's, step time, peak, collectives); and two
             processes sharing the card over gloo at 2 units against one
             process on the global batch;
9. model_axis — tensor parallelism and FSDP: four gloo processes sharing
             the card on ``{data: 2, model: 2}`` (the script re-invokes
             itself as ``--model-axis-worker`` under
             ``torch.distributed.run``), each running stablelm-3b at full
             width, 2 units, on its quarter of a global batch of 2 x 1024:
             three Trainers of 3 steps (plain, planned at the minimal
             per-device budget, FSDP over data) against one process's
             meshless Trainer (losses within 1e-4, gradient norms within
             2e-4, planned bitwise plain), every rank's kernels on 16
             heads, the first step's collectives by axis against the count
             from the shapes, parameters + AdamW per process against
             ``launch.specs`` (FSDP: its forced layout's); the FSDP
             Trainer with ``compress_grads`` against one process's
             compressed Trainer (its step-1 codec bitwise the global codec
             of the gathered gradient); ``plan_function(strategies=)`` on
             the loss at the minimal per-device budget (offload bitwise the
             mesh's vanilla, pinned host bytes against the offloaded local
             bytes; a quantizing plan within ``QUANT_BOUND``); a
             dropout MLP at width 2560 whose default plan recomputes its
             draws, bitwise plain autograd (and which DTensor RNG path the
             card took); ``hierarchical_psum`` on ``{pod: 2, data: 2}``
             against one process's reference arithmetic, its collectives
             by axis; then
             the per-device state of qwen2.5-14b, qwen3-moe-30b-a3b and
             mistral-large-123b on ``{data: 16, model: 16}`` (meta device);
9b. production — the production meshes (after phase axis_serve): the
             kernels at the GQA shards the model axis brings (mistral-large
             on 16 ranks, qwen3-moe on 8: each rank's q heads over local
             copies of its own KV head), held and timed; eight gloo
             processes sharing the card on ``{data: 1, model: 8}`` running
             qwen3-moe-30b-a3b (4 KV heads) at full width, 2 units (the
             first rematerialized), f32, against one process, their step-1
             collectives against the shapes' count and their launches; the
             same cell's dry run on a fake group of 8 ranks (collectives
             equal, memory estimate within 0.75-1.25 of the real peak); the
             card's memory against ``launch.mesh.H100_HBM_BYTES``;
10. analysis — the analysis layer on phase planned's workload: the effect
             pass (the 8 flash nodes opaque and pinned, nothing else
             tainted); ``plan_function(analyze_effects=True, verify=True,
             verify_hlo=True)`` at the exact minimal budget (no flash node
             recomputed, loss and grads bitwise, launch counts of the three
             kernels); the same call without effects, with its heavy-op
             census and memory-drift record; a corrupted plan rejected by
             ``check_plan`` with the reference's codes; the launcher's
             verification count; and ``python -m repro_torch.analysis
             --traced quickstart --hlo --device cuda``, which must exit 0;
10b. networks — the paper's seven benchmark graphs
             (``configs.paper_networks``): ``plan_lint --hlo --network
             NAME --device cuda`` on each (exit 0, heavy ops within the
             plan's eq. (1) count), then each network's executable twin at
             ``NETWORKS_BATCH`` x ``NETWORKS_WIDTH`` f32 (16 MiB a node)
             under its abstract plan at the exact minimal budget (the
             ``"policy"`` backend) and under plain autograd in the plan's
             order: loss and grads bitwise, requested and allocated peaks
             above the arguments and outputs beside the analytic peaks, the
             planned requested peak within the drift band of the analytic;
11. serve   — ``repro_torch.launch.serve`` at full stablelm-3b width and
             depth: 16 requests of 64 new tokens through 8 slots of a
             2048-token KV cache; engine steps, median and p90 step time,
             output tok/s, peak memory, KV-cache bytes and the kernels'
             launches (none: decode is plain PyTorch, as in the reference);
             every request must complete with its tokens and every logit be
             finite; then teacher forcing at the same width: 128 tokens
             decoded step by step against ``LM.forward`` (which launches
             ``flash_fwd``), in f32 and in bf16;
12. moe    — granite-moe-3b-a800m (MoE, 40 experts top-8, attention D 64
             with GQA 24:8): the training launcher at full width and depth
             for 3 steps (launches, peak, the share of routes dropped at
             capacity), ``plan_function`` on its loss at 4 units (loss and
             grads bitwise, the extra ``flash_fwd`` launches, a lower
             peak), the serving launcher as phase serve runs it, and
             decode against the forward on 8 tokens (no route dropped);
13. hybrid — zamba2-2.7b (units of 6 Mamba2 blocks and the shared
             attention block on ``concat(h, h0)``; 9 at full depth): the
             launcher, a profiled step, the serving launcher and decode
             against the forward on 128 tokens (the limits hold each block
             decoded on the forward's inputs, the logits the greedy
             agreement) at ``HYBRID_UNITS`` units, and ``plan_function`` on
             its non-chain graph at 1 unit;
14. xlstm  — xlstm-1.3b (units of 7 mLSTM blocks and 1 sLSTM block, heads
             of 512, no attention; 6 at full depth): the launcher, a
             profiled step, the serving launcher and decode against the
             forward (held block by block) at full width and
             ``XLSTM_UNITS`` units, ``plan_function`` at 1 unit on 512
             tokens; no kernel launch anywhere;
15. whisper — whisper-small (12 + 12 layers): the Trainer on frames at
             batch 8 (1500 frames, 448 tokens; the launcher has no frames),
             the serving launcher with one clip a slot (the encoder runs
             once), decode against ``decode_train``, and ``plan_function``
             on its non-chain graph at 6 layers a side;
16. vision — phi-3-vision-4.2b: the Trainer on batches carrying the
             576-patch prefix (S 1600) under ``launch.steps.segment_plan``'s
             plan for that length, the serving launcher (text-only), and
             ``plan_function`` at 2 units with the prefix;
17. result — the ``kernels`` JSON line, the card's name and power limit,
             and the final ``{"ok": true, ...}`` line.

Needs one CUDA card; exits non-zero without one, and outside a checkout.
"""

from __future__ import annotations

import collections
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TRAIN_ARGS = ["--arch", "stablelm-3b", "--steps", "3", "--batch", "2", "--seq", "1024"]
TRADE_UNITS = 8
# the planned phase's depth: planning time grows steeply with the node count
# (603 nodes at 8 units); width is never cut
PLANNED_UNITS = 8
# phase policy: the depth of stablelm-3b as a BlockGraph (full width): the
# embedding, this many unit blocks and the head with the loss
POLICY_UNITS = 8
# phase mesh: the accounting's mesh and global batch (the batch sharded over
# data: 2 sequences a device, as phase planned's unsharded batch), and the
# depth of the two processes that share the card over gloo
MESH_ACCOUNTING = {"data": 8}
MESH_GLOBAL_BATCH = 16
MESH_TWO_PROCESS_LAYERS = 2
# phase model_axis: four gloo processes sharing the card on {data: 2,
# model: 2}, each running stablelm-3b at full width and this depth on its
# quarter of the global batch, three Trainers of this many steps; then the
# per-device f32 state that specs.param_shardings gives the configs that
# one card cannot hold, on the reference's production mesh (meta device)
MODEL_AXIS_MESH = {"data": 2, "model": 2}
MODEL_AXIS_UNITS = 2
MODEL_AXIS_BATCH = 2
MODEL_AXIS_STEPS = 3
MODEL_AXIS_BIG = ("qwen2.5-14b", "qwen3-moe-30b-a3b", "mistral-large-123b")
MODEL_AXIS_BIG_MESH = {"data": 16, "model": 16}
# phase model_axis's checks of recomputed draws and hierarchical_psum on
# the same four processes: the dropout MLP's depth at stablelm-3b's width,
# and each rank's input of hierarchical_psum on {pod: 2, data: 2}
MESH_DROPOUT_DEPTH = 4
PSUM_SHAPE = (4096, 1024)
# phase axis_serve, on MODEL_AXIS_MESH at global batch MODEL_AXIS_BATCH:
# stablelm-3b and granite 2 units deep; stablelm's engine (slots, cache
# length, requests, new tokens); its KV cache a rank: 2 units x k, v x 4
# slots x 2048 x 16 KV heads x 80 x 2 B; zamba2 and xlstm one unit,
# whisper 2 layers a side
AXIS_SERVE_UNITS = 2
AXIS_SERVE_DECODE = (8, 2048, 16, 64)
AXIS_SERVE_CACHE_BYTES = 2 * 2 * 4 * 2048 * 16 * 80 * 2
AXIS_SERVE_GRANITE_STEPS = 3
GRANITE_AXIS_DECODE_TOKENS = 8
AXIS_SERVE_FAMILIES = (("zamba2-2.7b", 6), ("xlstm-1.3b", 8), ("whisper-small", 2))
AXIS_SERVE_FAMILY_STEPS = 2
AXIS_SERVE_FAMILY_DTYPES = ("bfloat16", "float32")
# phase production: eight gloo processes sharing the card on {data: 1,
# model: 8} (the smallest mesh on which a full-width config's KV heads, 4,
# do not divide the model axis), qwen3-moe-30b-a3b at full width and this
# depth in f32 on a global batch of 1 x 1024, two Trainer steps on a plan
# of one-unit segments, the first rematerialized; the same cell's dry run
# on a fake group of 8 ranks, its rank-0 memory estimate held to this
# band of the real rank 0's peak
PRODUCTION_ARCH = "qwen3-moe-30b-a3b"
PRODUCTION_MESH = {"data": 1, "model": 8}
PRODUCTION_UNITS = 2
PRODUCTION_REMAT = (True, False)
PRODUCTION_SEQ, PRODUCTION_BATCH, PRODUCTION_STEPS = 1024, 1, 2
PRODUCTION_MEMORY_BAND = (0.75, 1.25)
# phase production_dryrun: the dry run's full-depth cells of configs one
# card cannot hold on {data: 16, model: 16}, each in a process of its own,
# started before phase build (beside the compiler and the kernels'
# device-timed cases) and collected after phase kernels, before any phase
# that prints a host-clock step time.  qwen2.5-14b's and mistral-large's
# train_4k cells (traces of 68.4-79.2 s and 223.7 s on the card's host)
# are left out for the script's time limit
PRODUCTION_DRYRUNS = (("qwen3-moe-30b-a3b", "train_4k", ()),
                      ("mistral-large-123b", "decode_32k", ("ws",)))
PRODUCTION_DRYRUN_TIMEOUT = 300
SERVE_ARGS = ["--full", "--requests", "16", "--slots", "8", "--max-seq", "2048",
              "--new-tokens", "64"]
TEACHER_TOKENS = 128
# phase moe: the front door's depth (full width); decode against the forward
# on a prefix whose capacity (8 slots an expert) drops no route in the forward
MOE_PLANNED_UNITS = 4
# 8 tokens: capacity 8 holds every token, so the forward can drop no route.
# At 16 tokens (capacity 8, mean load 3.2) the forward dropped 809 of 4096
# routes on the H100: at random init the tokens' router inputs grow alike
# with depth and pick the same experts (PERF.md §6, ROADMAP.md §3)
MOE_TEACHER_TOKENS = 8
# phase hybrid: the depth of the launcher, the profiled step, serving and
# teacher forcing (full width; 9 units at full depth: cut to keep the
# script inside its time limit, PERF.md §6), and the front door's
# depth (one unit: 6 Mamba2 blocks and the shared block; planning time
# grows steeply with the node count)
HYBRID_UNITS = 1
HYBRID_PLANNED_UNITS = 1
# phase xlstm: the front door's depth (one unit: 7 mLSTM blocks and the sLSTM
# block); decode held block by block: at random init the 48 blocks amplify
# bf16 rounding (on the H100 the bf16 logits' max |gap| was 0.86, greedy
# agreement 0.60, while f32's was 1.5e-4)
XLSTM_PLANNED_UNITS = 1
XLSTM_BLOCKWISE = True
# the depth of phase xlstm's launcher, profiled step, serving and teacher
# forcing (full width; 6 units at full depth: cut for the time limit, as
# HYBRID_UNITS)
XLSTM_UNITS = 1
# the xLSTM front door's sequence: 2 chunks of 256 (1,394 nodes; at 1024
# tokens its 2,332 nodes took 376 s to plan on the H100's host, and at 256
# tokens the plan lowered no measured peak)
XLSTM_PLANNED_SEQ = 512
# phase whisper: the Trainer's batch, whisper's text context, the serving
# launcher (one clip a slot) and the front door's layers on each side
WHISPER_BATCH = 8
WHISPER_TOKENS = 448
WHISPER_SERVE_ARGS = ["--arch", "whisper-small", "--full", "--requests", "16", "--slots",
                      "8", "--max-seq", "448", "--new-tokens", "64"]
# 6 of the 12 layers on each side: planning time grows steeply with the
# node count (1,189 at full depth; ``--time-cuts`` times both depths in one
# process, PERF.md §6)
WHISPER_PLANNED_LAYERS = 6
# phase vision: the front door's depth (the Trainer runs all 32 layers: on
# the H100 they peaked at 0.850 of the card, under the 0.9 that would cut them)
VISION_PLANNED_UNITS = 2
# step-by-step decode against the full forward at full width (the limits of
# PERF.md's serving prediction): f32 max |gap|; bf16 max and mean |gap| and
# the share of positions whose greedy token agrees
TEACHER_F32_TOL = 1e-3
TEACHER_BF16_MAX, TEACHER_BF16_MEAN, TEACHER_BF16_AGREE = 0.5, 0.05, 0.8
# the planned phase's workload under storage strategies: the reference's
# documented bound for quantized plans (tests/test_strategies.py), relative
# on the loss and relative l2 on the grads
QUANT_BOUND = 5e-2
# phase networks: the executable twin of the paper's seven graphs at a size
# where a node's bytes are real (f32 (batch, width), 16 MiB a node), beside
# the plan_lint CLI's own run at the reference's twin size (batch 4, width 16)
NETWORKS_BATCH, NETWORKS_WIDTH = 4096, 1024
# the checkpoint phase's depth (full width): ~0.42e9 parameters, ~5 GB a
# checkpoint with the AdamW moments
CKPT_UNITS = 2
# the residual sizes whose pinned host <-> card bandwidth phase costs times:
# a bf16 d_ff activation of the planned workload (2 x 1024 x 6912) and the
# f32 log-softmax of its loss head (2 x 1024 x 50304)
BANDWIDTH_BYTES = (2 * 1024 * 6912 * 2, 2 * 1024 * 50304 * 4)
# (name, B, H, KV, Sq, Sk, D, dtype name, causal); the first is the training
# path's shape
KERNEL_CASES = [
    ("path", 2, 32, 32, 1024, 1024, 80, "bfloat16", True),
    ("gqa", 2, 32, 8, 1024, 1024, 80, "bfloat16", True),
    ("ragged", 1, 8, 4, 1000, 1000, 80, "bfloat16", True),
    ("empty_rows", 1, 8, 2, 384, 200, 80, "bfloat16", True),  # rows 0-183 see no key
    ("reduced", 2, 4, 4, 64, 64, 16, "bfloat16", True),  # the launcher's --reduced head
    ("d40_simt", 1, 4, 2, 136, 136, 40, "bfloat16", True),  # D not a multiple of 16: SIMT
    ("f32_decode", 1, 4, 2, 200, 328, 64, "float32", True),
    # granite-moe-3b-a800m's attention on its launcher path: D 64, GQA 24:8
    ("granite", 2, 24, 8, 1024, 1024, 64, "bfloat16", True),
    # whisper-small at phase whisper's batch 8: the encoder over 1500 frames
    # (non-causal), the decoder's cross-attention (448 queries against the
    # 1500 frames, non-causal) and its causal self-attention over 448 tokens
    ("whisper_enc", 8, 12, 12, 1500, 1500, 64, "bfloat16", False),
    ("whisper_cross", 8, 12, 12, 448, 1500, 64, "bfloat16", False),
    ("whisper_dec", 8, 12, 12, 448, 448, 64, "bfloat16", True),
    # phi-3-vision-4.2b: 576 patches before 1024 tokens, D 96
    ("vision", 2, 32, 32, 1600, 1600, 96, "bfloat16", True),
    # phase model_axis: one rank's local shard of the training shape, its
    # half of the heads ({data: 2, model: 2} on batch 2)
    ("model_axis", 1, 16, 16, 1024, 1024, 80, "bfloat16", True),
    # phase axis_serve: one rank's shard of granite's attention (its half of
    # 24 q and 8 KV heads, one sequence) and of whisper's encoder (its half
    # of 12 heads, one clip)
    ("granite_axis", 1, 12, 4, 1024, 1024, 64, "bfloat16", True),
    ("whisper_enc_axis", 1, 6, 6, 1500, 1500, 64, "bfloat16", False),
]
# phase production: one rank's shard of the GQA attentions whose KV heads
# the model axis does not divide, each rank's q heads over as many local
# copies of its own KV head (``kernels.ops.kv_to_q_heads``: MHA):
# mistral-large-123b's on {model: 16} at train_4k (96 q over 8 KV heads,
# one sequence of 4096) and qwen3-moe-30b-a3b's on {model: 8} (32 over 4,
# one of 1024)
PRODUCTION_KERNEL_CASES = [
    ("mistral_axis", 1, 6, 6, 4096, 4096, 128, "bfloat16", True),
    ("qwen3_axis", 1, 4, 4, 1024, 1024, 128, "bfloat16", True),
]
# ``--gqa-designs``: the same shards with the local call left GQA, k and v
# repeated to lcm(KV, m) heads only (one KV head a rank), the design the
# MHA call replaced; timed beside PRODUCTION_KERNEL_CASES in one process
GQA_DESIGN_CASES = [
    ("mistral_axis_gqa", 1, 6, 1, 4096, 4096, 128, "bfloat16", True),
    ("qwen3_axis_gqa", 1, 4, 1, 1024, 1024, 128, "bfloat16", True),
]
# the cases timed beside their bounds and library calls: the dense path's
# (whose numbers fill the kernels JSON line) and each model family's
TIMED_CASES = ("path", "granite", "whisper_enc", "whisper_cross", "whisper_dec", "vision",
               "model_axis", "granite_axis", "whisper_enc_axis")
# limits on |kernel - plain| for outputs and gradients, by dtype: absolute,
# plus for bf16 one unit in the last place of the plain value (2**-7 |ref|),
# by which two roundings of nearly equal values can differ (a value near 10
# can round to the neighbouring bf16 value, 6.25e-2 away)
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
RTOL = {"bfloat16": 2.0 ** -7, "float32": 0.0}
LSE_TOL = 1e-3
# the launcher against its dense-attention witness: step 1 runs the same
# weights and batch, so its loss is held to the bf16 limit and its grad
# norm to the same limit relative; later steps follow different updates
# and are held to a relative limit (on an H100 they differed by 2.2e-4)
WITNESS_STEP1_TOL = 2e-2
WITNESS_LATER_RTOL = 1e-2
REPLACES = {
    "flash_fwd": "src/repro/kernels/flash_attention.py:52",
    "flash_bwd_dq": "src/repro/kernels/flash_attention.py:185",
    "flash_bwd_dkv": "src/repro/kernels/flash_attention.py:229",
}
# the library call timed beside dq and dk/dv (the same call covers both)
BWD_LIBRARY = "aten._scaled_dot_product_flash_attention_backward (dq, dk and dv together)"
CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = {  # the source of each kernel on the path (bf16)
    "flash_fwd": CSRC + "flash_attention_sm90.cu",
    "flash_bwd_dq": CSRC + "flash_attention_sm90.cu",
    "flash_bwd_dkv": CSRC + "flash_attention_sm90.cu",
}


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def attention_blocks(cfg) -> int:
    """Attention blocks in one unit of ``cfg``'s LM (each launches the
    kernels once a forward): 1 for the dense, MoE and hybrid units, 0 for
    xLSTM's."""
    kinds, _ = importlib.import_module("repro_torch.models").unit_pattern(cfg)
    return sum("attn" in kind for kind in kinds)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` over ``iters`` calls launched from the host, timed
    with CUDA events: the device's time unless the host launches slower."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one ``fn`` call: ``iters`` calls captured in one CUDA
    graph and replayed, timed with CUDA events.  The replay launches no
    Python, so the wrappers' host work (checks, tensor maps, ctypes), which
    takes about as long as a bf16 kernel at the path's shape, is not in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture, as torch.cuda.graph asks
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def sdpa_backward_ms(q, k, v, do, causal=True):
    """Time of aten's flash-attention backward, which computes dq, dk and dv
    in one call (no PyTorch call computes dq alone), fed from its own
    forward: by CUDA-graph replay, or where capture is refused by CUDA
    events around back-to-back calls.  Returns (ms, method)."""
    import torch

    aten = torch.ops.aten
    out, lse, cq, ck, mq, mk, seed, offset = aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, causal)[:8]

    def call():
        return aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, out, lse, cq, ck, mq, mk, 0.0, causal, seed, offset)

    try:
        return device_ms(call), "CUDA-graph replay"
    except RuntimeError as e:
        torch.cuda.synchronize()
        return time_ms(call), f"CUDA events around back-to-back calls (capture refused: {e})"


def compare(label: str, tname: str, got, want, tol: float, rtol: float = 0.0) -> float:
    """|got - want| against ``tol + rtol·|want|`` elementwise; prints the max
    error and max |want|, the reading the limit is set against."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = diff.max().item()
    ok = math.isfinite(err) and bool((diff <= tol + rtol * want.abs()).all())
    limit = f"{tol:g}" + (f" + {rtol:g}·|ref|" if rtol else "")
    print(f"[kernels] {label:10s} {tname:3s} max_abs_err {err:.3e} (limit {limit}; "
          f"max |ref| {want.abs().max().item():.3e}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{label}/{tname}: the kernel disagrees with its plain version")
    return err


def attention_bounds(B, H, KV, Sq, Sk, D, dtype_name, causal=True):
    """Least time (ms) of each kernel's work: max(bytes / HBM rate,
    FLOPs / peak rate of the dtype), counting the (query, key) pairs the
    mask keeps.  The rates are the H100 SXM data sheet's (launch.mesh)."""
    mesh = importlib.import_module("repro_torch.launch.mesh")
    peak = {"bfloat16": mesh.PEAK_FLOPS_BF16, "float32": mesh.PEAK_FLOPS_F32}[dtype_name]
    off = Sk - Sq
    pairs = (sum(min(max(i + off + 1, 0), Sk) for i in range(Sq)) if causal
             else Sq * Sk)
    product = 2.0 * D * pairs * B * H  # one S x S x D product over the kept pairs
    item = 4 if dtype_name == "float32" else 2
    x = B * H * Sq * D * item
    kv = B * KV * Sk * D * item
    stat = B * H * Sq * 4
    work = {
        "flash_fwd": (2 * product, x + 2 * kv + x + stat),
        "flash_bwd_dq": (3 * product, x + 2 * kv + x + 2 * stat + x),
        "flash_bwd_dkv": (4 * product, x + 2 * kv + x + 2 * stat + 2 * kv),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / peak * 1e3
        t_bytes = nbytes / mesh.HBM_BW * 1e3
        out[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
                     flops, nbytes)
    return out


# ------------------------------------------------------------------ phases


def sass_counts(lib: Path, cuobjdump: str) -> dict:
    """Kernel function -> (HGMMA, UTMALDG) instruction counts in its SASS."""
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += "UTMALDG" in line
    return counts


def phase_build():
    import torch  # noqa: F401

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    t0 = time.perf_counter()
    lib = fa.build()
    fa._library()
    dt = time.perf_counter() - t0
    nvcc = subprocess.run([fa._nvcc(), "--version"], capture_output=True, text=True)
    print(f"[build] {lib.relative_to(ROOT)} in {dt:.1f} s")
    print("[build] nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("[build] ptxas: " + line.strip())
    for i, name in enumerate(fa.SM90_KERNELS):  # build() has held ptxas to these
        print(f"[build] {name}: setmaxnreg split of "
              f"{fa._library().flash_sm90_launch_regs(i)} registers a thread")
    cuobjdump = str(Path(fa._nvcc()).with_name("cuobjdump"))
    counts = sass_counts(lib, cuobjdump)
    for fn, (hgmma, utmaldg) in counts.items():
        print(f"[build] sass: HGMMA {hgmma:3d} UTMALDG {utmaldg:3d}  {fn}")
    for name in fa.SM90_KERNELS:
        found = [c for fn, c in counts.items() if name in fn]
        check(bool(found) and all(h > 0 and u > 0 for h, u in found),
              f"{name}: no wgmma (HGMMA) or TMA load (UTMALDG) in its SASS")


def phase_kernels(results):
    import torch

    for ci, case in enumerate(KERNEL_CASES):
        kernel_case(results, ci, case, case[0] in TIMED_CASES)
    for name in TIMED_CASES:
        check_model_layout(len(KERNEL_CASES), name)
    # cuBLAS keeps a workspace for each stream that ran a matmul, the timing
    # streams' too; drop them so that the launcher's peak memory is its own
    torch._C._cuda_clearCublasWorkspaces()


def kernel_case(results, ci: int, case: tuple, timed: bool) -> None:
    """One ``KERNEL_CASES`` entry: each kernel against its plain version
    (inputs from seed ``ci``); with ``timed``, each kernel, its plain
    version and the library's yardsticks timed beside its bound, into
    ``results`` (the path's entry, or another shape's beside it)."""
    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    ref = importlib.import_module("repro_torch.kernels.ref")
    dev = torch.device("cuda")
    name, B, H, KV, Sq, Sk, D, dtn, causal = case
    dt = getattr(torch, dtn)
    g = torch.Generator(device=dev).manual_seed(ci)
    q = torch.randn(B, H, Sq, D, device=dev, dtype=dt, generator=g)
    k = torch.randn(B, KV, Sk, D, device=dev, dtype=dt, generator=g)
    v = torch.randn(B, KV, Sk, D, device=dev, dtype=dt, generator=g)
    do = torch.randn(B, H, Sq, D, device=dev, dtype=dt, generator=g)
    c = dict(causal=causal)

    o_ref, lse_ref = ref.attention_with_lse_ref(q, k, v, **c)
    o, lse = fa.flash_attention_fwd(q, k, v, **c)
    delta = ref.row_delta(o_ref, do)
    dq_ref = ref.attention_bwd_dq_ref(q, k, v, lse_ref, delta, do, **c)
    dq = fa.flash_attention_bwd_dq(q, k, v, lse_ref, delta, do, **c)
    dk_ref, dv_ref = ref.attention_bwd_dkv_ref(q, k, v, lse_ref, delta, do, **c)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse_ref, delta, do, **c)
    torch.cuda.synchronize()

    tol, rtol = TOL[dtn], RTOL[dtn]
    errs = {}
    for kname, pairs in (("flash_fwd", [("out", o, o_ref)]),
                         ("flash_bwd_dq", [("dq", dq, dq_ref)]),
                         ("flash_bwd_dkv", [("dk", dk, dk_ref), ("dv", dv, dv_ref)])):
        errs[kname] = max(compare(name, tname, a, b, tol, rtol) for tname, a, b in pairs)
    lse_err = (lse - lse_ref).abs().max().item()
    print(f"[kernels] {name:10s} lse max_abs_err {lse_err:.3e} (limit {LSE_TOL:g})")
    check(lse_err <= LSE_TOL, f"flash_fwd lse disagrees on {name}")
    if not timed:
        return

    # a training path's shape: times, bounds and the library yardstick
    bounds = attention_bounds(B, H, KV, Sq, Sk, D, dtn, causal)
    timed = {
        "flash_fwd": (lambda: fa.flash_attention_fwd(q, k, v, **c),
                      lambda: ref.attention_with_lse_ref(q, k, v, **c)),
        "flash_bwd_dq": (lambda: fa.flash_attention_bwd_dq(q, k, v, lse_ref, delta, do, **c),
                         lambda: ref.attention_bwd_dq_ref(q, k, v, lse_ref, delta, do,
                                                          **c)),
        "flash_bwd_dkv": (lambda: fa.flash_attention_bwd_dkv(q, k, v, lse_ref, delta, do,
                                                             **c),
                          lambda: ref.attention_bwd_dkv_ref(q, k, v, lse_ref, delta, do,
                                                            **c)),
    }
    dq2 = fa.flash_attention_bwd_dq(q, k, v, lse_ref, delta, do, **c)
    torch.cuda.synchronize()
    print(f"[kernels] {name:10s} dq bitwise equal over two calls: {torch.equal(dq, dq2)}")
    check(torch.equal(dq, dq2), "flash_bwd_dq is not deterministic")
    lib_fwd, fwd_label = library_forward_ms(q, k, v, causal)
    if KV == H:
        lib_bwd, lib_bwd_method = sdpa_backward_ms(q, k, v, do, causal)
        bwd_label = BWD_LIBRARY
    else:  # aten's flash backward takes no GQA: k and v repeated to H heads
        rep = H // KV
        lib_bwd, lib_bwd_method = sdpa_backward_ms(
            q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1), do, causal)
        bwd_label = BWD_LIBRARY + f", on k and v repeated to {H} heads"
    library = {"flash_fwd": (lib_fwd, fwd_label),
               "flash_bwd_dq": (lib_bwd, bwd_label),
               "flash_bwd_dkv": (lib_bwd, bwd_label)}
    ms_of = {}
    for kname, (kern, plain) in timed.items():
        bound, bound_by, flops, nbytes = bounds[kname]
        entry = {
            "name": kname, "route": "cuda", "source": SOURCE[kname],
            "replaces": REPLACES[kname], "launches": 0,
            "max_abs_err": errs[kname], "ms": device_ms(kern),
            "plain_ms": device_ms(plain, iters=5), "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": library[kname][0], "library": library[kname][1],
        }
        if name == "path":
            results[kname] = entry
        else:  # another model's shape, kept beside the path's entry
            results[kname][name] = {k: entry[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        launched = time_ms(kern)
        print(f"[kernels] {name:10s} {kname:14s} {entry['ms']:.4f} ms (host-launched "
              f"{launched:.4f} ms)  plain {entry['plain_ms']:.4f} ms"
              f"  bound {bound:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)  library {entry['library_ms']}  achieved "
              f"{flops / entry['ms'] / 1e9:.1f} TFLOP/s, {bound / entry['ms']:.3f} of bound")
        ms_of[kname] = entry["ms"]
    print(f"[kernels] {name:10s} library forward {fwd_label}: {lib_fwd:.4f} ms; library "
          f"backward {bwd_label}: {lib_bwd:.4f} ms by {lib_bwd_method}; "
          f"flash_bwd_dq + flash_bwd_dkv {ms_of['flash_bwd_dq'] + ms_of['flash_bwd_dkv']:.4f} ms")


def library_forward_ms(q, k, v, causal=True):
    """Device time of ``scaled_dot_product_attention``'s forward on the
    kernels' inputs, with ``enable_gqa`` where k and v have fewer heads
    (or, where this torch lacks it, on k and v repeated to q's heads).
    Returns (ms, label)."""
    import torch.nn.functional as F

    label = "scaled_dot_product_attention (forward)"
    H, KV = q.shape[1], k.shape[1]
    if H == KV:
        return device_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                is_causal=causal)), label
    try:
        F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
    except TypeError:
        rep = H // KV
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        return (device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)),
                label + f", on k and v repeated to {H} heads")
    return (device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                             enable_gqa=True)),
            label + ", enable_gqa=True")


def check_model_layout(seed: int, case: str = "path") -> None:
    """``ops.flash_attention`` at a training shape (``KERNEL_CASES``'s
    ``case``) in the model layout (B, S, H, D), as the launcher calls it:
    the kernels read and write transposed views, and the backward gets the
    upstream gradient through autograd.  Held against the plain forward in
    f32 on the same card tensors, differentiated by autograd."""
    import torch

    ops = importlib.import_module("repro_torch.kernels.ops")
    ref = importlib.import_module("repro_torch.kernels.ref")
    _, B, H, KV, Sq, Sk, D, dtn, causal = next(
        c for c in KERNEL_CASES + PRODUCTION_KERNEL_CASES + GQA_DESIGN_CASES if c[0] == case)
    dev, dt = torch.device("cuda"), getattr(torch, dtn)
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, n, D, device=dev, dtype=dt, generator=g)
                   for S, n in ((Sq, H), (Sk, KV), (Sk, KV), (Sq, H)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal)
    grads = torch.autograd.grad(out, leaves, do)
    f32 = [t.float().requires_grad_() for t in (q, k, v)]
    out_ref = ref.attention_with_lse_ref(*(t.transpose(1, 2) for t in f32),
                                         causal=causal)[0].transpose(1, 2)
    grads_ref = torch.autograd.grad(out_ref, f32, do.float())
    torch.cuda.synchronize()
    for tname, a, b in zip(("out", "dq", "dk", "dv"), (out, *grads), (out_ref, *grads_ref)):
        check(a.shape == b.shape and a.dtype == dt, f"model layout {tname}: shape or dtype")
        compare(f"bshd_{case}", tname, a, b, TOL[dtn], RTOL[dtn])


def phase_launcher(results, state):
    """The launcher's path at full stablelm-3b width, counting launches."""
    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    train = importlib.import_module("repro_torch.launch.train")
    analysis = importlib.import_module("repro_torch.analysis")
    # the launcher verifies its plan (REPRO_VERIFY_PLANS=1 -> check_plan);
    # the reports are counted here and the count read by phase analysis
    reports, check_plan = [], analysis.check_plan

    def counted(*a, **kw):
        reports.append(check_plan(*a, **kw))
        return reports[-1]

    analysis.check_plan = counted
    os.environ["REPRO_VERIFY_PLANS"] = "1"
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    try:
        out = train.main(TRAIN_ARGS)
    finally:
        del os.environ["REPRO_VERIFY_PLANS"]
        analysis.check_plan = check_plan
    counts = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory

    sp, res = out["plan"], out["plan_result"]
    check(sp is not None and res.feasible, "the launcher made no feasible plan")
    n, steps = out["n_units"], out["step"]
    recomputed = sum(s for s, r in zip(sp.sizes, sp.remat) if r)
    cfg = importlib.import_module("repro_torch.configs").get_config("stablelm-3b")
    shape = importlib.import_module("repro_torch.configs").ShapeConfig("cli", 1024, 2, "train")
    pi = importlib.import_module("repro_torch.launch.plan").plan_inputs(
        cfg, shape, 1, model_shards=1, n_micro=sp.n_micro, hbm_bytes=total)
    print(f"[launcher] plan: sizes {list(sp.sizes)} remat {list(sp.remat)} "
          f"n_micro {sp.n_micro}; DP peak {res.peak_memory:.4e} B, overhead "
          f"{res.overhead:g}, budget {pi.budget:.4e} B of {total} B card memory")
    for i, (loss, dt) in enumerate(zip(out["losses"], out["step_seconds"])):
        print(f"[launcher] step {i + 1} loss {loss:.6f} time {dt:.4f} s")
    print(f"[launcher] max_memory_allocated {peak} B ({peak / total:.3f} of {total} B)")
    print(f"[launcher] launches {json.dumps(counts)} over {steps} steps of {n} units "
          f"({recomputed} recomputed per step)")
    check(steps == 3 and out["skipped"] == 0, "a launcher step was skipped")
    check(all(math.isfinite(x) for x in out["losses"]), "non-finite launcher loss")
    check(counts["flash_fwd"] == steps * (n + recomputed),
          "flash_fwd launches do not match the units run and recomputed")
    check(counts["flash_bwd_dq"] == steps * n and counts["flash_bwd_dkv"] == steps * n,
          "backward kernel launches do not match the units run")
    print(f"[launcher] REPRO_VERIFY_PLANS=1: check_plan ran {len(reports)} time(s), "
          f"reports ok {[r.ok for r in reports]}")
    check(bool(reports) and all(r.ok for r in reports), "the launcher's plan was not verified")
    for name, c in counts.items():
        results[name]["launches"] = c
    state["launcher_verified"] = len(reports)
    state["plan"] = sp
    state["launcher"] = out


def phase_witness(state):
    """The launcher's run again, with ``dense_attention`` (plain torch, the
    O(S²)-memory path) in place of the kernels: same seed, data and plan."""
    import gc

    import torch

    attn = importlib.import_module("repro_torch.models.attention")
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    train = importlib.import_module("repro_torch.launch.train")
    gc.collect()
    torch.cuda.empty_cache()
    kernel_path = attn.flash_attention
    attn.flash_attention = (lambda q, k, v, causal=True:
                            attn.dense_attention(q, k, v, causal=causal))
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        dense = train.main(TRAIN_ARGS)
    finally:
        attn.flash_attention = kernel_path
    print(f"[witness] max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    check(not any(fa.LAUNCHES.values()), "the dense witness launched a kernel")
    kern = state["launcher"]
    for i in range(3):
        dl = abs(kern["losses"][i] - dense["losses"][i])
        dg = abs(kern["grad_norms"][i] - dense["grad_norms"][i]) / dense["grad_norms"][i]
        print(f"[witness] step {i + 1} loss kernels {kern['losses'][i]:.6f} dense "
              f"{dense['losses'][i]:.6f} |diff| {dl:.3e}; grad norm kernels "
              f"{kern['grad_norms'][i]:.6f} dense {dense['grad_norms'][i]:.6f} "
              f"rel diff {dg:.3e}")
    check(dense["skipped"] == 0 and all(math.isfinite(x) for x in dense["losses"]),
          "the dense witness skipped a step or gave a non-finite loss")
    dl = abs(kern["losses"][0] - dense["losses"][0])
    dg = abs(kern["grad_norms"][0] - dense["grad_norms"][0]) / dense["grad_norms"][0]
    print(f"[witness] step 1 limits: loss |diff| {WITNESS_STEP1_TOL:g}, grad norm rel "
          f"diff {WITNESS_STEP1_TOL:g}; steps 2-3: loss rel diff {WITNESS_LATER_RTOL:g}")
    check(dl <= WITNESS_STEP1_TOL and dg <= WITNESS_STEP1_TOL,
          "step 1 (same weights and batch) differs from the dense witness")
    check(all(abs(a - b) <= WITNESS_LATER_RTOL * abs(b)
              for a, b in zip(kern["losses"][1:], dense["losses"][1:])),
          "the loss trajectory differs from the dense witness")


# kernel name fragment -> kind, for the profile's breakdown (first match wins);
# "fwd_kernel" and "dkv_kernel" also match the bf16 route's *_kernel_sm90
KERNEL_KINDS = [("fwd_kernel", "flash_fwd"), ("dq_kernel", "flash_bwd_dq"),
                ("dkv_kernel", "flash_bwd_dkv"), ("gemm", "matmul"), ("xmma", "matmul"),
                ("nvjet", "matmul"), ("cutlass", "matmul")]


def print_device_time(tag: str, what: str, prof, wall_ms: float, n: int = 1) -> None:
    """Device time of a ``torch.profiler`` trace over ``n`` repeats: busy
    time, idle share and time by kind of kernel, each per repeat, and the
    kernels that take most of "other"."""
    import torch

    by_kind, other, n_kernels = {}, {}, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3 / n
        kind = next((k for frag, k in KERNEL_KINDS if frag in e.name), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        if kind == "other":
            other[e.name] = other.get(e.name, 0.0) + ms
        n_kernels += 1
    busy = sum(by_kind.values())
    print(f"[{tag}] {what}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"over {n_kernels / n:g} device events, idle share "
          + (f"{1 - busy / wall_ms:.4f}" if busy else "not measured (no device "
             "time in the trace)"))
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}] {kind:14s} {ms:10.3f} ms  {ms / busy:.4f} of device time")
    for name, ms in sorted(other.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[{tag}]   other: {ms:9.3f} ms  {name[:110]}")


def phase_profile(state):
    """One step of the launcher's Trainer, on its plan at full width, under
    ``torch.profiler``: device time by kind of kernel, the kernels that take
    most of the rest, the idle share, and the AdamW update timed alone."""
    configs = importlib.import_module("repro_torch.configs")
    sp = state["plan"]
    profile_step("profile", configs.get_config("stablelm-3b"), sp.sizes, sp.remat)


def profile_step(tag: str, cfg, sizes, remat) -> None:
    """A Trainer step of ``cfg`` at batch 2 x seq 1024 on the plan (sizes,
    remat), after a warm-up step, under ``torch.profiler``; then the AdamW
    update timed alone."""
    import gc

    import torch

    models = importlib.import_module("repro_torch.models")
    data = importlib.import_module("repro_torch.data")
    train = importlib.import_module("repro_torch.train")

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    model = models.build_model(cfg, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    tr = train.Trainer(lambda m, b: m.loss(b, sizes, remat), model,
                       train.TrainConfig(total_steps=2, log_every=0), device=dev)
    stream = data.SyntheticLM(data.DataConfig(cfg.vocab_size, 1024, 2))
    profile_trainer(tag, tr, stream.batch(0), stream.batch(1))
    del tr, model
    gc.collect()
    torch.cuda.empty_cache()


def profile_trainer(tag: str, tr, warm, batch) -> None:
    """A step of Trainer ``tr`` on host ``batch`` after a warm-up step on
    ``warm``, under ``torch.profiler``; then its AdamW update timed alone."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    adamw = importlib.import_module("repro_torch.optim.adamw")
    tr.train_step(tr._to_device(warm))  # warm-up
    batch = tr._to_device(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print_device_time(tag, f"one step of {tr.model.cfg.name}", prof, wall_ms)

    grads = [torch.ones_like(p) for p in tr.params]
    update_ms = time_ms(lambda: adamw.update(tr.cfg.optimizer, grads, tr.opt_state,
                                             tr.params, decay=tr.decay),
                        iters=3, warmup=1)
    print(f"[{tag}] AdamW update alone (the Trainer's, {len(grads)} tensors): "
          f"{update_ms:.3f} ms")
    del grads, prof, batch
    gc.collect()
    torch.cuda.empty_cache()


def grads_agree(tag: str, got, want) -> bool:
    """Two lists of grads bitwise equal, or within rtol 1e-3; prints the
    worst relative error."""
    import torch

    bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
    worst = 0.0 if bitwise else max(
        ((a - b).abs() / b.abs().clamp(min=1e-30)).max().item()
        for a, b in zip(got, want) if not torch.equal(a, b))
    ok = bitwise or all(torch.allclose(a, b, rtol=1e-3, atol=0) for a, b in zip(got, want))
    print(f"[{tag}] grads bitwise {bitwise}"
          + ("" if bitwise else f", max rel err {worst:.3e} (limit rtol 1e-3)"))
    return ok


def phase_trade(state):
    """Planned vs unplanned forward+backward on the same weights and batch."""
    import dataclasses
    import gc

    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    configs = importlib.import_module("repro_torch.configs")
    plan = importlib.import_module("repro_torch.launch.plan")
    mesh = importlib.import_module("repro_torch.launch.mesh")
    models = importlib.import_module("repro_torch.models")
    data = importlib.import_module("repro_torch.data")

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(configs.get_config("stablelm-3b"), n_layers=TRADE_UNITS)
    shape = configs.ShapeConfig("trade", 1024, 2, "train")
    hbm = mesh.device_hbm_bytes()
    _, res_all = plan.plan_unit_segments(cfg, shape, 1, model_shards=1, hbm_bytes=hbm)
    budget = 0.5 * res_all.peak_memory
    sp, res = plan.plan_unit_segments(cfg, shape, 1, model_shards=1, budget=budget,
                                      hbm_bytes=hbm)
    recomputed = sum(s for s, r in zip(sp.sizes, sp.remat) if r)
    print(f"[trade] {TRADE_UNITS} units; all-cached DP peak {res_all.peak_memory:.4e} B; "
          f"budget {budget:.4e} B -> sizes {list(sp.sizes)} remat {list(sp.remat)}, "
          f"DP peak {res.peak_memory:.4e} B, overhead {res.overhead:g}")
    check(res.feasible and recomputed > 0, "the half-peak plan has no remat segment")

    dev = torch.device("cuda")
    model = models.build_model(cfg, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    params = [p for p in model.parameters()]
    host = data.SyntheticLM(data.DataConfig(cfg.vocab_size, 1024, 2)).batch(0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}

    def run(sizes, remat):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        loss = model.loss(batch, sizes, remat)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        counts = dict(fa.LAUNCHES)
        return loss.detach().cpu(), [g.cpu() for g in grads], peak, counts

    l0, g0, peak0, c0 = run((TRADE_UNITS,), (False,))
    l1, g1, peak1, c1 = run(sp.sizes, sp.remat)
    print(f"[trade] loss unplanned {l0.item():.8f} planned {l1.item():.8f} "
          f"bitwise {torch.equal(l0, l1)}")
    grads_ok = grads_agree("trade", g1, g0)
    print(f"[trade] peak above resident state: unplanned {peak0} B, planned {peak1} B "
          f"(DP predicted {res.peak_memory:.0f} B planned, "
          f"{res_all.peak_memory:.0f} B all-cached)")
    print(f"[trade] flash_fwd launches unplanned {c0['flash_fwd']} planned "
          f"{c1['flash_fwd']} ({recomputed} recomputed units)")
    check(torch.equal(l0, l1), "planned loss differs from unplanned")
    check(grads_ok, "planned grads differ from unplanned beyond rtol 1e-3")
    check(c1["flash_fwd"] - c0["flash_fwd"] == recomputed,
          "planned run did not recompute the planned units")
    check(peak1 < peak0, "planned run did not lower the measured peak")


def planned_setup(n: int = PLANNED_UNITS):
    """The front door's workload (phases planned, analysis, strategies and
    costs): stablelm-3b at full width, ``n`` units, batch 2 x seq 1024,
    weights from seed 0 on the card; returns the model, the data stream,
    batch 0, the loss, its functional form and its parameters."""
    import dataclasses

    import torch

    configs = importlib.import_module("repro_torch.configs")
    models = importlib.import_module("repro_torch.models")
    data = importlib.import_module("repro_torch.data")
    train = importlib.import_module("repro_torch.train")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get_config("stablelm-3b"), n_layers=n)
    model = models.build_model(cfg, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    stream = data.SyntheticLM(data.DataConfig(cfg.vocab_size, 1024, 2))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in stream.batch(0).items()}

    def loss_fn(m, b):  # no remat of its own: the plan decides
        return m.loss(b, (n,), (False,))

    step_loss, params = train.functional_loss(loss_fn, model)
    return model, stream, batch, loss_fn, step_loss, params


def phase_planned(results, state):
    """``plan_function`` on the full-width loss, against plain autograd."""
    import dataclasses
    import gc

    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    core = importlib.import_module("repro_torch.core")
    lowering = importlib.import_module("repro_torch.core.lowering")
    train = importlib.import_module("repro_torch.train")
    n = PLANNED_UNITS

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    model, stream, batch, loss_fn, step_loss, params = planned_setup()
    t0 = time.perf_counter()
    carrier = lowering.TracedCarrier.trace(step_loss, (params, batch))
    trace_s = time.perf_counter() - t0
    g = carrier.to_graph()
    flash = {nd.idx for nd in g.nodes if nd.kind == "flash_attention"}
    vanilla_peak = core.vanilla_peak(g, liveness=False)
    planner = core.get_default_planner()
    t0 = time.perf_counter()
    half = planner.plan(g, vanilla_peak / 2, "approx_dp")
    half_s = time.perf_counter() - t0
    half_flash = flash & set().union(*(s.recompute for s in half.plan.segments))
    print(f"[planned] {n} units: {g.n} nodes ({len(flash)} flash_attention), traced in "
          f"{trace_s:.2f} s; all-cached peak {vanilla_peak:.6e} B without liveness, "
          f"{core.vanilla_peak(g):.6e} B liveness-tight; node outputs "
          f"{sum(nd.memory for nd in g.nodes):.6e} B in all")
    print(f"[planned] at half the vanilla peak ({vanilla_peak / 2:.6e} B): planned in "
          f"{half_s:.2f} s, peak {half.plan.peak_memory:.6e} B, overhead "
          f"{half.plan.overhead:g}, {half.plan.num_segments} segments, "
          f"{len(half_flash)} flash nodes recomputed")

    t0 = time.perf_counter()
    planned = lowering.plan_function(step_loss, planner=planner)  # the exact minimal budget
    lowered = planned.lowered_for(params, batch)
    plan_s = time.perf_counter() - t0
    plan = lowered.plan
    rec = set().union(*(s.recompute for s in plan.segments))
    rec_flash = flash & rec
    print(f"[planned] at the exact minimal feasible budget {lowered.report.budget:.6e} B: "
          f"traced and planned in {plan_s:.2f} s, backend {lowered.backend}, peak "
          f"{plan.peak_memory:.6e} B, overhead {plan.overhead:g} of {g.total_time:g}, "
          f"{plan.num_segments} segments ({sum(1 for s in plan.segments if s.recompute)} "
          f"recompute), {len(rec)} nodes and {len(rec_flash)} flash nodes recomputed")
    check(bool(rec_flash), "the plan recomputes no flash-attention node")

    def run(fn):
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        loss, grads = fn(params, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - before
        gbytes = sum(t.numel() * t.element_size() for t in grads.values())
        return loss.cpu(), grads, peak, gbytes, dict(fa.LAUNCHES), ms

    planned(params, batch)  # warm-up (cuBLAS handles, workspaces)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    loss = step_loss({k: p.detach().requires_grad_() for k, p in params.items()}, batch)
    torch.cuda.synchronize()
    print(f"[planned] vanilla forward alone: autograd holds "
          f"{torch.cuda.memory_allocated() - before} B after it")
    del loss
    l0, g0, peak0, gb0, c0, ms0 = run(lowering.vanilla_traced_value_and_grad(carrier))
    l1, g1, peak1, gb1, c1, ms1 = run(planned)
    for tag, loss, peak, gb, c, ms in (("vanilla", l0, peak0, gb0, c0, ms0),
                                       ("planned", l1, peak1, gb1, c1, ms1)):
        print(f"[planned] {tag:7s} loss {loss.item():.8f}; peak above resident state "
              f"{peak} B, of which parameter grads {gb} B ({peak - gb} B without them); "
              f"launches {json.dumps(c)}; {ms:.1f} ms")
    print(f"[planned] loss bitwise {torch.equal(l0, l1)}")
    grads_ok = grads_agree("planned", [g1[k] for k in g0], list(g0.values()))
    # phase mesh holds its sharded twin against this one's loss and grads
    state["planned"] = dict(loss=l1, grads=g1, peak=vanilla_peak, nodes=g.n,
                            budget=lowered.report.budget)
    del g0, g1
    check(torch.equal(l0, l1), "planned loss differs from vanilla")
    check(grads_ok, "planned grads differ from vanilla beyond rtol 1e-3")
    check(c1["flash_fwd"] - c0["flash_fwd"] == len(rec_flash),
          "planned flash_fwd launches do not add up to the plan's recomputed flash nodes")
    check(c1["flash_bwd_dq"] == c0["flash_bwd_dq"] == len(flash)
          and c1["flash_bwd_dkv"] == c0["flash_bwd_dkv"] == len(flash),
          "backward kernel launches differ between the planned and vanilla runs")
    check(peak1 < peak0, "the planned run did not lower the measured peak")
    for name in fa.KERNELS:
        results[name]["planned_launches"] = c1[name]

    # Both Trainers start from the same weights and batches, so their steps
    # must agree as the planned and vanilla runs above do.
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    steps = {}
    for tag, budget in (("unplanned", None), ("planned", lowered.report.budget)):
        gc.collect()
        torch.cuda.empty_cache()
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(weights[k])
        tr = train.Trainer(loss_fn, model, train.TrainConfig(
            total_steps=1, log_every=0, plan_budget=budget), device=dev)
        batches = iter(stream)
        first = tr.run(batches)
        misses = planner.cache.stats()["misses"]
        tr.cfg = dataclasses.replace(tr.cfg, total_steps=2)
        second = tr.run(batches)
        new_misses = planner.cache.stats()["misses"] - misses
        losses = first["losses"] + second["losses"]
        norms = first["grad_norms"] + second["grad_norms"]
        seconds = first["step_seconds"] + second["step_seconds"]
        steps[tag] = (losses, norms)
        print(f"[planned] Trainer {tag:9s}: losses {losses}, step seconds "
              f"{[round(t, 4) for t in seconds]}; grad norms {norms}; "
              f"plan-cache misses in step 2: {new_misses}")
        check(tr.skipped == 0 and all(math.isfinite(x) for x in losses),
              f"the {tag} Trainer skipped a step or gave a non-finite loss")
        if budget is not None:
            check(new_misses == 0 and len(tr.planned._memo) == 1,
                  "the planned Trainer re-traced or re-planned in its second step")
        del tr
    del weights
    (la, na), (lb, nb) = steps["unplanned"], steps["planned"]
    worst = max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(la + na, lb + nb))
    print(f"[planned] Trainer planned vs unplanned: step-1 loss bitwise {la[0] == lb[0]}, "
          f"all losses and grad norms bitwise {(la, na) == (lb, nb)}, "
          f"worst relative error {worst:.3e}")
    check(la[0] == lb[0], "the planned Trainer's first loss differs from the unplanned one")
    check(worst <= 1e-3, "the planned Trainer's losses or grad norms differ beyond rtol 1e-3")


def lm_blockgraph(n: int = POLICY_UNITS, base=None, device: str = "cuda", seq: int = 1024):
    """stablelm-3b (or ``base``) at full width and ``n`` units as a
    BlockGraph of the port's modules: the embedding, one block a unit and
    the head with the loss (its output is the scalar loss); weights from
    seed 0 on ``device``, batch 0 of the synthetic stream (2 x ``seq``).
    Returns the BlockGraph, its params by block, its inputs and the loss
    over its output."""
    import dataclasses

    import torch
    from torch.func import functional_call

    configs = importlib.import_module("repro_torch.configs")
    models = importlib.import_module("repro_torch.models")
    layers = importlib.import_module("repro_torch.models.layers")
    data = importlib.import_module("repro_torch.data")
    blockgraph = importlib.import_module("repro_torch.core.blockgraph")
    dev = torch.device(device)
    cfg = dataclasses.replace(base or configs.get_config("stablelm-3b"), n_layers=n)
    model = models.build_model(cfg, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    dt = cfg.activation_dtype

    def embed(p, tokens):
        return layers.embed(p["embed"], tokens, dt)

    def unit_block(i):
        unit = model.layers[i]

        def apply(p, h):
            positions = torch.arange(h.shape[1], device=h.device)[None, :]
            return functional_call(unit, p, (h, positions))

        return blockgraph.Block(f"u{i}", apply, ("embed" if i == 0 else f"u{i - 1}",))

    def head(p, h, labels):
        logits = layers.unembed(p["unembed"], layers.rmsnorm(p["scale"], h))
        return layers.softmax_xent(logits[:, :-1], labels[:, 1:])

    bg = blockgraph.BlockGraph(
        [blockgraph.Block("embed", embed, ("tokens",)),
         *[unit_block(i) for i in range(n)],
         blockgraph.Block("head", head, (f"u{n - 1}", "labels"))],
        ["tokens", "labels"], ["head"])
    params = {"embed": {"embed": model.embedding.embed},
              **{f"u{i}": dict(model.layers[i].named_parameters()) for i in range(n)},
              "head": {"scale": model.final_norm.scale, "unembed": model.head.unembed}}
    stream = data.SyntheticLM(data.DataConfig(cfg.vocab_size, seq, 2))
    inputs = {k: torch.as_tensor(v, device=dev) for k, v in stream.batch(0).items()}
    return bg, params, inputs, (lambda loss: loss)


def phase_policy(results):
    """The ``"policy"`` backend (the BlockGraph default) on stablelm-3b at
    full width, ``POLICY_UNITS`` units as a BlockGraph (``lm_blockgraph``),
    planned at the exact minimal budget: ``"policy"``, ``"segment"`` and
    plain autograd, loss and grads bitwise; each run's peak above resident
    state beside the DP's peak, its ``flash_fwd`` launches against the
    design's count (every segment runs as a region whose backward reruns its
    units' internals, the attention included: one more launch a unit), and
    its time."""
    import gc

    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    lowering = importlib.import_module("repro_torch.core.lowering")
    gc.collect()
    torch.cuda.empty_cache()
    bg, params, inputs, loss_fn = lm_blockgraph()
    n = POLICY_UNITS
    t0 = time.perf_counter()
    pf = lowering.plan_function(bg, None, loss_fn=loss_fn)
    low = pf.lowered_for(params, inputs)
    plan_s = time.perf_counter() - t0
    plan, names = low.plan, [b.name for b in bg.blocks]
    g = low.carrier.to_graph()
    print(f"[policy] stablelm-3b at {n} units as a BlockGraph of {len(bg.blocks)} blocks: "
          f"planned in {plan_s:.2f} s at the exact minimal budget {low.report.budget:.6e} B "
          f"(all cached {sum(g.mem_v):.6e} B); backend {low.backend}; DP peak "
          f"{plan.peak_memory:.6e} B, overhead {plan.overhead:g}; segments "
          f"{[[names[v] for v in sorted(s.nodes)] for s in plan.segments]}; cached (U_k) "
          f"{[names[v] for v in sorted(plan.cached)]}")
    check(low.backend == "policy", "auto did not resolve to the policy backend")
    twins = {"policy": pf,
             "segment": lowering.get_lowering("segment").lower(low.carrier, plan),
             "plain": lowering.vanilla_value_and_grad(bg, loss_fn)}
    # every unit reruns once under both planned backends (module doc of
    # core/lowering/policy.py), none under plain autograd
    predicted = {"policy": 2 * n, "segment": 2 * n, "plain": n}
    runs = {}
    for tag, twin in twins.items():
        twin(params, inputs)  # warm-up
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        requested = torch.cuda.memory_stats()["requested_bytes.all.current"]
        t0 = time.perf_counter()
        loss, grads = twin(params, inputs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - before
        # the bytes the program asked for, before the allocator rounds each
        # block up (its slack depends on the order of the allocations)
        asked = torch.cuda.memory_stats()["requested_bytes.all.peak"] - requested
        runs[tag] = (loss, grads, asked, dict(fa.LAUNCHES), ms)
        print(f"[policy] {tag:7s}: loss {loss.item():.8f}; peak above resident state {peak} B "
              f"allocated, {asked} B requested (DP peak {plan.peak_memory:.6e} B); launches "
              f"{json.dumps(runs[tag][3])} (flash_fwd predicted {predicted[tag]}); {ms:.1f} ms")
    leaves = {tag: torch.utils._pytree.tree_leaves(r[:2]) for tag, r in runs.items()}
    for tag in ("policy", "segment"):
        same = all(torch.equal(a, b) for a, b in zip(leaves[tag], leaves["plain"]))
        print(f"[policy] {tag} loss and grads bitwise plain autograd: {same}")
        check(same, f"the {tag} twin's loss or grads differ from plain autograd")
    for tag, r in runs.items():
        check(r[3]["flash_fwd"] == predicted[tag],
              f"{tag}'s flash_fwd launches differ from the design's count")
        check(r[3]["flash_bwd_dq"] == r[3]["flash_bwd_dkv"] == n,
              f"{tag}'s backward kernels did not run once a unit")
    check(runs["policy"][2] <= runs["segment"][2],
          "the policy twin's requested peak is above the segment twin's")
    results["flash_fwd"]["policy_launches"] = runs["policy"][3]["flash_fwd"]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        results[name]["policy_launches"] = runs["policy"][3][name]
    del runs, leaves, twins, pf, low, params, inputs, bg
    gc.collect()
    torch.cuda.empty_cache()


def torchrun(nproc: int, args: list, timeout: float = 600, module: str = "repro_torch.launch.train"
             ) -> dict:
    """``torchrun --standalone --nproc_per_node nproc -m module args`` in a
    child process group (``module=None`` runs this script); returns rank
    0's ``summary:`` JSON, with the ``process group:`` line that
    ``launch.mesh.init_distributed`` prints under ``"process_group"``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    target = [str(ROOT / "chip_smoke.py")] if module is None else ["-m", module]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), *target, *args]
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("summary: ")]
    if proc.returncode != 0 or not lines:
        # the error lines, not the warnings (``W1017 12:00:00...``)
        errs = [ln for ln in proc.stderr.splitlines()
                if not ln.split("]:", 1)[-1].startswith("W") and "Warning" not in ln]
        # the first failing rank's own lines, then the launcher's summary
        ranked = [ln for ln in errs if ln.startswith("[rank")]
        raise PhaseError(f"torchrun {' '.join(args)} exited {proc.returncode}:\n"
                         f"{proc.stdout[-3000:]}\n" + "\n".join(ranked[:60] + errs[-30:]))
    out = json.loads(lines[-1][len("summary: "):])
    group = [ln for ln in proc.stdout.splitlines() if ln.startswith("process group: ")]
    out["process_group"] = group[0][len("process group: "):] if group else None
    return out


def phase_mesh(results, state):
    """Sharded planning and the data-parallel Trainer on the card: the
    per-device accounting of the full-width trace on an ``{axis: size}``
    mesh; on a one-rank NCCL group the sharded planned twin (DTensors)
    against sharded vanilla and phase planned's unsharded twin, the
    compressed and re-meshed Trainer; the launcher under ``torchrun`` (one
    rank) against phase launcher; two gloo processes sharing the card."""
    import dataclasses
    import gc
    import tempfile

    import torch
    import torch.distributed as dist
    from torch import nn
    from torch.distributed.device_mesh import init_device_mesh

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    core = importlib.import_module("repro_torch.core")
    fxg = importlib.import_module("repro_torch.core.fx_graph")
    lowering = importlib.import_module("repro_torch.core.lowering")
    data = importlib.import_module("repro_torch.data")
    train = importlib.import_module("repro_torch.train")
    planned_state = state.pop("planned")
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    model, stream, batch, loss_fn, step_loss, params = planned_setup()
    specs = (None, ("data", None))

    # accounting: the global batch over MESH_ACCOUNTING, nothing executed
    big = data.SyntheticLM(data.DataConfig(model.cfg.vocab_size, 1024, MESH_GLOBAL_BATCH))
    big_batch = {k: torch.as_tensor(v, device=dev) for k, v in big.batch(0).items()}
    t0 = time.perf_counter()
    carrier = lowering.TracedCarrier.trace(step_loss, (params, big_batch), mesh=MESH_ACCOUNTING,
                                           in_shardings=specs)
    trace_s = time.perf_counter() - t0
    g = carrier.to_graph()
    whole = fxg.from_graph_module(carrier.fx.gm).graph
    four = fxg.from_graph_module(carrier.fx.gm, mesh={"data": 4},
                                 in_specs=list(carrier.in_specs)).graph
    peak, peak_whole = core.vanilla_peak(g, liveness=False), core.vanilla_peak(whole, liveness=False)
    planner = core.get_default_planner()
    t0 = time.perf_counter()
    mfb = planner.min_feasible_budget(g)
    rep = planner.plan(g, mfb)
    plan_s = time.perf_counter() - t0
    plan = rep.plan
    digests = {core.graph_digest(x) for x in (g, four, whole)}
    print(f"[mesh] accounting: batch {MESH_GLOBAL_BATCH} x 1024 over {MESH_ACCOUNTING}, "
          f"{PLANNED_UNITS} units: {g.n} nodes, traced in {trace_s:.2f} s; per-device "
          f"all-cached peak {peak:.6e} B against phase planned's unsharded batch-2 "
          f"{planned_state['peak']:.6e} B ({planned_state['nodes']} nodes) and the "
          f"global batch's {peak_whole:.6e} B")
    print(f"[mesh] minimal per-device budget {mfb:.6e} B (phase planned's unsharded: "
          f"{planned_state['budget']:.6e} B), planned in {plan_s:.2f} s: peak "
          f"{plan.peak_memory:.6e} B, overhead {plan.overhead:g}, {plan.num_segments} "
          f"segments, {len(set().union(*(s.recompute for s in plan.segments)))} nodes "
          f"recomputed; digests of {MESH_ACCOUNTING}, {{data: 4}} and unsharded all "
          f"distinct: {len(digests) == 3}")
    check(len(digests) == 3, "the sharded traces' digests do not differ")
    # the batch over the data axis leaves each device phase planned's batch
    check(peak == planned_state["peak"] and mfb == planned_state["budget"],
          "the per-device peak or minimal budget is not that of the per-device batch")
    del carrier, g, whole, four, big_batch
    gc.collect()

    def run(fn, *args):
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        loss, grads = fn(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return loss, grads, torch.cuda.max_memory_allocated() - before, dict(fa.LAUNCHES), ms

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    store = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        t0 = time.perf_counter()
        twin = lowering.plan_function(step_loss, None, mesh=mesh, in_shardings=specs,
                                      planner=planner)
        low = twin.lowered_for(params, batch)
        sh_s = time.perf_counter() - t0
        flash = {nd.idx for nd in low.carrier.to_graph().nodes if nd.kind == "flash_attention"}
        rec_flash = flash & set().union(*(s.recompute for s in low.plan.segments))
        twin(params, batch)  # warm-up
        l0, g0, peak0, c0, ms0 = run(lowering.vanilla_traced_value_and_grad(low.carrier),
                                     params, batch)
        l1, g1, peak1, c1, ms1 = run(twin, params, batch)
        for tag, loss, pk, c, ms in (("vanilla", l0, peak0, c0, ms0),
                                     ("planned", l1, peak1, c1, ms1)):
            print(f"[mesh] one NCCL rank, sharded {tag:7s}: loss {local(loss).item():.8f} "
                  f"({type(loss).__name__} {list(getattr(loss, 'placements', []))}); peak "
                  f"above resident state {pk} B; launches {json.dumps(c)}; {ms:.1f} ms")
        bit_vanilla = torch.equal(local(l0), local(l1)) and all(
            torch.equal(local(g1[k]), local(g0[k])) for k in g0)
        bit_unsharded = torch.equal(local(l1).cpu(), planned_state["loss"]) and all(
            torch.equal(local(g1[k]), planned_state["grads"][k]) for k in g1)
        print(f"[mesh] sharded planned twin (traced and planned in {sh_s:.2f} s, "
              f"{len(rec_flash)} flash nodes recomputed, the same plan as phase planned's: "
              f"{low.report.budget == planned_state['budget']}): bitwise sharded vanilla "
              f"{bit_vanilla}, bitwise phase planned's unsharded twin {bit_unsharded}")
        check(bit_vanilla, "the sharded planned twin differs from sharded vanilla")
        check(bit_unsharded, "the sharded planned twin differs from the unsharded one")
        check(c1["flash_fwd"] - c0["flash_fwd"] == len(rec_flash) and c1["flash_bwd_dq"]
              == len(flash) and c1["flash_bwd_dkv"] == len(flash),
              "the sharded twin's launches do not match its plan")
        for name in fa.KERNELS:
            results[name]["mesh_launches"] = c1[name]
        del g0, g1, l0, l1, low, twin, planned_state

        # the Trainer on the mesh: plain, compressed, and re-meshed
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        weights = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}

        def trainer(mesh=None, steps=3, **kw):
            gc.collect()
            torch.cuda.empty_cache()
            for n in names:  # plain parameters again, from the same weights
                mod, _, leaf = n.rpartition(".")
                model.get_submodule(mod)._parameters[leaf] = nn.Parameter(weights[n].clone())
            torch.cuda.reset_peak_memory_stats()
            return train.Trainer(loss_fn, model, train.TrainConfig(
                total_steps=steps, log_every=0, **kw), device=dev, mesh=mesh)

        runs = {}
        for tag, kw in (("plain", {}), ("compressed", dict(compress_grads=True))):
            tr = trainer(mesh, **kw)
            out = tr.run(iter(stream))
            runs[tag] = out
            print(f"[mesh] Trainer on the mesh, {tag:10s}: losses {out['losses']}, step "
                  f"seconds {[round(t, 4) for t in out['step_seconds']]}, peak "
                  f"{torch.cuda.max_memory_allocated()} B, collectives {tr.comm_stats}")
            check(tr.skipped == 0 and all(math.isfinite(x) for x in out["losses"]),
                  f"the {tag} Trainer on the mesh skipped a step")
            del tr
        worst = max(abs(a - b) / abs(b) for a, b in zip(runs["compressed"]["losses"],
                                                        runs["plain"]["losses"]))
        print(f"[mesh] compressed against plain losses: worst relative gap {worst:.3e}")
        # the codec's int8 rounding moves the later losses, a little
        check(0 < worst < 1e-3, "compressed gradients left the losses unchanged or moved "
              "them by 1e-3 or more")
        tr = trainer(None, steps=1)
        first = tr.run(iter(stream))
        tr.remesh(mesh)
        tr.cfg = dataclasses.replace(tr.cfg, total_steps=2)
        second = tr.run(iter([stream.batch(1)]))
        moved = first["losses"] + second["losses"], first["grad_norms"] + second["grad_norms"]
        built = runs["plain"]["losses"][:2], runs["plain"]["grad_norms"][:2]
        print(f"[mesh] remesh from no mesh onto the rank's mesh after step 1: losses "
              f"{moved[0]}, against a Trainer built on the mesh {built[0]}; bitwise "
              f"{moved == built}")
        check(moved == built, "the step after remesh differs from a Trainer built on the mesh")
        del tr
    finally:
        dist.destroy_process_group()
    del model, params, batch, stream, weights
    gc.collect()
    torch.cuda.empty_cache()

    # the launcher under torchrun on one rank, against phase launcher
    t0 = time.perf_counter()
    one = torchrun(1, TRAIN_ARGS)
    want = state["launcher"]["losses"]
    print(f"[mesh] torchrun --nproc_per_node 1 launcher ({time.perf_counter() - t0:.1f} s): "
          f"losses {one['losses']} against phase launcher's {want}; bitwise "
          f"{one['losses'] == want}; step seconds {[round(t, 4) for t in one['step_seconds']]}; "
          f"peak {one['peak_bytes']} B; collectives a step {one['collectives']}; launches "
          f"{json.dumps(one['launches'])}")
    print(f"[mesh] torchrun --nproc_per_node 1: process group {one['process_group']!r}")
    check(one["losses"] == want, "the one-rank torchrun launcher's losses differ")
    check((one["process_group"] or "").startswith("nccl"),
          "the one-rank launcher did not take NCCL")
    for name in fa.KERNELS:
        results[name]["torchrun_launches"] = one["launches"][name]

    # two gloo processes sharing the card, against one process on the global
    # batch (the two ranks' slices, concatenated), from the same init
    args = TRAIN_ARGS + ["--layers", str(MESH_TWO_PROCESS_LAYERS)]
    t0 = time.perf_counter()
    two = torchrun(2, args)  # two ranks, one card: the launcher takes gloo
    two_s = time.perf_counter() - t0
    configs = importlib.import_module("repro_torch.configs")
    models = importlib.import_module("repro_torch.models")
    adamw = importlib.import_module("repro_torch.optim.adamw")
    cfg = dataclasses.replace(configs.get_config("stablelm-3b"), n_layers=MESH_TWO_PROCESS_LAYERS)
    model = models.build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    steps = len(two["losses"])
    tr = train.Trainer(lambda m, b: m.loss(b), model, train.TrainConfig(
        total_steps=steps, log_every=0, optimizer=adamw.AdamWConfig(
            lr=3e-4, warmup_steps=2, total_steps=steps)), device=dev)
    dc = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=1024, global_batch=2, num_hosts=2)
    single = tr.run(data.global_batch_for_test(dc, i) for i in range(steps))
    worst = max(abs(a - b) / abs(b) for a, b in zip(two["losses"], single["losses"]))
    # one all-reduce of every f32 gradient and one of the loss, a step
    grad_bytes = sum(p.numel() * p.element_size() for p in model.parameters()
                     if p.requires_grad)
    sent = two["collectives"].get("all_reduce", {}).get("payload_bytes")
    print(f"[mesh] two gloo processes on the card, {MESH_TWO_PROCESS_LAYERS} units "
          f"({two_s:.1f} s): losses {two['losses']} against one process on the global batch "
          f"{single['losses']} (worst relative gap {worst:.3e}); step seconds "
          f"{[round(t, 4) for t in two['step_seconds']]}; collectives a step "
          f"{two['collectives']} against the gradients' {grad_bytes} B and the loss's 4 B")
    print(f"[mesh] two processes: process group {two['process_group']!r}")
    check((two["process_group"] or "").startswith("gloo"),
          "the two processes sharing the card did not take gloo")
    check(sent == grad_bytes + 4, "the two processes did not all-reduce every gradient once")
    check(worst < 1e-4, "the two-process losses differ from the global batch's beyond 1e-4")
    del tr, model


def model_axis_setup(units: int = MODEL_AXIS_UNITS):
    """stablelm-3b at full width and ``units`` deep, weights from seed 0 on
    the card (every process draws the same), and its loss."""
    import dataclasses

    import torch

    configs = importlib.import_module("repro_torch.configs")
    models = importlib.import_module("repro_torch.models")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get_config("stablelm-3b"), n_layers=units)
    model = models.build_model(cfg, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))

    def loss_fn(m, b):  # no remat of its own: the planned Trainer's plan decides
        return m.loss(b, (units,), (False,))

    return cfg, model, loss_fn


def route_gloo_cuda_collectives(key: str = "CUDA") -> None:
    """Gloo in this torch gathers, scatters and exchanges no CUDA tensor
    (all-gather crashes the process): route DTensor's functional
    all-gather, reduce-scatter and all-to-all on ``key`` tensors through
    gloo's all-reduce, which it does run.  The collective counter still
    sees the op DTensor asked for, with its payload; the wire carries a
    whole-size buffer instead.  For phase model_axis's processes only."""
    import torch
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    lib = torch.library.Library("_c10d_functional", "IMPL")

    def reduce(buf, op, pg):
        op = op.lower()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM if op in ("sum", "avg") else
                        getattr(dist.ReduceOp, op.upper()), group=pg)
        if op == "avg":
            buf.div_(pg.size())
        return buf

    def all_gather_into_tensor(x, group_size, group_name):
        pg = _resolve_process_group(group_name)
        out = x.new_zeros((group_size * x.shape[0], *x.shape[1:]))
        n = x.shape[0]
        r = dist.get_rank(pg)
        out[r * n:(r + 1) * n] = x
        return reduce(out, "sum", pg)

    def reduce_scatter_tensor(x, op, group_size, group_name):
        pg = _resolve_process_group(group_name)
        full = reduce(x.clone(), op, pg)
        return full.chunk(group_size)[dist.get_rank(pg)].contiguous()

    def all_to_all_single(x, output_split_sizes, input_split_sizes, group_name):
        pg = _resolve_process_group(group_name)
        w, r = pg.size(), dist.get_rank(pg)
        n = x.shape[0]
        full = x.new_zeros((w * n, *x.shape[1:]))
        full[r * n:(r + 1) * n] = x
        full = reduce(full, "sum", pg)
        ins = input_split_sizes or [n // w] * w
        starts = [sum(ins[:i]) for i in range(w)]
        return torch.cat([full[s * n + starts[r]: s * n + starts[r] + ins[r]] for s in range(w)])

    for name, fn in (("all_gather_into_tensor", all_gather_into_tensor),
                     ("reduce_scatter_tensor", reduce_scatter_tensor),
                     ("all_to_all_single", all_to_all_single)):
        lib.impl(name, fn, key)
    route_gloo_cuda_collectives.lib = lib  # the registrations live with it


def _counted(batches, watched):
    """``batches``, setting ``watched.step`` to each batch's index first."""
    for i, b in enumerate(batches):
        watched.step = i
        yield b


def mesh_strategies(step_loss, params, batch, mesh) -> dict:
    """Phase model_axis, each rank: ``plan_function(strategies=)`` on the
    tensor-parallel loss at the minimal per-device budget, memory-centric
    (phase strategies' setting): an offload-only plan bitwise the mesh's
    vanilla, with the pinned host bytes this rank copied against the plan's
    offloaded local bytes (its ``M_v``); a quantize-only plan, and a plan
    that may do both, within ``QUANT_BOUND`` of vanilla (bitwise where
    it quantizes nothing)."""
    import torch

    lowering = importlib.import_module("repro_torch.core.lowering")
    storage = importlib.import_module("repro_torch.core.lowering.storage")
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    out = {}
    host, host_bytes = [], storage.host_bytes

    def counted(t, memo=None):
        h = host_bytes(t, memo)
        if not any(h is x for x in host):
            host.append(h)
        return h

    vanilla = None
    for tag, strategies in (("offload", ("store", "recompute", "offload")),
                            ("quantize", ("store", "recompute", "quantize")),
                            ("offload_quantize", ("store", "recompute", "offload", "quantize"))):
        t0 = time.perf_counter()
        pf = lowering.plan_function(step_loss, None, mesh=mesh, in_shardings=(None, None),
                                    strategies=strategies, method="approx_dp",
                                    objective="memory_centric")
        low = pf.lowered_for(params, batch)
        plan_s = time.perf_counter() - t0
        if vanilla is None:
            vanilla = lowering.vanilla_traced_value_and_grad(low.carrier)(params, batch)
        g = low.carrier.to_graph()
        codes = collections.Counter(low.plan.strategy.values())
        storage.host_bytes = counted
        try:
            host.clear()
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            t1 = time.perf_counter()
            got = pf(params, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            launches = dict(fa.LAUNCHES)
        finally:
            storage.host_bytes = host_bytes
        pinned = sum(h.numel() for h in host if h.is_pinned())
        host.clear()
        same = all(torch.equal(a.to_local(), b.to_local()) for a, b in zip(
            torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(vanilla)))
        lerr = abs(got[0].full_tensor().item() - vanilla[0].full_tensor().item()) / abs(
            vanilla[0].full_tensor().item())
        gerr = max(float((a.full_tensor().float() - b.full_tensor().float()).norm()
                         / b.full_tensor().float().norm().clamp_min(1e-30))
                   for a, b in zip(got[1].values(), vanilla[1].values()))
        out[tag] = {
            "plan_s": plan_s, "codes": dict(codes), "ms": ms, "pinned_bytes": pinned,
            "launches": launches,
            "offloaded_bytes": sum(g.nodes[v].memory for v, c in low.plan.strategy.items()
                                   if c == "offload"),
            "quantized_bytes": sum(g.nodes[v].memory for v, c in low.plan.strategy.items()
                                   if c == "quantize"),
            "dp_peak": low.plan.peak_memory, "bitwise": same, "loss_rel": lerr,
            "grads_rel_l2": gerr, "nodes": g.n}
        del pf, low, got
    return out


def mesh_dropout(mesh) -> dict:
    """Phase model_axis, each rank: a dropout MLP at stablelm-3b's width
    (``MESH_DROPOUT_DEPTH`` layers of 2560 x 2560 on 2 x 1024 tokens, the
    batch over data) whose default plan recomputes its ``bernoulli`` nodes,
    against plain autograd through the traced nodes (each drawn once) on
    the same generator state; and which RNG path DTensor took."""
    import torch
    from torch.distributed.tensor import _random

    lowering = importlib.import_module("repro_torch.core.lowering")
    fx_graph = importlib.import_module("repro_torch.core.fx_graph")
    prims = importlib.import_module("repro_torch.core.prims")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    ws = [torch.randn(2560, 2560, device=dev, generator=gen) * 2560 ** -0.5
          for _ in range(MESH_DROPOUT_DEPTH)]
    x = torch.randn(2, 1024, 2560, device=dev, generator=gen)

    def dropout_mlp(ws, x):
        h = x
        for w in ws:
            h = torch.nn.functional.dropout(torch.tanh(h @ w), 0.5, training=True)
        return torch.sum(h * h)

    pf = lowering.plan_function(dropout_mlp, None, mesh=mesh,
                                in_shardings=(None, ("data", None, None)))
    low = pf.lowered_for(ws, x)
    fxg = low.carrier.fx
    redrawn = [fxg.nodes[v].name for s in low.plan.segments for v in s.recompute
               if fx_graph.op_name(fxg.nodes[v].target) in prims.ATEN_PRNG]
    torch.manual_seed(7)
    got = pf(ws, x)
    torch.manual_seed(7)
    want = lowering.vanilla_traced_value_and_grad(low.carrier, low.plan)(ws, x)
    same = all(torch.equal(a.to_local(), b.to_local()) for a, b in zip(
        torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)))
    tracker = _random._rng_tracker
    return {"redrawn": redrawn, "bitwise": same, "loss": got[0].full_tensor().item(),
            "tracker": type(tracker).__name__ if tracker is not None else None,
            "tracker_keeps_states": hasattr(tracker, "rng_states")}


def psum_inputs(dev) -> list:
    """The four ranks' inputs of phase model_axis's ``hierarchical_psum``."""
    import torch

    return [torch.randn(PSUM_SHAPE, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(100 + r))
            for r in range(4)]


def psum_reference(xs) -> "torch.Tensor":
    """The reference's ``hierarchical_psum`` arithmetic on ``{pod: 2, data:
    2}``, in one process (rank = pod * 2 + data): each pod's data sum cut
    into its data chunks, each chunk's int8 payloads summed over the pods
    and scaled by the pods' mean scale, the chunks put back together."""
    import torch

    comp = importlib.import_module("repro_torch.optim.compression")
    chunks = []
    for d in range(2):
        cs = []
        for p in range(2):
            s = xs[2 * p].chunk(2)[d] + xs[2 * p + 1].chunk(2)[d]
            cs.append(comp.compress(s))
        qsum = cs[0].q.to(torch.int32) + cs[1].q.to(torch.int32)
        ssum = cs[0].scale + cs[1].scale
        n = xs[0].chunk(2)[d].numel()
        chunks.append((qsum.float() * (ssum / 2)[:, None]).reshape(-1)[:n].reshape(
            xs[0].chunk(2)[d].shape))
    return torch.cat(chunks)


def mesh_psum(rank: int) -> dict:
    """Phase model_axis, each rank: ``hierarchical_psum`` on ``{pod: 2, data:
    2}`` over the same four processes; its output's digest and its
    collectives by axis."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    comp = importlib.import_module("repro_torch.optim.compression")
    census = importlib.import_module("repro_torch.analysis.census")
    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("pod", "data"))
    x = psum_inputs(torch.device("cuda"))[rank]
    with census.CountCollectives() as counted:
        y = comp.hierarchical_psum(x, mesh)
        torch.cuda.synchronize()
    ref = psum_reference(psum_inputs(torch.device("cuda")))
    return {"bitwise": torch.equal(y, ref), "max_abs_exact": float(
        (y - sum(psum_inputs(torch.device("cuda")))).abs().max()),
            "comm": {axis: {op: [rec["calls"], rec["payload_bytes"]] for op, rec in ops.items()}
                     for axis, ops in counted.by_axis(mesh).items()}}


def model_axis_worker(out_dir: Path) -> int:
    """One of phase model_axis's processes (under ``torch.distributed.run``):
    the mesh over the gloo group, three Trainers on this rank's slice of the
    global batch, and a ``summary:`` JSON line (rank 0) plus
    ``out_dir/rank<r>.json`` (every rank)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    data = importlib.import_module("repro_torch.data")
    specs = importlib.import_module("repro_torch.launch.specs")
    sh = importlib.import_module("repro_torch.parallel.sharding")
    lowering = importlib.import_module("repro_torch.core.lowering")
    train = importlib.import_module("repro_torch.train")
    train_loop = importlib.import_module("repro_torch.train.loop")
    import faulthandler

    faulthandler.enable()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo")  # ranks sharing one card: NCCL cannot
    route_gloo_cuda_collectives()
    rank = dist.get_rank()
    if rank == 0:
        print(f"process group: gloo, {dist.get_world_size()} ranks sharing 1 card", flush=True)
    sizes = MODEL_AXIS_MESH
    mesh = init_device_mesh("cuda", tuple(sizes.values()), mesh_dim_names=tuple(sizes))
    data_rank = rank // sizes["model"]
    heads = []  # the q heads each kernel call of this rank receives
    fwd = fa.flash_attention_fwd

    def counted_fwd(q, *a, **kw):
        heads.append(int(q.shape[1]))
        return fwd(q, *a, **kw)

    fa.flash_attention_fwd = counted_fwd
    stream = data.SyntheticLM(data.DataConfig(50304, 1024, MODEL_AXIS_BATCH,
                                              num_hosts=sizes["data"], host_id=data_rank))
    out = {"rank": rank}

    def trainer(fsdp=False, **kw):
        """``specs``' layout (at 2 units the reference's ``needs_fsdp``
        asks for tensor parallelism alone) and its per-device parameter +
        AdamW bytes, or FSDP over data forced and that layout's bytes."""
        torch.cuda.empty_cache()
        cfg, model, loss_fn = model_axis_setup()
        named = dict(model.named_parameters())
        if fsdp:
            shardings = sh.named_sharding_tree(named, mesh, fsdp=True)
            spec = sh.spec_tree(named, sizes, fsdp=True)
            want = 3 * sum(sh.local_bytes(tuple(p.shape), spec[n], sizes, 4)
                           for n, p in named.items())
        else:
            shardings = specs.param_shardings(cfg, mesh, named)
            want = specs.state_bytes_per_device(cfg, sizes)
        tr = train.Trainer(loss_fn, model, train.TrainConfig(
            total_steps=MODEL_AXIS_STEPS, log_every=0, **kw), device="cuda", mesh=mesh,
            in_shardings=(shardings, None))
        return want, tr

    codec = train_loop.roundtrip_leaf_with_feedback
    codec_checks = []

    def watched_codec(g, e):
        """The Trainer's codec; at step 1 held against the global codec of
        the gathered gradient and error feedback."""
        got = codec(g, e)
        if watched_codec.step == 0:
            want = codec(g.full_tensor(), e.full_tensor())
            codec_checks.append(all(
                torch.equal(a.to_local(), sh.place(b, mesh, sh.normalize_spec(a)).to_local())
                for a, b in zip(got, want)))
        return got

    for tag, fsdp, planned in (("plain", False, False), ("planned", False, True),
                               ("fsdp", True, False), ("fsdp_compressed", True, False)):
        kw = {}
        if planned:  # the minimal per-device budget of the sharded trace
            step_loss, params = train.functional_loss(out_tr.loss_fn, out_tr.model)
            b0 = {k: torch.as_tensor(v, device="cuda") for k, v in stream.batch(0).items()}
            b0 = out_tr._place_batch(b0)
            probe = lowering.plan_function(step_loss, None, mesh=mesh, in_shardings=(None, None))
            kw["plan_budget"] = probe.lowered_for(params, b0).plan.peak_memory
            out["planned_budget"] = kw["plan_budget"]
            del probe
            out["strategies"] = mesh_strategies(step_loss, params, b0, mesh)
            del out_tr, params, b0
        if tag == "fsdp_compressed":
            kw["compress_grads"] = True
        want_state, tr = trainer(fsdp, **kw)
        train_loop.roundtrip_leaf_with_feedback = watched_codec
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        heads.clear()
        try:
            res = tr.run(_counted((stream.batch(i) for i in range(MODEL_AXIS_STEPS)),
                                  watched_codec))
        finally:
            train_loop.roundtrip_leaf_with_feedback = codec
        torch.cuda.synchronize()
        out[tag] = {
            "losses": res["losses"], "grad_norms": res["grad_norms"],
            "step_seconds": res["step_seconds"], "launches": dict(fa.LAUNCHES),
            "q_heads": sorted(set(heads)), "comm": tr.comm_by_axis,
            "peak_bytes": torch.cuda.max_memory_allocated(), "resident_bytes": resident,
            "state_bytes": 3 * sum(p.to_local().numel() * p.to_local().element_size()
                                   for p in tr.params),
            "layout_state_bytes": want_state,
            "model_sharded_leaves": sum(
                1 for p in tr.params if not p.placements[list(sizes).index("model")].is_replicate()),
            "local_param_bytes": [p.to_local().numel() * 4 for p in tr.params],
        }
        if tag == "plain":
            out_tr = tr
        else:
            del tr
    out["fsdp_compressed"]["step1_codec_bitwise"] = bool(codec_checks) and all(codec_checks)
    out["fsdp_compressed"]["codec_leaves"] = len(codec_checks)
    out["dropout"] = mesh_dropout(mesh)
    out["psum"] = mesh_psum(rank)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(out))
    if rank == 0:
        print("summary: " + json.dumps({"ranks": dist.get_world_size()}), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def expected_collectives(cfg, local_param_bytes, model_sharded_leaves: int) -> dict:
    """The plain tensor-parallel Trainer's first-step collectives by mesh
    axis and kind (payload bytes per rank), worked out from the shapes: L
    units, B_l sequences of S tokens a rank, d_model D, vocab V, m-way
    model axis, A = B_l·S·D activations of a rank.

    * data, all-reduce: every gradient's model shard in f32 (each rank's
      local parameter bytes; the embedding's too, each rank looking up its
      vocab slice); the loss's f32.
    * model, all-reduce: (4L+2)·A bf16, partial sums made whole: each
      unit's attention output and MLP output (reduced where the reference
      constrains them, and the cotangents of the residual gathered before
      each matmul) and the vocab shards' embedding rows; 3·B_l·(S−1) f32,
      the vocab-sharded loss's max, sum of exponentials and gold logit;
      (2L−1)·D f32, norm scales' gradients; one f32 per model-sharded
      leaf, the clip's norm.
    * model, all-gather: 4L·A/m bf16, the residual's sequence shards
      gathered before the attention's and the MLP's matmuls and for their
      weights' gradients.
    * model, all-to-all (an MoE config; phase axis_serve's granite checks
      this entry alone): each MoE layer exchanges its (E, C_loc, D) bf16
      buffer twice in the forward and twice in the backward, T_loc =
      B_l·S/m tokens a rank (batch over data, sequence over model), C_loc =
      max(8, ceil(cf·T_loc·K/E)); granite at 2 units: (40, 128, 1536),
      15,728,640 B a buffer, 125,829,120 B a step.

    The counts per unit are those the same code sent on four gloo CPU
    ranks at L 1-3, D 128-256, S 32-128 and B_l 1-2, where this formula
    held exactly."""
    L, D = cfg.n_layers, cfg.d_model
    m, S = MODEL_AXIS_MESH["model"], 1024
    Bl = MODEL_AXIS_BATCH // MODEL_AXIS_MESH["data"]
    A = Bl * S * D
    out = {
        "data": {"all_reduce": sum(local_param_bytes) + 4},
        "model": {
            "all_reduce": (4 * L + 2) * A * 2 + 3 * Bl * (S - 1) * 4 + (2 * L - 1) * D * 4
            + model_sharded_leaves * 4,
            "all_gather_into_tensor": 4 * L * (A // m) * 2,
        },
    }
    if cfg.moe is not None:
        moe = cfg.moe
        t_loc = Bl * S // m
        c_loc = max(8, math.ceil(moe.capacity_factor * t_loc * moe.top_k / moe.num_experts))
        out["model"]["all_to_all_single"] = 4 * L * moe.num_experts * c_loc * D * 2
    return out


def phase_model_axis(results):
    """Tensor parallelism and FSDP of the dense LM on the card: four gloo
    processes sharing it on ``{data: 2, model: 2}`` (``torch.distributed.run``
    of this script's worker), stablelm-3b at full width, each rank on its
    quarter; three Trainers (plain, planned at the minimal per-device
    budget, FSDP over data) against one process's meshless Trainer on the
    global batch (losses, gradient norms); the flash kernels on each rank's
    16 heads; collectives by axis against the shapes' count; per-process
    state bytes against ``specs`` (FSDP: its forced layout's); then the
    per-device f32 state of the configs one card cannot hold, on the meta
    device."""
    import tempfile

    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    data = importlib.import_module("repro_torch.data")
    train = importlib.import_module("repro_torch.train")
    specs = importlib.import_module("repro_torch.launch.specs")
    configs = importlib.import_module("repro_torch.configs")
    world = math.prod(MODEL_AXIS_MESH.values())
    out_dir = Path(tempfile.mkdtemp())
    t0 = time.perf_counter()
    run = torchrun(world, ["--model-axis-worker", str(out_dir)], module=None, timeout=600)
    spawn_s = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]
    print(f"[model_axis] {world} processes ({run['process_group']!r}) in {spawn_s:.1f} s")
    check((run["process_group"] or "").startswith("gloo"), "the processes did not take gloo")

    # one process, no mesh, the global batch, the same weights
    cfg, model, loss_fn = model_axis_setup()
    dc = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=1024,
                         global_batch=MODEL_AXIS_BATCH, num_hosts=MODEL_AXIS_MESH["data"])
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    singles = {}
    for compress in (False, True):
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(weights[k])
        tr = train.Trainer(loss_fn, model, train.TrainConfig(
            total_steps=MODEL_AXIS_STEPS, log_every=0, compress_grads=compress), device="cuda")
        singles[compress] = tr.run(data.global_batch_for_test(dc, i)
                                   for i in range(MODEL_AXIS_STEPS))
        del tr
        print(f"[model_axis] meshless Trainer on the global batch"
              f"{', compress_grads' if compress else ''}: losses {singles[compress]['losses']}, "
              f"grad norms {singles[compress]['grad_norms']}")
    del model, weights
    torch.cuda.empty_cache()
    heads = cfg.n_heads // MODEL_AXIS_MESH["model"]
    for r in ranks:
        for tag in ("plain", "planned", "fsdp", "fsdp_compressed"):
            x = r[tag]
            single = singles[tag == "fsdp_compressed"]
            worst = max(abs(a - b) / abs(b) for a, b in zip(x["losses"], single["losses"]))
            print(f"[model_axis] rank {r['rank']} {tag:7s}: losses {x['losses']} (worst "
                  f"relative gap {worst:.3e}); step seconds "
                  f"{[round(t, 4) for t in x['step_seconds']]}; launches "
                  f"{json.dumps(x['launches'])}; q heads {x['q_heads']}; peak "
                  f"{x['peak_bytes']} B; resident {x['resident_bytes']} B; parameters + "
                  f"AdamW {x['state_bytes']} B against its layout's {x['layout_state_bytes']} B "
                  f"({'FSDP forced' if tag.startswith('fsdp') else 'specs.state_bytes_per_device'})")
            check(worst < 1e-4, f"rank {r['rank']}'s {tag} losses differ from the meshless "
                  "Trainer's beyond 1e-4")
            gworst = max(abs(a - b) / abs(b)
                         for a, b in zip(x["grad_norms"], single["grad_norms"]))
            print(f"[model_axis] rank {r['rank']} {tag:7s}: grad norms {x['grad_norms']} "
                  f"(worst relative gap {gworst:.3e})")
            # 2 × the gap read on the H100 (9.875e-5: bf16 partial sums
            # rounded on each rank before the model axis adds them; in f32
            # on the CPU the norms agree to 1e-6): a gradient scaled or
            # reduced wrongly moves the norm by far more
            check(gworst < 2e-4, f"rank {r['rank']}'s {tag} gradient norms differ from the "
                  "meshless Trainer's beyond 2e-4")
            check(x["q_heads"] == [heads], f"rank {r['rank']}'s kernels did not get "
                  f"{heads} heads")
            check(all(x["launches"][k] > 0 for k in fa.KERNELS),
                  f"rank {r['rank']}'s {tag} Trainer launched a kernel no time")
            check(x["state_bytes"] == x["layout_state_bytes"],
                  f"rank {r['rank']}'s {tag} state bytes are not its layout's per-device figure")
        check(r["planned"]["losses"] == r["plain"]["losses"]
              and r["planned"]["grad_norms"] == r["plain"]["grad_norms"],
              "the planned Trainer is not bitwise the plain one")
        comp_ = r["fsdp_compressed"]
        print(f"[model_axis] rank {r['rank']} fsdp_compressed: step 1 codec bitwise the "
              f"global codec of the gathered gradient on {comp_['codec_leaves']} leaves: "
              f"{comp_['step1_codec_bitwise']}")
        check(comp_["step1_codec_bitwise"] and comp_["codec_leaves"] == len(
            comp_["local_param_bytes"]), f"rank {r['rank']}'s step-1 codec is not the global "
              "codec")
        for tag, st in r["strategies"].items():
            print(f"[model_axis] rank {r['rank']} strategies {tag}: {st['nodes']} nodes "
                  f"planned in {st['plan_s']:.2f} s, {st['codes']}, DP peak "
                  f"{st['dp_peak']:.6e} B; pinned host bytes {st['pinned_bytes']} against "
                  f"the plan's offloaded local bytes {st['offloaded_bytes']:.6e} (quantized "
                  f"{st['quantized_bytes']:.6e}); bitwise the mesh's vanilla {st['bitwise']}; "
                  f"loss rel {st['loss_rel']:.3e}, grads rel l2 {st['grads_rel_l2']:.3e}; "
                  f"{st['ms']:.1f} ms; launches {json.dumps(st['launches'])}")
        off = r["strategies"]["offload"]
        check(off["codes"].get("offload", 0) > 0 and off["pinned_bytes"] > 0,
              "the offload plan offloaded nothing to pinned host memory")
        check(off["bitwise"], f"rank {r['rank']}'s offload plan differs from the mesh's vanilla")
        check(r["strategies"]["quantize"]["codes"].get("quantize", 0) > 0,
              "the quantize plan quantizes nothing")
        for tag in ("quantize", "offload_quantize"):
            st = r["strategies"][tag]
            if st["codes"].get("quantize"):
                check(st["loss_rel"] <= QUANT_BOUND and st["grads_rel_l2"] <= QUANT_BOUND,
                      f"rank {r['rank']}'s {tag} plan is outside {QUANT_BOUND}")
            else:
                check(st["bitwise"], f"rank {r['rank']}'s {tag} plan differs from vanilla")
        d = r["dropout"]
        print(f"[model_axis] rank {r['rank']} dropout MLP: default plan recomputes "
              f"{len(d['redrawn'])} bernoulli nodes; bitwise plain autograd {d['bitwise']}; "
              f"loss {d['loss']:.6f}; DTensor RNG tracker {d['tracker']} (keeps states of its "
              f"own: {d['tracker_keeps_states']})")
        check(bool(d["redrawn"]) and d["bitwise"],
              f"rank {r['rank']}'s dropout plan recomputes no draw or differs from plain autograd")
        ps = r["psum"]
        print(f"[model_axis] rank {r['rank']} hierarchical_psum on {{pod: 2, data: 2}}: "
              f"bitwise one process's reference arithmetic {ps['bitwise']}; max |gap| to the "
              f"exact sum {ps['max_abs_exact']:.4e}; collectives [calls, payload B] by axis "
              f"{ps['comm']}")
        check(ps["bitwise"], f"rank {r['rank']}'s hierarchical_psum differs from the reference's "
              "arithmetic")
        check(r["fsdp"]["state_bytes"] < r["plain"]["state_bytes"],
              "FSDP did not shard the state further")
        want = expected_collectives(cfg, r["plain"]["local_param_bytes"],
                                    r["plain"]["model_sharded_leaves"])
        got = {axis: {op: rec["payload_bytes"] for op, rec in ops.items()}
               for axis, ops in r["plain"]["comm"].items()}
        print(f"[model_axis] rank {r['rank']} plain step 1 collectives (payload B): {got}; "
              f"worked out from the shapes: {want}; fsdp: "
              f"{ {a: {o: v['payload_bytes'] for o, v in ops.items()} for a, ops in r['fsdp']['comm'].items()} }")
        check(got == want, f"rank {r['rank']}'s collectives differ from the shapes' count")
    print(f"[model_axis] planned budget {ranks[0]['planned_budget']:.6e} B a device; planned "
          f"Trainer bitwise the plain one on every rank")
    for name in fa.KERNELS:
        results[name]["model_axis_launches"] = [r["plain"]["launches"][name] for r in ranks]
        results[name]["mesh_strategies_launches"] = [
            sum(st["launches"][name] for st in r["strategies"].values()) for r in ranks]

    # accounting only: the configs one card cannot hold, on the meta device
    for arch in MODEL_AXIS_BIG:
        big = configs.get_config(arch)
        t0 = time.perf_counter()
        per = specs.state_bytes_per_device(big, MODEL_AXIS_BIG_MESH)
        print(f"[model_axis] {arch}: {big.num_params():,} parameters; f32 parameters + "
              f"AdamW {12 * big.num_params():,} B whole (16 B a parameter with the f32 "
              f"gradient), {per:,} B a device on {MODEL_AXIS_BIG_MESH} "
              f"({time.perf_counter() - t0:.2f} s, meta device)")
        check(0 < per < torch.cuda.get_device_properties(0).total_memory,
              f"{arch}'s per-device state does not fit the card")


def per_shard_moe(dp: int, tp: int):
    """A one-process ``moe_apply`` with the mesh path's semantics: the
    tokens cut into the dp × tp shards the ranks hold (batch over data,
    sequence over model), each routed and packed with its own capacity
    C_loc; the meshless reference of phase axis_serve's granite."""
    import torch

    moe = importlib.import_module("repro_torch.models.moe")

    def apply(p, x, cfg, return_aux=False):
        B, S, D = x.shape
        E, K = cfg.num_experts, cfg.top_k
        bl, sl = B // dp, S // tp
        c_loc = max(8, math.ceil(cfg.capacity_factor * bl * sl * K / E))
        rows = []
        for d in range(dp):
            cols = []
            for m in range(tp):
                xt = x[d * bl:(d + 1) * bl, m * sl:(m + 1) * sl].reshape(bl * sl, D)
                gates, ids, _, _ = moe._route(p["router"], xt, cfg)
                disp, eid, pos_c, keep = moe._pack(xt, ids, E, c_loc)
                out = moe._expert_ffn(p["experts"], disp)
                cols.append(moe._combine(out, eid, pos_c, keep, gates, bl * sl, K)
                            .reshape(bl, sl, D))
            rows.append(torch.cat(cols, 1))
        return torch.cat(rows, 0)

    return apply


def axis_serve_model(arch: str, layers: int, dev, dtype: str = "bfloat16"):
    """``arch`` at full width, ``layers`` deep, activations in ``dtype``,
    weights from seed 0 on the card (every process draws the same)."""
    import dataclasses

    import torch

    configs = importlib.import_module("repro_torch.configs")
    models = importlib.import_module("repro_torch.models")
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers, dtype=dtype)
    return cfg, models.build_model(cfg, device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(0))


def axis_serve_batches(cfg, n: int, dev, host_id=None) -> list:
    """The first ``n`` batches of a family's stream at global batch
    ``MODEL_AXIS_BATCH``: data rank ``host_id``'s rows, or the whole batch
    (``host_id=None``, what one process runs); whisper's carry one clip of
    frames a row."""
    data = importlib.import_module("repro_torch.data")
    hosts = MODEL_AXIS_MESH["data"]
    seq = WHISPER_TOKENS if cfg.encoder_decoder else 1024
    stream = data.DataConfig(cfg.vocab_size, seq, MODEL_AXIS_BATCH, num_hosts=hosts,
                             host_id=host_id or 0)
    rows = slice(None) if host_id is None else slice(
        host_id * MODEL_AXIS_BATCH // hosts, (host_id + 1) * MODEL_AXIS_BATCH // hosts)
    out = []
    for i in range(n):
        b = dict(data.global_batch_for_test(stream, i) if host_id is None
                 else data.SyntheticLM(stream).batch(i))
        if cfg.encoder_decoder:
            b["frames"] = whisper_frames(cfg, i, MODEL_AXIS_BATCH, dev)[rows]
        out.append(b)
    return out


def axis_serve_worker(out_dir: Path) -> int:
    """One of phase axis_serve's processes (under ``torch.distributed.run``):
    on ``{data: 2, model: 2}`` over the gloo group sharing the card,
    stablelm-3b's sharded engine (rank 0 also replays its tokens through
    the same engine unsharded), granite's expert-parallel Trainer and
    sharded decode, and zamba2's, xlstm's and whisper's Trainers (whisper's
    engine encoding on head shards); a ``summary:`` line (rank 0) and
    ``out_dir/rank<r>.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    import datetime
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.utils._pytree as pytree
    from torch.distributed.device_mesh import init_device_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    configs = importlib.import_module("repro_torch.configs")
    specs = importlib.import_module("repro_torch.launch.specs")
    steps = importlib.import_module("repro_torch.launch.steps")
    serving = importlib.import_module("repro_torch.serving")
    train = importlib.import_module("repro_torch.train")
    census = importlib.import_module("repro_torch.analysis.census")
    import faulthandler

    faulthandler.enable()
    torch.cuda.set_device(0)
    # ranks sharing one card: NCCL cannot; a rank stuck in a collective
    # fails in minutes, not at gloo's default half hour
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=300))
    route_gloo_cuda_collectives()
    rank = dist.get_rank()
    if rank == 0:
        print(f"process group: gloo, {dist.get_world_size()} ranks sharing 1 card", flush=True)
    sizes = MODEL_AXIS_MESH
    mesh = init_device_mesh("cuda", tuple(sizes.values()), mesh_dim_names=tuple(sizes))
    data_rank = rank // sizes["model"]
    dev = torch.device("cuda")
    heads, fwd = [], fa.flash_attention_fwd

    def counted_fwd(q, *a, **kw):
        heads.append(int(q.shape[1]))
        return fwd(q, *a, **kw)

    fa.flash_attention_fwd = counted_fwd
    out = {"rank": rank}

    def by_axis(counted):
        return {axis: {op: rec["payload_bytes"] for op, rec in ops.items()}
                for axis, ops in counted.by_axis(mesh).items()}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def decode_section():
        # stablelm-3b: the sharded engine, and (rank 0) the same engine
        # unsharded fed the sharded engine's tokens
        cfg, model = axis_serve_model("stablelm-3b", AXIS_SERVE_UNITS, dev)
        slots, max_seq, n_req, new = AXIS_SERVE_DECODE
        shape = configs.ShapeConfig("axis_serve", max_seq, slots, "decode")
        fa.reset_launch_counts()
        heads.clear()
        torch.cuda.reset_peak_memory_stats()
        eng = serving.Engine(model, max_slots=slots, max_seq=max_seq, mesh=mesh,
                             step_shardings=steps.decode_shardings(cfg, shape, mesh))
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab_size, size=rng.integers(4, 32)).tolist()
                   for _ in range(n_req)]
        for prompt in prompts:
            eng.submit(prompt, max_new_tokens=new)
        fed, next_token = [], eng._next_token_for

        def logged(slot):
            fed.append(next_token(slot))
            return fed[-1]

        eng._next_token_for = logged
        logits, step_comm = [], None
        t0 = time.perf_counter()
        while eng.pending or any(r is not None for r in eng.slot_req):
            if step_comm is None and len(eng.step_seconds) == 8:  # a step in steady state
                with census.CountCollectives() as counted:
                    eng.step()
                step_comm = by_axis(counted)
            else:
                eng.step()
            if rank == 0:
                logits.append(eng.last_logits)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        done = eng.completed
        ms = np.array(eng.step_seconds) * 1e3
        out["decode"] = {
            "requests": len(done), "tokens": sum(len(r.output) for r in done),
            "complete": all(len(r.output) == new for r in done) and len(done) == n_req,
            "steps": len(ms), "seconds": seconds, "median_ms": float(np.median(ms)),
            "p90_ms": float(np.percentile(ms, 90)), "first_ms": float(ms[0]),
            "cache_bytes": sum(t.to_local().numel() * t.to_local().element_size()
                               for t in pytree.tree_leaves(eng.caches)),
            "step_collectives": step_comm, "launches": dict(fa.LAUNCHES),
            "finite": bool(all(np.isfinite(x).all() for x in logits)),
            "peak_bytes": torch.cuda.max_memory_allocated(),
        }
        del eng, model
        free()
        if rank == 0:  # the same engine unsharded, fed the same tokens, in this process
            cfg, plain = axis_serve_model("stablelm-3b", AXIS_SERVE_UNITS, dev)
            ref = serving.Engine(plain, max_slots=slots, max_seq=max_seq)
            for prompt in prompts:
                ref.submit(prompt, max_new_tokens=new)
            feed = iter(fed)
            ref._next_token_for = lambda slot: next(feed)
            gaps, agree, i = [], [], 0
            while ref.pending or any(r is not None for r in ref.slot_req):
                ref.step()
                gap = np.abs(ref.last_logits - logits[i])
                gaps.append((gap.max(), gap.mean()))
                agree.append(ref.last_logits.argmax(-1) == logits[i].argmax(-1))
                i += 1
            out["decode"]["vs_unsharded"] = {
                "steps": i, "max_gap": float(max(g for g, _ in gaps)),
                "mean_gap": float(np.mean([m for _, m in gaps])),
                "agreement": float(np.concatenate(agree).mean()),
                "unsharded_median_ms": float(np.median(ref.step_seconds) * 1e3)}
            del ref, plain
            free()

    def granite_section():
        # granite-moe-3b-a800m: the expert-parallel Trainer, then decode
        cfg, model = axis_serve_model("granite-moe-3b-a800m", AXIS_SERVE_UNITS, dev)
        layout = specs.param_shardings(cfg, mesh, dict(model.named_parameters()))
        heads.clear()
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        tr = train.Trainer(lambda m, b: m.loss(b, (AXIS_SERVE_UNITS,), (False,)), model,
                           train.TrainConfig(total_steps=AXIS_SERVE_GRANITE_STEPS, log_every=0),
                           device="cuda", mesh=mesh, in_shardings=(layout, None))
        res = tr.run(iter(axis_serve_batches(cfg, AXIS_SERVE_GRANITE_STEPS, dev, data_rank)))
        torch.cuda.synchronize()
        out["granite"] = {"losses": res["losses"], "step_seconds": res["step_seconds"],
                          "comm": {a: {o: r["payload_bytes"] for o, r in ops.items()}
                                   for a, ops in tr.comm_by_axis.items()},
                          "q_heads": sorted(set(heads)), "launches": dict(fa.LAUNCHES),
                          "peak_bytes": torch.cuda.max_memory_allocated()}
        del tr
        free()
        shape = configs.ShapeConfig("axis_serve", 64, 8, "decode")
        eng = serving.Engine(model, max_slots=8, max_seq=64, mesh=mesh,
                             step_shardings=steps.decode_shardings(cfg, shape, mesh))
        for i in range(8):
            eng.submit([1 + i, 2 + i, 3 + i, 4 + i], max_new_tokens=GRANITE_AXIS_DECODE_TOKENS)
        with census.CountCollectives() as counted:
            eng.step()
        done = eng.run()
        out["granite"]["decode"] = {
            "tokens": sum(len(r.output) for r in done),
            "complete": len(done) == 8 and all(len(r.output) == GRANITE_AXIS_DECODE_TOKENS
                                               for r in done),
            "median_ms": float(np.median(eng.step_seconds) * 1e3),
            "finite": bool(np.isfinite(eng.last_logits).all()),
            "first_step_collectives": by_axis(counted)}
        del eng, model
        free()

    def family_section(arch, layers):
        # a recurrent or encoder-decoder family on the model axis: its
        # Trainer in the config's bf16 and in f32, then (whisper) its engine
        out[arch] = {}
        for dtype in AXIS_SERVE_FAMILY_DTYPES:
            cfg, model = axis_serve_model(arch, layers, dev, dtype)
            layout = specs.param_shardings(cfg, mesh, dict(model.named_parameters()))
            heads.clear()
            fa.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            units = model.n_units
            tr = train.Trainer(lambda m, b: m.loss(b, (units,), (False,)), model,
                               train.TrainConfig(total_steps=AXIS_SERVE_FAMILY_STEPS,
                                                 log_every=0),
                               device="cuda", mesh=mesh, in_shardings=(layout, None))
            res = tr.run(iter(axis_serve_batches(cfg, AXIS_SERVE_FAMILY_STEPS, dev,
                                                 data_rank)))
            torch.cuda.synchronize()
            out[arch][dtype] = {
                "losses": res["losses"], "step_seconds": res["step_seconds"],
                "q_heads": sorted(set(heads)), "launches": dict(fa.LAUNCHES),
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "state_bytes": 3 * sum(p.to_local().numel() * 4 for p in tr.params),
                "specs_state_bytes": specs.state_bytes_per_device(cfg, sizes)}
            del tr
            free()
        if cfg.encoder_decoder:  # the engine encodes its clips on head shards
            heads.clear()
            fa.reset_launch_counts()
            frames = whisper_frames(cfg, 0, 2, dev)
            shape = configs.ShapeConfig("axis_serve", 64, 2, "decode")
            eng = serving.Engine(model, max_slots=2, max_seq=64, frames=frames, mesh=mesh,
                                 step_shardings=steps.decode_shardings(cfg, shape, mesh))
            for i in range(2):
                eng.submit([50257 + i, 50258], max_new_tokens=8)
            done = eng.run()
            out[arch]["engine"] = {
                "q_heads": sorted(set(heads)), "launches": dict(fa.LAUNCHES),
                "complete": len(done) == 2 and all(len(r.output) == 8 for r in done),
                "finite": bool(np.isfinite(eng.last_logits).all())}
            del eng
        del model
        free()

    def guarded(name, fn, *args):
        """``fn`` on every rank; an error is recorded under ``name`` (every
        rank raises alike at the same point, so the group stays in step)."""
        try:
            fn(*args)
        except Exception:
            import traceback

            out[name] = {"error": traceback.format_exc()[-4000:]}
        free()
        dist.barrier()

    guarded("decode", decode_section)
    guarded("granite", granite_section)
    for arch, layers in AXIS_SERVE_FAMILIES:
        guarded(arch, family_section, arch, layers)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(out))
    if rank == 0:
        print("summary: " + json.dumps({"ranks": dist.get_world_size()}), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_axis_serve(results):
    """Serving on a mesh and every family on the model axis: four gloo
    processes sharing the card on ``{data: 2, model: 2}``
    (``torch.distributed.run`` of this script's ``--axis-serve-worker``).
    stablelm-3b's sharded engine at full width, 2 units (16 requests of 64
    tokens through 8 slots of a 2048-token cache) held against the same
    engine unsharded fed the same tokens (phase serve's bf16 limits), its
    cache bytes a rank, step times and one step's collectives by axis;
    granite's expert-parallel Trainer (3 steps, losses against one process
    routing the same shards, step 1's all-to-all bytes against the
    shapes') and 8 sharded decode tokens; zamba2's, xlstm's (1 unit each)
    and whisper's (2 layers a side) Trainers, 2 steps against one
    process's meshless Trainer, state bytes against ``specs``; whisper's
    engine encoding on head shards; every process's kernels' heads and
    peak."""
    import tempfile

    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    moe = importlib.import_module("repro_torch.models.moe")
    train = importlib.import_module("repro_torch.train")
    world = math.prod(MODEL_AXIS_MESH.values())
    out_dir = Path(tempfile.mkdtemp())
    t0 = time.perf_counter()
    run = torchrun(world, ["--axis-serve-worker", str(out_dir)], module=None, timeout=900)
    print(f"[axis_serve] {world} processes ({run['process_group']!r}) in "
          f"{time.perf_counter() - t0:.1f} s")
    check((run["process_group"] or "").startswith("gloo"), "the processes did not take gloo")
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]
    errors = {(r["rank"], k): v["error"] for r in ranks for k, v in r.items()
              if isinstance(v, dict) and "error" in v}
    failures = []

    def soft(cond: bool, msg: str) -> None:  # every result printed before the phase fails
        if not cond:
            failures.append(msg)

    for (rank, section), text in errors.items():
        print(f"[axis_serve] rank {rank} {section} FAILED:\n{text}")
    check(not errors, f"sections failed: {sorted(errors)}")
    dev = torch.device("cuda")

    # stablelm-3b's sharded engine
    for r in ranks:
        d = r["decode"]
        print(f"[axis_serve] rank {r['rank']} stablelm-3b engine: {d['requests']} requests, "
              f"{d['tokens']} tokens, {d['steps']} steps in {d['seconds']:.4f} s; step ms "
              f"first {d['first_ms']:.4f}, median {d['median_ms']:.4f}, p90 {d['p90_ms']:.4f}; "
              f"KV cache {d['cache_bytes']} B a rank; one step's collectives (payload B) "
              f"{d['step_collectives']}; launches {json.dumps(d['launches'])}; peak "
              f"{d['peak_bytes']} B")
        soft(d["complete"], f"rank {r['rank']}'s sharded engine left a request incomplete")
        soft(d["cache_bytes"] == AXIS_SERVE_CACHE_BYTES,
              f"rank {r['rank']} holds {d['cache_bytes']} B of caches, not "
              f"{AXIS_SERVE_CACHE_BYTES}")
        soft(all(v == 0 for v in d["launches"].values()), "decode launched a kernel")
    vs = ranks[0]["decode"]["vs_unsharded"]
    print(f"[axis_serve] sharded against unsharded on the same tokens, {vs['steps']} steps: "
          f"max |gap| {vs['max_gap']:.4e}, mean |gap| {vs['mean_gap']:.4e}, greedy agreement "
          f"{vs['agreement']:.4f}; unsharded median step {vs['unsharded_median_ms']:.4f} ms")
    soft(ranks[0]["decode"]["finite"], "a sharded decode step gave a non-finite logit")
    soft(vs["max_gap"] <= TEACHER_BF16_MAX and vs["mean_gap"] <= TEACHER_BF16_MEAN
          and vs["agreement"] >= TEACHER_BF16_AGREE,
          "the sharded engine's logits differ from the unsharded engine's")

    # granite: the expert-parallel Trainer against one process routing the same shards
    cfg, model = axis_serve_model("granite-moe-3b-a800m", AXIS_SERVE_UNITS, dev)
    apply, moe.moe_apply = moe.moe_apply, per_shard_moe(MODEL_AXIS_MESH["data"],
                                                        MODEL_AXIS_MESH["model"])
    try:
        tr = train.Trainer(lambda m, b: m.loss(b, (AXIS_SERVE_UNITS,), (False,)), model,
                           train.TrainConfig(total_steps=AXIS_SERVE_GRANITE_STEPS, log_every=0),
                           device="cuda")
        single = tr.run(iter(axis_serve_batches(cfg, AXIS_SERVE_GRANITE_STEPS, dev)))
    finally:
        moe.moe_apply = apply
    del tr, model
    torch.cuda.empty_cache()
    want_a2a = expected_collectives(cfg, [], 0)["model"]["all_to_all_single"]
    print(f"[axis_serve] granite one process, per-shard routing: losses {single['losses']}")
    for r in ranks:
        g = r["granite"]
        worst = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], single["losses"]))
        a2a = g["comm"].get("model", {}).get("all_to_all_single")
        print(f"[axis_serve] rank {r['rank']} granite EP Trainer: losses {g['losses']} (worst "
              f"relative gap {worst:.3e}); step seconds {[round(t, 4) for t in g['step_seconds']]}"
              f"; step 1 collectives (payload B) {g['comm']}; all-to-all {a2a} B against the "
              f"shapes' {want_a2a} B; q heads {g['q_heads']}; launches "
              f"{json.dumps(g['launches'])}; peak {g['peak_bytes']} B")
        dd = g["decode"]
        print(f"[axis_serve] rank {r['rank']} granite sharded decode: {dd['tokens']} tokens, "
              f"median step {dd['median_ms']:.4f} ms, first step's collectives "
              f"{dd['first_step_collectives']}")
        soft(worst < 1e-4, f"rank {r['rank']}'s granite losses differ from one process's "
              "beyond 1e-4")
        soft(a2a == want_a2a, f"rank {r['rank']}'s all-to-all bytes differ from the shapes'")
        soft(g["q_heads"] == [cfg.n_heads // MODEL_AXIS_MESH["model"]],
              f"rank {r['rank']}'s granite kernels did not get half the heads")
        soft(dd["complete"] and dd["finite"], f"rank {r['rank']}'s granite decode failed")
        soft(all(g["launches"][k] > 0 for k in fa.KERNELS),
              f"rank {r['rank']}'s granite Trainer launched a kernel no time")
    for name in fa.KERNELS:
        results[name]["axis_serve_launches"] = {
            "granite": [r["granite"]["launches"][name] for r in ranks]}

    # zamba2, xlstm and whisper against one process's meshless Trainer: in
    # f32 to 1e-4 (the layout's partial sums round in f32 there); in bf16
    # the gap is printed (each rank rounds its partial sums to bf16 before
    # the model axis adds them, once a block)
    for arch, layers in AXIS_SERVE_FAMILIES:
        for dtype in AXIS_SERVE_FAMILY_DTYPES:
            cfg, model = axis_serve_model(arch, layers, dev, dtype)
            units = model.n_units
            tr = train.Trainer(lambda m, b: m.loss(b, (units,), (False,)), model,
                               train.TrainConfig(total_steps=AXIS_SERVE_FAMILY_STEPS,
                                                 log_every=0), device="cuda")
            single = tr.run(iter(axis_serve_batches(cfg, AXIS_SERVE_FAMILY_STEPS, dev)))
            del tr, model
            torch.cuda.empty_cache()
            print(f"[axis_serve] {arch} {dtype} one process: losses {single['losses']}")
            for r in ranks:
                x = r[arch][dtype]
                worst = max(abs(a - b) / abs(b) for a, b in zip(x["losses"], single["losses"]))
                print(f"[axis_serve] rank {r['rank']} {arch} {dtype}: losses {x['losses']} "
                      f"(worst relative gap {worst:.3e}); step seconds "
                      f"{[round(t, 4) for t in x['step_seconds']]}; q heads {x['q_heads']}; "
                      f"launches {json.dumps(x['launches'])}; peak {x['peak_bytes']} B; "
                      f"parameters + AdamW {x['state_bytes']} B against specs' "
                      f"{x['specs_state_bytes']} B")
                if dtype == "float32":
                    soft(worst < 1e-4, f"rank {r['rank']}'s {arch} f32 losses differ from one "
                         "process's beyond 1e-4")
                soft(x["state_bytes"] == x["specs_state_bytes"],
                     f"rank {r['rank']}'s {arch} state bytes are not specs'")
                soft(all((x["launches"][k] > 0) == (attention_blocks(cfg) > 0)
                         for k in fa.KERNELS),
                     f"rank {r['rank']}'s {arch} Trainer launched the kernels "
                     f"{x['launches']} times")
                if attention_blocks(cfg):
                    soft(x["q_heads"] == [cfg.n_heads // MODEL_AXIS_MESH["model"]],
                         f"rank {r['rank']}'s {arch} kernels did not get half the heads")
        for r in ranks:
            e = r[arch].get("engine")
            if e is not None:
                print(f"[axis_serve] rank {r['rank']} {arch} engine: q heads {e['q_heads']}, "
                      f"launches {json.dumps(e['launches'])}")
                soft(e["q_heads"] == [cfg.n_heads // MODEL_AXIS_MESH["model"]]
                     and e["launches"]["flash_fwd"] == cfg.n_layers and e["complete"]
                     and e["finite"], f"rank {r['rank']}'s {arch} engine failed")
        for name in fa.KERNELS:
            results[name].setdefault("axis_serve_launches", {})[arch] = [
                r[arch]["bfloat16"]["launches"][name] for r in ranks]
    check(not failures, "; ".join(failures))


def production_setup(dev):
    """qwen3-moe-30b-a3b at full width, ``PRODUCTION_UNITS`` deep, in f32,
    weights from seed 0 on ``dev`` (every process draws the same), the
    cell's shape and its first ``PRODUCTION_STEPS`` batches (the whole
    global batch: the data axis has one rank)."""
    import dataclasses

    import torch

    configs = importlib.import_module("repro_torch.configs")
    data = importlib.import_module("repro_torch.data")
    models = importlib.import_module("repro_torch.models")
    cfg = dataclasses.replace(configs.get_config(PRODUCTION_ARCH), n_layers=PRODUCTION_UNITS,
                              dtype="float32")
    model = models.build_model(cfg, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    shape = configs.ShapeConfig("production", PRODUCTION_SEQ, PRODUCTION_BATCH, "train")
    stream = data.SyntheticLM(data.DataConfig(cfg.vocab_size, PRODUCTION_SEQ, PRODUCTION_BATCH))
    return cfg, model, shape, [stream.batch(i) for i in range(PRODUCTION_STEPS)]


def production_plan() -> dict:
    """The cell's segment plan: one unit a segment, ``PRODUCTION_REMAT``."""
    return {"segment_sizes": (1,) * PRODUCTION_UNITS, "segment_remat": PRODUCTION_REMAT}


def production_collectives(cfg, model_sharded_leaves: int) -> dict:
    """Phase production's first-step collectives of a rank by mesh axis and
    kind, ``[calls, payload bytes]``, worked out from the shapes: L units,
    R of them rematerialized (R' of those after the first), B_l sequences
    of S tokens a rank, d_model D, m-way model axis, A = B_l·S·D
    activations, G = B_l·S·KV·d_head (k's or v's elements), T =
    B_l·(S/m)·D (a sequence shard); f32.  The data axis has one rank and
    sends nothing.  A recomputed unit sends its forward's collectives
    again.

    * all-reduce, 7L + R + 5 calls: A each for the vocab shards' embedding
      rows, the gradient of the vocab-split head's input, and in each unit
      the attention's output projection (again in a recomputed unit) and
      the gradient of its q, k and v projections' input; 3 of B_l·(S−1),
      the vocab-split loss's max, sum of exponentials and gold logit; in
      each unit the dk and dv sums over the ranks that share a KV head
      (``kernels.ops.kv_to_q_heads``), G each, and the router's gradient,
      D·E; 2L − 1 norm scales' gradients, D each; one f32 a model-sharded
      leaf, the clip's norm.
    * all-gather, 4L + 2R + R' + 2 calls: in each unit the k and v
      projections' columns (KV·d_head, which the axis divides while it does
      not divide the KV heads) before the head reshape, G/m each; each
      MoE's output gathered from its sequence shards where the next unit or
      the head reads it, T (again where a recomputed unit reads the one
      before it); in the backward one cotangent a unit and two more at its
      end, T each.
    * all-to-all, 4L + 2R calls: each MoE layer's (E, C_loc, D) buffer
      twice in the forward and twice in the backward, T_loc = B_l·S/m
      tokens a rank, C_loc = max(8, ceil(cf·T_loc·K/E)).

    The counts are those the same code sent on a fake group of 8 CPU ranks
    at L 1-3, every remat pattern of R 0-3 and B_l 2-3, where the formula
    held exactly."""
    L, D = cfg.n_layers, cfg.d_model
    R, R_after = sum(PRODUCTION_REMAT), sum(PRODUCTION_REMAT[1:])
    m, S = PRODUCTION_MESH["model"], PRODUCTION_SEQ
    Bl = PRODUCTION_BATCH // PRODUCTION_MESH["data"]
    A, G, T = Bl * S * D, Bl * S * cfg.n_kv_heads * cfg.head_dim, Bl * (S // m) * D
    moe = cfg.moe
    c_loc = max(8, math.ceil(moe.capacity_factor * Bl * S // m * moe.top_k / moe.num_experts))
    buf = moe.num_experts * c_loc * D
    return {"model": {
        "all_reduce": [7 * L + R + 5, 4 * ((2 + 2 * L + R) * A + 3 * Bl * (S - 1)
                                           + L * (2 * G + D * moe.num_experts)
                                           + (2 * L - 1) * D + model_sharded_leaves)],
        "all_gather_into_tensor": [4 * L + 2 * R + R_after + 2,
                                   4 * ((L + R) * 2 * (G // m) + (2 * L + 2 + R_after) * T)],
        "all_to_all_single": [4 * L + 2 * R, 4 * (4 * L + 2 * R) * buf],
    }}


def production_worker(out_dir: Path) -> int:
    """One of phase production's processes (under ``torch.distributed.run``):
    the mesh over the gloo group sharing the card, the cell's Trainer from
    ``launch.steps.build_train_step``, two steps; a ``summary:`` line (rank
    0) and ``out_dir/rank<r>.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    import datetime
    import faulthandler

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    steps = importlib.import_module("repro_torch.launch.steps")
    faulthandler.enable()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=300))
    route_gloo_cuda_collectives()
    rank = dist.get_rank()
    if rank == 0:
        print(f"process group: gloo, {dist.get_world_size()} ranks sharing 1 card", flush=True)
    mesh = init_device_mesh("cuda", tuple(PRODUCTION_MESH.values()),
                            mesh_dim_names=tuple(PRODUCTION_MESH))
    heads, fwd = [], fa.flash_attention_fwd

    def counted_fwd(q, k, *a, **kw):
        heads.append((int(q.shape[1]), int(k.shape[1])))
        return fwd(q, k, *a, **kw)

    fa.flash_attention_fwd = counted_fwd
    dev = torch.device("cuda")
    # the processes draw the weights on the card and lay out their Trainers'
    # shards in turn (a Trainer's layout sends nothing), each dropping its
    # whole copy before the next: eight whole copies would not fit the card
    for turn in range(dist.get_world_size()):
        if turn == rank:
            cfg, model, shape, batches = production_setup(dev)
            step = steps.build_train_step(cfg, shape, mesh, n_micro=1, **production_plan())[0]
            tr = step.trainer(model, device="cuda")
            del model
            torch.cuda.empty_cache()
        dist.barrier()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses, seconds, peak = [], [], None
    for b in batches:
        t0 = time.perf_counter()
        res = tr.train_step({k: torch.as_tensor(v, device=dev) for k, v in b.items()})
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(res["loss"])
        peak = peak or torch.cuda.max_memory_allocated()  # step 1's
    out = {"rank": rank, "losses": losses, "step_seconds": seconds,
           "launches": dict(fa.LAUNCHES), "heads": sorted(set(heads)),
           "comm": {axis: {op: [rec["calls"], rec["payload_bytes"]] for op, rec in ops.items()}
                    for axis, ops in tr.comm_by_axis.items()},
           "step1_peak_bytes": peak, "resident_bytes": resident,
           "state_bytes": 3 * sum(p.to_local().numel() * p.to_local().element_size()
                                  for p in tr.params),
           "model_sharded_leaves": sum(1 for p in tr.params if not p.placements[1].is_replicate())}
    (out_dir / f"rank{rank}.json").write_text(json.dumps(out))
    if rank == 0:
        print("summary: " + json.dumps({"ranks": dist.get_world_size()}), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_production(results):
    """The production meshes' path on the card.  The three kernels at the
    GQA shards the model axis brings (each rank's q heads over local copies
    of its own KV head), held and timed; eight gloo processes sharing the
    card on ``{data: 1, model: 8}`` running qwen3-moe-30b-a3b (4 KV heads,
    which the axis does not divide) at full width, 2 units, the first
    rematerialized, f32: two Trainer steps against one process's on the
    same weights and batches, routing the same token shards (run after the
    eight), the kernels on the local head shards and their launches, step
    1's collectives by axis against the shapes' count
    (:func:`production_collectives`), each process's peak; the same cell
    traced by the dry run on a fake group of 8 ranks, whose rank-0
    collectives must equal the real rank 0's op for op and byte for byte,
    and whose memory estimate must lie within ``PRODUCTION_MEMORY_BAND`` of
    its peak."""
    import tempfile

    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    train = importlib.import_module("repro_torch.train")
    steps = importlib.import_module("repro_torch.launch.steps")
    mesh_mod = importlib.import_module("repro_torch.launch.mesh")
    dryrun = importlib.import_module("repro_torch.launch.dryrun")
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[production] the card's total_memory {total} B; launch.mesh.H100_HBM_BYTES "
          f"{mesh_mod.H100_HBM_BYTES} B, the dry run's default budget")
    check(total == mesh_mod.H100_HBM_BYTES, "the card's memory is not H100_HBM_BYTES")
    t0 = time.perf_counter()
    for ci, case in enumerate(PRODUCTION_KERNEL_CASES):
        kernel_case(results, len(KERNEL_CASES) + 1 + ci, case, True)
        check_model_layout(len(KERNEL_CASES) + 1 + ci, case[0])
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    print(f"[production] kernels at the GQA shards in {time.perf_counter() - t0:.1f} s")

    world = math.prod(PRODUCTION_MESH.values())
    out_dir = Path(tempfile.mkdtemp())
    t0 = time.perf_counter()
    run = torchrun(world, ["--production-worker", str(out_dir)], module=None, timeout=600)
    print(f"[production] {world} processes ({run['process_group']!r}) in "
          f"{time.perf_counter() - t0:.1f} s")
    check((run["process_group"] or "").startswith("gloo"), "the processes did not take gloo")
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]

    # one process, no mesh, the same weights and batches, routing the
    # tokens in the shards the ranks route them in (each with its capacity)
    dev = torch.device("cuda")
    cfg, model, shape, batches = production_setup(dev)
    step = steps.build_train_step(cfg, shape, {"data": 1, "model": 1}, n_micro=1,
                                  **production_plan())[0]
    moe = importlib.import_module("repro_torch.models.moe")
    apply, moe.moe_apply = moe.moe_apply, per_shard_moe(PRODUCTION_MESH["data"],
                                                        PRODUCTION_MESH["model"])
    try:
        tr = train.Trainer(step.loss, model, train.TrainConfig(total_steps=PRODUCTION_STEPS,
                                                               log_every=0), device="cuda")
        single = tr.run(iter(batches))
    finally:
        moe.moe_apply = apply
    del tr, model
    torch.cuda.empty_cache()
    print(f"[production] {PRODUCTION_ARCH} one process, per-shard routing: losses "
          f"{single['losses']}")
    m = PRODUCTION_MESH["model"]
    # each rank's q heads over as many copies of its one KV head
    want_heads = [[cfg.n_heads // m, cfg.n_heads // m]]
    recomputed = sum(PRODUCTION_REMAT)
    want_launches = {"flash_fwd": PRODUCTION_STEPS * (cfg.n_layers + recomputed),
                     "flash_bwd_dq": PRODUCTION_STEPS * cfg.n_layers,
                     "flash_bwd_dkv": PRODUCTION_STEPS * cfg.n_layers}
    for r in ranks:
        worst = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], single["losses"]))
        print(f"[production] rank {r['rank']}: losses {r['losses']} (worst relative gap "
              f"{worst:.3e}); step seconds {[round(t, 4) for t in r['step_seconds']]}; "
              f"(q, kv) heads {r['heads']}; launches {json.dumps(r['launches'])}; step 1 peak "
              f"{r['step1_peak_bytes']} B; resident {r['resident_bytes']} B; parameters + "
              f"AdamW {r['state_bytes']} B; step 1 collectives (calls, payload B) {r['comm']}")
        check(worst < 1e-4, f"rank {r['rank']}'s losses differ from one process's beyond 1e-4")
        check(r["heads"] == want_heads, f"rank {r['rank']}'s kernels got heads {r['heads']}")
        check(r["launches"] == want_launches, f"rank {r['rank']}'s Trainer launched "
              f"{r['launches']}, not {want_launches} ({PRODUCTION_STEPS} steps of "
              f"{cfg.n_layers} units, {recomputed} recomputed)")
        want = production_collectives(cfg, r["model_sharded_leaves"])
        check(r["comm"] == want, f"rank {r['rank']}'s step 1 collectives {r['comm']} differ "
              f"from the shapes' {want}")
    print(f"[production] step 1 collectives of each rank (calls, payload B) equal the "
          f"shapes' count {production_collectives(cfg, ranks[0]['model_sharded_leaves'])}; "
          f"launches of each rank {want_launches}")
    for name in fa.KERNELS:
        results[name]["production_launches"] = [r["launches"][name] for r in ranks]

    # the same cell on a fake group: rank 0's collectives and memory
    t0 = time.perf_counter()
    with mesh_mod.fake_group(world):
        fake = mesh_mod.make_fake_mesh(tuple(PRODUCTION_MESH.values()), tuple(PRODUCTION_MESH),
                                       device_type="cuda")
        rec = dryrun.trace_cell(cfg, shape, fake, totals=False, n_micro=1,
                                **production_plan())
    fake_comm = {axis: {op: [v["calls"], v["payload_bytes"]] for op, v in ops.items()}
                 for axis, ops in rec["collectives_by_axis"].items()}
    estimate = rec["temp_size_in_bytes"] + rec["argument_size_in_bytes"]
    real = ranks[0]["step1_peak_bytes"]
    ratio = estimate / real
    print(f"[production] dry run of the cell on a fake group of {world} ranks "
          f"({time.perf_counter() - t0:.1f} s): collectives {fake_comm}; equal to the real "
          f"rank 0's: {fake_comm == ranks[0]['comm']}; arguments "
          f"{rec['argument_size_in_bytes']} B + temp {rec['temp_size_in_bytes']} B = "
          f"{estimate} B against the real rank 0's step-1 peak {real} B: ratio {ratio:.4f}")
    check(fake_comm == ranks[0]["comm"], "the dry run's collectives differ from the real "
          "rank 0's")
    check(PRODUCTION_MEMORY_BAND[0] <= ratio <= PRODUCTION_MEMORY_BAND[1],
          f"the dry run's memory estimate is {ratio:.4f} of the real peak")


def start_production_dryruns(state, out_dir: Path) -> None:
    """``python -m repro_torch.launch.dryrun`` for each of
    ``PRODUCTION_DRYRUNS`` (configs one card cannot hold, on the
    single-pod production mesh, at full depth), each in a process of its
    own, logged to ``out_dir``; ``state["dryruns"]`` holds them."""
    runs = []
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for arch, shape_name, opts in PRODUCTION_DRYRUNS:
        log = out_dir / f"dryrun_{arch}_{shape_name}.log"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape_name, "--mesh", "single"] + (["--opts", ",".join(opts)] if opts else [])
        with open(log, "w") as f:
            runs.append((arch, shape_name, opts, log, time.perf_counter(), subprocess.Popen(
                cmd, env=env, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)))
    state["dryruns"] = runs
    print(f"[production_dryrun] started {len(runs)} dry-run cells side by side", flush=True)


def phase_production_dryrun(state):
    """The dry run's ``PRODUCTION_DRYRUNS`` cells, started before phase
    build: each exits 0 with status ``ok``; a train cell's parameters and
    AdamW moments a device are ``specs.state_bytes_per_device`` exactly;
    per-device bytes and ``trace_s`` printed."""
    specs = importlib.import_module("repro_torch.launch.specs")
    configs = importlib.import_module("repro_torch.configs")
    mesh_mod = importlib.import_module("repro_torch.launch.mesh")
    sizes = dict(zip(mesh_mod.SINGLE_POD[1], mesh_mod.SINGLE_POD[0]))
    failures = []
    for arch, shape_name, opts, log, started, proc in state.pop("dryruns"):
        try:
            rc = proc.wait(timeout=max(1.0, started + PRODUCTION_DRYRUN_TIMEOUT
                                       - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            failures.append(f"{arch} {shape_name}: not done in {PRODUCTION_DRYRUN_TIMEOUT} s")
            continue
        wall = time.perf_counter() - started
        lines = [ln for ln in log.read_text().splitlines() if ln.startswith("{")]
        rec = json.loads(lines[-1]) if lines else {"status": "no record"}
        tag = f"{arch} {shape_name}" + (f" opts {','.join(opts)}" if opts else "")
        if rc != 0 or rec.get("status") != "ok":
            print(f"[production_dryrun] {tag}: exit {rc}, status {rec.get('status')}:\n"
                  + log.read_text()[-3000:])
            failures.append(f"{tag}: exit {rc}")
            continue
        parts = rec["argument_bytes"]
        print(f"[production_dryrun] {tag}: trace_s {rec['trace_s']} (process {wall:.1f} s); "
              f"a device: arguments {rec['argument_size_in_bytes']} B {parts}, temp "
              f"{rec['temp_size_in_bytes']} B, output {rec['output_size_in_bytes']} B; "
              f"collectives a device {rec['collectives']['total_bytes_per_chip']} B "
              f"{rec['collectives']['bytes_per_chip']}; global FLOPs "
              f"{rec['jaxpr_flops_global']:.4e}, bytes {rec['jaxpr_bytes_global']:.4e}"
              + (f"; plan: n_micro {rec['n_micro']}, segments {len(rec['segment_sizes'])}, "
                 f"remat {sum(rec['segment_remat'])}" if "n_micro" in rec else ""))
        if shape_name.startswith("train"):
            want = specs.state_bytes_per_device(configs.get_config(arch), sizes)
            state_bytes = parts["params"] + parts["opt_state"]
            print(f"[production_dryrun] {tag}: parameters + AdamW {state_bytes} B a device "
                  f"against specs.state_bytes_per_device {want} B")
            if state_bytes != want:
                failures.append(f"{tag}: state bytes {state_bytes} != {want}")
    check(not failures, "; ".join(failures))


def phase_analysis(results, state):
    """The analysis layer (``repro_torch.analysis``) on the front door's
    workload: the effect pass, the verified plan with effects on and off,
    the heavy-op census and the memory-drift record, a corrupted plan, the
    launcher's verification and the ``plan_lint`` CLI on the card."""
    import collections
    import dataclasses
    import gc
    import os
    import tempfile

    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    core = importlib.import_module("repro_torch.core")
    lowering = importlib.import_module("repro_torch.core.lowering")
    analysis = importlib.import_module("repro_torch.analysis")
    census = importlib.import_module("repro_torch.analysis.census")

    gc.collect()
    torch.cuda.empty_cache()
    _, _, batch, _, step_loss, params = planned_setup()
    args = (params, batch)
    planner = core.get_default_planner()

    # 1. the effect pass
    t0 = time.perf_counter()
    pinned = lowering.TracedCarrier.trace(step_loss, args, analyze_effects=True)
    ea, g = pinned.effects, pinned.to_graph()
    flash = {nd.idx for nd in g.nodes if nd.kind == "flash_attention"}
    by_class = collections.Counter((e.klass, e.primitive) for e in ea.effects if not e.pure)
    print(f"[analysis] effect pass over {g.n} nodes in {time.perf_counter() - t0:.2f} s: "
          f"tainted {dict(by_class)}; {len(ea.pins)} pins "
          f"({dict(collections.Counter(g.nodes[v].kind for v in ea.pins))}), "
          f"{sum(g.nodes[v].memory for v in ea.pins):.6e} B")
    check(len(flash) == PLANNED_UNITS and ea.tainted == flash and ea.pins == flash
          and all(ea.effects[v].klass == "opaque" for v in flash),
          "the effect pass should taint and pin exactly the flash-attention nodes")

    def run(fn):
        gc.collect()
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        loss, grads = fn(*args)
        torch.cuda.synchronize()
        return loss.cpu(), grads, dict(fa.LAUNCHES)

    # 2. verification with effects on (the phase's main path)
    t0 = time.perf_counter()
    planned = lowering.plan_function(step_loss, analyze_effects=True, verify=True,
                                     verify_hlo=True, planner=planner)
    lowered = planned.lowered_for(*args)
    plan_s = time.perf_counter() - t0
    plan = lowered.plan
    rec = set().union(*(s.recompute for s in plan.segments))
    planned(*args)  # warm-up outside the counts
    l1, g1, c1 = run(planned)
    l0, g0, c0 = run(lowering.vanilla_traced_value_and_grad(lowered.carrier))
    print(f"[analysis] effects on: traced, planned, verified (check_plan, census, drift "
          f"gate) in {plan_s:.2f} s at the exact minimal budget {lowered.report.budget:.6e} B: "
          f"peak {plan.peak_memory:.6e} B, overhead {plan.overhead:g} of {g.total_time:g}, "
          f"{plan.num_segments} segments, {len(rec)} nodes and {len(flash & rec)} flash "
          f"nodes recomputed; launches planned {json.dumps(c1)}, vanilla {json.dumps(c0)}")
    print(f"[analysis] effects on: loss {l1.item():.8f} bitwise {torch.equal(l0, l1)}")
    grads_ok = all(torch.equal(g1[k], g0[k]) for k in g0)
    print(f"[analysis] effects on: grads bitwise {grads_ok}")
    del g0, g1
    check(not flash & rec, "a pinned flash-attention node is recomputed")
    check(torch.equal(l0, l1) and grads_ok, "the pinned plan's loss or grads differ from vanilla")
    check(c1 == c0 == {name: PLANNED_UNITS for name in fa.KERNELS},
          "the pinned plan relaunched a flash kernel")
    for name in fa.KERNELS:
        results[name]["analysis_launches"] = c1[name]

    # 3. verification with effects off: phase planned's plan, which recomputes
    # every flash node; its census and drift record
    t0 = time.perf_counter()
    unpinned = lowering.plan_function(step_loss, verify=True, verify_hlo=True,
                                      planner=planner).lowered_for(*args)
    verify_s = time.perf_counter() - t0
    uplan = unpinned.plan
    urec = set().union(*(s.recompute for s in uplan.segments))
    print(f"[analysis] effects off: traced, planned, verified in {verify_s:.2f} s at "
          f"{unpinned.report.budget:.6e} B (pinned budget minus this: "
          f"{lowered.report.budget - unpinned.report.budget:.6e} B); "
          f"{len(flash & urec)} flash nodes recomputed")
    res = unpinned.hlo  # the census and drift gate that verify_hlo ran
    check(res is not None, "verify_hlo kept no census record")
    cen, drift = res.census, res.drift
    print(f"[analysis] census: heavy ops vanilla {cen.vanilla}, planned {cen.planned}, "
          f"expected {cen.expected} (band of planned - vanilla: "
          f"[{cen.unpacked_recompute}, {cen.plan_recompute}]); {len(cen.rerun)} nodes rerun, "
          f"all in V \\ U_k: {cen.rerun <= urec}")
    print(f"[analysis] drift record {json.dumps(drift)}; band "
          f"{uplan.peak_memory * (1 + census.DRIFT_REL) + census.DRIFT_ABS_SLACK:.6e} B")
    for f in res.report.findings:
        print(f"[analysis]   {f.severity}: {f.code}: {f.message}")
    check(res.report.ok, "the census or the drift gate failed on the unpinned plan")
    check(cen.extra == cen.plan_recompute and cen.rerun <= urec,
          "the census does not match the plan's heavy recompute")

    # 4. a corrupted plan: one cached node moved to its segment's recompute set
    seg = next(s for s in uplan.segments if s.keep and s.recompute)
    victim = min(seg.keep)
    moved = dataclasses.replace(seg, keep=seg.keep - {victim},
                                recompute=seg.recompute | {victim})
    bad = dataclasses.replace(uplan, cached=uplan.cached - {victim}, segments=tuple(
        moved if s.index == seg.index else s for s in uplan.segments))
    rep = analysis.check_plan(unpinned.carrier.to_graph(), bad,
                              budget=unpinned.report.budget, fx=unpinned.carrier.fx)
    codes = sorted({f.code for f in rep.errors()})
    print(f"[analysis] corrupted plan (node {victim} moved to segment {seg.index}'s "
          f"recompute set): ok {rep.ok}, error codes {codes}")
    check(not rep.ok and {"cache-set-mismatch", "keep-mismatch",
                          "recompute-mismatch"} <= set(codes),
          "check_plan did not reject the corrupted plan with the reference's codes")

    # 5. the launcher's plan under REPRO_VERIFY_PLANS=1 (phase launcher)
    calls = state.get("launcher_verified")
    print(f"[analysis] launcher under REPRO_VERIFY_PLANS=1 (phase launcher, full width and "
          f"depth): check_plan ran {calls} time(s), every report ok")
    check(bool(calls), "the launcher's plan was not verified")
    del lowered, unpinned, planned, res
    gc.collect()
    torch.cuda.empty_cache()

    # 6. the plan_lint CLI on the card
    with tempfile.TemporaryDirectory() as tmp:
        drift_path = os.path.join(tmp, "drift.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--traced", "quickstart", "--hlo",
             "--device", "cuda", "--drift-json", drift_path],
            capture_output=True, text=True, cwd=ROOT, timeout=300,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        for line in (proc.stdout + proc.stderr).strip().splitlines():
            print(f"[analysis] cli: {line}")
        records = json.load(open(drift_path))["records"] if proc.returncode == 0 else []
    print(f"[analysis] cli exit {proc.returncode} in {time.perf_counter() - t0:.1f} s; "
          f"drift records {json.dumps(records)}")
    check(proc.returncode == 0, "python -m repro_torch.analysis --traced quickstart --hlo failed")


def phase_networks(results):
    """The paper's seven benchmark networks (``configs.paper_networks``) on
    the card: ``plan_lint --hlo --network NAME --device cuda`` for each
    (exit 0, heavy ops measured within the plan's eq. (1) count), then each
    network's executable twin at ``NETWORKS_BATCH`` x ``NETWORKS_WIDTH`` f32
    under its abstract plan at the exact minimal budget (the ``"policy"``
    backend, one block a node) and under plain autograd in the plan's node
    order: loss and grads bitwise, and the planned twin's requested peak
    above its arguments and outputs within the drift gate's band of the
    plan's analytic peak in the twin's bytes."""
    import gc
    import os
    import tempfile

    import torch

    cli = importlib.import_module("repro_torch.analysis.cli")
    census = importlib.import_module("repro_torch.analysis.census")
    core = importlib.import_module("repro_torch.core")
    pn = importlib.import_module("repro_torch.configs.paper_networks")

    planner = core.get_default_planner()
    node_bytes = 4 * NETWORKS_BATCH * NETWORKS_WIDTH
    for name in sorted(pn.NETWORKS):
        # 1. the CLI's own run, at the reference's twin size
        with tempfile.TemporaryDirectory() as tmp:
            drift_path = os.path.join(tmp, "drift.json")
            t0 = time.perf_counter()
            rc = cli.main(["--hlo", "--network", name, "--device", "cuda",
                           "--drift-json", drift_path])
            cli_s = time.perf_counter() - t0
            (rec,) = json.load(open(drift_path))["records"] if rc == 0 else [{}]
        print(f"[networks] {name}: plan_lint --hlo exit {rc} in {cli_s:.2f} s; drift status "
              f"{rec.get('drift_status')}, heavy ops measured {rec.get('heavy_measured')} of "
              f"{rec.get('heavy_expected')} expected; record {json.dumps(rec)}")
        check(rc == 0, f"plan_lint --hlo --network {name} failed")
        check(rec["heavy_measured"] <= rec["heavy_expected"],
              f"{name}: the twin ran more heavy ops than the plan's eq. (1) count")

        # 2. the twin where a node's bytes are real
        g = pn.NETWORKS[name]()
        t0 = time.perf_counter()
        plan = planner.plan(g, None).plan
        plan_s = time.perf_counter() - t0
        _, (params, x), byte_graph = pn.executable_twin(g, NETWORKS_BATCH, NETWORKS_WIDTH,
                                                         device="cuda")
        analytic = core.peak_memory_live(byte_graph, [s.lower_set for s in plan.segments])
        vanilla = core.vanilla_peak(byte_graph, liveness=True)
        band = analytic * (1 + census.DRIFT_REL) + census.DRIFT_ABS_SLACK
        twins = {"planned": pn.twin_value_and_grad(g, plan),
                 "plain": pn.twin_value_and_grad(g, order=pn.plan_order(plan))}
        runs = {}
        for tag, twin in twins.items():
            twin(params, x)  # warm-up: cuBLAS's workspace stays out of the peak
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            requested = torch.cuda.memory_stats()["requested_bytes.all.current"]
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, grads = twin(params, x)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            stats = torch.cuda.memory_stats()
            # above the arguments and, as the census's temp bytes, the outputs
            out = loss.nbytes + sum(t.nbytes for t in grads.values())
            asked = stats["requested_bytes.all.peak"] - requested - out
            held = torch.cuda.max_memory_allocated() - before - out
            runs[tag] = (loss, grads, asked, held, ms)
        same = torch.equal(runs["planned"][0], runs["plain"][0]) and all(
            torch.equal(runs["planned"][1][k], runs["plain"][1][k]) for k in grads)
        (_, _, p_req, p_alloc, p_ms), (_, _, v_req, v_alloc, v_ms) = (runs["planned"],
                                                                      runs["plain"])
        print(f"[networks] {name}: {g.n} nodes, planned in {plan_s:.2f} s at the exact minimal "
              f"budget ({len(plan.segments)} segments, {len(plan.cached)} cached); twin at "
              f"{NETWORKS_BATCH} x {NETWORKS_WIDTH} f32 ({node_bytes} B a node): peak above "
              f"arguments and outputs, requested / allocated, planned {p_req} / {p_alloc} B, "
              f"plain {v_req} / {v_alloc} B, ratio {p_req / v_req:.4f} / "
              f"{p_alloc / v_alloc:.4f}; analytic planned {analytic:.6e} B, vanilla "
              f"{vanilla:.6e} B, ratio {analytic / vanilla:.4f}; requested / analytic "
              f"{p_req / analytic:.4f} (band {band:.6e} B); loss and grads bitwise plain "
              f"autograd in the plan's order: {same}; {p_ms:.1f} ms planned, {v_ms:.1f} ms "
              f"plain")
        check(same, f"{name}: the planned twin's loss or grads differ from plain autograd")
        check(p_req <= band, f"{name}: the planned twin's requested peak {p_req} B is outside "
              f"the drift band {band:.6e} B of the analytic peak")
        results.setdefault("networks", {})[name] = {
            "requested": [p_req, v_req], "allocated": [p_alloc, v_alloc],
            "analytic": [analytic, vanilla]}
        del params, x, twins, runs, grads, loss
        gc.collect()
        torch.cuda.empty_cache()


def rel_l2(got, want) -> float:
    num = sum(float(((a.float() - b.float()) ** 2).sum()) for a, b in zip(got, want))
    den = sum(float((b.float() ** 2).sum()) for b in want)
    return (num / den) ** 0.5


def measured_run(fn, args):
    """One call of a value-and-grad twin on the card: loss (on the host),
    grads, peak above the memory allocated before it, the kernels' launches
    and the host time (ms), the call ending in a synchronize."""
    import gc

    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    loss, grads = fn(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return loss.cpu(), grads, torch.cuda.max_memory_allocated() - before, dict(fa.LAUNCHES), ms


def phase_strategies(results):
    """Storage strategies and donation on the front door's workload: offload
    only at its exact minimal budget, quantize only with effects on, both at
    the recompute-only exact minimal budget against the recompute-only plan
    there, and ``donate=True``.  The strategy plans are memory-centric: the
    time-centric strategy DP's Pareto frontier exhausts memory at full width
    (PERF.md, PR 17)."""
    import gc

    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    core = importlib.import_module("repro_torch.core")
    lowering = importlib.import_module("repro_torch.core.lowering")
    storage = importlib.import_module("repro_torch.core.lowering.storage")
    census = importlib.import_module("repro_torch.analysis.census")

    gc.collect()
    torch.cuda.empty_cache()
    _, _, batch, _, step_loss, params = planned_setup()
    args = (params, batch)
    planner = core.get_default_planner()
    carrier = lowering.TracedCarrier.trace(step_loss, args)
    g = carrier.to_graph()
    flash = {nd.idx for nd in g.nodes if nd.kind == "flash_attention"}
    vanilla = lowering.vanilla_traced_value_and_grad(carrier)
    vanilla(*args)  # warm-up
    l0, g0, peak0, c0, ms0 = measured_run(vanilla, args)
    grad_bytes = sum(t.numel() * t.element_size() for t in g0.values())
    g0 = [g0[k] for k in params]
    print(f"[strategies] vanilla: loss {l0.item():.8f}, peak above resident state {peak0} B "
          f"({peak0 - grad_bytes} B without the parameter grads), {ms0:.1f} ms")
    host = []  # the pinned host copies the offloading twins make
    host_bytes = storage.host_bytes

    def counted(t, memo=None):
        out = host_bytes(t, memo)
        if not any(out is h for h in host):
            host.append(out)
        return out

    def plan(tag, **kw):
        t0 = time.perf_counter()
        pf = lowering.plan_function(step_loss, planner=planner, **kw)
        low = pf.lowered_for(*args)
        s = time.perf_counter() - t0
        p = low.plan
        rec = set().union(*(seg.recompute for seg in p.segments))
        codes = collections.Counter(p.strategy.values())
        print(f"[strategies] {tag}: traced and planned in {s:.2f} s at "
              f"{low.report.budget:.6e} B: DP peak {p.peak_memory:.6e} B, overhead "
              f"{p.overhead:.6g}, {p.num_segments} segments, {len(p.cached)} nodes cached "
              f"({dict(codes)}), {len(rec)} nodes and {len(flash & rec)} flash nodes "
              f"recomputed; offloaded node bytes "
              f"{sum(g.nodes[v].memory for v, c in p.strategy.items() if c == 'offload'):.6e}, "
              f"quantized node bytes "
              f"{sum(g.nodes[v].memory for v, c in p.strategy.items() if c == 'quantize'):.6e}")
        return pf, low, rec

    def timed(tag, pf, low):
        storage.host_bytes = counted
        try:
            pf(*args)  # warm-up: pinned blocks, workspaces
            host.clear()
            out = measured_run(pf, args)
        finally:
            storage.host_bytes = host_bytes
        loss, grads, peak, counts, ms = out
        pinned = sum(h.numel() for h in host)
        host.clear()
        print(f"[strategies] {tag}: loss {loss.item():.8f}; peak above resident state {peak} B "
              f"({peak - grad_bytes} B without the parameter grads; DP peak "
              f"{low.plan.peak_memory:.6e} B); pinned host bytes {pinned}; {ms:.1f} ms; "
              f"launches {json.dumps(counts)}")
        return loss, [grads[k] for k in params], counts, ms, pinned

    def drift(tag, low):
        """The census and drift record of a strategy plan's twin."""
        rec = census.analyze_hlo(low.carrier, low.plan, args=args)
        print(f"[strategies] {tag}: drift record {json.dumps(rec.drift)}; findings "
              f"{sorted({f.code for f in rec.report.findings})}")
        check(rec.report.ok and rec.drift.get("drift_status") == "ok",
              f"the {tag} plan failed the census or the drift gate")

    def bitwise(tag, loss, grads):
        ok = torch.equal(loss, l0) and all(torch.equal(a, b) for a, b in zip(grads, g0))
        print(f"[strategies] {tag}: loss and grads bitwise vanilla: {ok}")
        return ok

    def within_bound(tag, loss, grads):
        lerr, gerr = abs(loss.item() - l0.item()) / abs(l0.item()), rel_l2(grads, g0)
        print(f"[strategies] {tag}: loss rel err {lerr:.3e}, grads rel l2 {gerr:.3e} "
              f"(bound {QUANT_BOUND:g})")
        return lerr <= QUANT_BOUND and gerr <= QUANT_BOUND

    counts_all = collections.Counter()
    mc = dict(method="approx_dp", objective="memory_centric")
    # 1. offload only, at its exact minimal budget
    pf, low, rec = plan("offload only", strategies=("store", "recompute", "offload"), **mc)
    check(set(low.plan.strategy.values()) == {"offload"}, "the offload plan offloads nothing")
    loss, grads, counts, ms, pinned = timed("offload only", pf, low)
    counts_all.update(counts)
    check(bitwise("offload only", loss, grads), "the offload plan's loss or grads differ")
    check(pinned > 0, "the offload plan copied nothing to pinned host memory")
    check(counts["flash_fwd"] == len(flash) + len(flash & rec),
          "flash_fwd launches do not add up to the offload plan's recomputed flash nodes")
    drift("offload only", low)
    del pf, low, grads

    # 2. quantize only, with effects on: the flash nodes are pinned
    pf, low, rec = plan("quantize only, effects on",
                        strategies=("store", "recompute", "quantize"),
                        analyze_effects=True, verify=True, **mc)
    quantized = {v for v, c in low.plan.strategy.items() if c == "quantize"}
    check(bool(quantized), "the quantize plan quantizes nothing")
    check(not quantized & flash and low.carrier.effects.pins == flash,
          "a pinned flash node is quantized")
    loss, grads, counts, ms, _ = timed("quantize only", pf, low)
    counts_all.update(counts)
    print(f"[strategies] quantize only: {len(quantized)} nodes quantized, none of the "
          f"{len(flash)} pinned flash nodes; check_plan ok")
    check(within_bound("quantize only", loss, grads),
          "the quantize plan is outside the documented bound")
    check(counts["flash_fwd"] == len(flash), "a pinned flash node was recomputed")
    drift("quantize only", low)
    del pf, low, grads

    # 3. both, at the recompute-only exact minimal budget, against the
    # recompute-only plan there
    budget = planner.min_feasible_budget(g, "approx_dp")
    pf_r, low_r, _ = plan("recompute only", budget=budget, **mc)
    pf, low, _ = plan("offload + quantize", budget=budget,
                      strategies=("store", "recompute", "offload", "quantize"), **mc)
    rec_out = timed("recompute only", pf_r, low_r)
    out = timed("offload + quantize", pf, low)
    counts_all.update(out[2])
    check(bitwise("recompute only", *rec_out[:2]), "the recompute-only plan differs")
    if "quantize" in low.plan.strategy.values():
        check(within_bound("offload + quantize", *out[:2]),
              "the joint plan is outside the documented bound")
    else:
        check(bitwise("offload + quantize", *out[:2]), "the joint plan differs")
    print(f"[strategies] at {budget:.6e} B: recompute only {rec_out[3]:.1f} ms, "
          f"offload + quantize {out[3]:.1f} ms")
    del pf, low, pf_r, low_r, out, rec_out

    # 4. donate=True, with the census and drift gate
    t0 = time.perf_counter()
    pf = lowering.plan_function(step_loss, donate=True, verify=True, verify_hlo=True,
                                planner=planner)
    low = pf.lowered_for(*args)
    print(f"[strategies] donate: planned and verified in {time.perf_counter() - t0:.2f} s; "
          f"donate_argnums {low.run.donate_argnums}, {len(low.run.donation_hints)} "
          f"windows hinted; drift record {json.dumps(low.hlo.drift)}")
    check(low.hlo.report.ok and low.hlo.drift.get("drift_status") == "ok",
          "the donated twin failed the drift gate")
    loss, grads, counts, ms, _ = timed("donate", pf, low)
    counts_all.update(counts)
    check(bitwise("donate", loss, grads), "the donated twin's loss or grads differ")
    for name in fa.KERNELS:
        results[name]["strategies_launches"] = counts_all[name]
    del pf, low, grads, g0, params, batch, vanilla, carrier
    gc.collect()
    torch.cuda.empty_cache()


def phase_costs(results):
    """The measured cost profile on the card, the launcher's chain planned
    with it, ``cost_model="compiled"`` on the front door's workload, and the
    card's pinned host bandwidth beside the DP's constant."""
    import dataclasses
    import gc
    import tempfile

    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    cm = importlib.import_module("repro_torch.core.cost_model")
    configs = importlib.import_module("repro_torch.configs")
    steps = importlib.import_module("repro_torch.launch.steps")
    mesh = importlib.import_module("repro_torch.launch.mesh")
    lowering = importlib.import_module("repro_torch.core.lowering")
    core = importlib.import_module("repro_torch.core")
    strategies = importlib.import_module("repro_torch.core.strategies")
    costs = importlib.import_module("repro_torch.analysis.costs")
    graph_digest = importlib.import_module("repro_torch.core.graph").graph_digest

    # 1. the profile, measured once and then read from its file
    calls = []

    def profiler(device):
        calls.append(device)
        return cm.profile_ops(device=device)

    fa.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        prof = cm.load_or_profile(cache_dir=tmp, profiler=profiler, device="cuda")
        first_s = time.perf_counter() - t0
        counts = dict(fa.LAUNCHES)
        t0 = time.perf_counter()
        again = cm.load_or_profile(cache_dir=tmp, profiler=profiler, device="cuda")
        second_s = time.perf_counter() - t0
        files = os.listdir(os.path.join(tmp, "profiles"))
    print(f"[costs] profile_ops on the card in {first_s:.3f} s: sec_per_flop_matmul "
          f"{prof.sec_per_flop_matmul:.6e} ({1 / prof.sec_per_flop_matmul / 1e12:.3f} TFLOP/s), "
          f"sec_per_flop_attention {prof.sec_per_flop_attention:.6e} "
          f"({1 / prof.sec_per_flop_attention / 1e12:.3f} TFLOP/s), sec_per_byte_elementwise "
          f"{prof.sec_per_byte_elementwise:.6e} ({1 / prof.sec_per_byte_elementwise / 1e9:.1f} "
          f"GB/s); key {prof.profile_key()}; launches {json.dumps(counts)}")
    print(f"[costs] second load_or_profile in {second_s:.4f} s from {files}: equal {again == prof}")
    check(len(calls) == 1 and again == prof, "the second load_or_profile measured again")
    check(counts["flash_fwd"] > 0, "profile_ops did not time the flash kernel")

    # 2. the launcher's 32-unit chain, analytic and measured
    cfg = configs.get_config("stablelm-3b")
    shape = configs.ShapeConfig("cli", 1024, 2, "train")
    hbm = mesh.device_hbm_bytes()
    plans = {}
    for tag, env in (("analytic", None), ("measured", "1")):
        if env:
            os.environ["REPRO_MEASURED_COSTS"] = env
        t0 = time.perf_counter()
        try:
            plans[tag] = steps.segment_plan(cfg, shape, hbm_bytes=hbm, device="cuda")
        finally:
            os.environ.pop("REPRO_MEASURED_COSTS", None)
        print(f"[costs] launcher chain, {tag} costs: planned in {time.perf_counter() - t0:.2f} s")
    for tag, (sp, res) in plans.items():
        print(f"[costs] launcher chain ({cfg.n_layers} units), {tag} costs: sizes "
              f"{list(sp.sizes)} remat {list(sp.remat)} n_micro {sp.n_micro}; DP peak "
              f"{res.peak_memory:.6e} B, overhead {res.overhead:g}")
    check(all(res.feasible for _, res in plans.values()), "a launcher chain plan is infeasible")

    # 3. cost_model="compiled" on the front door's workload
    gc.collect()
    torch.cuda.empty_cache()
    _, _, batch, _, step_loss, params = planned_setup()
    args = (params, batch)
    t0 = time.perf_counter()
    pf = lowering.plan_function(step_loss, cost_model="compiled",
                                planner=core.get_default_planner())
    low = pf.lowered_for(*args)
    plan_s = time.perf_counter() - t0
    p = low.plan
    rec = set().union(*(s.recompute for s in p.segments))
    g = low.carrier.to_graph()  # FLOP priced: the pilot's graph
    flash = {nd.idx for nd in g.nodes if nd.kind == "flash_attention"}
    # the second phase again by hand: the graph the plan was made on
    planner = core.get_default_planner()
    pilot = planner.plan(g, None, "approx_dp", "time_centric").plan
    profile = dataclasses.replace(cm.DEFAULT_PROFILE, backend=cm.device_key(torch.device("cuda")),
                                  jax_version=torch.__version__, source="compiled")
    seg_costs = costs.extract_segment_costs(low.carrier, pilot)
    cg = cm.compiled_calibrated_graph(g, pilot, seg_costs, profile)
    print(f"[costs] compiled: traced, planned twice and re-priced in {plan_s:.2f} s at "
          f"{low.report.budget:.6e} B: peak {p.peak_memory:.6e} B, overhead {p.overhead:g}, "
          f"{p.num_segments} segments, {len(rec)} nodes and {len(flash & rec)} flash nodes "
          f"recomputed; pilot {pilot.num_segments} segments, {len(seg_costs)} segment costs "
          f"({sum(c['flops'] for c in seg_costs):.6e} FLOP, "
          f"{sum(c['bytes'] for c in seg_costs):.6e} B); re-priced graph digest "
          f"{graph_digest(cg)} (FLOP-priced {graph_digest(g)})")
    check(planner.plan(cg, None, "approx_dp", "time_centric").plan == p,
          "the compiled plan is not the DP's plan on the re-priced graph")
    vanilla = lowering.vanilla_traced_value_and_grad(low.carrier)
    pf(*args)  # warm-up
    l1, g1, peak1, c1, ms1 = measured_run(pf, args)
    l0, g0, _, _, ms0 = measured_run(vanilla, args)
    ok = torch.equal(l0, l1) and all(torch.equal(g1[k], g0[k]) for k in g0)
    print(f"[costs] compiled: loss {l1.item():.8f}, loss and grads bitwise vanilla {ok}; "
          f"{ms1:.1f} ms (vanilla {ms0:.1f}); launches {json.dumps(c1)}")
    check(ok, "the compiled-cost plan's loss or grads differ")
    check(c1["flash_fwd"] - len(flash) == len(flash & rec),
          "flash_fwd launches do not add up to the compiled plan's recomputed flash nodes")
    for name in fa.KERNELS:
        results[name]["costs_launches"] = counts[name] + c1[name]
    del pf, low, g0, g1, vanilla

    # 4. the card's pinned host bandwidth beside the DP's constant
    for nbytes in BANDWIDTH_BYTES:
        dev_buf = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
        host_buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        d2h = time_ms(lambda: host_buf.copy_(dev_buf, non_blocking=True), iters=10)
        h2d = time_ms(lambda: dev_buf.copy_(host_buf, non_blocking=True), iters=10)
        print(f"[costs] pinned copies of {nbytes} B: card to host {d2h:.4f} ms "
              f"({nbytes / d2h * 1e3:.4e} B/s), host to card {h2d:.4f} ms "
              f"({nbytes / h2d * 1e3:.4e} B/s); the DP prices "
              f"{strategies.DEFAULT_HOST_BYTES_PER_SEC:.4e} B/s")
        del dev_buf, host_buf
    gc.collect()
    torch.cuda.empty_cache()


def phase_ckpt(results):
    """Checkpoint/restart of the launcher's Trainer at full width, cut to
    ``CKPT_UNITS`` units: 4 steps uninterrupted, against 2 steps that
    checkpoint and a fresh Trainer that restores them and runs 2 more."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    configs = importlib.import_module("repro_torch.configs")
    models = importlib.import_module("repro_torch.models")
    data = importlib.import_module("repro_torch.data")
    train = importlib.import_module("repro_torch.train")
    steps = importlib.import_module("repro_torch.launch.steps")
    mesh = importlib.import_module("repro_torch.launch.mesh")
    adamw = importlib.import_module("repro_torch.optim.adamw")

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get_config("stablelm-3b"), n_layers=CKPT_UNITS)
    shape = configs.ShapeConfig("cli", 1024, 2, "train")
    sp, _ = steps.segment_plan(cfg, shape, hbm_bytes=mesh.device_hbm_bytes(dev))
    stream = data.SyntheticLM(data.DataConfig(cfg.vocab_size, 1024, 2))

    def trainer(ckpt_dir, total):
        model = models.build_model(cfg, device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(0))
        tc = train.TrainConfig(
            total_steps=total, ckpt_dir=ckpt_dir, ckpt_every=2, log_every=0,
            optimizer=adamw.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=4))
        return train.Trainer(lambda m, b: m.loss(b, sp.sizes, sp.remat), model, tc, device=dev)

    def state(tr):
        return tr.params + tr.opt_state.mu + tr.opt_state.nu

    tmp = tempfile.mkdtemp()
    try:
        fa.reset_launch_counts()
        whole = trainer(None, 4)
        n_params = sum(p.numel() for p in whole.params)
        out = whole.run(stream.batch(i) for i in range(4))
        t0 = time.perf_counter()
        head_tr = trainer(tmp, 2)
        head = head_tr.run(stream.batch(i) for i in range(2))
        head_tr.close()
        head_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(tmp) for f in fs)
        del head_tr
        gc.collect()
        t0 = time.perf_counter()
        tail_tr = trainer(tmp, 4)
        restored = tail_tr.maybe_restore()
        restore_s, restored_step = time.perf_counter() - t0, tail_tr.step
        tail = tail_tr.run(stream.batch(i) for i in range(tail_tr.step, 4))
        tail_tr.close()
        counts = dict(fa.LAUNCHES)
        kept = sorted(os.listdir(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = head["losses"] + tail["losses"]
    same = all(torch.equal(a, b) for a, b in zip(state(tail_tr), state(whole)))
    print(f"[ckpt] {CKPT_UNITS} units at full width, {n_params} parameters; checkpoint "
          f"of step 2: {size} B on disk; a Trainer built, 2 steps run and saved in "
          f"{head_s:.2f} s; a fresh Trainer built and restored in {restore_s:.2f} s "
          f"(restored {restored}, step {restored_step}); directory after the run {kept}")
    print(f"[ckpt] losses uninterrupted {out['losses']}, restarted {losses}")
    print(f"[ckpt] losses bitwise {losses == out['losses']}; params and AdamW moments "
          f"bitwise {same}; step {tail_tr.opt_state.step} vs {whole.opt_state.step}; "
          f"launches {json.dumps(counts)}")
    check(restored and restored_step == 2 and losses == out["losses"] and same
          and tail_tr.opt_state.step == whole.opt_state.step == 4,
          "the restarted run differs from the uninterrupted one")
    check(not os.path.exists(tmp), "the checkpoint directory was not removed")
    for name in fa.KERNELS:
        results[name]["ckpt_launches"] = counts[name]
    del whole, tail_tr
    gc.collect()
    torch.cuda.empty_cache()


def serve_run(tag: str, args, launches=None) -> dict:
    """``repro_torch.launch.serve`` with ``args`` at full width: every decode
    step's logits checked finite on the device (read once at the end);
    prints requests, tokens, step times, peak memory, KV-cache bytes and
    the kernels' launches, and fails unless every request completes with
    its 64 tokens and the kernels launched ``launches`` times (none by
    default: decode is plain PyTorch, as in the reference; an
    encoder-decoder engine runs its encoder once).  Returns the launcher's
    result and the launch counts."""
    import gc

    import numpy as np
    import torch
    import torch.utils._pytree as pytree

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    serve = importlib.import_module("repro_torch.launch.serve")
    models = importlib.import_module("repro_torch.models")
    gc.collect()
    torch.cuda.empty_cache()

    finite = []
    decode_steps = {cls: cls.decode_step for cls in (models.LM, models.WhisperModel)}

    def watched(decode_step):
        def checked(self, tokens, caches, position):
            logits, caches = decode_step(self, tokens, caches, position)
            finite.append(torch.isfinite(logits).all())
            return logits, caches
        return checked

    for cls, decode_step in decode_steps.items():
        cls.decode_step = watched(decode_step)
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        out = serve.main(args)
    finally:
        for cls, decode_step in decode_steps.items():
            cls.decode_step = decode_step
    counts = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    eng, done = out["engine"], out["completed"]
    cache_bytes = sum(t.numel() * t.element_size() for t in pytree.tree_leaves(eng.caches))
    ms = np.array(out["step_seconds"]) * 1e3
    tokens = sum(len(r.output) for r in done)
    all_finite = bool(torch.stack(finite).all())
    print(f"[{tag}] serve {eng.model.cfg.name}: {len(done)} requests, {tokens} tokens, "
          f"{out['steps']} engine steps in {out['seconds']:.4f} s: "
          f"{tokens / out['seconds']:.1f} output tok/s")
    print(f"[{tag}] step ms: first {ms[0]:.4f}, median {np.median(ms):.4f}, p90 "
          f"{np.percentile(ms, 90):.4f}, min {ms.min():.4f}, max {ms.max():.4f}")
    print(f"[{tag}] max_memory_allocated {peak} B ({peak / total:.3f} of {total} B); "
          f"KV cache {cache_bytes} B")
    print(f"[{tag}] launches {json.dumps(counts)}; all logits finite {all_finite}")
    check(len(done) == 16 and all(len(r.output) == 64 for r in done),
          "a request did not complete with its 64 tokens")
    check(all_finite, "a decode step gave a non-finite logit")
    check(peak < 0.9 * total, "serving took more than 0.9 of the card's memory")
    want = {name: (launches or {}).get(name, 0) for name in fa.KERNELS}
    check(counts == want, f"the engine launched the kernels {counts} times, not {want}")
    return out, counts


def routes_watched():
    """Wrap ``models.moe._pack`` so that each dispatch appends its kept-route
    mask (on the device) to the returned list; returns (list, undo)."""
    moe = importlib.import_module("repro_torch.models.moe")
    pack, kept = moe._pack, []

    def watched(*a, **kw):
        out = pack(*a, **kw)
        kept.append(out[3])
        return out

    moe._pack = watched
    return kept, lambda: setattr(moe, "_pack", pack)


def blockwise_gaps(model, toks) -> list:
    """Each block decoded step by step on the forward's own inputs to that
    block, against the block's forward: [(block, max |gap|, mean |gap|,
    max |output|)].  An error of one block does not enter the next, so a
    model that amplifies rounding with depth is held block by block."""
    import torch

    layers = importlib.import_module("repro_torch.models.layers")
    dev, T = toks.device, toks.shape[1]
    out = []
    with torch.no_grad():
        h = layers.embed(model.embedding.embed, toks, model.cfg.activation_dtype)
        h0, pos = h, torch.arange(T, device=dev)[None]
        caches = model.init_caches(1, T)
        units = caches["units"] if model.has_shared else caches
        for u, unit in enumerate(model.layers):
            for name in unit.steps:
                if name is None:
                    block, cache = model.shared_attn, {k: t[u] for k, t in caches["shared"].items()}
                    full = block(h, h0, pos)
                    steps = [block.decode(h[:, t:t + 1], h0[:, t:t + 1], cache,
                                          torch.tensor([t], device=dev)) for t in range(T)]
                else:
                    block, cache = getattr(unit, name), {k: t[u] for k, t in units[name].items()}
                    full = block(h, pos)
                    steps = [block.decode(h[:, t:t + 1], cache, torch.tensor([t], device=dev))
                             for t in range(T)]
                gap = (torch.cat(steps, 1) - full).abs()
                out.append((f"unit {u} {name or 'shared_attn'}", gap.max().item(),
                            gap.mean().item(), full.abs().max().item()))
                h = full
    return out


def teacher_forcing(tag: str, arch: str, n_tokens: int, blockwise: bool = False,
                    seed: int = 5, units: int = None) -> None:
    """Step-by-step decode of ``n_tokens`` tokens against ``LM.forward`` at
    full width, in f32 and bf16, under the ``TEACHER_*`` limits; the forward
    launches ``flash_fwd`` once per attention block (once a unit).  An MoE
    forward must drop no route: decode (one token a step) never does.

    ``blockwise``: the limits hold each block decoded on the forward's own
    inputs (``blockwise_gaps``), and the f32 logits only to the greedy
    agreement limit.  For a model that amplifies rounding with depth, as
    zamba2 does at its random init (ROADMAP.md §3: the reference's own
    decode at one unit of it differs from its forward by 9.8e-4 in f32;
    at 9 units the port's f32 gap grows from 6.3e-5 after the first block
    to 0.81, and bf16's blocks, each within the bf16 limits, compose into
    logits whose greedy tokens agree at 0.02), the logits' gap measures
    the amplification, not the decode."""
    import dataclasses
    import gc

    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    configs = importlib.import_module("repro_torch.configs")
    models = importlib.import_module("repro_torch.models")
    dev = torch.device("cuda")
    base = cut_depth(configs.get_config(arch), units)
    toks = torch.randint(0, base.vocab_size, (1, n_tokens),
                         generator=torch.Generator().manual_seed(seed)).to(dev)
    for dtn in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtn)
        model = models.build_model(cfg, device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(0))
        fa.reset_launch_counts()
        kept, undo = routes_watched()
        try:
            with torch.no_grad():
                full = model(toks)
        finally:
            undo()
        counts = dict(fa.LAUNCHES)
        dropped = int(sum((~k).sum() for k in kept)) if kept else 0
        caches = model.init_caches(1, n_tokens)
        stepwise = torch.stack([
            model.decode_step(toks[:, t:t + 1], caches, torch.tensor([t], device=dev))[0][:, 0]
            for t in range(n_tokens)], 1)
        gap = (stepwise - full).abs()
        worst, mean = gap.max().item(), gap.mean().item()
        agree = (stepwise.argmax(-1) == full.argmax(-1)).float().mean().item()
        print(f"[{tag}] teacher forcing {arch} {dtn}, {n_tokens} tokens: max |gap| "
              f"{worst:.4e}, mean |gap| {mean:.4e}, greedy agreement {agree:.4f}; forward "
              f"launches {json.dumps(counts)}; logits max |x| {full.abs().max().item():.4f}"
              + (f"; routes dropped by the forward {dropped} of "
                 f"{sum(k.numel() for k in kept)}" if kept else ""))
        check(counts["flash_fwd"] == model.n_units * attention_blocks(cfg),
              "the forward did not launch flash_fwd once an attention block")
        check(dropped == 0, "the forward dropped routes that decode keeps")
        if blockwise:
            blocks = blockwise_gaps(model, toks)
            name, worst, _, size = max(blocks, key=lambda b: b[1])
            mean = max(b[2] for b in blocks)
            print(f"[{tag}] block by block, {len(blocks)} blocks: worst max |gap| {worst:.4e} "
                  f"({name}, max |output| {size:.4e}), worst mean |gap| {mean:.4e}; first "
                  f"{blocks[0][1]:.4e}, last {blocks[-1][1]:.4e}")
            if dtn == "float32":
                check(agree >= TEACHER_BF16_AGREE,
                      "decode's greedy tokens differ from the forward's")
        if dtn == "float32":
            check(worst <= TEACHER_F32_TOL, "f32 decode differs from the forward")
        else:
            check(worst <= TEACHER_BF16_MAX and mean <= TEACHER_BF16_MEAN
                  and (blockwise or agree >= TEACHER_BF16_AGREE),
                  "bf16 decode differs from the forward")
        del model, caches, full, stepwise, gap
        gc.collect()
        torch.cuda.empty_cache()


def phase_serve(results):
    """The serving launcher at full width, then step-by-step decode against
    the full forward on the same tokens."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    out, counts = serve_run("serve", SERVE_ARGS)
    for name in fa.KERNELS:
        results[name]["serve_launches"] = counts[name]

    # Where a step's time goes: the engine's decode step (its model, caches
    # and last positions) and the logits' copy to the host, under the profiler
    eng = out["engine"]
    tokens = torch.ones(eng.max_slots, 1, dtype=torch.int64, device=eng.device)
    position = torch.from_numpy(eng.positions).to(eng.device, torch.int64)
    eng.model.decode_step(tokens, eng.caches, position)[0].cpu()  # warm-up
    n = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.model.decode_step(tokens, eng.caches, position)[0].cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    print_device_time("serve", f"one decode step (mean of {n}, profiled)", prof, wall_ms, n)
    del out, eng, prof
    gc.collect()
    torch.cuda.empty_cache()
    teacher_forcing("serve", "stablelm-3b", TEACHER_TOKENS)


def family_launcher(results, tag: str, arch: str, units: int = None):
    """``repro_torch.launch.train`` at full width of ``arch``, at full depth
    or ``units`` units (``--layers``), for 3
    steps (batch 2, seq 1024), budgeted from the card's memory: plan, step
    times, peak against the card, the kernels' launches (one attention
    block a unit), finite losses and, for an MoE, the share of routes
    dropped at capacity.  Returns the plan."""
    import gc

    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    train = importlib.import_module("repro_torch.launch.train")
    configs = importlib.import_module("repro_torch.configs")
    moe = importlib.import_module("repro_torch.models.moe")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = cut_depth(configs.get_config(arch), units)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    kept, undo = routes_watched()
    try:
        out = train.main(["--arch", arch, "--steps", "3", "--batch", "2", "--seq", "1024",
                          "--layers", str(cfg.n_layers)])
    finally:
        undo()
    counts = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    sp, res = out["plan"], out["plan_result"]
    check(sp is not None and res.feasible, "the launcher made no feasible plan")
    n, steps = out["n_units"], out["step"]
    recomputed = sum(s for s, r in zip(sp.sizes, sp.remat) if r)
    per_unit = attention_blocks(cfg)
    print(f"[{tag}] {arch}: {cfg.num_params()} parameters, {n} units; plan: sizes "
          f"{list(sp.sizes)} remat {list(sp.remat)} n_micro {sp.n_micro}; DP peak "
          f"{res.peak_memory:.4e} B, overhead {res.overhead:g}")
    for i, (loss, dt) in enumerate(zip(out["losses"], out["step_seconds"])):
        print(f"[{tag}] step {i + 1} loss {loss:.6f} time {dt:.4f} s")
    print(f"[{tag}] max_memory_allocated {peak} B ({peak / total:.3f} of {total} B)")
    print(f"[{tag}] launches {json.dumps(counts)} over {steps} steps of {n} units "
          f"({recomputed} recomputed per step)")
    if cfg.moe is not None:
        routes = sum(k.numel() for k in kept)
        dropped = int(sum((~k).sum() for k in kept))
        T = 2 * 1024
        print(f"[{tag}] MoE dispatches {len(kept)}: {dropped} of {routes} routes dropped "
              f"({dropped / routes:.4f}) at capacity {moe.capacity(cfg.moe, T)}, mean load "
              f"{T * cfg.moe.top_k / cfg.moe.num_experts:g} routes an expert")
    check(steps == 3 and out["skipped"] == 0, "a launcher step was skipped")
    check(all(math.isfinite(x) for x in out["losses"]), "non-finite launcher loss")
    check(counts["flash_fwd"] == steps * per_unit * (n + recomputed),
          "flash_fwd launches do not match the units run and recomputed")
    check(counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == steps * per_unit * n,
          "backward kernel launches do not match the units run")
    check(peak < 0.9 * total, "the launcher took more than 0.9 of the card's memory")
    for name, c in counts.items():
        results[name][f"{tag}_launches"] = c
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return sp


def front_door(results, tag: str, arch: str, n_units: int, seq: int = 1024,
               batch_size: int = 2, extra=None) -> None:
    """``plan_function`` on ``arch``'s loss at full width and ``n_units``
    units (layers on each side for whisper), at the exact minimal budget,
    against plain autograd on the same weights and batch (``batch_size`` x
    ``seq`` tokens, and ``extra(cfg, device)``'s entries): the loss bitwise;
    the grads bitwise those of plain autograd run in the plan's node order
    (``vanilla_traced_value_and_grad`` with the plan), and beside plain
    autograd in the trace's order; one more ``flash_fwd`` per recomputed
    flash node; a lower peak above resident state."""
    import dataclasses
    import gc

    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    configs = importlib.import_module("repro_torch.configs")
    models = importlib.import_module("repro_torch.models")
    data = importlib.import_module("repro_torch.data")
    train = importlib.import_module("repro_torch.train")
    lowering = importlib.import_module("repro_torch.core.lowering")
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    base = configs.get_config(arch)
    per_unit = base.n_layers // models.unit_pattern(base)[1]  # layers a unit
    cfg = dataclasses.replace(base, n_layers=n_units * per_unit)
    model = models.build_model(cfg, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    host = data.SyntheticLM(data.DataConfig(cfg.vocab_size, seq, batch_size)).batch(0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    if extra is not None:
        batch.update(extra(cfg, dev))
    n = model.n_units
    step_loss, params = train.functional_loss(lambda m, b: m.loss(b, (n,), (False,)), model)

    t0 = time.perf_counter()
    planned = lowering.plan_function(step_loss)  # the exact minimal budget
    lowered = planned.lowered_for(params, batch)
    plan_s = time.perf_counter() - t0
    plan, carrier = lowered.plan, lowered.carrier
    g = carrier.to_graph()
    flash = {nd.idx for nd in g.nodes if nd.kind == "flash_attention"}
    rec = set().union(*(s.recompute for s in plan.segments))
    rec_flash = flash & rec
    widest = max(range(g.n), key=lambda v: len(g.succ[v]))
    print(f"[{tag}] front door {arch} at {n} unit(s): {g.n} nodes ({len(flash)} "
          f"flash_attention), widest fan-out {len(g.succ[widest])} (node {widest}, "
          f"{g.nodes[widest].kind}, read by {sorted({g.nodes[w].kind for w in g.succ[widest]})})"
          f"; traced and planned in {plan_s:.2f} s; "
          f"exact minimal budget {lowered.report.budget:.6e} B, peak {plan.peak_memory:.6e} B, "
          f"overhead {plan.overhead:g} of {g.total_time:g}, {plan.num_segments} segments, "
          f"{len(rec)} nodes and {len(rec_flash)} flash nodes recomputed")

    def run(fn):
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        loss, grads = fn(params, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - before
        return loss.cpu(), grads, peak, dict(fa.LAUNCHES), ms

    planned(params, batch)  # warm-up
    runs = {"vanilla": run(lowering.vanilla_traced_value_and_grad(carrier)),
            "plan-order": run(lowering.vanilla_traced_value_and_grad(carrier, plan)),
            "planned": run(planned)}
    for name, (loss, _, peak, c, ms) in runs.items():
        print(f"[{tag}] {name:10s} loss {loss.item():.8f}; peak above resident state {peak} B; "
              f"launches {json.dumps(c)}; {ms:.1f} ms")
    (l0, g0, peak0, c0, _), (l2, g2, _, _, _), (l1, g1, peak1, c1, _) = runs.values()
    ordered = all(torch.equal(g1[k], g2[k]) for k in g2)
    print(f"[{tag}] loss bitwise {torch.equal(l0, l1)}; grads bitwise plain autograd in the "
          f"plan's order {ordered}")
    grads_ok = grads_agree(tag, [g1[k] for k in g0], list(g0.values()))
    check(torch.equal(l0, l1) and torch.equal(l0, l2), "planned loss differs from vanilla")
    check(ordered, "planned grads differ from plain autograd in the plan's order")
    check(grads_ok, "planned grads differ from vanilla beyond rtol 1e-3")
    check(c1["flash_fwd"] - c0["flash_fwd"] == len(rec_flash),
          "planned flash_fwd launches do not add up to the plan's recomputed flash nodes")
    check(c1["flash_bwd_dq"] == c0["flash_bwd_dq"] == len(flash)
          and c1["flash_bwd_dkv"] == c0["flash_bwd_dkv"] == len(flash),
          "backward kernel launches differ between the planned and vanilla runs")
    check(peak1 < peak0, "the planned run did not lower the measured peak")
    for name in fa.KERNELS:
        results[name][f"{tag}_planned_launches"] = c1[name]
    del runs, g0, g1, g2, planned, lowered, carrier, model, params
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe(results):
    """granite-moe-3b-a800m: the launcher at full width and depth, the front
    door at 4 units, the serving launcher, and decode against the forward on
    an 8-token prefix, whose capacity (8) holds every token."""
    arch = "granite-moe-3b-a800m"
    configs = importlib.import_module("repro_torch.configs")
    sp = family_launcher(results, "moe", arch)
    profile_step("moe", configs.get_config(arch), sp.sizes, sp.remat)
    front_door(results, "moe", arch, MOE_PLANNED_UNITS)
    _, counts = serve_run("moe", ["--arch", arch] + SERVE_ARGS)
    for name in counts:
        results[name]["moe_serve_launches"] = counts[name]
    teacher_forcing("moe", arch, MOE_TEACHER_TOKENS)


def cut_depth(cfg, units: int = None):
    """``cfg`` at ``units`` units (the same layers a unit), full width; the
    whole depth for None."""
    import dataclasses

    if units is None:
        return cfg
    models = importlib.import_module("repro_torch.models")
    per_unit = cfg.n_layers // models.unit_pattern(cfg)[1]
    return dataclasses.replace(cfg, n_layers=units * per_unit)


def phase_hybrid(results):
    """zamba2-2.7b at full width: the launcher, a profiled step, the
    serving launcher and teacher forcing at ``HYBRID_UNITS`` units of 6
    Mamba2 blocks and the shared block (9 at full depth), and the front
    door on its non-chain graph at 1 unit."""
    arch = "zamba2-2.7b"
    configs = importlib.import_module("repro_torch.configs")
    cfg = cut_depth(configs.get_config(arch), HYBRID_UNITS)
    sp = family_launcher(results, "hybrid", arch, HYBRID_UNITS)
    profile_step("hybrid", cfg, sp.sizes, sp.remat)
    _, counts = serve_run("hybrid", ["--arch", arch, "--layers", str(cfg.n_layers)]
                          + SERVE_ARGS)
    for name in counts:
        results[name]["hybrid_serve_launches"] = counts[name]
    teacher_forcing("hybrid", arch, TEACHER_TOKENS, blockwise=True, units=HYBRID_UNITS)
    front_door(results, "hybrid", arch, HYBRID_PLANNED_UNITS)


def phase_xlstm(results):
    """xlstm-1.3b (7 mLSTM blocks and 1 sLSTM block a unit, no attention)
    at full width: the launcher, a profiled step, the serving launcher and
    teacher forcing at ``XLSTM_UNITS`` units (6 at full depth), and the
    front door at 1 unit; no kernel launches anywhere."""
    arch = "xlstm-1.3b"
    configs = importlib.import_module("repro_torch.configs")
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    cfg = cut_depth(configs.get_config(arch), XLSTM_UNITS)
    sp = family_launcher(results, "xlstm", arch, XLSTM_UNITS)
    profile_step("xlstm", cfg, sp.sizes, sp.remat)
    _, counts = serve_run("xlstm", ["--arch", arch, "--layers", str(cfg.n_layers)]
                          + SERVE_ARGS)
    for name in counts:
        results[name]["xlstm_serve_launches"] = counts[name]
    teacher_forcing("xlstm", arch, TEACHER_TOKENS, blockwise=XLSTM_BLOCKWISE,
                    units=XLSTM_UNITS)
    front_door(results, "xlstm", arch, XLSTM_PLANNED_UNITS, seq=XLSTM_PLANNED_SEQ)
    check(not any(results[name][key] for name in fa.KERNELS
                  for key in ("xlstm_launches", "xlstm_serve_launches",
                              "xlstm_planned_launches")),
          "an xLSTM path launched an attention kernel")


def whisper_frames(cfg, step: int, batch: int, dev):
    """The audio stub's frames (batch, 1500, d_model) in f32, drawn on the
    card from a generator seeded ``step``."""
    import torch

    return torch.randn((batch, cfg.frontend_seq, cfg.d_model), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(step))


def whisper_batch(cfg, step: int, batch: int, dev) -> dict:
    """Batch ``step`` of whisper's training stream: the reference pipeline's
    tokens and labels (``batch`` x ``WHISPER_TOKENS``) and their frames."""
    data = importlib.import_module("repro_torch.data")
    out = dict(data.SyntheticLM(data.DataConfig(cfg.vocab_size, WHISPER_TOKENS,
                                                batch)).batch(step))
    out["frames"] = whisper_frames(cfg, step, batch, dev)
    return out


def train_family(results, tag: str, cfg, loss_fn, batches, per_step: dict,
                 plan=None) -> None:
    """3 Trainer steps of ``cfg`` at full width on ``loss_fn`` over
    ``batches(step)``: losses, step times, the peak against the card, the
    kernels' launches (``per_step`` of each a step), then a profiled step.
    ``plan`` = (sizes, remat, DP result) is printed beside the peak."""
    import gc

    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    models = importlib.import_module("repro_torch.models")
    train = importlib.import_module("repro_torch.train")
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    model = models.build_model(cfg, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    tr = train.Trainer(loss_fn, model, train.TrainConfig(total_steps=3, log_every=0),
                       device=dev)
    torch.cuda.synchronize()
    state = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    out = tr.run(batches(i) for i in range(3))
    counts = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[{tag}] {cfg.name}: {n_params} parameters ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}), {state} B on the card before the first step")
    if plan is not None:
        sizes, remat, res = plan
        print(f"[{tag}] plan: sizes {list(sizes)} remat {list(remat)}; DP peak "
              f"{res.peak_memory:.4e} B above state, overhead {res.overhead:g}; measured "
              f"{peak - state} B above the parameters and moments")
    for i, (loss, dt) in enumerate(zip(out["losses"], out["step_seconds"])):
        print(f"[{tag}] step {i + 1} loss {loss:.6f} grad norm {out['grad_norms'][i]:.4f} "
              f"time {dt:.4f} s")
    print(f"[{tag}] max_memory_allocated {peak} B ({peak / total:.3f} of {total} B)")
    print(f"[{tag}] launches {json.dumps(counts)} over 3 steps")
    check(out["skipped"] == 0 and all(math.isfinite(x) for x in out["losses"]),
          "a step was skipped or gave a non-finite loss")
    check(counts == {k: 3 * n for k, n in per_step.items()},
          f"the kernels launched {counts} times, not {per_step} a step")
    check(peak < 0.9 * total, "training took more than 0.9 of the card's memory")
    for name, c in counts.items():
        results[name][f"{tag}_launches"] = c
    profile_trainer(tag, tr, batches(3), batches(4))
    del tr, model, out
    gc.collect()
    torch.cuda.empty_cache()


def teacher_forcing_whisper(tag: str, n_tokens: int, seed: int = 5) -> None:
    """whisper-small's step-by-step decode of ``n_tokens`` tokens (caches
    from ``init_caches``, which encodes the clip) against ``decode_train``
    on the same encoder output, in f32 and bf16, under the ``TEACHER_*``
    limits."""
    import dataclasses
    import gc

    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    configs = importlib.import_module("repro_torch.configs")
    models = importlib.import_module("repro_torch.models")
    dev = torch.device("cuda")
    base = configs.get_config("whisper-small")
    toks = torch.randint(0, base.vocab_size, (1, n_tokens),
                         generator=torch.Generator().manual_seed(seed)).to(dev)
    frames = torch.randn((1, base.frontend_seq, base.d_model), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(seed))
    L = base.n_layers
    for dtn in ("float32", "bfloat16"):
        model = models.build_model(dataclasses.replace(base, dtype=dtn), device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(0))
        fa.reset_launch_counts()
        with torch.no_grad():
            full = model.decode_train(toks, model.encode(frames))
        counts = dict(fa.LAUNCHES)
        caches = model.init_caches(frames, n_tokens)
        stepwise = torch.stack([
            model.decode_step(toks[:, t:t + 1], caches, torch.tensor([t], device=dev))[0][:, 0]
            for t in range(n_tokens)], 1)
        gap = (stepwise - full).abs()
        worst, mean = gap.max().item(), gap.mean().item()
        agree = (stepwise.argmax(-1) == full.argmax(-1)).float().mean().item()
        print(f"[{tag}] teacher forcing whisper-small {dtn}, {n_tokens} tokens on one clip: "
              f"max |gap| {worst:.4e}, mean |gap| {mean:.4e}, greedy agreement {agree:.4f}; "
              f"encode + decode_train launches {json.dumps(counts)}; logits max |x| "
              f"{full.abs().max().item():.4f}")
        check(counts["flash_fwd"] == 3 * L, "the forward did not launch flash_fwd once an "
              "attention (encoder, self, cross)")
        if dtn == "float32":
            check(worst <= TEACHER_F32_TOL, "f32 decode differs from the forward")
        else:
            check(worst <= TEACHER_BF16_MAX and mean <= TEACHER_BF16_MEAN
                  and agree >= TEACHER_BF16_AGREE, "bf16 decode differs from the forward")
        del model, caches, full, stepwise, gap
        gc.collect()
        torch.cuda.empty_cache()


def phase_whisper(results):
    """whisper-small (12 encoder + 12 decoder layers): the Trainer on
    ``WhisperModel.loss`` at batch 8 (1500 frames, 448 tokens) with the
    reference's default segmentation, the serving launcher with frames,
    teacher forcing, and the front door on its non-chain graph."""
    import torch

    configs = importlib.import_module("repro_torch.configs")
    models = importlib.import_module("repro_torch.models")
    arch = "whisper-small"
    cfg = configs.get_config(arch)
    dev = torch.device("cuda")
    L = cfg.n_layers
    # no plan: the reference's default, sqrt(L) segments, each rematerialized
    sizes = models.default_segments(L)
    recomputed = sum(sizes) if len(sizes) > 1 else 0
    print(f"[whisper] segments {list(sizes)} on each side, all rematerialized")
    fwd = 3 * L + recomputed * 3  # encoder, self and cross attention, and their reruns
    train_family(results, "whisper", cfg, lambda m, b: m.loss(b),
                 lambda i: whisper_batch(cfg, i, WHISPER_BATCH, dev),
                 {"flash_fwd": fwd, "flash_bwd_dq": 3 * L, "flash_bwd_dkv": 3 * L})
    _, counts = serve_run("whisper", WHISPER_SERVE_ARGS, launches={"flash_fwd": L})
    for name in counts:
        results[name]["whisper_serve_launches"] = counts[name]
    teacher_forcing_whisper("whisper", TEACHER_TOKENS)
    front_door(results, "whisper", arch, WHISPER_PLANNED_LAYERS, seq=WHISPER_TOKENS,
               extra=lambda c, d: {"frames": whisper_frames(c, 0, 2, d)})


def vision_prefix(cfg, step: int, batch: int, dev):
    """The vision stub's patch embeddings (batch, 576, d_model) in bf16,
    drawn on the card from a generator seeded 1000 + ``step``."""
    import torch

    return torch.randn((batch, cfg.frontend_seq, cfg.d_model), device=dev,
                       dtype=torch.bfloat16,
                       generator=torch.Generator(device=dev).manual_seed(1000 + step))


def phase_vision(results):
    """phi-3-vision-4.2b (32 layers, d_model 3072, heads of 96): the Trainer
    on batches carrying the 576-patch prefix (S = 1600) under the
    launcher's own plan for that length, the serving launcher (text-only,
    as the reference engine serves it), and the front door at 2 units with
    the prefix."""
    import torch

    configs = importlib.import_module("repro_torch.configs")
    data = importlib.import_module("repro_torch.data")
    steps = importlib.import_module("repro_torch.launch.steps")
    mesh = importlib.import_module("repro_torch.launch.mesh")
    arch = "phi-3-vision-4.2b"
    cfg = configs.get_config(arch)
    dev = torch.device("cuda")
    S = cfg.frontend_seq + 1024
    sp, res = steps.segment_plan(cfg, configs.ShapeConfig("vision", S, 2, "train"),
                                 hbm_bytes=mesh.device_hbm_bytes(), device="cuda")
    check(sp is not None and res.feasible, "the launcher's planner made no feasible plan")
    n = sum(sp.sizes)
    recomputed = sum(s for s, r in zip(sp.sizes, sp.remat) if r)
    print(f"[vision] {cfg.n_layers} layers; segment_plan at seq {S}: sizes "
          f"{list(sp.sizes)} remat {list(sp.remat)} n_micro {sp.n_micro}")
    stream = data.SyntheticLM(data.DataConfig(cfg.vocab_size, 1024, 2))

    def batches(i):
        return dict(stream.batch(i), extra_embeds=vision_prefix(cfg, i, 2, dev))

    train_family(results, "vision", cfg,
                 lambda m, b: m.loss(b, sp.sizes, sp.remat), batches,
                 {"flash_fwd": n + recomputed, "flash_bwd_dq": n, "flash_bwd_dkv": n},
                 plan=(sp.sizes, sp.remat, res))
    _, counts = serve_run("vision", ["--arch", arch] + SERVE_ARGS)
    for name in counts:
        results[name]["vision_serve_launches"] = counts[name]
    front_door(results, "vision", arch, VISION_PLANNED_UNITS,
               extra=lambda c, d: {"extra_embeds": vision_prefix(c, 0, 2, d)})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found; run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    results, state = {}, {}
    phases = [
        ("build", phase_build),
        ("kernels", lambda: phase_kernels(results)),
        ("production_dryrun", lambda: phase_production_dryrun(state)),
        ("launcher", lambda: phase_launcher(results, state)),
        ("witness", lambda: phase_witness(state)),
        ("profile", lambda: phase_profile(state)),
        ("trade", lambda: phase_trade(state)),
        ("planned", lambda: phase_planned(results, state)),
        ("policy", lambda: phase_policy(results)),
        ("mesh", lambda: phase_mesh(results, state)),
        ("model_axis", lambda: phase_model_axis(results)),
        ("axis_serve", lambda: phase_axis_serve(results)),
        ("production", lambda: phase_production(results)),
        ("analysis", lambda: phase_analysis(results, state)),
        ("networks", lambda: phase_networks(results)),
        ("strategies", lambda: phase_strategies(results)),
        ("costs", lambda: phase_costs(results)),
        ("ckpt", lambda: phase_ckpt(results)),
        ("serve", lambda: phase_serve(results)),
        ("moe", lambda: phase_moe(results)),
        ("hybrid", lambda: phase_hybrid(results)),
        ("xlstm", lambda: phase_xlstm(results)),
        ("whisper", lambda: phase_whisper(results)),
        ("vision", lambda: phase_vision(results)),
    ]
    t_all = time.perf_counter()
    try:
        start_production_dryruns(state, Path(tempfile.mkdtemp()))
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                fn()
            except Exception as e:  # report the phase, then fail the run
                print(f"[{name}] FAILED: {type(e).__name__}: {e}")
                return 1
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    finally:  # stop the dry-run processes of a run that failed before reading them
        for *_, proc in state.pop("dryruns", []):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"[phases] ok in {time.perf_counter() - t_all:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    print(json.dumps({"kernels": [results[k] for k in
                                  ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]}))
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
          else "nvidia-smi: not available")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def time_cuts() -> int:
    """``--time-cuts``: the front doors of phases hybrid and whisper, each
    at its size in the run and at a cut one, timed in one process: zamba2
    at 1024 and 512 tokens, whisper at ``WHISPER_PLANNED_LAYERS`` and 12
    layers a side.  Not part of the run."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {k: {} for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    phase_build()
    whisper = dict(seq=WHISPER_TOKENS,
                   extra=lambda c, d: {"frames": whisper_frames(c, 0, 2, d)})
    for tag, arch, n, kw in (("hybrid", "zamba2-2.7b", HYBRID_PLANNED_UNITS, {"seq": 512}),
                             ("hybrid", "zamba2-2.7b", HYBRID_PLANNED_UNITS, {}),
                             ("whisper", "whisper-small", WHISPER_PLANNED_LAYERS, whisper),
                             ("whisper", "whisper-small", 12, whisper)):
        t0 = time.perf_counter()
        front_door(results, tag, arch, n, **kw)
        print(f"[time_cuts] {arch} front door at {n} unit(s) or layers a side, "
              f"{kw.get('seq', 1024)} tokens: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


def gqa_designs() -> int:
    """``--gqa-designs``: the three kernels at phase production's GQA shards
    in the two designs of ``kernels.ops.kv_to_q_heads``, in one process:
    the local call as MHA (``PRODUCTION_KERNEL_CASES``, the design taken)
    and as GQA over one KV head (``GQA_DESIGN_CASES``), each beside its
    bound; and the device time of each design's local repeat of k (the
    forward's ``index_select``) and sum of dk into KV heads (the backward's
    ``index_add_``).  Not part of the run."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {k: {} for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    phase_build()
    dev = torch.device("cuda")
    for ci, (mha, gqa) in enumerate(zip(PRODUCTION_KERNEL_CASES, GQA_DESIGN_CASES)):
        for case in (mha, gqa):
            kernel_case(results, len(KERNEL_CASES) + 1 + ci, case, True)
        B, H, S, D = mha[1], mha[2], mha[4], mha[6]
        k = torch.randn(B, S, 1, D, device=dev, dtype=torch.bfloat16)
        for name, heads in ((mha[0], H), (gqa[0], gqa[3])):
            idx = torch.zeros(heads, dtype=torch.long, device=dev)
            g = torch.randn(B, S, heads, D, device=dev, dtype=torch.bfloat16)
            rep_ms = device_ms(lambda: k.index_select(2, idx))
            sum_ms = device_ms(lambda: g.new_zeros((B, S, 1, D)).index_add_(2, idx, g))
            ms = {kn: results[kn][name]["ms"] for kn in results}
            print(f"[gqa_designs] {name}: fwd {ms['flash_fwd']:.4f} ms, dq "
                  f"{ms['flash_bwd_dq']:.4f} ms, dk/dv {ms['flash_bwd_dkv']:.4f} ms, total "
                  f"{sum(ms.values()):.4f} ms; k's local repeat to {heads} heads "
                  f"{rep_ms:.4f} ms, dk's sum into its KV head {sum_ms:.4f} ms (each once for "
                  f"k and once for v in a layer)", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--model-axis-worker"]:  # one of phase model_axis's processes
        sys.exit(model_axis_worker(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--axis-serve-worker"]:  # one of phase axis_serve's processes
        sys.exit(axis_serve_worker(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--production-worker"]:  # one of phase production's processes
        sys.exit(production_worker(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--time-cuts"]:
        sys.exit(time_cuts())
    if sys.argv[1:2] == ["--gqa-designs"]:
        sys.exit(gqa_designs())
    sys.exit(main())
