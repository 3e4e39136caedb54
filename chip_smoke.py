#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (each prints its lines; a failing phase makes the script exit
non-zero and print no result):

1. build   — compile the flash-attention kernels from the sources with nvcc;
2. kernels — each CUDA kernel against its plain PyTorch version on the
             training shape (B 2, H 32, S 1024, D 80, bf16), a GQA shape, a
             ragged length and an f32 shape, and ``ops.flash_attention`` in
             the model layout (B, S, H, D) at the training shape, forward
             and autograd backward, against the plain forward differentiated
             by autograd; times each kernel, its plain version and
             ``scaled_dot_product_attention`` (yardstick only);
3. launcher — ``repro_torch.launch.train`` at full stablelm-3b width for 3
             steps (batch 2, seq 1024), budgeted from the card's memory,
             with the launch counts of the three kernels over the run;
4. witness — the same launcher run with the attention through the plain
             ``dense_attention`` instead of the kernels: step 1 (same
             weights and batch) must agree, and the losses of all three
             steps are printed side by side;
5. profile — one more step of the launcher's Trainer on its plan, under
             ``torch.profiler``: device time by kind of kernel, idle share;
6. trade   — the paper's trade on the card: the same width at 8 units, one
             forward+backward with a DP remat plan at half the all-cached
             peak and one without; same loss, lower measured peak;
7. result  — the ``kernels`` JSON line, the card's name and power limit,
             and the final ``{"ok": true, ...}`` line.

Needs one CUDA card; exits non-zero without one, and outside a checkout.
"""

from __future__ import annotations

import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TRAIN_ARGS = ["--arch", "stablelm-3b", "--steps", "3", "--batch", "2", "--seq", "1024"]
TRADE_UNITS = 8
# (name, B, H, KV, Sq, Sk, D, dtype name); the first is the training path's shape
KERNEL_CASES = [
    ("path", 2, 32, 32, 1024, 1024, 80, "bfloat16"),
    ("gqa", 2, 32, 8, 1024, 1024, 80, "bfloat16"),
    ("ragged", 1, 8, 4, 1000, 1000, 80, "bfloat16"),
    ("f32_decode", 1, 4, 2, 200, 328, 64, "float32"),
]
# absolute limits on |kernel - plain| for outputs and gradients, by dtype
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
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
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
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


def compare(label: str, tname: str, got, want, tol: float) -> float:
    """Max |got - want| against the absolute limit ``tol``; prints the error
    and max |want|, the reading the limit is set against."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    ok = math.isfinite(err) and err <= tol
    print(f"[kernels] {label:10s} {tname:3s} max_abs_err {err:.3e} (limit {tol:g}; "
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
        if "registers" in line or "spill" in line:
            print("[build] ptxas: " + line.strip())


def phase_kernels(results):
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    ref = importlib.import_module("repro_torch.kernels.ref")
    dev = torch.device("cuda")
    for ci, (name, B, H, KV, Sq, Sk, D, dtn) in enumerate(KERNEL_CASES):
        dt = getattr(torch, dtn)
        g = torch.Generator(device=dev).manual_seed(ci)
        q = torch.randn(B, H, Sq, D, device=dev, dtype=dt, generator=g)
        k = torch.randn(B, KV, Sk, D, device=dev, dtype=dt, generator=g)
        v = torch.randn(B, KV, Sk, D, device=dev, dtype=dt, generator=g)
        do = torch.randn(B, H, Sq, D, device=dev, dtype=dt, generator=g)

        o_ref, lse_ref = ref.attention_with_lse_ref(q, k, v)
        o, lse = fa.flash_attention_fwd(q, k, v)
        delta = ref.row_delta(o_ref, do)
        dq_ref = ref.attention_bwd_dq_ref(q, k, v, lse_ref, delta, do)
        dq = fa.flash_attention_bwd_dq(q, k, v, lse_ref, delta, do)
        dk_ref, dv_ref = ref.attention_bwd_dkv_ref(q, k, v, lse_ref, delta, do)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse_ref, delta, do)
        torch.cuda.synchronize()

        tol = TOL[dtn]
        errs = {}
        for kname, pairs in (("flash_fwd", [("out", o, o_ref)]),
                             ("flash_bwd_dq", [("dq", dq, dq_ref)]),
                             ("flash_bwd_dkv", [("dk", dk, dk_ref), ("dv", dv, dv_ref)])):
            errs[kname] = max(compare(name, tname, a, b, tol) for tname, a, b in pairs)
        lse_err = (lse - lse_ref).abs().max().item()
        print(f"[kernels] {name:10s} lse max_abs_err {lse_err:.3e} (limit {LSE_TOL:g})")
        check(lse_err <= LSE_TOL, f"flash_fwd lse disagrees on {name}")
        if ci:
            continue

        # the training path's shape: times, bounds and the library yardstick
        bounds = attention_bounds(B, H, KV, Sq, Sk, D, dtn)
        timed = {
            "flash_fwd": (lambda: fa.flash_attention_fwd(q, k, v),
                          lambda: ref.attention_with_lse_ref(q, k, v)),
            "flash_bwd_dq": (lambda: fa.flash_attention_bwd_dq(q, k, v, lse_ref, delta, do),
                             lambda: ref.attention_bwd_dq_ref(q, k, v, lse_ref, delta, do)),
            "flash_bwd_dkv": (lambda: fa.flash_attention_bwd_dkv(q, k, v, lse_ref, delta, do),
                              lambda: ref.attention_bwd_dkv_ref(q, k, v, lse_ref, delta, do)),
        }
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
        lib_bwd = time_ms(lambda: torch.autograd.grad(sdpa_out, (qq, kk, vv), do,
                                                      retain_graph=True))
        for kname, (kern, plain) in timed.items():
            bound, bound_by, flops, nbytes = bounds[kname]
            entry = {
                "name": kname, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[kname], "launches": 0,
                "max_abs_err": errs[kname], "ms": time_ms(kern),
                "plain_ms": time_ms(plain, iters=5), "bound_ms": bound,
                "bound_by": bound_by,
                "library_ms": lib_fwd if kname == "flash_fwd" else None,
            }
            results[kname] = entry
            print(f"[kernels] {kname:14s} {entry['ms']:.4f} ms  plain {entry['plain_ms']:.4f} ms"
                  f"  bound {bound:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB)  library {entry['library_ms']}")
        print(f"[kernels] sdpa backward (dq, dk, dv in one call) {lib_bwd:.4f} ms "
              f"(yardstick for flash_bwd_dq + flash_bwd_dkv)")
    check_model_layout(len(KERNEL_CASES))


def check_model_layout(seed: int) -> None:
    """``ops.flash_attention`` at the training shape in the model layout
    (B, S, H, D), as the launcher calls it: the kernels read and write
    transposed views, and the backward gets the upstream gradient through
    autograd.  Held against the plain forward in f32 on the same card
    tensors, differentiated by autograd."""
    import torch

    ops = importlib.import_module("repro_torch.kernels.ops")
    ref = importlib.import_module("repro_torch.kernels.ref")
    _, B, H, KV, S, _, D, dtn = KERNEL_CASES[0]
    dev, dt = torch.device("cuda"), getattr(torch, dtn)
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, n, D, device=dev, dtype=dt, generator=g)
                   for n in (H, KV, KV, H))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    f32 = [t.float().requires_grad_() for t in (q, k, v)]
    out_ref = ref.attention_with_lse_ref(*(t.transpose(1, 2) for t in f32))[0].transpose(1, 2)
    grads_ref = torch.autograd.grad(out_ref, f32, do.float())
    torch.cuda.synchronize()
    for tname, a, b in zip(("out", "dq", "dk", "dv"), (out, *grads), (out_ref, *grads_ref)):
        check(a.shape == b.shape and a.dtype == dt, f"model layout {tname}: shape or dtype")
        compare("bshd_path", tname, a, b, TOL[dtn])


def phase_launcher(results, state):
    """The launcher's path at full stablelm-3b width, counting launches."""
    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    train = importlib.import_module("repro_torch.launch.train")
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    out = train.main(TRAIN_ARGS)
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
    for name, c in counts.items():
        results[name]["launches"] = c
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


# kernel name fragment -> kind, for the profile's breakdown (first match wins)
KERNEL_KINDS = [("fwd_kernel", "flash_fwd"), ("dq_kernel", "flash_bwd_dq"),
                ("dkv_kernel", "flash_bwd_dkv"), ("gemm", "matmul"), ("xmma", "matmul"),
                ("nvjet", "matmul"), ("cutlass", "matmul")]


def phase_profile(state):
    """One step of the launcher's Trainer, on its plan at full width, under
    ``torch.profiler``: device time by kind of kernel, the kernels that take
    most of the rest, the idle share, and the AdamW update timed alone."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    configs = importlib.import_module("repro_torch.configs")
    models = importlib.import_module("repro_torch.models")
    data = importlib.import_module("repro_torch.data")
    train = importlib.import_module("repro_torch.train")
    adamw = importlib.import_module("repro_torch.optim.adamw")

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = configs.get_config("stablelm-3b")
    sp = state["plan"]
    model = models.build_model(cfg, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    tr = train.Trainer(lambda m, b: m.loss(b, sp.sizes, sp.remat), model,
                       train.TrainConfig(total_steps=2, log_every=0), device=dev)
    stream = data.SyntheticLM(data.DataConfig(cfg.vocab_size, 1024, 2))
    tr.train_step(tr._to_device(stream.batch(0)))  # warm-up
    batch = tr._to_device(stream.batch(1))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind, other, n_kernels = {}, {}, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        kind = next((k for frag, k in KERNEL_KINDS if frag in e.name), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        if kind == "other":
            other[e.name] = other.get(e.name, 0.0) + ms
        n_kernels += 1
    busy = sum(by_kind.values())
    print(f"[profile] one step: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"over {n_kernels} device events, idle share "
          + (f"{1 - busy / wall_ms:.4f}" if busy else "not measured (no device "
             "time in the trace)"))
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {kind:14s} {ms:10.3f} ms  {ms / busy:.4f} of device time")
    for name, ms in sorted(other.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[profile]   other: {ms:9.3f} ms  {name[:110]}")

    grads = [torch.ones_like(p) for p in tr.params]
    update_ms = time_ms(lambda: adamw.update(tr.cfg.optimizer, grads, tr.opt_state,
                                             tr.params, decay=tr.decay),
                        iters=3, warmup=1)
    print(f"[profile] AdamW update alone (the Trainer's, {len(grads)} tensors): "
          f"{update_ms:.3f} ms")
    del tr, model, grads


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
    bitwise = all(torch.equal(a, b) for a, b in zip(g0, g1))
    worst = max(((a - b).abs() / b.abs().clamp(min=1e-30)).max().item()
                for a, b in zip(g1, g0) if not torch.equal(a, b)) if not bitwise else 0.0
    grads_ok = bitwise or all(torch.allclose(a, b, rtol=1e-3, atol=0) for a, b in zip(g1, g0))
    print(f"[trade] loss unplanned {l0.item():.8f} planned {l1.item():.8f} "
          f"bitwise {torch.equal(l0, l1)}")
    print(f"[trade] grads bitwise {bitwise}"
          + ("" if bitwise else f", max rel err {worst:.3e} (limit rtol 1e-3)"))
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
        ("launcher", lambda: phase_launcher(results, state)),
        ("witness", lambda: phase_witness(state)),
        ("profile", lambda: phase_profile(state)),
        ("trade", lambda: phase_trade(state)),
    ]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # report the phase, then fail the run
            print(f"[{name}] FAILED: {type(e).__name__}: {e}")
            return 1
        print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")

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


if __name__ == "__main__":
    sys.exit(main())
