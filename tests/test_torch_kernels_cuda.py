"""The CUDA flash-attention kernels against their plain versions, on the card.

This file imports neither jax nor the reference, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports the JAX package.)
Without a card every case skips.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

fa = importlib.import_module("repro_torch.kernels.flash_attention")
ref = importlib.import_module("repro_torch.kernels.ref")


def make(B, H, KV, Sq, Sk, D, seed):
    """q (B,H,Sq,D), k/v (B,KV,Sk,D) and do (B,H,Sq,D) from one numpy seed."""
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, H, Sq, D)).astype(np.float32),
            r.standard_normal((B, KV, Sk, D)).astype(np.float32),
            r.standard_normal((B, KV, Sk, D)).astype(np.float32),
            r.standard_normal((B, H, Sq, D)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", [(2, 4, 2, 200, 200, 80), (1, 2, 1, 100, 160, 64)])
def test_cuda_kernels_match_plain_versions(shape, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.tensor(x).to("cuda", dt) for x in make(*shape, seed=7))
    o_ref, lse_ref = ref.attention_with_lse_ref(q, k, v)
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = ref.row_delta(o_ref, do)
    got = [o, fa.flash_attention_bwd_dq(q, k, v, lse_ref, delta, do),
           *fa.flash_attention_bwd_dkv(q, k, v, lse_ref, delta, do)]
    want = [o_ref, ref.attention_bwd_dq_ref(q, k, v, lse_ref, delta, do),
            *ref.attention_bwd_dkv_ref(q, k, v, lse_ref, delta, do)]
    torch.cuda.synchronize()
    # bf16: the absolute limit plus one bf16 unit in the last place (2**-7
    # of the value), by which two roundings of nearly equal values can differ
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)


# bf16 on the model's layout: (B, S, H, D) tensors passed as transposed
# (B, H, S, D) views; forward, dq and dk/dv take the tensor-core route when
# D is a multiple of 16 and the SIMT one otherwise
BF16_VIEW_SHAPES = [
    (2, 4, 2, 200, 200, 80),   # GQA 2:1, ragged S (not a multiple of any tile), D 80
    (1, 4, 4, 256, 256, 64),   # whole tiles, D 64
    (1, 8, 2, 130, 130, 64),   # GQA 4:1, two rows past a 128-row tile
    (1, 2, 1, 100, 160, 80),   # decode-style Sq < Sk
    (1, 4, 2, 300, 136, 80),   # Sq > Sk: the first 164 rows see no key
    (1, 2, 2, 160, 160, 96),   # D 96: atoms 64 + 32
    (1, 4, 2, 192, 192, 128),  # D 128: two 64-column atoms
    (2, 4, 4, 64, 64, 16),     # D 16: the launcher's --reduced head, one 16-column atom
    (1, 4, 2, 136, 136, 32),   # D 32: one 32-column atom
    (1, 2, 1, 150, 150, 48),   # D 48: atoms 32 + 16
    (1, 2, 2, 130, 130, 112),  # D 112: atoms 64 + 32 + 16
    (1, 4, 2, 136, 136, 40),   # D 40, not a multiple of 16: the SIMT kernels
    (1, 2, 1, 100, 70, 24),    # D 24, SIMT, Sq > Sk
]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", BF16_VIEW_SHAPES)
def test_cuda_bf16_kernels_on_model_layout_views(shape, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    B, H, KV, Sq, Sk, D = shape
    q, k, v, do = (torch.tensor(x.transpose(0, 2, 1, 3).copy()).to("cuda", torch.bfloat16)
                   .transpose(1, 2) for x in make(*shape, seed=11))
    assert q.stride(1) == D and not q.is_contiguous()
    o_ref, lse_ref = ref.attention_with_lse_ref(q, k, v, causal=causal)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = ref.row_delta(o_ref, do)
    dq = fa.flash_attention_bwd_dq(q, k, v, lse_ref, delta, do, causal=causal)
    dq_ref = ref.attention_bwd_dq_ref(q, k, v, lse_ref, delta, do, causal=causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse_ref, delta, do, causal=causal)
    dk_ref, dv_ref = ref.attention_bwd_dkv_ref(q, k, v, lse_ref, delta, do, causal=causal)
    torch.cuda.synchronize()
    assert o.stride() == q.stride() and dq.stride() == q.stride() and dk.stride() == k.stride()
    for a, b in ((o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        torch.testing.assert_close(a.float(), b.float(), rtol=2.0 ** -7, atol=2e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)
    if causal and Sq > Sk:
        empty = Sq - Sk
        assert torch.all(o[:, :, :empty] == 0) and torch.all(lse[:, :, :empty] == fa.NEG_INF)
        assert torch.all(dq[:, :, :empty] == 0)


@pytest.mark.cuda
def test_cuda_bf16_route_rejects_misaligned_views():
    """TMA needs 16-byte aligned bases and strides: the wrapper raises and
    names the tensor; it never copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    B, H, S, D = 1, 2, 64, 80
    q, k, v, do = (torch.tensor(x).to("cuda", torch.bfloat16) for x in make(B, H, H, S, S, D, 1))
    flat = torch.zeros(q.numel() + 1, device="cuda", dtype=torch.bfloat16)
    shifted = flat[1:].view(B, H, S, D)  # base 2 bytes past an aligned address
    shifted.copy_(q)
    with pytest.raises(ValueError, match="^q: .*TMA"):
        fa.flash_attention_fwd(shifted, k, v)
    lse = torch.zeros(B, H, S, device="cuda")
    with pytest.raises(ValueError, match="^do: .*TMA"):
        fa.flash_attention_bwd_dkv(q, k, v, lse, lse, shifted)
    with pytest.raises(ValueError, match="^do: .*TMA"):
        fa.flash_attention_bwd_dq(q, k, v, lse, lse, shifted)
    with pytest.raises(ValueError, match="^q: .*TMA"):
        fa.flash_attention_bwd_dq(shifted, k, v, lse, lse, do)
    wide = torch.zeros(B, H, S, D + 4, device="cuda", dtype=torch.bfloat16)[..., :D]
    with pytest.raises(ValueError, match="^k: .*TMA"):  # seq stride 84 elements = 168 B
        fa.flash_attention_fwd(q, wide, v)
    with pytest.raises(ValueError, match="^v: .*TMA"):
        fa.flash_attention_bwd_dq(q, k, wide, lse, lse, do)


@pytest.mark.cuda
def test_cuda_bf16_dq_is_deterministic_at_the_path_shape():
    """dq at the training path's shape (B 2, H 32, S 1024, D 80, bf16,
    causal) is bitwise the same over two calls: each element is summed by
    one thread in a fixed order, with no atomics; and it matches the plain
    version within the bf16 limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, do = (torch.tensor(x).to("cuda", torch.bfloat16)
                   for x in make(2, 32, 32, 1024, 1024, 80, seed=13))
    o_ref, lse_ref = ref.attention_with_lse_ref(q, k, v)
    delta = ref.row_delta(o_ref, do)
    first = fa.flash_attention_bwd_dq(q, k, v, lse_ref, delta, do)
    second = fa.flash_attention_bwd_dq(q, k, v, lse_ref, delta, do)
    want = ref.attention_bwd_dq_ref(q, k, v, lse_ref, delta, do)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    torch.testing.assert_close(first.float(), want.float(), rtol=2.0 ** -7, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_bf16_kernels_at_the_granite_shape(causal):
    """granite-moe-3b-a800m's attention on its launcher path: B 2, H 24
    over 8 kv heads (a group of 3), S 1024, D 64, bf16, on model-layout
    views; dq bitwise the same over two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    shape = (2, 24, 8, 1024, 1024, 64)
    q, k, v, do = (torch.tensor(x.transpose(0, 2, 1, 3).copy()).to("cuda", torch.bfloat16)
                   .transpose(1, 2) for x in make(*shape, seed=17))
    o_ref, lse_ref = ref.attention_with_lse_ref(q, k, v, causal=causal)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = ref.row_delta(o_ref, do)
    dq = fa.flash_attention_bwd_dq(q, k, v, lse_ref, delta, do, causal=causal)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, lse_ref, delta, do, causal=causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse_ref, delta, do, causal=causal)
    want = [o_ref, ref.attention_bwd_dq_ref(q, k, v, lse_ref, delta, do, causal=causal),
            *ref.attention_bwd_dkv_ref(q, k, v, lse_ref, delta, do, causal=causal)]
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2)
    for a, b in zip((o, dq, dk, dv), want):
        torch.testing.assert_close(a.float(), b.float(), rtol=2.0 ** -7, atol=2e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)


# (B, H, KV, Sq, Sk, D, causal) of the model families' attention at full
# width: whisper-small's encoder over 1500 frames and its cross-attention
# (448 queries against them), both non-causal, and its causal decoder at
# batch 8; phi-3-vision-4.2b's 576 patches + 1024 tokens at D 96
FAMILY_SHAPES = {
    "whisper_enc": (8, 12, 12, 1500, 1500, 64, False),
    "whisper_cross": (8, 12, 12, 448, 1500, 64, False),
    "whisper_dec": (8, 12, 12, 448, 448, 64, True),
    "vision": (2, 32, 32, 1600, 1600, 96, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FAMILY_SHAPES))
def test_cuda_bf16_kernels_at_the_family_shapes(name):
    """Forward, dq and dk/dv at each family's shape on model-layout views,
    causal or not as the model calls them, against the plain versions; dq
    bitwise the same over two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    *shape, causal = FAMILY_SHAPES[name]
    q, k, v, do = (torch.tensor(x.transpose(0, 2, 1, 3).copy()).to("cuda", torch.bfloat16)
                   .transpose(1, 2) for x in make(*shape, seed=19))
    c = dict(causal=causal)
    o_ref, lse_ref = ref.attention_with_lse_ref(q, k, v, **c)
    o, lse = fa.flash_attention_fwd(q, k, v, **c)
    delta = ref.row_delta(o_ref, do)
    dq = fa.flash_attention_bwd_dq(q, k, v, lse_ref, delta, do, **c)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, lse_ref, delta, do, **c)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse_ref, delta, do, **c)
    want = [o_ref, ref.attention_bwd_dq_ref(q, k, v, lse_ref, delta, do, **c),
            *ref.attention_bwd_dkv_ref(q, k, v, lse_ref, delta, do, **c)]
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2)
    for a, b in zip((o, dq, dk, dv), want):
        torch.testing.assert_close(a.float(), b.float(), rtol=2.0 ** -7, atol=2e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "zamba2-2.7b",
                                  "phi-3-vision-4.2b"])
def test_cuda_reduced_family_launchers_train(arch):
    """``repro_torch.launch.train --reduced`` of the MoE, the hybrid and the
    vision stub's backbone (text-only) on the card, in bf16 at head dim 16,
    through all three kernels: one attention block a unit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.launch.train import main

    fa.reset_launch_counts()
    out = main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2", "--seq", "64"])
    assert out["step"] == 2 and np.isfinite(out["final_loss"])
    recomputed = sum(s for s, r in zip(out["plan"].sizes, out["plan"].remat) if r)
    assert fa.LAUNCHES["flash_fwd"] == 2 * (out["n_units"] + recomputed), fa.LAUNCHES
    assert fa.LAUNCHES["flash_bwd_dq"] == fa.LAUNCHES["flash_bwd_dkv"] == 2 * out["n_units"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_cuda_op_with_a_scale_matches_plain_grads(dtype, tol):
    """``ops.flash_attention`` with granite-4.0-h's scale (1/128, not
    1/sqrt(128)) at its GQA 32/8 and head dim 128, on the card against the
    same op on the CPU (plain versions): the scale reaches the forward and
    both backward kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels.ops import flash_attention

    q, k, v, do = (x.transpose(0, 2, 1, 3).copy() for x in make(1, 32, 8, 256, 256, 128, 11))
    dt = getattr(torch, dtype)
    runs = []
    for dev in ("cpu", "cuda"):
        ts = [torch.tensor(x, device=dev).to(dt).requires_grad_(True) for x in (q, k, v)]
        out = flash_attention(*ts, scale=1.0 / 128)
        runs.append([out.detach(), *torch.autograd.grad(
            (out.float() * torch.tensor(do, device=dev)).sum(), ts)])
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    for a, b in zip(runs[1], runs[0]):
        torch.testing.assert_close(a.cpu().float(), b.float(), rtol=rtol, atol=tol)


@pytest.mark.cuda
def test_cuda_autograd_function_matches_plain_grads():
    """``ops.flash_attention`` on the card (model layout, kernels in both
    passes) against the same Function on the CPU (plain versions), f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels.ops import flash_attention

    q, k, v, do = (x.transpose(0, 2, 1, 3).copy() for x in make(1, 4, 2, 136, 136, 80, 9))
    grads = []
    for dev in ("cpu", "cuda"):
        ts = [torch.tensor(x, device=dev, requires_grad=True) for x in (q, k, v)]
        out = flash_attention(*ts)
        grads.append([out.detach(), *torch.autograd.grad(
            (out * torch.tensor(do, device=dev)).sum(), ts)])
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_reduced_launcher_trains():
    """``repro_torch.launch.train --reduced`` on the card: stablelm-3b's
    family at head dim 16 in bf16, through all three kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.launch.train import main

    fa.reset_launch_counts()
    out = main(["--arch", "stablelm-3b", "--reduced", "--steps", "3", "--batch", "2",
                "--seq", "64"])
    assert out["step"] == 3 and np.isfinite(out["final_loss"])
    assert all(fa.LAUNCHES[name] > 0 for name in fa.KERNELS), fa.LAUNCHES


@pytest.mark.cuda
def test_cuda_planned_attention_relaunches_the_forward_kernel():
    """``plan_function`` on a small bf16 attention stack on the card, at the
    exact minimal budget: the ``"fx"`` lowering gives plain autograd's loss
    and grads, each flash node the plan recomputes launches ``flash_fwd``
    once more, and the backward kernels launch once per node as in vanilla."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    core = importlib.import_module("repro_torch.core")
    lowering = importlib.import_module("repro_torch.core.lowering")
    ops = importlib.import_module("repro_torch.kernels.ops")
    B, S, H, KV, D, DM = 2, 128, 4, 2, 16, 64

    def loss(layers, x):
        h = x
        for w in layers:
            q = (h @ w["wq"]).reshape(B, S, H, D)
            k = (h @ w["wk"]).reshape(B, S, KV, D)
            v = (h @ w["wv"]).reshape(B, S, KV, D)
            ctx = ops.flash_attention(q, k, v, causal=True)
            h = torch.tanh(ctx.reshape(B, S, H * D) @ w["wo"]) + h
        return h.float().square().sum() / (B * S)

    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = (("wq", (DM, H * D)), ("wk", (DM, KV * D)), ("wv", (DM, KV * D)),
              ("wo", (H * D, DM)))
    layers = [{n: (torch.randn(s, device="cuda", generator=g) * 0.2).bfloat16()
               for n, s in shapes} for _ in range(3)]
    x = torch.randn(B, S, DM, device="cuda", generator=g).bfloat16()
    carrier = lowering.TracedCarrier.trace(loss, (layers, x))
    flash = {nd.idx for nd in carrier.to_graph().nodes if nd.kind == "flash_attention"}
    planned = lowering.plan_function(loss, planner=core.Planner(cache=core.PlanCache()))
    plan = planned.lowered_for(layers, x).plan
    recomputed = flash & set().union(*(s.recompute for s in plan.segments))
    assert len(flash) == 3 and recomputed

    def run(fn):
        fa.reset_launch_counts()
        out = fn(layers, x)
        torch.cuda.synchronize()
        return out, dict(fa.LAUNCHES)

    planned(layers, x)  # warm-up
    (l0, g0), c0 = run(lowering.vanilla_traced_value_and_grad(carrier))
    (l1, g1), c1 = run(planned)
    assert torch.equal(l0, l1)
    for a, b in zip(g1, g0):
        for name in a:
            torch.testing.assert_close(a[name], b[name], rtol=1e-3, atol=0)
    assert c1["flash_fwd"] - c0["flash_fwd"] == len(recomputed)
    assert c1["flash_bwd_dq"] == c0["flash_bwd_dq"] == len(flash)
    assert c1["flash_bwd_dkv"] == c0["flash_bwd_dkv"] == len(flash)


@pytest.mark.cuda
def test_cuda_drift_gate_is_ok_on_a_planned_mlp():
    """The memory-drift gate on the card (``analysis.census``): a small MLP
    planned at the exact minimal budget needs no more device bytes beyond
    its arguments and outputs than the plan's analytic peak allows
    (``DRIFT_REL`` and ``DRIFT_ABS_SLACK``), and no more than plain
    autograd; the heavy-op census is exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the allocator's statistics are the card's")
    core = importlib.import_module("repro_torch.core")
    lowering = importlib.import_module("repro_torch.core.lowering")
    census = importlib.import_module("repro_torch.analysis.census")

    def mlp(params, x):
        h = x
        for w in params:
            h = torch.tanh(h @ w)
        return torch.sum(h * h)

    g = torch.Generator(device="cuda").manual_seed(0)
    params = [torch.randn(256, 256, device="cuda", generator=g) * 0.06 for _ in range(8)]
    x = torch.randn(16, 256, device="cuda", generator=g)
    carrier = lowering.TracedCarrier.trace(mlp, (params, x))
    plan = core.Planner(cache=core.PlanCache()).plan(carrier.to_graph(), None, "approx_dp").plan
    res = census.analyze_hlo(carrier, plan, args=(params, x))
    assert res.report.ok, str(res.report)
    assert res.drift["drift_status"] == "ok", res.drift
    assert res.drift["temp_bytes"] <= res.drift["vanilla_temp_bytes"]
    assert res.census.extra == res.census.plan_recompute > 0


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_op_under_dtensor_is_bitwise_plain(causal, tmp_path):
    """The custom op on DTensors of a one-rank NCCL mesh (batch ``Shard(0)``
    over ``data``, as the data-parallel twin lays it out): its sharding
    rules hand the kernels the local tensors, so output, lse and the
    gradients are bitwise those of the op on plain tensors, and the
    gradients keep the inputs' placements."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    ops = importlib.import_module("repro_torch.kernels.ops")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        q, k, v, do = (torch.tensor(x).to("cuda", torch.bfloat16).transpose(1, 2).contiguous()
                       for x in make(2, 8, 4, 256, 256, 64, seed=11))
        plain = [t.clone().requires_grad_() for t in (q, k, v)]
        out, lse = ops.flash_attention_op(*plain, causal)
        grads = torch.autograd.grad(out, plain, do)
        place = [Shard(0), Shard(0)]
        dts = [distribute_tensor(t, mesh, place).requires_grad_() for t in (q, k, v)]
        fa.reset_launch_counts()
        dout, dlse = ops.flash_attention_op(*dts, causal)
        dgrads = torch.autograd.grad(dout, dts, distribute_tensor(do, mesh, place))
        assert fa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
        assert torch.equal(dout.to_local(), out) and torch.equal(dlse.to_local(), lse)
        for got, want in zip(dgrads, grads):
            assert list(got.placements) == place
            assert torch.equal(got.to_local(), want)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_wrappers_reject_dtensors(tmp_path):
    """A DTensor never reaches the ctypes wrappers: they raise on one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        q, k, v, _ = (distribute_tensor(torch.tensor(x).to("cuda", torch.bfloat16), mesh,
                                        [Replicate()])
                      for x in make(1, 2, 2, 64, 64, 64, seed=3))
        with pytest.raises(TypeError, match="local tensors"):
            fa.flash_attention_fwd(q, k, v)
    finally:
        dist.destroy_process_group()
