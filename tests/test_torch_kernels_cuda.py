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
