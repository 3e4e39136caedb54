"""The port's flash attention against the reference's Pallas kernels.

On the CPU the port runs the kernels' plain versions (``kernels/ref.py``);
they are held here against the reference's Pallas kernels in interpret mode,
as ``tests/test_kernels.py`` runs them, on causal Sq ≤ Sk shapes (the parity
domain), plus D = 80 (the stablelm-3b head) and KV ∈ {1, 2, 4}.  The CUDA
kernels themselves run only on the card: ``test_torch_kernels_cuda.py``,
which imports no jax, compares each with its plain version there.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_fwd as pallas_fwd  # noqa: E402
from repro.kernels.ops import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels.ops import flash_attention  # noqa: E402

fa = importlib.import_module("repro_torch.kernels.flash_attention")

SHAPES = [
    # B, H, KV, Sq,  Sk,  D   (tests/test_kernels.py, plus the stablelm-3b head)
    (1, 2, 2, 128, 128, 64),
    (2, 4, 2, 256, 256, 64),   # GQA 2:1
    (1, 8, 1, 128, 128, 32),   # MQA
    (1, 2, 2, 128, 256, 64),   # decode-style Sk > Sq
    (2, 2, 2, 64, 64, 128),
    (1, 4, 2, 128, 128, 80),   # D = 80
]


def make(B, H, KV, Sq, Sk, D, seed=0, dtype=np.float32):
    """q (B,H,Sq,D), k/v (B,KV,Sk,D) and do (B,H,Sq,D) from one numpy seed."""
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, H, Sq, D)).astype(dtype),
            r.standard_normal((B, KV, Sk, D)).astype(dtype),
            r.standard_normal((B, KV, Sk, D)).astype(dtype),
            r.standard_normal((B, H, Sq, D)).astype(dtype))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_pallas(shape, causal):
    q, k, v, _ = make(*shape)
    out, lse = pallas_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, block_q=64, block_k=64, interpret=True)
    pout, plse = fa.flash_attention_fwd(torch.tensor(q), torch.tensor(k),
                                        torch.tensor(v), causal=causal)
    np.testing.assert_allclose(pout.numpy(), np.asarray(out), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(plse.numpy(), np.asarray(lse), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("KV,D", [(1, 32), (2, 32), (4, 32), (2, 80)])
def test_plain_backward_matches_pallas(KV, D):
    """Grads of the autograd Function (plain recompute backward on the CPU)
    against ``jax.grad`` through the reference's custom-VJP Pallas kernels,
    both in model layout (B, S, H, D)."""
    B, H, S = 1, 4, 128
    q, k, v, do = (x.transpose(0, 2, 1, 3).copy() for x in make(B, H, KV, S, S, D, seed=3))

    def loss(q_, k_, v_):
        out = pallas_flash(q_, k_, v_, interpret=True, block_q=64, block_k=64)
        return jnp.sum(out * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv)
    got = torch.autograd.grad((out * torch.tensor(do)).sum(), (tq, tk, tv))
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_no_score_matrix_is_saved():
    """The residuals are q, k, v, out and lse: nothing of shape (S, S)."""
    S = 256
    q, k, v, _ = make(1, 2, 2, S, S, 32)
    tq, tk, tv = (torch.tensor(x.transpose(0, 2, 1, 3).copy(), requires_grad=True)
                  for x in (q, k, v))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        out = flash_attention(tq, tk, tv)
    assert len(saved) == 5, saved
    assert all(shape[-2:] != (S, S) for shape in saved), saved
    torch.autograd.grad(out.sum(), (tq, tk, tv))


def test_rows_that_see_no_key_are_zero():
    """Causal with Sq > Sk: the first Sq − Sk rows see no key.  The port
    gives them zero output, lse = −1e30 and zero gradients (the reference
    gives the mean of v there; outside the parity domain)."""
    B, H, KV, Sq, Sk, D = 1, 2, 1, 96, 64, 16
    q, k, v, do = (torch.tensor(x) for x in make(B, H, KV, Sq, Sk, D, seed=5))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    empty = Sq - Sk
    assert torch.all(out[:, :, :empty] == 0)
    assert torch.all(lse[:, :, :empty] == fa.NEG_INF)
    assert torch.all(out[:, :, empty:].abs().sum(-1) > 0)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    assert torch.all(dq[:, :, :empty] == 0)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
    # the visible rows alone give the same dk/dv
    _, dk2, dv2 = fa.flash_attention_bwd(q[:, :, empty:], k, v, out[:, :, empty:],
                                         lse[:, :, empty:], do[:, :, empty:])
    torch.testing.assert_close(dk, dk2, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dv, dv2, rtol=1e-5, atol=1e-6)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    q, k, v, _ = (torch.tensor(x) for x in make(1, 4, 3, 16, 16, 16))
    with pytest.raises(ValueError, match="incompatible"):  # H % KV != 0
        fa.flash_attention_fwd(q, k, v)
    q, k, v, _ = (torch.tensor(x) for x in make(1, 2, 2, 16, 16, 12))
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention_fwd(q, k, v)


@pytest.mark.parametrize("dtype,D,tensor_core", [
    ("bfloat16", 16, True), ("bfloat16", 80, True), ("bfloat16", 128, True),
    ("bfloat16", 40, False), ("bfloat16", 24, False), ("float32", 80, False)])
def test_tensor_core_route_by_dtype_and_head_dim(dtype, D, tensor_core):
    """bf16 forward, dq and dk/dv go to the tensor-core kernels when D is a
    multiple of 16 (whole swizzle atoms), else to the SIMT kernels: one
    rule for the three, each with its sm90 kernel, whose register split
    ``build()`` checks."""
    assert fa.tensor_core_route(getattr(torch, dtype), D) is tensor_core
    assert sorted(fa.SM90_KERNELS) == ["dkv_kernel_sm90", "dq_kernel_sm90", "fwd_kernel_sm90"]
    assert fa.KERNELS == ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115fwd_kernel_sm90ILi16EEEvT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115fwd_kernel_sm90ILi16EEEvT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used {fwd16} registers, used 1 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115fwd_kernel_sm90ILi80EEEvT_' for 'sm_90a'
ptxas info    : Used 128 registers, used 1 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115dkv_kernel_sm90ILi80EEEvT_' for 'sm_90a'
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes cmem[0]
"""


@pytest.mark.parametrize("fwd16,ok", [(128, True), (96, False)])
def test_register_split_check_reads_the_ptxas_report(fwd16, ok):
    """A tensor-core kernel built at fewer registers than its setmaxnreg split
    hands out would hang; the build refuses it."""
    regs = fa.ptxas_registers(PTXAS_LOG.format(fwd16=fwd16))
    assert len(regs) == 3
    launch = {"fwd_kernel_sm90": 128, "dkv_kernel_sm90": 168}
    if ok:
        fa.check_register_split(regs, launch)
    else:
        with pytest.raises(RuntimeError, match="fwd_kernel_sm90ILi16.*96"):
            fa.check_register_split(regs, launch)
    with pytest.raises(RuntimeError, match="no instantiation"):
        fa.check_register_split(regs, {"missing_kernel_sm90": 128})
