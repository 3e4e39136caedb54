"""The rounding points of the bf16 tensor-core kernels, pinned on the CPU.

``csrc/flash_attention_sm90.cu`` rounds the probabilities P (forward and
dk/dv) and dS (dq and dk/dv) to bf16 before the second product of each
pair, and sums in f32; the Pallas kernels of the reference keep P and dS in
f32.
A plain torch emulation of those rounding points, written here, is held
against the reference's Pallas kernels in interpret mode (forward, and
``jax.grad`` through the custom VJP, as ``tests/test_kernels.py`` runs
them) on bf16 inputs, to the limits that ``chip_smoke.py`` and
``test_torch_kernels_cuda.py`` hold the card's kernels to: 2e-2 absolute
plus one bf16 unit in the last place (2**-7 |ref|), and 1e-3 on lse.  It
shows before any card run that the design's rounding fits those limits.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_fwd as pallas_fwd  # noqa: E402
from repro.kernels.ops import flash_attention as pallas_flash  # noqa: E402

ATOL, RTOL, LSE_TOL = 2e-2, 2.0 ** -7, 1e-3


def bf16_inputs(B, H, KV, S, D, seed):
    """q, do (B, H, S, D) and k, v (B, KV, S, D) from a numpy seed, rounded
    to bf16: f32 arrays of bf16 values, so both sides see the same inputs."""
    r = np.random.default_rng(seed)
    shapes = ((B, H, S, D), (B, KV, S, D), (B, KV, S, D), (B, H, S, D))
    return [torch.tensor(r.standard_normal(s).astype(np.float32)).bfloat16().float().numpy()
            for s in shapes]


def emulate(q, k, v, do, causal):
    """The sm90 kernels' arithmetic in plain torch, f32 on bf16 values:
    P rounded to bf16 before P·V (forward) and P^T·dO, dS rounded before
    dS^T·Q (dk/dv) and before dS·K (dq).  Returns out (bf16), lse, dq, dk,
    dv (bf16), all in the (B, H, S, D) layout."""
    q, k, v, do = (torch.tensor(x) for x in (q, k, v, do))
    B, H, S, D = q.shape
    KV = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    kf, vf = (x.repeat_interleave(H // KV, dim=1) for x in (k, v))
    s = q @ kf.transpose(-1, -2) * scale
    mask = torch.ones(S, S, dtype=torch.bool)
    if causal:
        mask = torch.tril(mask)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    bf = lambda x: x.bfloat16().float()  # noqa: E731
    out = bf((bf(p) @ vf) / l)
    lse = (m + torch.log(l)).squeeze(-1)

    delta = (do * out).sum(-1, keepdim=True)
    p = torch.exp(s - lse[..., None])
    ds = p * (do @ vf.transpose(-1, -2) - delta) * scale
    fold = lambda g: g.reshape(B, KV, H // KV, S, D).sum(2)  # noqa: E731
    dv = bf(fold(bf(p).transpose(-1, -2) @ do))
    dk = bf(fold(bf(ds).transpose(-1, -2) @ q))
    dq = bf(bf(ds) @ kf)
    return out, lse, dq, dk, dv


def assert_close_bf16(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_rounding_points_fit_the_card_limits(causal):
    B, H, KV, S, D = 1, 4, 2, 128, 80
    q, k, v, do = bf16_inputs(B, H, KV, S, D, seed=12)
    out, lse, dq, dk, dv = emulate(q, k, v, do, causal)

    bf = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    j_out, j_lse = pallas_fwd(bf(q), bf(k), bf(v), causal=causal, block_q=64, block_k=64,
                              interpret=True)
    assert j_out.dtype == jnp.bfloat16
    assert_close_bf16(out.numpy(), j_out.astype(jnp.float32), "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), rtol=0, atol=LSE_TOL)

    # grads through the reference's custom VJP, in the model layout (B, S, H, D)
    tr = lambda x: bf(x.transpose(0, 2, 1, 3))  # noqa: E731
    do_bshd = jnp.asarray(do.transpose(0, 2, 1, 3))

    def loss(q_, k_, v_):
        o = pallas_flash(q_, k_, v_, causal=causal, interpret=True, block_q=64, block_k=64)
        return jnp.sum(o.astype(jnp.float32) * do_bshd)

    grads = jax.grad(loss, argnums=(0, 1, 2))(tr(q), tr(k), tr(v))
    for got, want, name in zip((dq, dk, dv), grads, ("dq", "dk", "dv")):
        assert want.dtype == jnp.bfloat16
        assert_close_bf16(got.numpy(), np.asarray(want.astype(jnp.float32)).transpose(0, 2, 1, 3),
                          name)
