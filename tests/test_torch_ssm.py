"""The port's Mamba2 core (``repro_torch.models.ssm``) against the reference.

Numpy inputs from a seed go through the reference's jnp functions and their
ports: ``_segsum``; ``ssd_chunked`` with and without a carried state, at
one chunk (S = Q) and four (S = 4Q), output and final state, and its grads;
``ssd_step``; ``mamba2_apply`` on the reference's ``mamba2_init`` weights
(reduced zamba2-2.7b: d_model 64, 2 heads of 64, state 16, chunk 8) with
its grads; ``mamba2_step`` and its state.  f32 to 1e-5, bf16 to 2e-2,
relative to each value and to the tensor's largest (``close``).  The
chunked scan equals the step recurrence run token by token, and the per-chunk
checkpoint leaves the grads bitwise equal to a run without it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import reduced as rreduced  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro_torch.configs import get_config as pget_config  # noqa: E402
from repro_torch.configs import reduced as preduced  # noqa: E402
from repro_torch.models import ssm as pssm  # noqa: E402

ARCH = "zamba2-2.7b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, H, P, N, Q = 2, 3, 8, 4, 8


def close(got, want, dtype="float32", what=""):
    """|got - want| ≤ tol·|want| + tol·max(1, max |want|): the absolute part
    scales with the tensor, as a sum over B·S rows in another order differs
    by f32 rounding of its largest terms (a weight grad of max 163 differs
    by 1.4e-4 between the packages, each within 1.8e-4 of an f64 run)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=TOL[dtype],
                               atol=TOL[dtype] * scale, err_msg=what)


def ssd_inputs(S, seed=0, with_h0=False):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, S, H, P)).astype(np.float32)
    a = -np.abs(r.standard_normal((B, S, H))).astype(np.float32) * 0.3
    Bm = r.standard_normal((B, S, H, N)).astype(np.float32)
    Cm = r.standard_normal((B, S, H, N)).astype(np.float32)
    h0 = r.standard_normal((B, H, P, N)).astype(np.float32) if with_h0 else None
    return x, a, Bm, Cm, h0


def test_segsum_matches_reference():
    a = np.random.default_rng(2).standard_normal((2, 3, Q)).astype(np.float32)
    want = np.asarray(rssm._segsum(jnp.asarray(a)))
    got = pssm._segsum(torch.tensor(a)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    close(got[finite], want[finite], what="segsum")


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_state", "carried_state"])
@pytest.mark.parametrize("n_chunks", [1, 4])
def test_ssd_chunked_and_grads_match_reference(n_chunks, with_h0):
    x, a, Bm, Cm, h0 = ssd_inputs(n_chunks * Q, with_h0=with_h0)
    cot = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    cot_h = np.random.default_rng(10).standard_normal((B, H, P, N)).astype(np.float32)
    args = [x, a, Bm, Cm] + ([h0] if with_h0 else [])

    def rfn(*xs):
        y, hT = rssm.ssd_chunked(*xs[:4], Q, h0=xs[4] if with_h0 else None)
        return jnp.sum(y * cot) + jnp.sum(hT * cot_h), (y, hT)

    argnums = tuple(range(len(args)))
    (_, (ry, rh)), rgrads = jax.value_and_grad(rfn, argnums=argnums, has_aux=True)(
        *map(jnp.asarray, args))
    targs = [torch.tensor(t, requires_grad=True) for t in args]
    py, ph = pssm.ssd_chunked(*targs[:4], Q, h0=targs[4] if with_h0 else None)
    pgrads = torch.autograd.grad((py * torch.tensor(cot)).sum()
                                 + (ph * torch.tensor(cot_h)).sum(), targs)
    close(py, ry, what="y")
    close(ph, rh, what="final state")
    for name, g, w in zip(("x", "a_log", "B", "C", "h0"), pgrads, rgrads):
        close(g, w, what=f"grad {name}")


def test_ssd_chunked_equals_the_step_recurrence():
    x, a, Bm, Cm, h0 = ssd_inputs(4 * Q, seed=4, with_h0=True)
    y, hT = pssm.ssd_chunked(*map(torch.tensor, (x, a, Bm, Cm)), Q, h0=torch.tensor(h0))
    h, ys = torch.tensor(h0), []
    for t in range(4 * Q):
        yt, h = pssm.ssd_step(*(torch.tensor(v[:, t]) for v in (x, a, Bm, Cm)), h)
        ys.append(yt)
    close(torch.stack(ys, 1), y.numpy(), what="y")
    close(h, hT.numpy(), what="state")


def test_ssd_step_matches_reference():
    x, a, Bm, Cm, h0 = ssd_inputs(1, seed=6, with_h0=True)
    args = [v[:, 0] for v in (x, a, Bm, Cm)] + [h0]
    ry, rh = rssm.ssd_step(*map(jnp.asarray, args))
    py, ph = pssm.ssd_step(*map(torch.tensor, args))
    close(py, ry, what="y")
    close(ph, rh, what="state")


def mamba_setup(seed=0):
    rcfg, pcfg = rreduced(rget_config(ARCH)), preduced(pget_config(ARCH))
    tree = jax.tree_util.tree_map(
        np.asarray, rssm.mamba2_init(jax.random.PRNGKey(seed), rcfg.d_model, rcfg.ssm))
    return rcfg, pcfg, tree


def to_torch(tree, grad=False):
    return {k: to_torch(v, grad) if isinstance(v, dict)
            else torch.tensor(v, requires_grad=grad) for k, v in tree.items()}


def leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_mamba2_init_tree_matches_reference():
    rcfg, pcfg, tree = mamba_setup()
    got = pssm.mamba2_init(pcfg.d_model, pcfg.ssm, generator=torch.Generator().manual_seed(0))
    spec = jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
                                  got)
    assert spec == jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), tree)
    for k in ("A_log", "D_skip", "dt_bias"):  # the deterministic leaves are equal
        close(got[k], tree[k], what=k)
    assert pssm.mamba2_sizes(2560, pget_config(ARCH).ssm) == rssm.mamba2_sizes(
        2560, rget_config(ARCH).ssm) == (5120, 80, 64)


@pytest.mark.parametrize("S", [8, 32])
def test_mamba2_apply_and_grads_match_reference(S):
    rcfg, pcfg, tree = mamba_setup()
    x = np.random.default_rng(S).standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    cot = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def rfn(p, xx):
        y = rssm.mamba2_apply(p, xx, rcfg.ssm)
        return jnp.sum(y * cot), y

    (_, ry), (rgp, rgx) = jax.value_and_grad(rfn, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    p = to_torch(tree, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    py = pssm.mamba2_apply(p, tx, pcfg.ssm)
    pgrads = torch.autograd.grad((py * torch.tensor(cot)).sum(), [*leaves(p), tx])
    close(py, ry, what="y")
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(rgp)]
    for name, g, w in zip(paths + ["x"], pgrads, leaves(rgp) + [rgx]):
        close(g, w, what=f"grad {name}")


def test_mamba2_apply_bf16_matches_reference():
    rcfg, pcfg, tree = mamba_setup(seed=2)
    x = np.random.default_rng(3).standard_normal((B, 16, rcfg.d_model)).astype(np.float32)
    want = rssm.mamba2_apply(jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(x, jnp.bfloat16), rcfg.ssm)
    got = pssm.mamba2_apply(to_torch(tree), torch.tensor(x).bfloat16(), pcfg.ssm)
    assert got.dtype == torch.bfloat16
    close(got, want.astype(jnp.float32), "bfloat16", "y")


def test_mamba2_step_matches_reference_and_the_full_sequence():
    """Three steps from random states against the reference (outputs and
    states); and steps from the zero state reproduce ``mamba2_apply``."""
    rcfg, pcfg, tree = mamba_setup(seed=1)
    d = rcfg.d_model
    r = np.random.default_rng(7)
    rstate = jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.standard_normal(a.shape).astype(np.float32)),
        rssm.mamba2_init_state(B, d, rcfg.ssm, jnp.float32))
    pstate = {k: torch.tensor(np.asarray(v)) for k, v in rstate.items()}
    rp, pp = jax.tree_util.tree_map(jnp.asarray, tree), to_torch(tree)
    for t in range(3):
        x = r.standard_normal((B, 1, d)).astype(np.float32)
        ry, rstate = rssm.mamba2_step(rp, jnp.asarray(x), rstate, rcfg.ssm)
        py, pstate = pssm.mamba2_step(pp, torch.tensor(x), pstate, pcfg.ssm)
        close(py, ry, what=f"y step {t}")
        for k in ("ssm", "conv"):
            close(pstate[k], rstate[k], what=f"{k} step {t}")

    S = 16
    x = torch.tensor(r.standard_normal((1, S, d)).astype(np.float32))
    full = pssm.mamba2_apply(pp, x, pcfg.ssm)
    state = pssm.mamba2_init_state(1, d, pcfg.ssm, torch.float32)
    assert state["ssm"].dtype == torch.float32 and state["conv"].shape == (1, 3, 2 * d)
    steps = []
    for t in range(S):
        y, state = pssm.mamba2_step(pp, x[:, t:t + 1], state, pcfg.ssm)
        steps.append(y)
    close(torch.cat(steps, 1), full.numpy(), what="steps vs full sequence")


def test_chunk_checkpoint_keeps_grads_bitwise(monkeypatch):
    """The per-chunk checkpoint recomputes, and changes no bit of the grads."""
    x, a, Bm, Cm, h0 = ssd_inputs(4 * Q, seed=5, with_h0=True)

    def grads():
        ts = [torch.tensor(v, requires_grad=True) for v in (x, a, Bm, Cm, h0)]
        y, h = pssm.ssd_chunked(*ts[:4], Q, h0=ts[4])
        return torch.autograd.grad(y.square().sum() + h.sum(), ts)

    with_ckpt = grads()
    monkeypatch.setattr(pssm, "checkpointed", lambda fn, *args: fn(*args))
    without = grads()
    assert all(torch.equal(p, q) for p, q in zip(with_ckpt, without))
