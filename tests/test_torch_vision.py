"""The vision stub's ``extra_embeds`` (reduced phi-3-vision-4.2b: 8 patch
embeddings before the tokens) and ``chunked_attention`` against the
reference.

On the reference's weights (``weights.params_from_jax``): ``LM.forward``
with the prefix (logits over F + S positions), the loss, which drops the F
prefix positions, and its grads in f32, the loss in bf16; decode, the
engine and both launchers text-only, as the reference serves and trains
the model; ``plan_function`` with the prefix bitwise plain autograd; the
launcher's plan at the prefixed length (1600) bitwise the reference's.
``chunked_attention`` against the reference's and ``dense_attention``,
with S and Sk padded to chunk multiples, GQA, and its grads; ``attention``
takes it on the CPU above ``chunked_threshold``.  f32 to 1e-5 (grads rtol
1e-4), bf16 to 2e-2, each absolute limit relative to the tensor's largest
value (``close``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.steps import segment_plan as rsegment_plan  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.serving import Engine as REngine  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig as PShape  # noqa: E402
from repro_torch.core import PlanCache, Planner  # noqa: E402
from repro_torch.core.lowering import TracedCarrier, vanilla_traced_value_and_grad  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.mesh import REFERENCE_HBM_BYTES  # noqa: E402
from repro_torch.launch.steps import segment_plan as psegment_plan  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models.layers import softmax_xent  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402
from repro_torch.train import functional_loss  # noqa: E402
from repro_torch.weights import params_to_jax  # noqa: E402
from test_torch_families import (  # noqa: E402
    BATCH, SEQ, assert_trees_close, batch_of, close, setup)

ARCH = "phi-3-vision-4.2b"


def prefix_of(cfg, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, cfg.frontend_seq, cfg.d_model)).astype(np.float32)


def vision_batch(cfg, seed=0):
    return dict(batch_of(cfg, seed), extra_embeds=prefix_of(cfg, seed + 3))


def jtree(np_tree):
    return jax.tree_util.tree_map(jnp.asarray, np_tree)


# ------------------------------------------------------------------ prefix


def test_forward_with_prefix_matches_reference():
    rlm, np_tree, plm = setup(ARCH)
    batch = vision_batch(plm.cfg)
    want = rlm.forward(jtree(np_tree), jnp.asarray(batch["tokens"]),
                       extra_embeds=jnp.asarray(batch["extra_embeds"]))
    with torch.no_grad():
        got = plm(torch.tensor(batch["tokens"]), torch.tensor(batch["extra_embeds"]))
    assert got.shape == (BATCH, plm.cfg.frontend_seq + SEQ, plm.cfg.vocab_size)
    close(got, want, what="logits")


def test_f32_loss_drops_the_prefix_and_grads_match_reference():
    rlm, np_tree, plm = setup(ARCH)
    batch = vision_batch(plm.cfg)
    loss, grads = jax.value_and_grad(rlm.loss)(jtree(np_tree),
                                              {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    ploss = plm.loss(tb)
    close(ploss, loss, what="loss")
    with torch.no_grad():
        logits = plm(tb["tokens"], tb["extra_embeds"])[:, plm.cfg.frontend_seq:]
    assert torch.equal(ploss.detach(), softmax_xent(logits[:, :-1], tb["labels"][:, 1:]))
    names = [n for n, _ in plm.named_parameters()]
    pgrads = params_to_jax(dict(zip(names, torch.autograd.grad(ploss, list(plm.parameters())))))
    assert_trees_close(pgrads, grads, "grads", rtol=1e-4)


def test_bf16_loss_with_prefix_matches_reference():
    rlm, np_tree, plm = setup(ARCH, "bfloat16")
    batch = vision_batch(plm.cfg, seed=1)
    loss = rlm.loss(jtree(np_tree), {k: jnp.asarray(v) for k, v in batch.items()})
    close(plm.loss({k: torch.tensor(v) for k, v in batch.items()}), loss, "bfloat16", "loss")


def test_text_only_decode_and_engine_match_reference():
    """Decode and serving are text-only, as in the reference: three decode
    steps (logits and KV caches), and the engines' tokens."""
    rlm, np_tree, plm = setup(ARCH)
    rparams = jtree(np_tree)
    rcaches, pcaches = rlm.init_caches(BATCH, 16), plm.init_caches(BATCH, 16)
    toks = np.random.default_rng(7).integers(0, plm.cfg.vocab_size, (3, BATCH, 1))
    start = np.array([0, 5], np.int32)
    for t in range(3):
        rlogits, rcaches = rlm.decode_step(rparams, jnp.asarray(toks[t], jnp.int32),
                                           rcaches, jnp.asarray(start + t))
        plogits, _ = plm.decode_step(torch.tensor(toks[t]), pcaches,
                                     torch.tensor(start + t, dtype=torch.int64))
        close(plogits, rlogits, what=f"logits step {t}")
        assert_trees_close(pcaches, rcaches, f"caches step {t}")
    r = np.random.default_rng(11)
    prompts = [r.integers(1, 256, size=n).tolist() for n in (3, 7, 20, 2)]
    outs = []
    for eng in (REngine(rlm, rparams, max_slots=2, max_seq=16, rng_seed=4),
                Engine(plm, max_slots=2, max_seq=16, rng_seed=4)):
        for prompt in prompts:
            eng.submit(prompt, max_new_tokens=6)
        outs.append([(q.uid, q.output) for q in eng.run()])
    assert outs[1] == outs[0]


def test_plan_function_with_the_prefix_is_bitwise_vanilla():
    """The front door on the loss with its prefix, at the minimal budget:
    loss and grads bitwise plain autograd's in the plan's order; the
    prefix's concatenation is one node of the graph."""
    _, _, plm = setup(ARCH, n_layers=2)
    tb = {k: torch.tensor(v) for k, v in vision_batch(plm.cfg).items()}
    n = plm.n_units
    fn, params = functional_loss(lambda m, b: m.loss(b, (n,), (False,)), plm)
    planned = repro_torch.plan_function(fn, planner=Planner(cache=PlanCache()))
    plan = planned.lowered_for(params, tb).plan
    carrier = TracedCarrier.trace(fn, (params, tb))
    g = carrier.to_graph()
    # the prefix's, and RoPE's on q and on k in each layer
    assert sum(v.kind == "concatenate" for v in g.nodes) == 1 + 2 * n
    assert sum(v.kind == "flash_attention" for v in g.nodes) == n
    l0, _ = vanilla_traced_value_and_grad(carrier)(params, tb)
    l1, g1 = planned(params, tb)
    l2, g2 = vanilla_traced_value_and_grad(carrier, plan)(params, tb)
    assert torch.equal(l0, l1) and torch.equal(l0, l2)
    assert [k for k in g2 if not torch.equal(g1[k], g2[k])] == []


def test_launch_plan_at_the_prefixed_length_matches_reference():
    """``segment_plan`` at full width, batch 2 × (576 + 1024) on one
    device under the reference's per-device memory: bitwise the
    reference's (the plan the card's vision phase trains under, there
    budgeted from the card)."""
    rs, ps = RShape("vision", 1600, 2, "train"), PShape("vision", 1600, 2, "train")
    r = rsegment_plan(rget_config(ARCH), rs, make_host_mesh())
    p = psegment_plan(get_config(ARCH), ps, hbm_bytes=REFERENCE_HBM_BYTES)
    assert dataclasses.asdict(p[0]) == dataclasses.asdict(r[0])
    assert (p[1].sequence, p[1].overhead, p[1].peak_memory, p[1].feasible) == (
        r[1].sequence, r[1].overhead, r[1].peak_memory, r[1].feasible)


def test_launchers_run_text_only_on_the_cpu():
    out = train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
                      "--seq", "32", "--device", "cpu"])
    assert out["step"] == 2 and all(np.isfinite(out["losses"]))
    served = serve.main(["--arch", ARCH, "--requests", "3", "--slots", "2", "--max-seq",
                         "48", "--new-tokens", "4", "--device", "cpu"])
    assert all(len(q.output) == 4 for q in served["completed"])


# -------------------------------------------------------- chunked attention


def qkv(B, S, Sk, H, KV, D, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, S, H, D)).astype(np.float32),
            r.standard_normal((B, Sk, KV, D)).astype(np.float32),
            r.standard_normal((B, Sk, KV, D)).astype(np.float32))


@pytest.mark.parametrize("S,chunk,causal", [(40, 16, True), (37, 8, True), (32, 8, False),
                                            (24, 64, True)])
def test_chunked_attention_matches_reference_and_dense(S, chunk, causal):
    """S = 40 and 37 pad to chunk multiples (causal); 32 is whole chunks
    (non-causal); a chunk past S is cut to S.  GQA 4:2."""
    q, k, v = qkv(2, S, S, 4, 2, 8, seed=S)
    want = rattn.chunked_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                   q_chunk=chunk, kv_chunk=chunk)
    got = pattn.chunked_attention(*map(torch.tensor, (q, k, v)), causal=causal,
                                  q_chunk=chunk, kv_chunk=chunk)
    dense = pattn.dense_attention(*map(torch.tensor, (q, k, v)), causal=causal)
    assert got.shape == (2, S, 4, 8)
    close(got, want, what="against the reference")
    close(got, dense.numpy(), what="against dense_attention")


def test_chunked_attention_grads_and_bf16():
    q, k, v = qkv(1, 37, 37, 4, 4, 8, seed=5)
    cot = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)

    def rfn(*xs):
        return jnp.sum(rattn.chunked_attention(*xs, q_chunk=16, kv_chunk=8) * cot)

    rgrads = jax.grad(rfn, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    out = pattn.chunked_attention(*leaves, q_chunk=16, kv_chunk=8)
    pgrads = torch.autograd.grad((out * torch.tensor(cot)).sum(), leaves)
    for name, g, w in zip("qkv", pgrads, rgrads):
        close(g, w, what=f"grad {name}")
    want = rattn.chunked_attention(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                                   q_chunk=16, kv_chunk=8)
    got = pattn.chunked_attention(*(torch.tensor(t).bfloat16() for t in (q, k, v)),
                                  q_chunk=16, kv_chunk=8)
    assert got.dtype == torch.bfloat16
    close(got, want.astype(jnp.float32), "bfloat16", "bf16 output")


def test_chunk_padding_requires_causal_masking():
    q, k, v = map(torch.tensor, qkv(1, 37, 37, 2, 2, 8))
    with pytest.raises(ValueError, match="requires causal"):
        pattn.chunked_attention(q, k, v, causal=False, q_chunk=16, kv_chunk=16)


def test_attention_takes_the_chunked_path_above_the_threshold(monkeypatch):
    """On a CPU tensor longer than ``chunked_threshold`` ``attention`` runs
    ``chunked_attention`` (under a checkpoint) instead of the kernels'
    plain O(S²) version; the output and grads agree with the kernel path."""
    r = np.random.default_rng(2)
    d, H = 32, 4
    p = {name: torch.tensor((r.standard_normal(shape) / 6).astype(np.float32),
                            requires_grad=True)
         for name, shape in (("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)), ("wo", (d, d)))}
    x = torch.tensor(r.standard_normal((1, 40, d)).astype(np.float32))
    calls = []
    chunked = pattn.chunked_attention
    monkeypatch.setattr(pattn, "chunked_attention",
                        lambda *a, **kw: calls.append(1) or chunked(*a, q_chunk=16,
                                                                   kv_chunk=16, **kw))
    kw = dict(n_heads=H, n_kv_heads=H, d_head=d // H, rope_theta=10_000.0)
    outs = [pattn.attention(p, x, chunked_threshold=t, **kw) for t in (8192, 32)]
    assert len(calls) == 1
    close(outs[1], outs[0].detach().numpy(), what="chunked against the kernel path")
    grads = [torch.autograd.grad(o.square().sum(), list(p.values())) for o in outs]
    for name, a, b in zip(p, grads[1], grads[0]):
        close(a, b.numpy(), what=f"grad {name}")
