"""The MoE layer's mesh path (the reference's ``_moe_shard_map``) on
DTensors, held against the reference's own per-shard semantics.

Four gloo ranks on the CPU, ``{data: 2, model: 2}`` (one spawn,
``tests/torch_dist_workers.py`` case ``expert_parallel``), f32.  The
reference of a rank's output and gradients is the reference's ``_route``,
``_pack``, ``_expert_ffn`` and ``_combine`` applied to each shard of the
tokens (batch over data, sequence over model where the model axis divides
it) with the shard's capacity ``C_loc = max(8, ceil(cf·T_loc·K/E))``:
what ``shard_map``'s local function computes on each device, whether or
not the rows travel to their experts' owners in between.  Cases:

* ``all_to_all``: E = 4 divides the model axis: one ``all_to_all`` pair
  over ``model`` in the forward and one in the backward, exactly the
  (E, C_loc, D) buffer's bytes each, and nothing else;
* ``local``: E = 5 does not divide it (granite's 40 experts on a 16-way
  axis): the experts are gathered whole and the layer sends nothing;
* ``local_seq``: E = 6 divides it, but an odd sequence is not split
  (decode's S = 1): the same local layout, the experts gathered whole;
* ``dense``: B = 3 does not divide the data axis: the dense path with
  its three constraints, against the reference's ``moe_apply`` on the
  global tokens.

Output within rtol 1e-6 and gradients within rtol 1e-5, each with an
absolute floor of rtol × the tensor's largest magnitude (the ranks sum in
another order than one device).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoEConfig as RMoEConfig  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from torch_dist_workers import spawn  # noqa: E402

WORLD, DP, TP = 4, 2, 2
D, F = 16, 8
# (E, K, B, S): the all-to-all layout, experts the axis does not divide,
# a sequence the axis does not divide, a batch the data axis does not divide
CASES = {"all_to_all": (4, 2, 4, 8), "local": (5, 2, 4, 8), "local_seq": (6, 2, 4, 7),
         "dense": (4, 2, 3, 8)}
CF = 1.25


def _close(got, want, rtol, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def _inputs(case, seed):
    E, K, B, S = CASES[case]
    r = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: (s * r.standard_normal(shape)).astype(np.float32)  # noqa: E731
    return {"x": f(B, S, D), "cot": f(B, S, D), "router": f(D, E, s=D**-0.5),
            "w_gate": f(E, D, F, s=D**-0.5), "w_up": f(E, D, F, s=D**-0.5),
            "w_down": f(E, F, D, s=F**-0.5)}


def _c_loc(case):
    E, K, B, S = CASES[case]
    seq_split = TP if S % TP == 0 else 1
    return max(8, int(math.ceil(CF * (B // DP) * (S // seq_split) * K / E))), seq_split


def _reference(case, v):
    """The reference's value and gradients of ``sum(y · cot)``."""
    E, K, B, S = CASES[case]
    cfg = RMoEConfig(num_experts=E, top_k=K, d_ff_expert=F, capacity_factor=CF)
    C, seq_split = _c_loc(case)

    def per_shard(p, x):
        if case == "dense":
            return rmoe.moe_apply(p, x, cfg)
        rows = []
        bl, sl = B // DP, S // seq_split
        for d in range(DP):
            cols = []
            for m in range(seq_split):
                xs = x[d * bl:(d + 1) * bl, m * sl:(m + 1) * sl]
                b, s = xs.shape[:2]
                xt = xs.reshape(b * s, D)
                g, ids, _ = rmoe._route(p["router"], xt, cfg)
                disp, eid, pos_c, keep = rmoe._pack(xt, g, ids, E, C, xt.dtype)
                out = rmoe._expert_ffn(p["experts"], disp, xt.dtype)
                cols.append(rmoe._combine(out, eid, pos_c, keep, g, b * s, K, D,
                                          xt.dtype).reshape(b, s, D))
            rows.append(jnp.concatenate(cols, axis=1))
        return jnp.concatenate(rows, axis=0)

    p = {"router": jnp.asarray(v["router"]),
         "experts": {k: jnp.asarray(v[k]) for k in ("w_gate", "w_up", "w_down")}}
    x = jnp.asarray(v["x"])
    y = per_shard(p, x)
    gp, gx = jax.grad(lambda p_, x_: jnp.sum(per_shard(p_, x_) * v["cot"]),
                      argnums=(0, 1))(p, x)
    return np.asarray(y), {"x": gx, "router": gp["router"], **gp["experts"]}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    inp = {"cases": np.array(list(CASES))}
    values = {}
    for i, case in enumerate(CASES):
        E, K, _, _ = CASES[case]
        values[case] = _inputs(case, i)
        inp[f"{case}:moe"] = np.array([E, K, F, CF])
        inp.update({f"{case}:{k}": a for k, a in values[case].items()})
    refs = {}

    def references():  # computed while the ranks run
        refs.update({case: _reference(case, values[case]) for case in CASES})

    ranks = spawn("expert_parallel", WORLD, tmp_path_factory.mktemp("expert_parallel"), inp,
                  meanwhile=references)
    return refs, ranks


@pytest.mark.parametrize("case", list(CASES))
def test_output_and_grads_match_the_references_shards(four_ranks, case):
    refs, ranks = four_ranks
    y, grads = refs[case]
    for r in ranks:
        _close(r[f"{case}:y"], y, 1e-6, f"{case} y")
        for k, g in grads.items():
            _close(r[f"{case}:g:{k}"], np.asarray(g), 1e-5, f"{case} d{k}")


def test_all_to_all_sends_the_shapes_buffers(four_ranks):
    """Two forward and two backward exchanges over ``model`` of the
    (E, C_loc, D) f32 buffer (each rank's payload), and no other
    collective in the layer."""
    _, ranks = four_ranks
    E = CASES["all_to_all"][0]
    C, _ = _c_loc("all_to_all")
    for r in ranks:
        comm = {k[len("all_to_all:comm:"):]: int(v) for k, v in r.items()
                if k.startswith("all_to_all:comm:")}
        assert comm == {"model:all_to_all_single:calls": 4,
                        "model:all_to_all_single:payload": 4 * E * C * D * 4}, comm


def test_local_layout_sends_nothing(four_ranks):
    """Experts the model axis does not divide stay whole on every rank and
    the layer sends nothing, forward or backward."""
    for r in four_ranks[1]:
        assert not [k for k in r if k.startswith("local:comm:")]


def test_unsplit_sequence_gathers_the_experts(four_ranks):
    """Decode's layout (the sequence unsplit): the three expert weights,
    stored over ``model``, are gathered whole (each rank's shard of E/2
    experts), and their gradients summed over ``data``; no all-to-all."""
    E = CASES["local_seq"][0]
    shard = (E // TP) * D * F * 4
    for r in four_ranks[1]:
        comm = {k[len("local_seq:comm:"):]: int(v) for k, v in r.items()
                if k.startswith("local_seq:comm:")}
        assert comm == {"model:all_gather_into_tensor:calls": 3,
                        "model:all_gather_into_tensor:payload": 3 * shard,
                        "data:all_reduce:calls": 3,
                        "data:all_reduce:payload": 3 * 2 * shard}, comm
