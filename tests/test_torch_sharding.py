"""The torch half of ``repro_torch/parallel/sharding.py`` against the reference.

Single process: each case of ``tests/test_sharding.py`` gives the
reference's spec (a ``PartitionSpec``'s entries) for the same inputs; the
aten spec propagation gives, node for node, the specs the reference's
``propagate_eqn_specs`` gives the jaxpr of the reference's ``_mlp`` and of
an attention function (compared where the graphs have the same nodes).
Four gloo ranks on the CPU (one spawn, ``tests/torch_dist_workers.py``):
specs become DTensor placements and back, ``shard`` redistributes, and
``named_sharding_tree`` gives a parameter tree's placements.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core.jaxpr_graph import trace as rtrace  # noqa: E402
from repro.kernels.ops import flash_attention as rflash  # noqa: E402
from repro.parallel import sharding as rsh  # noqa: E402
from repro_torch.core.fx_graph import trace  # noqa: E402
from repro_torch.kernels.ops import flash_attention  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from torch_dist_workers import spawn  # noqa: E402

SIZES = {"pod": 2, "data": 16, "model": 16}
DN = (((1,), (0,)), ((), ()))


def setup_function(_):
    sh.set_rules(sh.DEFAULT_RULES)
    rsh.set_rules(rsh.DEFAULT_RULES)


def spec(p):
    """A reference PartitionSpec as the port's tuple."""
    return tuple(p)


@pytest.mark.parametrize("entries,shape", [
    ((("pod", "data"), None, "model"), (64, 7, 32)),  # all divide: kept
    ((None, None, "model", None), (2, 128, 8, 64)),  # kv_heads 8 on a 16-way axis
    (("model", None), (49155, 1536)),  # odd vocab
])
def test_drop_indivisible_matches_reference(entries, shape):
    want = spec(rsh.drop_indivisible(P(*entries), shape, SIZES))
    assert sh.drop_indivisible(entries, shape, SIZES) == want


@pytest.mark.parametrize("entries,shape", [
    ((None, "model"), (4096, 11008)), ((), (2560,)), (("data", None), (4096, 64)),
])
def test_fsdp_extend_matches_reference(entries, shape):
    want = spec(rsh.fsdp_extend(P(*entries), shape, SIZES))
    assert sh.fsdp_extend(entries, shape, SIZES) == want


@pytest.mark.parametrize("path,shape", [
    ("layers/attn/wq", (1024, 2048)), ("layers/attn/wo", (2048, 1024)),
    ("layers/mlp/w_gate", (1024, 8192)), ("layers/mlp/w_down", (8192, 1024)),
    ("embedding/embed", (50304, 1024)), ("ln/scale", (1024,)),
    ("moe/experts/w_gate", (64, 1024, 768)), ("ssm/in_proj", (64, 256)),
])
def test_param_spec_conventions_match_reference(path, shape):
    want = spec(rsh.param_spec(path, shape))
    assert sh.param_spec(path, shape) == want
    # the port's parameter names carry the same leaf names (weights.py)
    assert sh.param_spec(path.replace("/", ".").replace("layers.", "layers.0."), shape) == want


def test_tree_param_specs_stacked_layers_match_reference():
    shapes = {"layers": {"attn": {"wq": (4, 64, 128)}}, "embedding": {"embed": (256, 64)}}
    want = rsh.tree_param_specs(jax.tree_util.tree_map(
        jnp.zeros, shapes, is_leaf=lambda x: isinstance(x, tuple)))
    got = sh.tree_param_specs({"layers": {"attn": {"wq": torch.zeros(4, 64, 128)}},
                               "embedding": {"embed": torch.zeros(256, 64)}})
    assert got["layers"]["attn"]["wq"] == spec(want["layers"]["attn"]["wq"]) == (None, None, "model")
    assert got["embedding"]["embed"] == spec(want["embedding"]["embed"])
    # a port unit's own parameter carries no stacked unit axis
    flat = sh.tree_param_specs({"layers.0.attn.wq": torch.zeros(64, 128)})
    assert flat["layers.0.attn.wq"] == spec(rsh.param_spec("layers/attn/wq", (64, 128)))


def test_resolve_respects_missing_axes():
    assert sh.resolve(["batch", None, "heads"]) == spec(rsh.resolve(["batch", None, "heads"]))
    assert sh.resolve(["batch", None, "heads"], {"data": 4, "model": 2}) == ("data", None, "model")


def test_rules_swap():
    sh.set_rules({**sh.DEFAULT_RULES, "heads": None})
    rsh.set_rules({**rsh.DEFAULT_RULES, "heads": None})
    assert sh.param_spec("x/wq", (16, 16)) == spec(rsh.param_spec("x/wq", (16, 16)))
    assert sh.param_spec("x/wq", (16, 16)) == (None, None)


def test_shard_noop_without_mesh():
    x = torch.ones(4, 4)
    assert sh.shard(x, "batch", None) is x
    assert bool((rsh.shard(jnp.ones((4, 4)), "batch", None) == 1).all())


@pytest.mark.parametrize("sharding,want", [
    (None, ()), (("data", None), ("data", None)), (["data", None], ("data", None)),
    ((("pod", "data"), "model"), (("pod", "data"), "model")),
])
def test_normalize_spec_matches_reference(sharding, want):
    ref = rsh.normalize_spec(None if sharding is None else P(*sharding))
    assert sh.normalize_spec(sharding) == want == spec(ref)


def _mlp_pair(n=6, width=16, batch=8):
    rng = np.random.default_rng(0)
    ws = [(rng.standard_normal((width, width)) * 0.3).astype(np.float32) for _ in range(n)]
    x = rng.standard_normal((batch, width)).astype(np.float32)

    def jfn(params, x):
        h = x
        for w in params:
            h = lax.tanh(lax.dot_general(h, w, DN))
        return jnp.sum(h * h)

    def tfn(params, x):
        h = x
        for w in params:
            h = torch.tanh(h @ w)
        return torch.sum(h * h)

    return jfn, tfn, ws, x


@pytest.mark.parametrize("mesh,x_spec,w_spec", [
    ({"data": 8}, ("data", None), ()),
    ({"data": 4, "model": 2}, ("data", None), (None, "model")),
    ({"data": 2, "model": 4}, ("data", "model"), ("model", None)),
])
def test_mlp_propagation_matches_reference(mesh, x_spec, w_spec):
    """Node by node, the propagated output specs and per-device bytes of
    the port's aten graph equal the reference's on its jaxpr."""
    jfn, tfn, ws, x = _mlp_pair()
    n = len(ws)
    jg = rtrace(jfn, [jnp.asarray(w) for w in ws], jnp.asarray(x), mesh=mesh,
                in_shardings=[P(*w_spec)] * n + [P(*x_spec)])
    tg = trace(tfn, [torch.tensor(w) for w in ws], torch.tensor(x), mesh=mesh,
               in_shardings=[w_spec] * n + [x_spec])
    assert [nd.kind for nd in tg.graph.nodes] == [nd.kind for nd in jg.graph.nodes]
    assert [tuple(spec(s) for s in specs) for specs in jg.eqn_specs] == tg.node_specs
    assert tg.graph.mem_v == jg.graph.mem_v
    assert tg.axis_sizes == jg.axis_sizes == mesh


def test_attention_propagation_matches_reference():
    """The flash-attention op keeps batch and heads: its output, and the
    loss's nodes after it, carry the reference's specs and per-device bytes
    (the port's op also returns lse, sharded alike)."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((8, 16, 4, 8)).astype(np.float32)
    mesh = {"data": 4, "model": 2}
    x_spec = ("data", None, "model", None)

    def jfn(q):
        out = rflash(q, q, q, causal=True)
        return jnp.sum(out * out)

    def tfn(q):
        out = flash_attention(q, q, q, causal=True)
        return torch.sum(out * out)

    jg = rtrace(jfn, jnp.asarray(q), mesh=mesh, in_shardings=[P(*x_spec)])
    tg = trace(tfn, torch.tensor(q), mesh=mesh, in_shardings=[x_spec])
    jspecs = {nd.kind: [spec(s) for s in specs] for nd, specs in zip(jg.graph.nodes,
                                                                       jg.eqn_specs)}
    tspecs = {nd.kind: list(specs) for nd, specs in zip(tg.graph.nodes, tg.node_specs)}
    assert tspecs["flash_attention"] == [x_spec, ("data", "model", None)]
    flash_kind = next(k for k in jspecs if k not in ("mul", "reduce_sum"))
    assert jspecs[flash_kind][0] == tspecs["flash_attention"][0]
    for kind in ("mul", "reduce_sum"):
        assert tspecs[kind] == jspecs[kind]
        assert ([nd.memory for nd in tg.graph.nodes if nd.kind == kind]
                == [nd.memory for nd in jg.graph.nodes if nd.kind == kind])
    out_bytes = 8 * 16 * 4 * 8 * 4 // 8
    flash = next(nd for nd in tg.graph.nodes if nd.kind == "flash_attention")
    assert flash.memory == out_bytes + 8 * 4 * 16 * 4 // 8  # out and lse, each /8


# ---------------------------------------------------------------------------
# Four gloo ranks: placements on a DeviceMesh
# ---------------------------------------------------------------------------

DTENSOR_CHECKS = [
    "place_shards_dim0", "normalize_spec_of_dtensor", "normalize_spec_of_placements",
    "shard_replicates", "shard_batch_over_data", "shard_passes_plain_tensors",
    "place_two_axes", "place_joint_axes", "named_sharding_tree", "named_sharding_tree_fsdp",
]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    x = np.arange(48, dtype=np.float32).reshape(8, 6)
    return spawn("sharding", 4, tmp_path_factory.mktemp("sharding"), {"x": x})


@pytest.mark.parametrize("check", DTENSOR_CHECKS)
def test_placements_on_four_ranks(four_ranks, check):
    assert all(bool(r[check]) for r in four_ranks), check
