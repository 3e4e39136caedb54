"""``repro_torch.launch.specs`` against the reference's ``launch/specs.py``:
for all ten configs, every ``SHAPES`` cell, on the production meshes
``{data: 16, model: 16}`` and ``{pod: 2, data: 16, model: 16}``.

The reference builds its shardings on a ``jax.sharding.AbstractMesh`` (a
subclass lends it the ``devices`` shape its ``_model_shards`` reads), so no
device and no ``with_sharding_constraint`` is involved; the port takes the
``{axis: size}`` dict.  Spec for spec (a one-axis tuple read as that axis,
trailing Nones dropped, as ``PartitionSpec`` compares): the inputs', the
parameters' (tensor parallelism plus the ``needs_fsdp`` extension), the
decode caches'; and the shapes and dtypes of the input, parameter,
optimizer and cache trees, all built on the meta device.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCH_IDS as RARCH_IDS  # noqa: E402
from repro.configs import SHAPES as RSHAPES  # noqa: E402
from repro.configs import get_config as rget_config  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import specs  # noqa: E402

MESHES = {"tp16_dp16": {"data": 16, "model": 16},
          "pod2": {"pod": 2, "data": 16, "model": 16}}


class _Mesh(AbstractMesh):
    """An abstract mesh with the ``devices`` shape the reference reads."""

    @property
    def devices(self):
        return np.empty(self.axis_sizes, dtype=object)


def _canon(spec):
    out = []
    for e in tuple(spec):
        if isinstance(e, (tuple, list)):
            e = None if not e else (e[0] if len(e) == 1 else tuple(e))
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _ref_leaves(tree, get):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp): get(v)
            for kp, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_leaves(tree, get, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_leaves(v, get, f"{prefix}{k}/"))
        else:
            out[prefix + k] = get(v)
    return out


def _shape(x):
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


def test_arch_ids_and_shapes_are_the_references():
    assert list(ARCH_IDS) == list(RARCH_IDS)
    assert {k: (v.seq_len, v.global_batch, v.kind) for k, v in SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind) for k, v in RSHAPES.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_and_shardings_match_the_reference(arch, mesh_name):
    sizes = MESHES[mesh_name]
    rmesh = _Mesh(tuple(sizes.values()), tuple(sizes))
    rcfg, cfg = rget_config(arch), get_config(arch)

    # parameters: shapes, dtypes, the serving cast, AdamW's state, shardings
    rparams, params = rspecs.params_specs(rcfg), specs.params_specs(cfg)
    assert _port_leaves(params, _shape) == _ref_leaves(rparams, _shape)
    assert _port_leaves(specs.params_specs(cfg, serving=True), _shape) == _ref_leaves(
        rspecs.params_specs(rcfg, serving=True), _shape)
    ropt, opt = rspecs.opt_specs(rparams), specs.opt_specs(params)
    assert _shape(opt["step"]) == _shape(ropt.step)
    for part in ("mu", "nu"):
        assert _port_leaves(opt[part], _shape) == _ref_leaves(getattr(ropt, part), _shape)
    want = _ref_leaves(rspecs.param_shardings(rcfg, rmesh), lambda s: _canon(s.spec))
    got = _port_leaves(specs.param_shardings(cfg, sizes), _canon)
    assert got == want

    # inputs and decode caches, every cell
    for name, rshape in RSHAPES.items():
        shape = SHAPES[name]
        assert {k: _shape(v) for k, v in specs.input_specs(cfg, shape).items()} == {
            k: _shape(v) for k, v in rspecs.input_specs(rcfg, rshape).items()}, name
        assert {k: _canon(v) for k, v in specs.input_shardings(cfg, shape, sizes).items()} == {
            k: _canon(v.spec) for k, v in rspecs.input_shardings(rcfg, rshape, rmesh).items()}
        if shape.kind != "decode":
            continue
        rcache, cache = rspecs.cache_specs(rcfg, rshape), specs.cache_specs(cfg, shape)
        assert _port_leaves(cache, _shape) == _ref_leaves(rcache, _shape), name
        assert _port_leaves(specs.cache_shardings(cfg, shape, sizes, cache), _canon) == \
            _ref_leaves(rspecs.cache_shardings(rcfg, rshape, rmesh, rcache),
                        lambda s: _canon(s.spec)), name


def test_replicated_and_batch_axes():
    sizes = MESHES["pod2"]
    rmesh = _Mesh(tuple(sizes.values()), tuple(sizes))
    assert specs.batch_axes(sizes) == rspecs.batch_axes(rmesh) == ("pod", "data")
    assert specs.replicated(sizes) == _canon(rspecs.replicated(rmesh).spec) == ()


def test_state_bytes_per_device_follows_the_shardings():
    """Per-device f32 parameters and AdamW moments: the shards' bytes, so a
    config one card cannot hold (mistral-large-123b: 16 B a parameter,
    ~2e12 B) fits on ``{data: 16, model: 16}`` under FSDP."""
    cfg = get_config("mistral-large-123b")
    whole = specs.state_bytes_per_device(cfg, {"data": 1, "model": 1})
    per = specs.state_bytes_per_device(cfg, MESHES["tp16_dp16"])
    assert whole == 12 * sum(int(np.prod(t.shape)) for t in jax.tree_util.tree_leaves(
        rspecs.params_specs(rget_config("mistral-large-123b"))))
    assert whole / 256 <= per < whole / 200
