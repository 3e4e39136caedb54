"""The dry run's planning fields against the reference's, bitwise, for
every (arch × mesh) train cell at the reference's 16 GiB, and the skip
statuses of every cell (``repro_torch.launch.dryrun.run_cell(...,
trace=False)``: the builder's rules, then ``segment_plan`` and
``plan_inputs``, as the reference's ``run_cell`` records them).

The reference's side runs in a subprocess (the same accounting, on an
abstract mesh; its ``dryrun`` module sets ``XLA_FLAGS`` at import, so it is
not imported) while the port plans here.  The cells are split between this
file and ``tests/test_torch_dryrun_planning_b.py`` by arch, so the two
halves run on two workers.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import SHAPES as RSHAPES  # noqa: E402
from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import shape_applicable as rshape_applicable  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import REFERENCE_HBM_BYTES  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402

ARCHS = ["qwen2.5-14b", "mistral-large-123b", "xlstm-1.3b", "zamba2-2.7b", "whisper-small"]
MESHES = ("single", "multi")
ROOT = Path(__file__).resolve().parents[1]

#: The reference's planning fields of a train cell, as its ``run_cell``
#: computes them after ``build_step`` (which sets the default rules)
REFERENCE = r'''
import json, sys
import numpy as np
from jax.sharding import AbstractMesh
from repro.configs import SHAPES, get_config
from repro.launch.plan import plan_inputs
from repro.launch.steps import _dp_shards, _model_shards, _seq_shards, segment_plan
from repro.parallel.sharding import DEFAULT_RULES, get_rules, set_rules

class Mesh(AbstractMesh):
    @property
    def devices(self):
        return np.empty(self.axis_sizes, dtype=object)

MESHES = {"single": ((16, 16), ("data", "model")), "multi": ((2, 16, 16), ("pod", "data", "model"))}
out = {}
for arch in sys.argv[2].split(","):
    cfg, shape = get_config(arch), SHAPES["train_4k"]
    for kind, (dims, names) in MESHES.items():
        set_rules(DEFAULT_RULES)
        mesh = Mesh(dims, names)
        sp, res = segment_plan(cfg, shape, mesh)
        pi = plan_inputs(cfg, shape, _dp_shards(mesh), _seq_shards(mesh, shape),
                         _model_shards(mesh), n_micro=sp.n_micro, rules=get_rules())
        out[f"{arch}|{kind}"] = {
            "segment_sizes": list(sp.sizes), "segment_remat": [bool(r) for r in sp.remat],
            "n_micro": sp.n_micro, "plan_feasible": bool(res.feasible),
            "plan_overhead_T": res.overhead if res.feasible else None,
            "plan_peak_M": res.peak_memory if res.feasible else None,
            "budget_per_device": pi.budget, "bytes_interior_per_device": pi.bytes_interior,
            "bytes_boundary_per_device": pi.bytes_boundary}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
'''


def reference_fields(tmp_path_factory, archs, compute_port):
    """The reference's fields (from a subprocess, started first) and the
    port's (``compute_port()``, meanwhile)."""
    path = tmp_path_factory.mktemp("dryrun_planning") / "reference.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(path), ",".join(archs)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        port = compute_port()
        log, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log.decode()[-4000:]
    return port, json.loads(path.read_text())


def port_fields(archs):
    out = {}
    for arch in archs:
        for kind in MESHES:
            sh.set_rules(sh.DEFAULT_RULES)
            rec = dryrun.run_cell(arch, "train_4k", kind, hbm_bytes=REFERENCE_HBM_BYTES,
                                  trace=False)
            out[f"{arch}|{kind}"] = rec
    sh.set_rules(sh.DEFAULT_RULES)
    return out


@pytest.fixture(scope="module")
def fields(tmp_path_factory):
    return reference_fields(tmp_path_factory, ARCHS, lambda: port_fields(ARCHS))


def check_cell(fields, arch, mesh):
    port, ref = fields
    got, want = port[f"{arch}|{mesh}"], ref[f"{arch}|{mesh}"]
    assert got["status"] == "ok"
    assert got["devices"] == (256 if mesh == "single" else 512)
    assert {k: got[k] for k in want} == want  # bitwise: ints and floats as json gives them


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_planning_fields_are_the_reference_run_cells(fields, arch, mesh):
    check_cell(fields, arch, mesh)


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_skip_statuses_are_the_references(arch, shape_name):
    """A cell is skipped, with the reference's reason, exactly where the
    reference's ``run_cell`` skips it."""
    rcfg, rshape = rget_config(arch), RSHAPES[shape_name]
    if not rshape_applicable(rcfg, rshape):
        want = dryrun.SKIP_LONG
    elif rcfg.encoder_decoder and rshape.kind == "decode" and rshape.seq_len > 32_768:
        want = dryrun.SKIP_ENC_DEC
    else:
        want = None
    assert dryrun.skip_reason(get_config(arch), SHAPES[shape_name]) == want
