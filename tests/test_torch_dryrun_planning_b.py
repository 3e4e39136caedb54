"""The other half of ``tests/test_torch_dryrun_planning.py``'s cells: the
dry run's planning fields against the reference's, bitwise, at the
reference's 16 GiB."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_dryrun_planning import (MESHES, check_cell, port_fields,  # noqa: E402
                                        reference_fields)

ARCHS = ["stablelm-3b", "phi4-mini-3.8b", "phi-3-vision-4.2b", "qwen3-moe-30b-a3b",
         "granite-moe-3b-a800m"]


@pytest.fixture(scope="module")
def fields(tmp_path_factory):
    return reference_fields(tmp_path_factory, ARCHS, lambda: port_fields(ARCHS))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_planning_fields_are_the_reference_run_cells(fields, arch, mesh):
    check_cell(fields, arch, mesh)
