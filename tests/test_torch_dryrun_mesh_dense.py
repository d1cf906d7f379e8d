"""Smoke steps of the dense archs without a mesh file of their own
(glm4-9b, granite-20b, starcoder2-3b) on 2x4 and 2x2x2 fake meshes
(``tests/_torch_mesh.py``): train, prefill and decode run under
``launch/dryrun.lower_cell`` on the meshes that ``CELLS`` names, and
each step reads the reference's counts (``matches_reference``)."""
import pytest

pytest.importorskip("torch")

from _torch_mesh import (matches_reference, meshes,  # noqa: E402,F401
                         reference_cases)


@pytest.mark.parametrize("arch,kind,mesh_name", reference_cases(
    ["glm4-9b", "granite-20b", "starcoder2-3b"]))
def test_step_reads_the_reference_counts(meshes, arch, kind,  # noqa: F811
                                         mesh_name):
    matches_reference(arch, kind, mesh_name, meshes)
