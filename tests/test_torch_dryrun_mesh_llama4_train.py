"""A smoke train step of llama4 (chunked-local attention, MoE) on the
2x2x2 fake mesh (``tests/_torch_mesh.py``) under
``launch/dryrun.lower_cell``: each device's FLOPs times the devices cover
the unsharded step's, and it reads the reference's counts
(``matches_reference``). Its other cells are in
``test_torch_dryrun_mesh_llama4.py``; this one alone takes half a
minute."""
import pytest

pytest.importorskip("torch")

from _torch_mesh import (holds_on_mesh, matches_reference,  # noqa: E402
                         meshes, reference_cases)  # noqa: F401


def test_train_step_runs_on_the_3d_mesh(meshes):  # noqa: F811
    holds_on_mesh("llama4-maverick-400b-a17b", "train", meshes["2x2x2"])


@pytest.mark.parametrize("arch,kind,mesh_name", reference_cases(
    ["llama4-maverick-400b-a17b"], [("train", "2x2x2")]))
def test_step_reads_the_reference_counts(meshes, arch, kind,  # noqa: F811
                                         mesh_name):
    matches_reference(arch, kind, mesh_name, meshes)
