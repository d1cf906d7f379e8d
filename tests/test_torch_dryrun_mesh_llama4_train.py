"""A smoke train step of llama4 (chunked-local attention, MoE) on the
2x2x2 fake mesh (``tests/_torch_mesh.py``) under
``launch/dryrun.lower_cell``: each device's FLOPs times the devices cover
the unsharded step's. Its other cells are in
``test_torch_dryrun_mesh_llama4.py``; this one alone takes half a
minute."""
import pytest

pytest.importorskip("torch")

from _torch_mesh import holds_on_mesh, meshes  # noqa: E402,F401


def test_train_step_runs_on_the_3d_mesh(meshes):  # noqa: F811
    holds_on_mesh("llama4-maverick-400b-a17b", "train", meshes["2x2x2"])
