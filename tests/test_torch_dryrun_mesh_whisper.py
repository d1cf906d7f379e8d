"""Smoke steps of whisper-tiny (encoder-decoder, cross attention) on 2x4 and 2x2x2 fake meshes
(``tests/_torch_mesh.py``): train, prefill and decode run under
``launch/dryrun.lower_cell`` on the meshes that ``CELLS`` names, and
each device's FLOPs times the devices cover the unsharded step's;
each step reads the reference's counts (``matches_reference``)."""
import pytest

pytest.importorskip("torch")

from _torch_mesh import (CELLS, holds_on_mesh,  # noqa: E402,F401
                         matches_reference, meshes, reference_cases)


@pytest.mark.parametrize("kind,mesh_name", CELLS)
@pytest.mark.parametrize("arch", ["whisper-tiny"])
def test_step_runs_on_the_mesh(meshes, arch, kind, mesh_name):  # noqa: F811
    holds_on_mesh(arch, kind, meshes[mesh_name])


@pytest.mark.parametrize("arch,kind,mesh_name",
                         reference_cases(["whisper-tiny"]))
def test_step_reads_the_reference_counts(meshes, arch, kind,  # noqa: F811
                                         mesh_name):
    matches_reference(arch, kind, mesh_name, meshes)
