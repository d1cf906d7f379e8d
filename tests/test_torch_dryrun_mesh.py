"""Smoke steps of the dense and vlm family (``_decoder_lm``) on 2x4 and 2x2x2 fake meshes
(``tests/_torch_mesh.py``): train, prefill and decode run under
``launch/dryrun.lower_cell`` on the meshes that ``CELLS`` names, and
each device's FLOPs times the devices cover the unsharded step's;
each step reads the reference's counts (``matches_reference``)."""
import pytest

pytest.importorskip("torch")

from _torch_mesh import (CELLS, holds_on_mesh,  # noqa: E402,F401
                         matches_reference, meshes, reference_cases)


@pytest.mark.parametrize("kind,mesh_name", CELLS)
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-vl-7b"])
def test_step_runs_on_the_mesh(meshes, arch, kind, mesh_name):  # noqa: F811
    holds_on_mesh(arch, kind, meshes[mesh_name])


@pytest.mark.parametrize("arch,kind,mesh_name",
                         reference_cases(["smollm-135m", "qwen2-vl-7b"]))
def test_step_reads_the_reference_counts(meshes, arch, kind,  # noqa: F811
                                         mesh_name):
    matches_reference(arch, kind, mesh_name, meshes)



def test_a_fallback_runs_gathered_only_for_a_known_gap(
        meshes, monkeypatch):  # noqa: F811
    """An operation that DTensor has no strategy for fails under
    ``Reshards`` unless it is one of ``KNOWN_GAPS`` (renorm, which has
    none at any layout); a known one runs again on its operands gathered
    whole and is counted by name (an operation that fails at its
    operands' first layout only)."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import dryrun as D
    x = DTensor.from_local(torch.empty(4, 8, device="meta"), meshes["2x4"],
                           [Shard(0), Shard(1)], run_check=False)
    mode = D.Reshards()
    with pytest.raises(NotImplementedError, match="renorm: .*KNOWN_GAPS"):
        with mode:
            torch.renorm(x, 2, 0, 1.0)

    class FailsSharded:
        _schema = torch.ops.aten.renorm.default._schema
        seen = []

        def __call__(self, t):
            self.seen.append(t.placements)
            if len(self.seen) == 1:
                raise NotImplementedError("no strategy at this layout")
            return t

    monkeypatch.setattr(D, "KNOWN_GAPS", frozenset({"renorm"}))
    y = mode.__torch_dispatch__(FailsSharded(), (DTensor,), (x,))
    assert FailsSharded.seen == [x.placements, (Replicate(), Replicate())]
    assert y.shape == x.shape and mode.fallbacks == {"renorm": 1}
