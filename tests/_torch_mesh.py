"""The one fixture of the port's tests that builds meshes: a module's
2x4 ("data", "model") and 2x2x2 ("pod", "data", "model") meshes over the
fake process group of ``repro_torch.launch.mesh``, which it starts and
destroys at the module's end, so no other test sees a process group."""
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.launch.mesh import make_mesh  # noqa: E402

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def meshes():
    if dist.is_initialized():
        pytest.fail("a process group is already running")
    try:
        yield {name: make_mesh(*spec) for name, spec in MESHES.items()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# the (kind, mesh) cells each family's smoke steps run on: train on both
# meshes, a serve step on one each (prefill on the 3-D mesh, decode on
# 2x4), which keeps each file near a minute
CELLS = (("train", "2x4"), ("train", "2x2x2"), ("prefill", "2x2x2"),
         ("decode", "2x4"))
B, S = 4, 16
# the layers a smoke step keeps on a mesh: every kind of layer a family
# has once (deepseek's dense layer and one MoE layer, griffin's (rec, rec,
# attn) triple, llama4's super-block of 4); DTensor's per-operation cost
# makes the depth the test's time
LAYERS = {"deepseek-v2-lite-16b": 2, "recurrentgemma-9b": 3,
          "llama4-maverick-400b-a17b": 4, "whisper-tiny": 1}


def holds_on_mesh(arch: str, kind: str, mesh) -> dict:
    """A smoke step of ``arch`` run under ``launch/dryrun.lower_cell`` on
    ``mesh``: it must count each device's work, at least the unsharded
    step's FLOPs over the mesh's devices, and call the same kernel entries
    as the unsharded step on one device. -> the analysis."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import mesh_chips
    cfg = smoke_config(arch)
    cfg = cfg.replace(num_layers=LAYERS.get(arch, 2))
    if cfg.family == "audio":
        cfg = cfg.replace(encoder_layers=1)
    shape = ShapeConfig("smoke", S, B, kind)
    one, _ = lower_cell(arch, shape, None, cfg=cfg)
    got, _ = lower_cell(arch, shape, mesh, cfg=cfg)
    assert got["flops"] > 0 and got["memory_bytes"] > 0
    assert got["flops"] * mesh_chips(mesh) >= one["flops"]
    assert got["kernel_calls"] == one["kernel_calls"]
    assert got["collective_total_bytes"] > 0
    assert got["peak_bytes"] >= got["argument_bytes"] > 0
    return got
