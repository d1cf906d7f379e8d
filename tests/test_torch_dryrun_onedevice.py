"""The dry run's one-device smoke steps against the reference's compiled
steps: each arch's prefill, decode and train step (the smoke config cut as
``_torch_mesh.LAYERS`` cuts it, B 4, S 16, no mesh) run on meta tensors
under ``launch/dryrun.lower_cell``, where the kernels' entries count
their calls by the model's own algorithm (``ops.model_work``) and the
train step's backward goes through the kernels' backward, reads FLOPs
within ``FLOPS_TOL`` of the reference's ``hlo_analysis`` count of the same
step compiled on one device (``tests/data/torch_mesh_reference.json``,
mesh name "1"; read without JAX)."""
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_mesh import (B, FLOPS_TOL, LAYERS, NO_REFERENCE,  # noqa
                         ONE_DEVICE_CELLS, REFERENCE, S)
from repro_torch.configs.base import ShapeConfig, registry  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.launch.dryrun import lower_cell  # noqa: E402

# every arch of the port that the reference has (``NO_REFERENCE``: none
# to compare with)
ARCHS = sorted(a for a in registry() if a not in NO_REFERENCE)


@pytest.mark.parametrize("kind", [k for k, _ in ONE_DEVICE_CELLS])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_step_reads_the_reference_flops(arch, kind):
    cfg = smoke_config(arch).replace(num_layers=LAYERS.get(arch, 2))
    if cfg.family == "audio":
        cfg = cfg.replace(encoder_layers=1)
    got, _ = lower_cell(arch, ShapeConfig("smoke", S, B, kind), None,
                        cfg=cfg)
    want = json.loads(REFERENCE.read_text())["cells"][f"{arch}:{kind}:1"]
    assert abs(got["flops"] - want["flops"]) <= FLOPS_TOL * want["flops"], \
        (got["flops"], want["flops"])
