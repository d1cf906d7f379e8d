"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's: ``active_params`` and ``model_flops`` exactly the reference's
for all ten archs at full width and every cell; each smoke train step's
analyzed FLOPs on the CPU within ``FLOPS_TOL`` of the reference's
``hlo_analysis.analyze`` of its compiled step (split with
``test_torch_dryrun_families.py``, a JAX compile a step); the op record
that ``--save-ops`` writes read by ``launch/breakdown.py``."""
import json

import jax
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import cells as jax_cells  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import registry as jax_registry  # noqa: E402
from repro.configs.smoke import smoke_config as jax_smoke  # noqa: E402
from repro.launch import dryrun as JD  # noqa: E402
from repro.launch.hlo_analysis import analyze as hlo_analyze  # noqa: E402
from repro.launch.steps import make_train_step as jax_train_step  # noqa
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.modules import abstract_params as jax_abstract  # noqa
from repro.runtime.optimizer import make_optimizer as jax_opt  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig, cells  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.launch import breakdown  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import step_analysis  # noqa: E402
from repro_torch.launch.step_analysis import analyze  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.modules import init_params  # noqa: E402

ARCHS = sorted(jax_registry())
# the smoke train steps' FLOPs, port (CPU plain paths) against the
# reference's compiled HLO: -1.72 % (qwen2-vl-7b) to +0.02 % (whisper-tiny)
# when measured; the gap is where the two frameworks lower the same
# products differently (einsum splits, the loss's chunking)
FLOPS_TOL = 0.025
TRAIN_B, TRAIN_S = 2, 32
HERE = ["glm4-9b", "granite-20b", "mamba2-2.7b", "qwen2-vl-7b",
        "smollm-135m", "starcoder2-3b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_and_model_flops_are_the_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jdefs, defs = jax_build(jcfg).param_defs, build_model(cfg).param_defs
    assert D.active_params(cfg, defs) == JD.active_params(jcfg, jdefs)
    assert cells(arch) == jax_cells(arch)
    for name in cells(arch):
        assert D.model_flops(cfg, defs, SHAPES[name]) == \
            JD.model_flops(jcfg, jdefs, JSHAPES[name])


def smoke_train_flops(arch) -> tuple[float, float]:
    """(the port's analyzed FLOPs of a smoke train step on CPU tensors,
    the reference's HLO count of the same step compiled)."""
    jcfg = jax_smoke(arch)
    jb = jax_build(jcfg)
    step, state_defs = jax_train_step(jb, jax_opt(jcfg.optimizer))
    batch = jb.batch_defs(JShape("t", TRAIN_S, TRAIN_B, "train"))
    text = jax.jit(step).lower(jax_abstract(state_defs),
                               jax_abstract(batch)).compile().as_text()
    want = hlo_analyze(text, 1)["flops"]
    bundle = build_model(smoke_config(arch))
    step, defs = D.step_and_defs(bundle, ShapeConfig("t", TRAIN_S, TRAIN_B,
                                                     "train"))
    args = tuple(init_params(d, torch.Generator().manual_seed(0), "cpu")
                 for d in defs)
    _, got = analyze(step, *args)
    return got["flops"], want


@pytest.mark.parametrize("arch", HERE)
def test_smoke_train_flops_match_the_reference_hlo(arch):
    got, want = smoke_train_flops(arch)
    assert abs(got - want) <= FLOPS_TOL * want, (got, want)


def test_breakdown_reads_the_saved_ops(tmp_path, monkeypatch):
    """An op record as ``--save-ops`` writes it, of a smoke train step on
    one device with every row kept: the memory breakdown returns the
    largest rows, summed, and there is no collective."""
    bundle = build_model(smoke_config("smollm-135m"))
    step, args = D.step_and_args(bundle, ShapeConfig("t", 16, 2, "train"))
    monkeypatch.setattr(step_analysis, "ROW_BYTES", 0)
    _, ana = analyze(step, *args, record_ops=True)
    path = tmp_path / "cell.ops.json"
    path.write_text(json.dumps({"chips": 1, "ops": ana["ops"]}))
    record = json.loads(path.read_text())
    assert record["ops"] and all(
        {"kind", "op", "shapes", "bytes", "frame"} <= set(r)
        for r in record["ops"])
    rows = breakdown.memory_breakdown(record, top=5, min_bytes=0)
    assert 0 < len(rows) <= 5
    assert rows == sorted(rows, reverse=True)
    assert rows[0][0] == max(r[0] for r in breakdown.memory_breakdown(
        record, top=10 ** 6, min_bytes=0))
    assert breakdown.collective_breakdown(record) == []
    assert any("models/" in r["frame"] for r in record["ops"])



def test_abstract_tree_is_the_reference_on_the_production_meshes():
    """``dryrun.abstract_tree`` of every arch's parameters on the 16x16 and
    2x16x16 meshes: each leaf's shape, dtype and spec (the mesh axes of
    each dim, major to minor) are the reference's ``abstract_tree``'s,
    which a child process with 512 host devices computes."""
    import sys
    import torch.distributed as dist
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from make_torch_mesh_reference import abstract_trees

    from repro_torch.launch.mesh import make_mesh_by_name
    from repro_torch.models.modules import tree_leaves

    def spec(x):
        axes = [[] for _ in x.shape]
        for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
            if p.is_shard():
                axes[p.dim].append(name)
        return axes

    want = abstract_trees()
    assert not dist.is_initialized()
    try:
        for arch in ARCHS:
            defs = build_model(get_config(arch)).param_defs
            for name in ("single", "multi"):
                leaves = tree_leaves(D.abstract_tree(
                    defs, make_mesh_by_name(name)), is_leaf=torch.is_tensor)
                got = [[list(x.shape), str(x.dtype).replace("torch.", ""),
                        spec(x)] for x in leaves]
                assert got == want[arch][name], (arch, name)
    finally:
        dist.destroy_process_group()
