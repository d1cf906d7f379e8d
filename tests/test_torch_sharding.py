"""The port's logical-axis sharding rules (``repro_torch.parallel.
sharding``) against the JAX package's: ``logical_to_spec`` for every leaf
of every arch's parameter, train-state and cache defs on shape-only
16x16 and 2x16x16 meshes, ``bytes_per_device``, ``effective_rules``, the
reference test's divisibility and priority cases, and the DTensor
placements of a spec (a dim over ("pod", "data") splits pod-major, as in
JAX)."""
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import SHAPES  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import registry as jax_registry  # noqa: E402
from repro.launch.steps import make_train_step as jax_train_step  # noqa
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.modules import is_spec as jax_is_spec  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro.runtime.optimizer import make_optimizer as jax_opt  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.modules import tree_leaves  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.runtime.optimizer import make_optimizer  # noqa: E402

ARCHS = sorted(jax_registry())
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class TorchMesh:
    """A shape-only mesh as the port's rules read one."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = shape, names


def jax_mesh(shape, names):
    """A shape-only mesh as the reference's rules read one (its test's
    FakeMesh)."""
    class FakeMesh:
        axis_names = names

        class devices:
            pass
    FakeMesh.devices.shape = shape
    return FakeMesh()


def _leaves(tree_jax, tree_torch):
    import jax
    a = jax.tree.leaves(tree_jax, is_leaf=jax_is_spec)
    b = tree_leaves(tree_torch)
    assert [tuple(s.shape) for s in a] == [tuple(s.shape) for s in b]
    assert [tuple(s.logical_axes) for s in a] == \
        [tuple(s.logical_axes) for s in b]
    return a, b


def _defs(arch):
    """(reference, port) pairs of ParamSpec trees: parameters, the train
    state of the arch's optimizer, and the decode and long-context
    caches."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jb, b = jax_build(jcfg), build_model(cfg)
    out = [(jb.param_defs, b.param_defs),
           (jax_train_step(jb, jax_opt(jcfg.optimizer))[1],
            make_train_step(b, make_optimizer(cfg.optimizer))[1])]
    for name in ("decode_32k", "long_500k"):
        sh = SHAPES[name]
        long = sh.seq_len >= 2 ** 19
        out.append((jb.cache_defs(sh.global_batch, sh.seq_len, long),
                    b.cache_defs(sh.global_batch, sh.seq_len, long)))
    return jcfg, cfg, out


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_bytes_equal_the_reference(arch):
    jcfg, cfg, pairs = _defs(arch)
    jrules, rules = JS.effective_rules(jcfg), S.effective_rules(cfg)
    assert rules == jrules
    for shape, names in MESHES.values():
        jm, m = jax_mesh(shape, names), TorchMesh(shape, names)
        for jdefs, defs in pairs:
            a, b = _leaves(jdefs, defs)
            for js, s in zip(a, b):
                want = tuple(JS.logical_to_spec(js.shape, js.logical_axes,
                                                jm, jrules))
                assert S.logical_to_spec(s.shape, s.logical_axes, m,
                                         rules) == want
            assert S.bytes_per_device(defs, m, rules) == \
                JS.bytes_per_device(jdefs, jm, jrules)


def test_effective_rules_moe_modes():
    for impl in ("gspmd", "a2a", "hierarchical"):
        for arch in ARCHS:
            jcfg = jax_get_config(arch).replace(moe_impl=impl)
            cfg = get_config(arch).replace(moe_impl=impl)
            assert S.effective_rules(cfg) == JS.effective_rules(jcfg)
    r = S.effective_rules(get_config("llama4-maverick-400b-a17b"))
    assert r["moe_e"] == "dp" and r["moe_f"] == "tp"
    assert S.DEFAULT_RULES == JS.DEFAULT_RULES


def test_logical_spec_divisibility_and_priority():
    """The reference test's cases (tests/test_optimizer_and_sharding.py)."""
    m = TorchMesh((4, 8), ("data", "model"))
    P = S.logical_to_spec((64, 24), ("embed", "heads_q"), m)
    assert P == ("data", "model")
    assert S.logical_to_spec((6, 9), ("embed", "heads_q"), m) == (None, None)
    P3 = S.logical_to_spec((2, 4096, 9, 64),
                           ("batch", "act_seq_q", "act_heads", None), m)
    assert P3[1] == "model" and P3[2] is None
    P4 = S.logical_to_spec((2, 4096, 16, 64),
                           ("batch", "act_seq_q", "act_heads", None), m)
    assert P4[1] is None and P4[2] == "model"


def test_placements_split_pod_major():
    """("pod", "data") on dim 0 of a 2x16x16 mesh: device (p, d, m) holds
    chunk p * 16 + d of 32, JAX's order; "model" on dim 1 is Shard(1)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset as local_of
    m = TorchMesh((2, 16, 16), ("pod", "data", "model"))
    spec = S.logical_to_spec((64, 32, 8), ("batch", "mlp", None), m)
    assert spec == (("pod", "data"), "model", None)
    pl = S.logical_to_placements(spec, m)
    assert pl == (Shard(0), Shard(0), Shard(1))
    for coord in ((0, 0, 0), (1, 0, 3), (0, 5, 2), (1, 15, 15)):
        shape, offset = local_of((64, 32, 8), m.shape,
                                 lambda i, c=coord: c[i], pl, False)
        assert tuple(shape) == (2, 2, 8)
        assert tuple(offset) == ((coord[0] * 16 + coord[1]) * 2,
                                 coord[2] * 2, 0)
    assert S.logical_to_placements((None, None), m) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        S.logical_to_placements((("data", "pod"),), m)
