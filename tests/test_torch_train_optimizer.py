"""The port's optimizers (``repro_torch.runtime.optimizer``) and the
pieces of its train step that do not depend on a model: the reference's
optimizer checks (tests/test_optimizer_and_sharding.py:12-55) on the
port, both optimizers against the reference from identical gradients
over three steps (a tree of 1-D, 2-D and stacked 3-D leaves; parameters
and state to 1e-6 relative), the state definitions leaf for leaf, and the
microbatch split of the grad-accumulating train step. The model-level
train parity is in the family files ``tests/test_torch_train_*.py``."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.smoke import smoke_config as jax_smoke_config  # noqa
from repro.models.model import build_model as jax_build_model  # noqa
from repro.runtime import optimizer as JO  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.launch.steps import microbatches  # noqa: E402
from repro_torch.models.bridge import tree_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import optimizer as O  # noqa: E402
from repro_torch.runtime.optimizer import (  # noqa: E402
    adafactor, adamw, make_optimizer)

from _torch_parity import spec_rows_port, spec_rows_ref  # noqa: E402
from _torch_train import leaves_port, leaves_ref  # noqa: E402

# identical gradients: the same f32 arithmetic in the same order, but
# pow, sqrt, rsqrt and the means of two libraries
OPT_TOL = 1e-6


def _t(a):
    return torch.tensor(a, dtype=torch.float32)


# ------------------------------------------ the reference's optimizer checks
def test_adamw_matches_reference_math():
    opt = adamw(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0)
    p = {"w": _t([1.0, -2.0])}
    g = {"w": _t([0.5, 0.5])}
    s = opt.init(p)
    p1, s1 = opt.update(g, s, p, torch.tensor(0, dtype=torch.int32))
    # step 1 with bias correction: m_hat = g, v_hat = g^2 -> step = g/|g| = 1
    np.testing.assert_allclose(p1["w"].numpy(), [1.0 - 0.1, -2.0 - 0.1],
                               rtol=1e-5)


def test_adamw_weight_decay_pulls_to_zero():
    opt = adamw(lr=0.01, weight_decay=0.1)
    p = {"w": torch.ones(4)}
    g = {"w": torch.zeros(4)}
    s = opt.init(p)
    p1, _ = opt.update(g, s, p, torch.tensor(0, dtype=torch.int32))
    assert (p1["w"] < 1.0).all()


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_adafactor_descends_quadratic(seed):
    rng = np.random.default_rng(seed)
    target = _t(rng.normal(size=(8, 8)))
    p = {"w": torch.zeros((8, 8))}
    opt = adafactor(lr=0.3)
    s = opt.init(p)
    loss0 = float(((p["w"] - target) ** 2).sum())
    for step in range(20):
        g = {"w": 2 * (p["w"] - target)}
        p, s = opt.update(g, s, p, torch.tensor(step, dtype=torch.int32))
    loss1 = float(((p["w"] - target) ** 2).sum())
    assert loss1 < 0.5 * loss0


def test_adafactor_state_is_factored():
    """Over the last two dims, so a stacked [L, a, b] leaf keeps [L, a]
    and [L, b]; a full moment for vectors."""
    opt = adafactor()
    p = {"w": torch.zeros((64, 32)), "b": torch.zeros((64,)),
         "stack": torch.zeros((3, 64, 32))}
    s = opt.init(p)
    assert s["f"]["w"]["vr"].shape == (64,)
    assert s["f"]["w"]["vc"].shape == (32,)
    assert s["f"]["b"]["v"].shape == (64,)
    assert s["f"]["stack"]["vr"].shape == (3, 64)
    assert s["f"]["stack"]["vc"].shape == (3, 32)
    assert all(t.dtype == torch.float32 for t in
               [s["f"][k][m] for k in s["f"] for m in s["f"][k]])


def test_make_optimizer_refuses_an_unknown_name():
    assert make_optimizer("adamw").name == "adamw"
    assert make_optimizer("adafactor", lr=0.5).name == "adafactor"
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("sgd")


# ------------------------------------------------- against the reference
def _tree(seed: int, scale: float = 1.0) -> dict:
    """1-D, 2-D and stacked 3-D leaves, nested in dicts and a list."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {"b": f(7), "w": f(6, 5),
            "layers": {"stack": f(3, 4, 5), "ln": f(3, 4)},
            "enc": [{"w": f(5, 2)}, {"w": f(5, 2)}]}


@pytest.mark.parametrize("name,kw", [
    ("adamw", {"lr": 1e-2, "weight_decay": 0.1}),
    ("adafactor", {"lr": 1e-2})])
def test_optimizers_match_reference_from_identical_gradients(name, kw):
    """Three steps, the same gradients given to both packages at each:
    the parameters and every state leaf to 1e-6 relative."""
    p_np = _tree(0)
    jopt, topt = JO.make_optimizer(name, **kw), make_optimizer(name, **kw)
    pj = jax.tree.map(jnp.asarray, p_np)
    pt = tree_from_numpy(p_np, "cpu")
    sj, stt = jopt.init(pj), topt.init(pt)
    for step in range(3):
        g_np = _tree(10 + step, scale=0.1)
        # one gradient entry exactly zero and one tiny: Adam's sign region
        g_np["b"][0], g_np["b"][1] = 0.0, 1e-12
        pj, sj = jopt.update(jax.tree.map(jnp.asarray, g_np), sj, pj,
                             jnp.int32(step))
        pt, stt = topt.update(tree_from_numpy(g_np, "cpu"), stt, pt,
                              torch.tensor(step, dtype=torch.int32))
        for got, want in ((pt, pj), (stt, sj)):
            for g, (path, w) in zip(leaves_port(got), leaves_ref(want),
                                    strict=True):
                np.testing.assert_allclose(g, w, rtol=OPT_TOL, atol=1e-12,
                                           err_msg=f"step {step}: {path}")


def test_adamw_in_slices_equals_one_pass(monkeypatch):
    """AdamW updates a leaf in slices of ``_SLICE`` values: elementwise,
    so the bits are those of one pass."""
    p_np, g_np = _tree(1), _tree(2, scale=0.1)
    out = []
    for size in (O._SLICE, 7):
        monkeypatch.setattr(O, "_SLICE", size)
        opt = adamw(lr=1e-2)
        p = tree_from_numpy(p_np, "cpu")
        s = opt.init(p)
        for step in range(2):
            opt.update(tree_from_numpy(g_np, "cpu"), s, p,
                       torch.tensor(step, dtype=torch.int32))
        out.append(leaves_port(p) + leaves_port(s))
    for a, b in zip(*out):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_state_defs_match_reference(name):
    """llama4's smoke parameter tree (stacked super-blocks, 3-D expert
    weights, norms): the state's ParamSpec tree equals the reference's
    leaf for leaf (path, shape, dtype, init, axes)."""
    arch = "llama4-maverick-400b-a17b"
    jdefs = jax_build_model(jax_smoke_config(arch)).param_defs
    tdefs = build_model(smoke_config(arch)).param_defs
    assert (spec_rows_port(make_optimizer(name).state_defs(tdefs))
            == spec_rows_ref(JO.make_optimizer(name).state_defs(jdefs)))


# ------------------------------------------------------------ microbatches
def test_microbatches_split_like_the_reference():
    """The reference's split (src/repro/launch/steps.py:44-52): a batch
    axis n_mb divides is cut, any other leaf goes whole to each
    microbatch, and mrope_positions [3, B, S] is cut on its second axis."""
    B, S = 4, 6
    batch = {"tokens": torch.arange(B * S).reshape(B, S),
             "frames": torch.arange(B * 2 * 3.0).reshape(B, 2, 3),
             "mrope_positions": torch.arange(3 * B * S).reshape(3, B, S)}
    mbs = microbatches(batch, 2)
    assert len(mbs) == 2
    for i, mb in enumerate(mbs):
        assert torch.equal(mb["tokens"], batch["tokens"][2 * i:2 * i + 2])
        assert torch.equal(mb["frames"], batch["frames"][2 * i:2 * i + 2])
        assert torch.equal(mb["mrope_positions"],
                           batch["mrope_positions"][:, 2 * i:2 * i + 2])
    # n_mb = 4 at B = 2 (llama4's smoke step): every microbatch whole
    half = {k: (v[:, :2] if k == "mrope_positions" else v[:2])
            for k, v in batch.items()}
    for mb in microbatches(half, 4):
        for k in half:
            assert torch.equal(mb[k], half[k])
