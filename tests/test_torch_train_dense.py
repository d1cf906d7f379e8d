"""Training of the homogeneous decoder LMs (glm4, granite, qwen2-vl,
smollm, starcoder2) in the PyTorch port against the JAX package, at the
smoke configs in f32 from bridged weights (``tests/_torch_train.py`` has
the helpers and the tolerances): ``loss_fn``'s loss, metrics and every
gradient leaf, one ``make_train_step`` step (granite accumulates 2
microbatches; qwen2-vl with ``grad_accum=2`` splits ``mrope_positions``
on its second axis), the three ``remat`` modes, a train state carried
across the bridge at step 2, and the port's own ``init_train_state``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import registry as jax_registry  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    grads_of, init_train_state, make_prefill_step, make_train_step,
    train_state_defs)
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import tree_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.modules import init_params, tree_leaves  # noqa
from repro_torch.runtime.optimizer import make_optimizer  # noqa: E402

import _torch_train as TR  # noqa: E402

ARCHS = sorted(a for a in jax_registry()
               if jax_get_config(a).family in ("dense", "vlm"))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    TR.check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    TR.check_train_step(arch)


@pytest.mark.parametrize("arch", ["glm4-9b", "starcoder2-3b"])
def test_remat_modes_give_identical_gradients(arch):
    TR.check_remat_modes(arch)


def test_vlm_grad_accum_splits_mrope_positions():
    """qwen2-vl with 2 microbatches of a batch of 4: each takes 2 rows of
    the tokens and mrope_positions[:, rows] (random positions, so a split
    on another axis would move the rope)."""
    TR.check_train_step("qwen2-vl-7b", b=4, grad_accum=2)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_train_state_crosses_the_bridge_at_step_k(opt_name):
    """Two reference steps, then the state at step 2 (parameters, the
    optimizer's m/v or f trees, step) crosses through
    ``tree_from_numpy``; one more step in each package agrees."""
    arch = "smollm-135m"
    jcfg, tcfg = TR.cfgs(arch, optimizer=opt_name)
    jb, tb = TR.bundles(jcfg, tcfg)
    jopt, _ = TR.optimizers(opt_name)
    p, b = TR.params_np(jb, 5), TR.batch_np(jb, 6)
    at2, _ = TR.ref_steps(arch, jb, TR.state_np(jopt, p), b, n=2)
    assert int(at2["step"]) == 2
    want, wm = TR.ref_steps(arch, jb, at2, b)
    got, gm = TR.port_step(tb, at2, b)
    assert int(got["step"]) == 3
    TR.close_metrics(gm, wm)
    grads = TR.ref_grads(arch, jb, at2["params"], b)[2]
    TR.check_update(arch, opt_name, at2["params"], got["params"],
                    want["params"], grads)
    TR.close_leaves(got["opt"], want["opt"])


def test_init_train_state_follows_the_state_defs():
    """The port's own init: the parameters drawn from the generator (the
    same seed gives the same tree), zero f32 moments, step 0 in int32,
    every leaf as ``train_state_defs`` declares it."""
    bundle = build_model(smoke_config("smollm-135m"))
    opt = make_optimizer("adamw")
    defs = train_state_defs(bundle, opt)
    st = init_train_state(bundle, opt, torch.Generator().manual_seed(1),
                          "cpu")
    specs = tree_leaves(defs)
    leaves = tree_leaves(st, is_leaf=torch.is_tensor)
    assert len(specs) == len(leaves)
    for spec, t in zip(specs, leaves):
        assert tuple(t.shape) == spec.shape and t.dtype == spec.dtype
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    assert all(not t.any() for t in tree_leaves(st["opt"], torch.is_tensor))
    again = init_train_state(bundle, opt, torch.Generator().manual_seed(1),
                             "cpu")
    for a, b in zip(tree_leaves(st["params"], torch.is_tensor),
                    tree_leaves(again["params"], torch.is_tensor)):
        assert torch.equal(a, b)
    # and it trains: one step moves every parameter
    step, _ = make_train_step(bundle, opt)
    before = [t.clone() for t in tree_leaves(st["params"], torch.is_tensor)]
    rng = np.random.default_rng(0)
    tok = lambda: torch.from_numpy(rng.integers(0, 512, (2, 16))
                                   .astype(np.int32))
    st, m = step(st, {"tokens": tok(), "targets": tok(),
                      "mask": torch.ones(2, 16, dtype=torch.int32)})
    assert np.isfinite(float(m["loss"])) and int(st["step"]) == 1
    assert all(not torch.equal(a, b) for a, b in zip(
        before, tree_leaves(st["params"], torch.is_tensor)))


@pytest.mark.parametrize("arch", ["smollm-135m", "llama4-maverick-400b-a17b"])
def test_training_after_serving_the_same_config(arch):
    """The padded heads' kv map and mask are tensors cached per config
    and device; when a prefill under inference_mode makes them first, a
    train step of the same config must still save them for its
    backward."""
    TT._kv_index.cache_clear()
    TT._head_mask_on.cache_clear()
    cfg = smoke_config(arch)
    assert cfg.pad_q_heads > cfg.num_heads
    bundle = build_model(cfg)
    params = init_params(bundle.param_defs, torch.Generator().manual_seed(0),
                         "cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    make_prefill_step(bundle)(params, {"tokens": tok})
    grads, m = grads_of(bundle.loss_fn, params, {
        "tokens": tok, "targets": tok,
        "mask": torch.ones(2, 16, dtype=torch.int32)})
    assert np.isfinite(float(m["loss"]))
    assert all(torch.isfinite(g).all()
               for g in tree_leaves(grads, torch.is_tensor))
