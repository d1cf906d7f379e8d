"""Helpers the port's training parity tests share (``test_torch_train_*``):
the same numpy weights, optimizer state and batch handed to the reference
and to the port, and the comparisons with their tolerances.

Tolerances (f32 on both sides, sums in another order):
- the loss and its metrics to ``TOL`` (1e-4);
- every gradient leaf to ``TOL`` of its largest entry (a leaf's small
  entries are sums of the same size as its large ones, so their error is
  of the leaf's scale, not their own);
- parameters after a train step within 2·lr·(1 + weight_decay·|p|) +
  1e-6. AdamW's first step moves an entry by lr·(m̂ / (sqrt(v̂) + eps) +
  weight_decay·p), and m̂ / sqrt(v̂) is g / |g| at step 1: the sign of the
  gradient, so where an entry's gradient lies within rounding of zero a
  1e-7 difference between the packages flips its update by up to 2·lr
  (Adafactor's rsqrt(g² + 1e-30) does the same). The optimizers' own
  arithmetic is held to 1e-6 from identical gradients in
  tests/test_torch_train_optimizer.py, and the updates of the entries
  whose gradient is far from zero to ``STEP_TOL`` of lr here.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.smoke import smoke_config as jax_smoke_config
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.model import build_model as jax_build_model
from repro.models.modules import init_params as jax_init_params
from repro.runtime.optimizer import make_optimizer as jax_make_optimizer
from repro_torch.configs.smoke import smoke_config
from repro_torch.launch.steps import grads_of, make_train_step
from repro_torch.models.bridge import tree_from_numpy
from repro_torch.models.model import build_model
from repro_torch.models.modules import tree_leaves
from repro_torch.runtime.optimizer import make_optimizer

from _torch_parity import perturb

TOL = 1e-4
# an update whose gradient entry is at least GRAD_FLOOR of its leaf's
# largest is far from the sign flip above: it agrees to STEP_TOL of lr
GRAD_FLOOR, STEP_TOL = 1e-2, 1e-2
B, S = 2, 16
# the architectures whose reference runs op by op: the jitted reference
# flips a near-tie expert choice at the smoke router (ROADMAP, Queue C)
EAGER = ("deepseek-v2-lite-16b", "llama4-maverick-400b-a17b")


def cfgs(arch: str, **kw):
    """(reference config, port config) at the smoke size, with ``kw``."""
    return (jax_smoke_config(arch).replace(**kw),
            smoke_config(arch).replace(**kw))


def batch_np(jbundle, seed: int, b: int = B, s: int = S) -> dict:
    """A train batch as numpy: the reference's batch_defs filled from a
    seed, tokens and targets in range, a mask with some zeros, normal
    frames and small vision embeddings, and random rope positions in
    [0, s) (which a wrong split of mrope_positions would move)."""
    defs = jbundle.batch_defs(JaxShape("smoke", s, b, "train"))
    batch = {k: np.asarray(v)
             for k, v in jax_init_params(defs, jax.random.key(0)).items()}
    rng = np.random.default_rng(seed)
    V = jbundle.cfg.vocab_size
    batch["tokens"] = rng.integers(0, V, (b, s)).astype(np.int32)
    batch["targets"] = rng.integers(0, V, (b, s)).astype(np.int32)
    batch["mask"] = (rng.random((b, s)) > 0.2).astype(np.int32)
    if "frames" in batch:
        batch["frames"] = rng.standard_normal(
            batch["frames"].shape).astype(np.float32)
    if "vision_embeds" in batch:
        batch["vision_embeds"] = (rng.standard_normal(
            batch["vision_embeds"].shape) * 0.02).astype(np.float32)
    if "mrope_positions" in batch:
        batch["mrope_positions"] = rng.integers(
            0, s, batch["mrope_positions"].shape).astype(np.int32)
    return batch


def params_np(jbundle, seed: int):
    """The reference's initialization at ``seed``, as numpy, constant
    leaves given random values (``_torch_parity.perturb``)."""
    return perturb(jax_init_params(jbundle.param_defs, jax.random.key(seed)),
                   seed)


def run_ref(arch: str, fn):
    """``fn()`` op by op for the MoE archs (``EAGER``), else as it is."""
    if arch in EAGER:
        with jax.disable_jit():
            return fn()
    return fn()


def ref_grads(arch, jbundle, p_np, b_np):
    """-> (loss, metrics, grads) of the reference's ``loss_fn``."""
    def go():
        f = jax.value_and_grad(jbundle.loss_fn, has_aux=True)
        if arch not in EAGER:
            f = jax.jit(f)
        (loss, metrics), grads = f(jax.tree.map(jnp.asarray, p_np),
                                   {k: jnp.asarray(v)
                                    for k, v in b_np.items()})
        return loss, metrics, grads
    return run_ref(arch, go)


def leaves_ref(tree) -> list:
    """(path, numpy leaf) in the reference's flatten order (the port's
    ``tree_leaves`` order)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(v, np.float32))
            for p, v in flat]


def leaves_port(tree) -> list:
    return [t.detach().float().numpy()
            for t in tree_leaves(tree, is_leaf=torch.is_tensor)]


def close_metrics(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


def close_leaves(got, want, tol=TOL):
    """Every leaf of the port's tree ``got`` within ``tol`` of the largest
    entry of the reference's leaf (``want``), leaf for leaf."""
    got, want = leaves_port(got), leaves_ref(want)
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        assert g.shape == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (path, err, scale)


def port_grads(tbundle, p_np, b_np):
    """-> (grads, metrics) of the port's ``loss_fn`` on the CPU."""
    return grads_of(tbundle.loss_fn, tree_from_numpy(p_np, "cpu"),
                    tree_from_numpy(b_np, "cpu"))


def state_np(jopt, p_np, step: int = 0) -> dict:
    """A reference train state at ``step`` (fresh optimizer state), as
    numpy."""
    opt = jax.tree.map(np.asarray, jopt.init(jax.tree.map(jnp.asarray,
                                                          p_np)))
    return {"params": p_np, "opt": opt, "step": np.int32(step)}


def ref_steps(arch, jbundle, st_np, b_np, n: int = 1):
    """``n`` steps of the reference's train step from the numpy state.
    -> (the state as numpy, the last step's metrics)."""
    def go():
        step_fn, _ = jax_make_train_step(jbundle)
        if arch not in EAGER:
            step_fn = jax.jit(step_fn)
        st = jax.tree.map(jnp.asarray, st_np)
        b = {k: jnp.asarray(v) for k, v in b_np.items()}
        for _ in range(n):
            st, m = step_fn(st, b)
        return jax.tree.map(np.asarray, st), m
    return run_ref(arch, go)


def port_step(tbundle, st_np, b_np):
    """One port train step from the numpy state (through
    ``tree_from_numpy``). -> (new state, metrics)."""
    step_fn, _ = make_train_step(tbundle)
    return step_fn(tree_from_numpy(st_np, "cpu"),
                   tree_from_numpy(b_np, "cpu"))


def check_update(arch, opt_name, p0_np, got_params, want_params,
                 grads_np):
    """The updated parameters: within the sign-flip bound of the module
    docstring everywhere, within STEP_TOL of lr where the gradient entry is
    at least GRAD_FLOOR of its leaf's largest, and moved from ``p0``."""
    hp = HYPER[opt_name]
    got, want = leaves_port(got_params), leaves_ref(want_params)
    p0, g = leaves_ref(p0_np), leaves_ref(grads_np)
    moved = 0
    for x, (path, w), (_, p), (_, gr) in zip(got, want, p0, g):
        bound = 2 * hp["lr"] * (1 + hp["wd"] * np.abs(p)) + 1e-6
        assert (np.abs(x - w) <= bound).all(), (arch, path)
        firm = np.abs(gr) >= GRAD_FLOOR * max(np.abs(gr).max(), 1e-30)
        assert (np.abs(x - w)[firm] <= STEP_TOL * hp["lr"] + 1e-6).all(), (
            arch, path)
        moved += int((x != p).any())
    assert moved == len(got), f"{arch}: {len(got) - moved} leaves did not move"


# lr and weight decay of ``make_optimizer(name)``, the optimizer a train
# step makes from ``cfg.optimizer`` (both packages' defaults)
HYPER = {"adamw": {"lr": 1e-4, "wd": 0.01},
         "adafactor": {"lr": 1e-4, "wd": 0.0}}
ADAMW_B1 = 0.9


def bundles(jcfg, tcfg):
    return jax_build_model(jcfg), build_model(tcfg)


def optimizers(name: str, **kw):
    return jax_make_optimizer(name, **kw), make_optimizer(name, **kw)


# ------------------------------------------------- the checks of each arch
@functools.lru_cache(maxsize=None)
def _reference(arch: str, seed: int, b: int, s: int, kw: tuple):
    """Weights, batch and the reference's loss, metrics and gradients of
    one case, computed once per test process (the MoE archs run op by op,
    tens of seconds)."""
    jcfg, tcfg = cfgs(arch, **dict(kw))
    jb, tb = bundles(jcfg, tcfg)
    p, bt = params_np(jb, seed), batch_np(jb, seed + 1, b, s)
    return (jb, tb, p, bt) + ref_grads(arch, jb, p, bt)


def check_loss_and_grads(arch: str, seed: int = 3, b: int = B, s: int = S,
                         **kw):
    """The port's ``loss_fn`` against ``jax.value_and_grad`` of the
    reference's, from the same weights and batch: the loss and metrics to
    TOL, every gradient leaf to TOL of its largest entry. -> the port's
    gradients."""
    jb, tb, p, b, loss, metrics, grads = _reference(
        arch, seed, b, s, tuple(sorted(kw.items())))
    g, m = port_grads(tb, p, b)
    close_metrics(m, metrics)
    assert float(metrics["loss"]) == float(loss)
    close_leaves(g, grads)
    return g


def check_train_step(arch: str, seed: int = 3, b: int = B, s: int = S,
                     **kw):
    """One ``make_train_step`` step of each package from the same state
    and batch (the smoke_archs checks: finite loss, step 1, parameters
    moved; plus the metrics to TOL and the updated parameters as
    ``check_update`` holds them)."""
    jb, tb, p, bt, _, _, grads = _reference(arch, seed, b, s,
                                            tuple(sorted(kw.items())))
    jopt, _ = optimizers(jb.cfg.optimizer)
    st = state_np(jopt, p)
    want, wm = ref_steps(arch, jb, st, bt)
    got, gm = port_step(tb, st, bt)
    assert np.isfinite(float(gm["loss"]))
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 1
    close_metrics(gm, wm)
    # the gradient the update followed, which a step with microbatches
    # averages over them: AdamW's first moment holds it, (1 - b1) g at
    # step 1; Adafactor keeps none, and its one arch (llama4) gives each
    # microbatch the whole batch, so the loss gradient is the step's
    if jb.cfg.optimizer == "adamw":
        grads = jax.tree.map(lambda m: m / (1 - ADAMW_B1), want["opt"]["m"])
    check_update(arch, jb.cfg.optimizer, p, got["params"], want["params"],
                 grads)
    return got, want


def remat_grads(arch: str, seed: int = 3, **kw) -> dict:
    """The port's gradients under each ``remat`` mode, same weights and
    batch. -> {mode: grads}."""
    jcfg, _ = cfgs(arch, **kw)
    jb = jax_build_model(jcfg)
    p, b = params_np(jb, seed), batch_np(jb, seed + 1)
    out = {}
    for mode in ("none", "full", "dots"):
        tb = build_model(smoke_config(arch).replace(remat=mode, **kw))
        out[mode] = leaves_port(port_grads(tb, p, b)[0])
    return out


def check_remat_modes(arch: str, **kw):
    """``remat`` none, full and dots give the same gradients, bit for
    bit: the recomputed forward runs the same operations on the same
    inputs."""
    g = remat_grads(arch, **kw)
    for mode in ("full", "dots"):
        for a, b in zip(g["none"], g[mode], strict=True):
            assert np.array_equal(a, b), (arch, mode)
