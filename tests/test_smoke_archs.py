"""Per-architecture smoke tests: reduced config, one train step + one
prefill + one decode step on CPU; assert output shapes and finiteness."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ShapeConfig, registry
from repro.configs.smoke import smoke_config
from repro.models.model import build_model
from repro.models.modules import init_params
from repro.launch.steps import (init_train_state, make_decode_step,
                                make_prefill_step, make_train_step)

# the JAX package's archs; the port's own granite-4.0-h-small, which it
# lacks, is held to its plain reference by bench/tests/test_bench_granite.py
ARCHS = sorted(registry().keys())
B, S = 2, 16


def _batch(bundle, kind: str):
    cfg = bundle.cfg
    shape = ShapeConfig("smoke", S, B, kind)
    defs = bundle.batch_defs(shape)
    batch = init_params(defs, jax.random.key(0))
    rng = np.random.default_rng(0)
    if "tokens" in batch:
        batch["tokens"] = jnp.asarray(
            rng.integers(0, cfg.vocab_size, batch["tokens"].shape), jnp.int32)
    if "targets" in batch:
        batch["targets"] = jnp.asarray(
            rng.integers(0, cfg.vocab_size, batch["targets"].shape), jnp.int32)
    if "token" in batch:
        batch["token"] = jnp.asarray(
            rng.integers(0, cfg.vocab_size, batch["token"].shape), jnp.int32)
    if "frames" in batch:
        batch["frames"] = jnp.asarray(
            rng.normal(size=batch["frames"].shape), cfg.compute_dtype)
    if "vision_embeds" in batch:
        batch["vision_embeds"] = jnp.asarray(
            rng.normal(size=batch["vision_embeds"].shape) * 0.02,
            cfg.compute_dtype)
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def arch_bundle(request):
    cfg = smoke_config(request.param)
    return build_model(cfg)


def test_train_step(arch_bundle):
    bundle = arch_bundle
    step_fn, _ = make_train_step(bundle)
    state = init_train_state(bundle, __import__(
        "repro.runtime.optimizer", fromlist=["make_optimizer"]
    ).make_optimizer(bundle.cfg.optimizer), jax.random.key(1))
    batch = _batch(bundle, "train")
    new_state, metrics = jax.jit(step_fn)(state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"{bundle.cfg.name}: loss={loss}"
    assert int(new_state["step"]) == 1
    # params actually changed
    d0 = jax.tree.leaves(state["params"])[0]
    d1 = jax.tree.leaves(new_state["params"])[0]
    assert not np.allclose(np.asarray(d0), np.asarray(d1))


def test_prefill_and_decode(arch_bundle):
    bundle = arch_bundle
    cfg = bundle.cfg
    params = init_params(bundle.param_defs, jax.random.key(2))
    prefill = jax.jit(make_prefill_step(bundle))
    logits, cache = prefill(params, _batch(bundle, "prefill"))
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert np.isfinite(np.asarray(logits, np.float32)).all()

    decode = jax.jit(make_decode_step(bundle))
    cache_tree = init_params(bundle.cache_defs(B, S), jax.random.key(3))
    batch = _batch(bundle, "decode")
    lg, new_cache = decode(params, cache_tree, batch)
    assert lg.shape == (B, 1, cfg.vocab_size)
    assert np.isfinite(np.asarray(lg, np.float32)).all()
    assert int(new_cache["len"]) == 1
    # a second step advances
    lg2, cache2 = decode(params, new_cache, batch)
    assert int(cache2["len"]) == 2
    assert np.isfinite(np.asarray(lg2, np.float32)).all()
