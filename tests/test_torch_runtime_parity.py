"""The port's elastic runtime against the reference's on the CPU: both
packages write the same checkpoint objects byte for byte and read each
other's, their train states line up leaf for leaf, and every step-task of
the port's ElasticTrainer, started from the reference trainer's
checkpoint (task 0 from the reference's initial state, bridged), logs the
reference's loss to ``TOL``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.smoke import smoke_config as jax_smoke_config  # noqa
from repro.launch.steps import init_train_state as jax_init_state  # noqa
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.objectstore.store import ObjectStore as JaxStore  # noqa: E402
from repro.objectstore.store import StoreConfig as JaxStoreConfig  # noqa
from repro.runtime.checkpoint import CheckpointManager as JaxCkpt  # noqa
from repro.runtime.optimizer import make_optimizer as jax_opt  # noqa: E402
from repro.runtime.train_loop import ElasticTrainer as JaxTrainer  # noqa
from repro.runtime.train_loop import JobConfig as JaxJob  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.launch.steps import train_state_defs  # noqa: E402
from repro_torch.models.bridge import tree_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.objectstore.store import ObjectStore, StoreConfig  # noqa
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.optimizer import make_optimizer  # noqa: E402
from repro_torch.runtime.train_loop import (  # noqa: E402
    ElasticTrainer, JobConfig)

from _torch_train import TOL  # noqa: E402

ARCH = "smollm-135m"
JOB = dict(steps_per_task=2, total_steps=8, batch=4, seq=16)
SHARDS, STEP, SEED = 4, 5, 3


def _store(cls=ObjectStore, cfg=StoreConfig):
    return cls(cfg(seed=1, time_scale=0.0, simulate_visibility_lag=False))


def _ref_store():
    return _store(JaxStore, JaxStoreConfig)


def _numpy_state() -> dict:
    """f32, int32 and bf16 leaves in nested dicts and lists, a scalar
    step, and a None the flatten drops."""
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((37, 5)).astype(np.float32),
            "blocks": [{"a": rng.standard_normal(11).astype(np.float32),
                        "h": rng.standard_normal((3, 4)).astype(
                            jnp.bfloat16), "none": None}
                       for _ in range(2)],
            "ids": rng.integers(-9, 9, (6, 2)).astype(np.int32),
            "step": np.int32(7)}


def _bits(x) -> bytes:
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _leaves(tree) -> list:
    return jax.tree.leaves(tree)


def _save(writer: str, store, state):
    if writer == "reference":
        return JaxCkpt(store, "m", n_shards=SHARDS, seed=SEED).save(
            state, STEP)
    return CheckpointManager(store, "m", n_shards=SHARDS, seed=SEED).save(
        tree_from_numpy(state, "cpu"), STEP)


def _paths(tree, pre: str = "") -> list:
    """(jax keystr path, leaf) in the port's flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _paths(tree[k], f"{pre}['{k}']")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _paths(v, f"{pre}[{i}]")]
    return [] if tree is None else [(pre, tree)]


def test_train_state_leaves_line_up_with_the_reference():
    """Leaf i of the train state has the same path, shape and dtype name in
    both packages, so leaf<i> of a checkpoint means one thing."""
    jb = jax_build_model(jax_smoke_config(ARCH))
    tb = build_model(smoke_config(ARCH))
    ref = jax.eval_shape(lambda: jax_init_state(
        jb, jax_opt(jb.cfg.optimizer, lr=1e-3), jax.random.key(0)))
    want = [(jax.tree_util.keystr(p), tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(ref)[0]]
    defs = train_state_defs(tb, make_optimizer(tb.cfg.optimizer, lr=1e-3))
    got = [(p, spec.shape, torch.empty(0, dtype=spec.dtype).numpy()
            .dtype.name) for p, spec in _paths(defs)]
    assert got == want


def test_both_packages_write_the_same_objects():
    """The same numpy state saved by both packages at the same seed and
    policy: the same keys, byte-identical objects, the same (won, end),
    the same request counts; and the same reads back."""
    state = _numpy_state()
    a, b = _ref_store(), _store()
    assert _save("reference", a, state) == _save("port", b, state)
    assert a.stats.snapshot() == b.stats.snapshot()
    assert a.keys() == b.keys()
    assert all(a.get(k) == b.get(k) for k in a.keys())
    ra = JaxCkpt(a, "m", n_shards=SHARDS, seed=SEED).restore(STEP)
    rb = CheckpointManager(b, "m", n_shards=SHARDS, seed=SEED).restore(STEP)
    assert ra[1:] == rb[1:]                       # manifest, virtual end
    assert a.stats.snapshot() == b.stats.snapshot()


@pytest.mark.parametrize("shard", [None, (1, 4)], ids=["full", "shard"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_reads_the_others_checkpoint(writer, shard):
    state = _numpy_state()
    store = _ref_store() if writer == "reference" else _store()
    _save(writer, store, state)
    want = [_bits(x) for x in _leaves(state)]
    if writer == "reference":
        reader = CheckpointManager(store, "m", n_shards=SHARDS)
        template = tree_from_numpy(state, "cpu")
    else:
        reader = JaxCkpt(store, "m", n_shards=SHARDS)
        template = state
    if shard is None:
        got, _ = reader.restore_state(template, STEP)
        assert [_bits(x) for x in _leaves(got)] == want
        return
    got, _ = reader.restore(STEP, shard=shard)
    cuts = [np.linspace(0, len(w), SHARDS + 1).astype(int) for w in want]
    assert [x.tobytes() for x in got] == [w[c[1]:c[2]]
                                          for w, c in zip(want, cuts)]


@functools.lru_cache(maxsize=None)
def _reference_run():
    """The reference trainer's run: (its store, its loss log, its initial
    state as numpy)."""
    store = _ref_store()
    t = JaxTrainer(jax_build_model(jax_smoke_config(ARCH)), store,
                   JaxJob(**JOB), seed=0)
    log = t.run()
    return store, log, jax.tree.map(np.asarray, t._init_state())


@pytest.mark.parametrize("task", range(4))
def test_each_task_logs_the_references_loss(task):
    """The port's run_task(k) from the reference's checkpoint at step 2k
    (task 0 from the reference's initial state) logs the reference's loss
    of that task to TOL."""
    ref_store, log, init = _reference_run()
    store = _store()
    prefix = f"ckpt/{ARCH}/{task * JOB['steps_per_task']}/"
    for k in ref_store.keys():
        if k.startswith(prefix):
            store.put(k, ref_store.get(k))
    t = ElasticTrainer(build_model(smoke_config(ARCH)), store,
                       JobConfig(**JOB), seed=0, device="cpu")
    if task == 0:
        t._init_state = lambda: tree_from_numpy(init, "cpu")
    assert t.run_task(task) == log[task]["step"]
    (got,) = t.metrics_log
    assert got["step"] == log[task]["step"]
    np.testing.assert_allclose(got["loss"], log[task]["loss"], rtol=TOL,
                               atol=0)
