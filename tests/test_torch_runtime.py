"""The port's elastic runtime on the CPU (tests/test_runtime.py, case for
case, on repro_torch): checkpoint/restart determinism, failure recovery,
first-writer-wins duplicate tasks, data pipeline reproducibility; and the
checks the port's checkpoints add (the restore template's shapes and
dtypes, bf16 leaves)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.modules import ParamSpec, tree_leaves  # noqa: E402
from repro_torch.objectstore.store import ObjectStore, StoreConfig  # noqa
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.data import StoredCorpus, SyntheticCorpus  # noqa
from repro_torch.runtime.train_loop import (  # noqa: E402
    ElasticTrainer, JobConfig, TaskFailure)


def _store():
    return ObjectStore(StoreConfig(seed=1, time_scale=0.0,
                                   simulate_visibility_lag=False))


def _trainer(store, failure_hook=None, seed=0):
    bundle = build_model(smoke_config("smollm-135m"))
    job = JobConfig(steps_per_task=2, total_steps=8, batch=4, seq=16)
    return ElasticTrainer(bundle, store, job, seed=seed,
                          failure_hook=failure_hook, device="cpu")


def test_no_failures_runs_to_completion():
    t = _trainer(_store())
    log = t.run()
    assert [m["step"] for m in log] == [2, 4, 6, 8]
    losses = [m["loss"] for m in log]
    assert all(np.isfinite(losses))


def test_failure_recovery_bit_exact():
    # baseline without failures
    t0 = _trainer(_store())
    log0 = t0.run()

    # inject a failure in task 1 (first attempt only) and task 2
    fails = {(1, 2): 1, (2, 5): 1}

    def hook(task, step):
        k = (task, step)
        if fails.get(k, 0) > 0:
            fails[k] -= 1
            return True
        return False

    t1 = _trainer(_store(), failure_hook=hook)
    log1 = t1.run()
    assert not any(fails.values())
    assert [m["step"] for m in log1] == [m["step"] for m in log0]
    np.testing.assert_allclose([m["loss"] for m in log1],
                               [m["loss"] for m in log0], rtol=0, atol=0)


def test_a_task_that_keeps_failing_raises():
    t = _trainer(_store(), failure_hook=lambda task, step: task == 1)
    with pytest.raises(TaskFailure):
        t.run(max_retries=2)
    assert [m["step"] for m in t.metrics_log] == [2]


def test_resume_from_existing_checkpoints():
    store = _store()
    t0 = _trainer(store)
    t0.run()                                   # full run: ckpts exist
    puts = store.stats.puts
    t1 = _trainer(store)
    log = t1.run()                             # resumes instantly past all
    assert log == [] and store.stats.puts == puts


def test_duplicate_task_first_writer_wins():
    store = _store()
    t = _trainer(store)
    t.run_task(0)
    # a straggling duplicate of task 0 finishes later: must NOT overwrite
    ck = t.ckpt
    state = t._init_state()
    won, _ = ck.save(state, 2)                 # same step as task 0's output
    assert not won


def test_checkpoint_shard_range_reads():
    store = _store()
    ck = CheckpointManager(store, "m", n_shards=4)
    state = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
             "b": torch.arange(4, dtype=torch.int32)}
    ck.save(state, 0)
    got, _ = ck.restore_state({"w": state["w"], "b": state["b"]}, 0)
    assert torch.equal(got["w"], state["w"])
    assert torch.equal(got["b"], state["b"])
    # shard read: two range GETs fetch a contiguous byte shard of each leaf
    leaves, end = ck.restore(0, shard=(1, 4))
    assert all(isinstance(x, np.ndarray) for x in leaves)
    assert [x.tobytes() for x in leaves] == [
        state["b"].numpy().tobytes()[4:8],
        state["w"].numpy().tobytes()[64:128]]


def test_stored_corpus_deterministic_and_mitigated():
    store = _store()
    corpus = StoredCorpus.create(store, "corpus", n_shards=4,
                                 tokens_per_shard=4096, vocab_size=128)
    b1, t1 = corpus.batch_at(3, 4, 16)
    b2, t2 = corpus.batch_at(3, 4, 16)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert t1 > 0 and t2 > 0

    syn = SyntheticCorpus(128, seed=5)
    a = syn.batch_at(7, 4, 16)
    b = syn.batch_at(7, 4, 16)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


# ------------------------------------------------- what the port adds
def test_restore_state_takes_the_train_state_defs():
    """The trainer restores into its ParamSpec defs: the same tree, every
    leaf a CPU tensor of the declared shape and dtype, equal to the state
    the task saved."""
    store = _store()
    t = _trainer(store)
    state = t._init_state()
    t.ckpt.save(state, 0)
    got, _ = t.ckpt.restore_state(t.state_defs, 0)
    specs = tree_leaves(t.state_defs)
    have = tree_leaves(got, torch.is_tensor)
    assert len(have) == len(specs) == len(tree_leaves(state, torch.is_tensor))
    for spec, x, want in zip(specs, have, tree_leaves(state, torch.is_tensor)):
        assert tuple(x.shape) == spec.shape and x.dtype == spec.dtype
        assert torch.equal(x, want)


def test_bf16_leaves_round_trip_and_are_named_as_numpy_names_them():
    store = _store()
    ck = CheckpointManager(store, "m", n_shards=4)
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    state = {"h": x.bfloat16(), "f": x, "i": torch.arange(6).int()}
    ck.save(state, 1)
    got, _ = ck.restore_state(state, 1)
    for k in state:
        assert got[k].dtype == state[k].dtype and torch.equal(got[k],
                                                              state[k])
    leaves, manifest, _ = ck.restore(1)
    assert [m["dtype"] for m in manifest["leaves"]] == [
        "float32", "bfloat16", "int32"]
    # numpy has no bfloat16 without ml_dtypes: restore gives its bits
    assert leaves[1].dtype == np.uint16
    assert np.array_equal(leaves[1], state["h"].view(torch.int16).numpy()
                          .view(np.uint16))


@pytest.mark.parametrize("bad", ["shape", "dtype", "count"])
def test_restore_state_refuses_a_template_that_does_not_match(bad):
    ck = CheckpointManager(_store(), "m", n_shards=2)
    ck.save({"a": torch.zeros(4, 2), "b": torch.zeros(3)}, 0)
    template = {"a": ParamSpec((4, 2), (None, None)),
                "b": ParamSpec((3,), (None,))}
    if bad == "shape":
        template["a"] = ParamSpec((2, 4), (None, None))
    elif bad == "dtype":
        template["b"] = ParamSpec((3,), (None,), dtype=torch.bfloat16)
    else:
        del template["b"]
    with pytest.raises(ValueError):
        ck.restore_state(template, 0)
