"""Fault C3 of the port's coordinator (ROADMAP Queue C): a request event
of a task attempt that a worker loss discarded must not be applied to the
next attempt's requests.

The reference's coordinator raises ``IndexError`` on these inputs
(``_on_req_done`` reads ``io.reqs[rq]`` of the new attempt), so its own
property test (``tests/test_faults.py::
test_replay_is_byte_identical_and_bills_once``) fails when hypothesis
draws one of them. The port holds the property the reference's test
states on each: replayed at width 1 against the same immutable store,
every re-PUT is byte-identical (``ObjectStore.verify_replay``), and the
query bills the cost and takes the latency of the width-8 run."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.coordinator import Coordinator  # noqa: E402
from repro_torch.core.stragglers import StragglerConfig  # noqa: E402
from repro_torch.faults import FaultConfig, RetryPolicy  # noqa: E402
from repro_torch.objectstore.store import ObjectStore, StoreConfig  # noqa
from repro_torch.relational.table import Table, serialize_table  # noqa

N = 8                       # tasks in the micro plan (tests/test_faults.py)
FLOOR = 1 << 20             # billed output size per task
BIG_BUDGET = RetryPolicy(max_attempts=8)


def _micro_store(seed: int):
    store = ObjectStore(StoreConfig(seed=seed, time_scale=0.0,
                                    simulate_visibility_lag=False))
    split = serialize_table(
        Table({"x": torch.arange(4000, dtype=torch.float64)}))
    store.put("base/micro/p0", split)
    return store, {"micro": ["base/micro/p0"]}


def _run(store, splits, *, seed: int, width: int, faults):
    coord = Coordinator(store, splits, StragglerConfig(), seed=seed,
                        max_parallel=N, compute_scale=0.0,
                        executor_workers=width, record_events=True,
                        faults=faults, retry=BIG_BUDGET, device="cpu")
    plan = {"name": "micro_f",
            "stages": [{"name": "scan", "kind": "scan", "table": "micro",
                        "tasks": N, "deps": [], "out_bytes_floor": FLOOR}]}
    return coord, coord.run_query(plan)


@pytest.mark.parametrize("seed,loss", [(94187, 0.2), (455262, 0.4),
                                       (799189, 0.4)])
def test_replay_after_worker_loss_is_byte_identical_and_bills_once(seed,
                                                                    loss):
    faults = FaultConfig(worker_loss_rate=loss)
    store, splits = _micro_store(seed)
    c8, first = _run(store, splits, seed=seed, width=8, faults=faults)
    store.verify_replay = True
    try:
        _, again = _run(store, splits, seed=seed, width=1, faults=faults)
    finally:
        store.verify_replay = False
    assert not first.failed and not again.failed
    assert c8.event_summary()["worker_losses"] > 0
    assert again.cost == first.cost
    assert again.latency_s == first.latency_s
