"""The port's engine (device="cpu") against the numpy engine, end to end.

At compute_scale=0 virtual time depends only on the store requests and
their byte sizes, so every structural field of a QueryResult must be
exactly equal; result values compare at rtol 1e-9 / atol 1e-6 after a
canonical row sort, as tests/test_query_engine.py compares the engine
with its oracle."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as RE  # noqa: E402
from repro.relational.table import DictColumn as RDict  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.core.session import QuerySpec, Session  # noqa: E402
from repro_torch.relational.table import DictColumn  # noqa: E402

OPTS = dict(sf=0.002, seed=3, target_bytes=200_000, compute_scale=0.0)
MULTI = {"shuffle": {"strategy": "multi", "p": 0.5, "f": 0.5}}
CASES = [(q, None) for q in ("q1", "q3", "q5", "q6", "q12", "q14")] + \
    [("q12", MULTI)]


def _canon(t):
    """Rows sorted by all columns, as float64 numpy arrays."""
    cols = {}
    for n in sorted(t.column_names()):
        c = t[n]
        if isinstance(c, DictColumn):
            c = c.codes.cpu().numpy()
        elif isinstance(c, RDict):
            c = c.codes
        elif isinstance(c, torch.Tensor):
            c = c.cpu().numpy()
        cols[n] = np.asarray(c, np.float64)
    if not cols:
        return cols
    order = np.lexsort(tuple(cols.values()))
    return {n: v[order] for n, v in cols.items()}


def assert_same_result(got, want, what):
    got, want = _canon(got), _canon(want)
    assert sorted(got) == sorted(want), what
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-9, atol=1e-6,
                                   err_msg=f"{what}:{n}")


@pytest.fixture(scope="module", params=[1, 8], ids=["w1", "w8"])
def engines(request):
    ref = RE.make_engine(executor_workers=request.param, **OPTS)
    port = PE.make_engine(executor_workers=request.param, device="cpu",
                          **OPTS)
    return ref, port


@pytest.mark.parametrize("q,plan_kw", CASES,
                         ids=[q + ("-multi" if kw else "")
                              for q, kw in CASES])
def test_engine_matches_reference(engines, q, plan_kw):
    (rc, rtables), (pc, ptables) = engines
    want = RE.run_query(rc, q, None, **(plan_kw or {}))
    got = PE.run_query(pc, q, None, **(plan_kw or {}))
    assert got.latency_s == want.latency_s
    assert got.cost.total == want.cost.total
    assert (got.cost.gets, got.cost.puts) == (want.cost.gets, want.cost.puts)
    assert got.task_count == want.task_count
    assert got.backup_count == want.backup_count
    assert got.stage_times == want.stage_times
    assert got.columns_read == want.columns_read
    assert_same_result(got.result, want.result, q)
    assert_same_result(got.result, PE.oracle(q, ptables), q + " oracle")


@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q6", "q12", "q14"])
def test_oracle_matches_reference_oracle(q):
    from repro.relational.tpch import generate
    from repro_torch.relational.tpch import generate as pgenerate
    assert_same_result(PE.oracle(q, pgenerate(0.002, seed=4)),
                       RE.oracle(q, generate(0.002, seed=4)), q)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        PE.make_engine(sf=0.001)
    with pytest.raises(RuntimeError, match="cuda"):
        Session(sf=0.001)
    from repro_torch.launch.run_query import main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--sf", "0.001"])


def test_session_paths_agree():
    """submit, run and the engine shims build the same plans; spawn keeps
    the device; every other entry point of the reference's Session exists
    and stays on the session's device."""
    sess = Session(device="cpu", **OPTS)
    a = sess.submit(("q12", {"join": 4}))
    b = PE.run_queries(PE.make_engine(device="cpu", **OPTS)[0],
                       [("q12", {"join": 4})])[0]
    assert a.latency_s == b.latency_s and a.cost.total == b.cost.total
    assert sess.run([QuerySpec("q6")])[0].latency_s > 0
    assert sess.spawn().device == "cpu"
    assert sess.run_mix([], []).records == []
    with pytest.raises(ValueError):
        sess.run_fleet([])
    res, journal = sess.run_with_failover("q6", kill_after=3)
    assert res.latency_s > 0 and journal.replaying
    traced = Session(trace=True, metrics=True, device="cpu", **OPTS)
    assert traced.coord.observers == [traced.tracer, traced.metrics]
    assert traced.coord.device == "cpu"
