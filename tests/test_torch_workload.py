"""The port's workload layer (``repro_torch.workload`` behind
``Session.run_mix`` and ``Session.run_fleet``, device="cpu") against the
reference's.

At compute_scale=0 a workload's virtual timeline depends only on store
requests and byte sizes, so records, summaries, fleet numbers and the
Fig-7 pricing must be equal exactly, at executor widths {1, 8}."""
import pytest

torch = pytest.importorskip("torch")

import repro.workload as RW  # noqa: E402
import repro_torch.workload as PW  # noqa: E402
from repro.core.cost import PROVISIONED  # noqa: E402
from repro.core.engine import make_engine as r_make_engine  # noqa: E402
from repro.core.session import Session as RSession  # noqa: E402
from repro_torch.core.engine import make_engine as p_make_engine  # noqa
from repro_torch.core.session import Session as PSession  # noqa: E402

from _torch_query_parity import OPTS, plain, ref  # noqa: E402

N = 6
ARRIVALS = {
    "uniform": lambda W: W.uniform(N, 0.5),
    "poisson": lambda W: W.poisson(N, 1.0, seed=5),
    "bursty": lambda W: W.bursty(N, 1.0, seed=7),
    "closed_loop": lambda W: W.closed_loop(2, N // 2, think_time_s=0.25,
                                           stagger_s=1.0),
}


def _mix(W, arrivals: str):
    return W.sample_mix(W.TPCH_MIX, N, seed=5), ARRIVALS[arrivals](W)


@pytest.mark.parametrize("width", [1, 8])
@pytest.mark.parametrize("arrivals", sorted(ARRIVALS))
def test_run_mix_matches_reference(arrivals, width):
    """A 4-slot pool, so queries queue: every record (arrival, queue
    delay, latency, cost, attribution), the summary's percentiles and the
    per-class report are the reference's."""
    kw = dict(executor_workers=width, max_parallel=4, **OPTS)
    want = RSession(**kw).run_mix(*_mix(RW, arrivals))
    got = PSession(device="cpu", **kw).run_mix(*_mix(PW, arrivals))
    assert plain(got.records) == ref(want.records)
    assert plain(got.summary) == ref(want.summary)
    assert got.makespan_s == want.makespan_s
    assert got.report().to_json() == want.report().to_json()
    assert max(r.queue_delay_s for r in got.records) > 0 \
        or arrivals == "closed_loop"
    assert plain(PW.frontier(got.cost_per_query)) == \
        ref(RW.frontier(want.cost_per_query))


@pytest.mark.parametrize("cpq", [0.0005, 0.01, 0.29])
def test_pricing_matches_reference(cpq):
    assert plain(PW.frontier(cpq)) == ref(RW.frontier(cpq))
    assert plain(PW.frontier(6.0, scan_tb=1.0, systems=["spectrum"])) == \
        ref(RW.frontier(6.0, scan_tb=1.0, systems=["spectrum"]))
    for system in PROVISIONED:
        assert PW.solve_break_even(system, cpq) == \
            RW.solve_break_even(system, cpq)


# ------------------------------------------------------------------ fleet
MIX = [("q1", 2.0, {"scan": 4}), ("q6", 3.0, {"scan": 4}),
       ("q12", 1.0, {"join": 8})]


def _streams(W, n: int, bob: int = len(MIX)):
    """alice: foreground with a slot quota; bob: background, rejected
    past one query in flight, over the first ``bob`` classes."""
    mix = tuple(W.QueryClass(*c) for c in MIX)
    return [
        W.TenantStream.open_loop(W.TenantSpec("alice", slot_quota=6), mix,
                                 n, mean_interarrival_s=2.0, seed=11),
        W.TenantStream.open_loop(
            W.TenantSpec("bob", priority="background", admission="reject",
                         max_inflight=1), mix[:bob], n,
            mean_interarrival_s=0.5, seed=22)]


def _fleet(session_cls, W, mode, n=3, bob=len(MIX), **kw):
    opts = dict(max_parallel=24, **OPTS, **kw)
    return session_cls(**opts).run_fleet(_streams(W, n, bob), mode=mode)


@pytest.mark.parametrize("width", [1, 8])
def test_exact_fleet_matches_reference(width):
    want = _fleet(RSession, RW, "exact", executor_workers=width)
    got = _fleet(PSession, PW, "exact", executor_workers=width,
                 device="cpu")
    assert plain(got) == ref(want)
    assert got.rejected > 0 and got.quota_max_held["alice"] <= 6
    assert got.report().to_json() == want.report().to_json()


def test_hybrid_fleet_matches_reference():
    """Hybrid mode probes each background class on engines of its own.
    Wrapped by ``Session.from_coordinator``, a session has no engine
    options, and the probe engines still run on the coordinator's device.
    The hybrid fleet's numbers and its drift from the exact fleet are the
    reference's."""
    def hybrid(session_cls, make_engine, W, **kw):
        coord, _ = make_engine(max_parallel=24, **OPTS, **kw)
        return session_cls.from_coordinator(coord).run_fleet(
            _streams(W, 2, bob=1), mode="hybrid", probe_runs=2)

    r_exact = _fleet(RSession, RW, "exact", n=2, bob=1)
    p_exact = _fleet(PSession, PW, "exact", n=2, bob=1, device="cpu")
    r_hyb = hybrid(RSession, r_make_engine, RW)
    p_hyb = hybrid(PSession, p_make_engine, PW, device="cpu")
    assert plain(p_hyb) == ref(r_hyb)
    assert p_hyb.event_pops < p_exact.event_pops
    assert plain(PW.hybrid_parity(p_exact, p_hyb)) == \
        ref(RW.hybrid_parity(r_exact, r_hyb))
