"""The port's observability layer (``obs/trace``, ``metrics``, ``drift``,
``report`` behind ``Session(trace=True, metrics=True)``; device="cpu")
against the reference's.

Observers only read popped events, so a traced run gives what an untraced
one gives. The port's span trees, metric snapshots and drift reports must
equal the reference's. Span trees compare as multisets of (kind, name,
start, end): event order inside one virtual instant is not part of the
contract. No run here has fault injection and cold starts on together
(the reference's own event log varies between runs there)."""
import collections
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.core.session import Session as RSession  # noqa: E402
from repro.obs.drift import DriftDetector as RDrift  # noqa: E402
from repro.planner.calibrate import calibrate as r_calibrate  # noqa: E402
from repro_torch.core.session import Session as PSession  # noqa: E402
from repro_torch.obs.drift import DriftDetector as PDrift  # noqa: E402
from repro_torch.obs.trace import from_chrome  # noqa: E402
from repro_torch.planner.calibrate import \
    calibrate as p_calibrate  # noqa: E402

from _torch_query_parity import plain, ref, result_sig  # noqa: E402

OPTS = dict(sf=0.002, seed=7, compute_scale=0)
SPECS = [("q1", {"scan": 3}), ("q6", {"scan": 2}), ("q12", {"join": 4})]


def _traced(S, **dev):
    s = S(**OPTS, executor_workers=2, record_events=True, trace=True,
          metrics=True, **dev)
    results = s.run(SPECS)
    s.tracer.finalize()
    return s, results


@pytest.fixture(scope="module")
def traced():
    return _traced(RSession), _traced(PSession, device="cpu")


def _spans(tracer) -> collections.Counter:
    return collections.Counter((sp.kind, sp.name, sp.start, sp.end,
                                len(sp.marks)) for sp in tracer.spans())


@pytest.mark.parametrize("width", [1, 8])
def test_traced_run_equals_untraced_and_reference(traced, width):
    (_, want), (_, got) = traced
    plain_run = PSession(**OPTS, executor_workers=width,
                         device="cpu").run(SPECS)
    assert [result_sig(r) for r in got] == \
        [result_sig(r) for r in plain_run] == \
        [result_sig(r, strict=False) for r in want]


def test_span_trees_match_reference(traced):
    (rs, _), (ps, _) = traced
    ps.tracer.validate()
    assert _spans(ps.tracer) == _spans(rs.tracer)
    assert sorted(r.name for r in ps.tracer.roots) == \
        sorted(r.name for r in rs.tracer.roots)


def test_metric_snapshots_match_reference(traced):
    (rs, _), (ps, _) = traced
    assert plain(ps.metrics.registry.collect()) == \
        ref(rs.metrics.registry.collect())


def test_chrome_export_round_trips_and_matches_reference(traced, tmp_path):
    (rs, _), (ps, _) = traced
    path = tmp_path / "trace.json"
    events = ps.tracer.to_chrome(str(path))
    data = json.loads(path.read_text())
    assert data["traceEvents"] == json.loads(json.dumps(events))
    assert collections.Counter(json.dumps(e, sort_keys=True)
                               for e in events) == \
        collections.Counter(json.dumps(e, sort_keys=True)
                            for e in rs.tracer.to_chrome())
    rebuilt = {sp.uid: sp for r in from_chrome(data) for sp in r.walk()}
    spans = list(ps.tracer.spans())
    assert len(rebuilt) == len(spans)
    for sp in spans:
        rb = rebuilt[sp.uid]
        assert (rb.kind, rb.name, len(rb.marks)) == \
            (sp.kind, sp.name, len(sp.marks))
        assert rb.start == pytest.approx(sp.start)
        assert rb.end == pytest.approx(sp.end)
        assert (rb.parent.uid if rb.parent else None) == \
            (sp.parent.uid if sp.parent else None)


def _drift(S, Drift, calibrate, **dev):
    """tests/test_obs.py's scenario: a detector seeded from a 14-query
    probe watches 16 q6 runs (null), then 12 more after the store's GET
    base latency doubles (shift)."""
    probe = S(sf=0.002, seed=11, compute_scale=0, executor_workers=2,
              record_events=True, **dev)
    for _ in range(14):
        probe.submit(("q6", {"scan": 4}))
    summ = probe.coord.event_summary()
    det = Drift.from_summary(calibrate(summ), summ, window=64,
                             consecutive=2)
    live = S(sf=0.002, seed=23, compute_scale=0, executor_workers=2, **dev)
    live.coord.attach_observer(det)
    for _ in range(16):
        live.submit(("q6", {"scan": 4}))
    null = list(det.reports)
    gm = live.coord.store.config.get_model
    live.coord.store.config.get_model = dataclasses.replace(
        gm, base_median_s=gm.base_median_s * 2.0)
    for _ in range(12):
        live.submit(("q6", {"scan": 4}))
    return det, null


def test_drift_reports_match_reference():
    r_det, r_null = _drift(RSession, RDrift, r_calibrate)
    p_det, p_null = _drift(PSession, PDrift, p_calibrate, device="cpu")
    assert plain(p_det.thresholds) == ref(r_det.thresholds)
    assert plain(p_null) == ref(r_null) and p_null
    assert not any(r.flagged for r in p_null)
    assert plain(p_det.reports) == ref(r_det.reports)
    assert p_det.first_flag("get") is not None


def test_reports_match_reference():
    """The workload and fleet rollups (``obs.report``) as JSON."""
    from repro.workload import (QueryClass as RQ, TenantSpec as RT,
                                TenantStream as RTS)
    from repro_torch.workload import (QueryClass as PQ, TenantSpec as PT,
                                      TenantStream as PTS)

    def run(S, Q, T, TS, **dev):
        mix = (Q("q1", 2.0, {"scan": 3}), Q("q6", 3.0, {"scan": 2}))
        wl = S(**OPTS, executor_workers=2, **dev).run_mix(
            [Q(q, 1.0, nt) for q, nt in SPECS], [0.0] * len(SPECS))
        s = S(**OPTS, executor_workers=2, metrics=True, **dev)
        fr = s.run_fleet([
            TS.open_loop(T("a", slot_quota=8), mix, 3,
                         mean_interarrival_s=2.0, seed=1),
            TS.open_loop(T("b"), mix, 3, mean_interarrival_s=2.0,
                         seed=2)])
        rep = fr.report(registry=s.metrics.registry)
        return wl.report().to_json(), rep.to_json(), rep.to_text()

    assert run(PSession, PQ, PT, PTS, device="cpu") == \
        run(RSession, RQ, RT, RTS)
