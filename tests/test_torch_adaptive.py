"""The port's adaptive control plane (``planner/adaptive.py``;
device="cpu") against the reference's, in the null-drift and regime-shift
cases of tests/test_adaptive.py.

Under the null the segmented adaptive run reproduces the frozen run; after
a shift it re-probes on a spawned coordinator, re-searches on fresh ones
(all on the session's device) and swaps config at a segment boundary. The
records, segments, drift reports, swaps and control-plane cost must equal
the reference's exactly."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import repro.planner as RP  # noqa: E402
import repro.workload as RW  # noqa: E402
import repro_torch.planner as PP  # noqa: E402
import repro_torch.workload as PW  # noqa: E402
from repro.core.session import Session as RSession  # noqa: E402
from repro.obs.drift import DriftDetector as RDrift  # noqa: E402
from repro_torch.core.session import Session as PSession  # noqa: E402
from repro_torch.obs.drift import DriftDetector as PDrift  # noqa: E402

from _torch_query_parity import plain, ref  # noqa: E402

SF, SEED = 0.002, 3
SIDES = {"ref": (RSession, RP, RW, RDrift, {}),
         "port": (PSession, PP, PW, PDrift, {"device": "cpu"})}


@pytest.fixture(scope="module")
def probe_summaries():
    """One reference probe (14 x q6) per package."""
    out = {}
    for side, (S, _, _, _, dev) in SIDES.items():
        probe = S(sf=SF, seed=11, compute_scale=0, max_parallel=16,
                  record_events=True, **dev)
        for _ in range(14):
            probe.submit(("q6", {"scan": 4}))
        out[side] = probe.coord.event_summary()
    return out


def _session(S, width, dev):
    return S(sf=SF, seed=SEED, compute_scale=0, max_parallel=16,
             executor_workers=width, **dev)


def _run(side, summary, width, *, shift: bool):
    S, P, W, Drift, dev = SIDES[side]
    s = _session(S, width, dev)
    det = Drift.from_summary(P.calibrate(summary), summary, window=64,
                             consecutive=2)
    kw = {}
    if shift:                       # GET base latency doubles at segment 2
        classes = [W.QueryClass("q6", 1.0, {"scan": 4})] * 48
        arrivals = W.bursty(48, 1.2, seed=7)

        def on_segment(k, t0):
            if k == 2:
                gm = s.coord.store.config.get_model
                s.coord.store.config.get_model = dataclasses.replace(
                    gm, base_median_s=gm.base_median_s * 2.0)
        kw["on_segment"] = on_segment
    else:
        classes = W.sample_mix(W.TPCH_MIX, 24, seed=5)
        arrivals = W.bursty(24, 2.0, seed=7)
    ctl = P.AdaptiveController(s, P.PlanConfig.make({"scan": 4}),
                               target_query="q6", detector=det, **kw)
    return ctl.run(classes, arrivals)


@pytest.mark.parametrize("width", [1, 8])
def test_null_drift_matches_reference(probe_summaries, width):
    want = _run("ref", probe_summaries["ref"], width, shift=False)
    got = _run("port", probe_summaries["port"], width, shift=False)
    assert plain(got) == ref(want)
    assert len(got.segments) > 1 and not got.swaps and got.replans == 0


def test_shift_matches_reference(probe_summaries):
    want = _run("ref", probe_summaries["ref"], 8, shift=True)
    got = _run("port", probe_summaries["port"], 8, shift=True)
    assert plain(got) == ref(want)
    assert len(got.swaps) == 1 and got.replans == got.probes_used == 1
    assert got.control_cost_usd > 0
    assert not got.swaps[0].to_config.pushdown
