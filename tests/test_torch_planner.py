"""The port's planner (``planner/calibrate``, ``model``, ``search``,
``sla``; device="cpu") against the reference's, on the scenarios of
tests/test_planner.py and tests/test_multishuffle.py.

A calibration fits what one probe run's event log shows, the model
predicts from that fit, and the search confirms candidates on fresh
coordinators at compute_scale=0. All of it is a pure function of the seed,
so fits, predictions, frontiers and SLA picks must be equal exactly, at
executor widths {1, 8}."""
import pytest

torch = pytest.importorskip("torch")

import repro.planner as RP  # noqa: E402
import repro.workload as RW  # noqa: E402
import repro_torch.planner as PP  # noqa: E402
import repro_torch.workload as PW  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.core.session import Session as PSession  # noqa: E402
from repro.core.session import Session as RSession  # noqa: E402

from _torch_query_parity import plain, ref, result_sig  # noqa: E402

OPTS = dict(sf=0.002, seed=11, target_bytes=200_000, compute_scale=0.0)
SIDES = {"ref": (RE, RP, {}), "port": (PE, PP, {"device": "cpu"})}


def _engine(side: str, width=None):
    E, _, dev = SIDES[side]
    return E.make_engine(executor_workers=width, record_events=True,
                         **OPTS, **dev)[0]


def _configs(P, joins=(1, 2, 8, 32), lanes=(8, 16)):
    return [P.PlanConfig.make({"join": nt}, parallel_reads=pr)
            for nt in joins for pr in lanes]


MULTI = {"shuffle": {"strategy": "multi", "p": 0.5, "f": 0.5}}


@pytest.mark.parametrize("plan_kw", [None, MULTI], ids=["single", "multi"])
def test_probe_calibration_matches_reference(plan_kw):
    """One probe of q12: the probe's result, the event summary's fit and
    the model built on it."""
    out = {}
    for side, (E, P, _) in SIDES.items():
        coord = _engine(side)
        model, probe = P.QueryModel.from_probe(coord, "q12", {"join": 8},
                                               plan_kw=plan_kw)
        fit = P.calibrate(coord.event_summary(query=probe.store_name))
        out[side] = (model, probe, fit)
    (rm, rprobe, rfit), (pm, pprobe, pfit) = out["ref"], out["port"]
    assert result_sig(pprobe) == result_sig(rprobe, strict=False)
    assert plain(pm.calib) == ref(rm.calib)
    assert plain(pfit) == ref(rfit)
    assert not pm.calib.from_defaults


def test_predictions_match_reference():
    """The model's latency and cost over a grid of configs: join tasks,
    read lanes, shuffle strategies, mitigation and pushdown."""
    models = {side: P.QueryModel.from_probe(_engine(side), "q12",
                                            {"join": 8})[0]
              for side, (_, P, _) in SIDES.items()}

    def grid(P):
        out = []
        for cfg in _configs(P):
            out += [cfg, cfg.replace(shuffle=("multi", 2, 2)),
                    cfg.replace(shuffle=("multi", 4, 2), pushdown=False),
                    cfg.replace(rsm=False, wsm=False, backup_tasks=False)]
        return out

    got = [plain(models["port"].predict(c)) for c in grid(PP)]
    want = [ref(models["ref"].predict(c)) for c in grid(RP)]
    assert got == want
    assert len(got) == 32


def _search(side: str, width, scenario: str):
    E, P, dev = SIDES[side]
    coord = _engine(side, width)
    probe_nt = {"join": 8 if scenario == "q12" else 16}
    model, _ = P.QueryModel.from_probe(coord, "q12", probe_nt)
    ev = P.QueryEvaluator(coord.store, coord.base_splits, "q12", seed=11,
                          max_parallel=coord.max_parallel,
                          executor_workers=width, **dev)
    if scenario == "q12":       # tests/test_planner.py's _q12_search
        grid = _configs(P)
        must = tuple(P.PlanConfig.make({"join": nt}) for nt in (2, 8))
    else:                       # tests/test_multishuffle.py's search
        grid = [P.PlanConfig.make({"join": nt}, shuffle=sh)
                for nt in (8, 16) for sh in (("single",), ("multi", 2, 2),
                                             ("multi", 4, 2))]
        must = (grid[0],)
    return P, P.pareto_search(model, ev, grid, must_confirm=must)


@pytest.mark.parametrize("width", [1, 8])
@pytest.mark.parametrize("scenario", ["q12", "shuffle"])
def test_pareto_search_matches_reference(scenario, width):
    """The confirmed candidates, the pruned ones and the frontier, then
    the SLA pick at each frontier point's latency, below the fastest and
    above the slowest."""
    RPm, want = _search("ref", width, scenario)
    PPm, got = _search("port", width, scenario)
    assert plain(got) == ref(want)
    assert got.frontier and got.sim_evals < got.grid_size + got.off_grid
    targets = [0.0, 1e9] + [p.sim_latency_s for p in want.frontier]
    assert [plain(PPm.select(got, t)) for t in targets] == \
        [ref(RPm.select(want, t)) for t in targets]


def test_workload_sla_pick_matches_reference():
    """``select_for_workload`` over two q12 configs, each a small mix
    retuned to it and run through ``Session.run_mix``."""
    def run(S, P, W, **dev):
        def workload(cfg):
            classes = W.retune(W.sample_mix(W.TPCH_MIX, 4, seed=2),
                               {"q12": cfg})
            return S(**OPTS, **dev).run_mix(classes, W.uniform(4, 1.0))
        cands = [P.PlanConfig.make({"join": nt}) for nt in (2, 8)]
        first = P.select_for_workload(workload, cands, target_p99_s=0.0)
        best = P.select_for_workload(workload, cands,
                                     target_p99_s=first.latency_p99_s)
        return first, best, P.sla_breakeven(best)

    got = run(PSession, PP, PW, device="cpu")
    want = run(RSession, RP, RW)
    assert plain(got) == ref(want)
    assert not got[0].feasible and got[1].feasible
