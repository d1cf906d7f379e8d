"""SLA-constrained plan selection (§6 discussion; ROADMAP "cheapest
config meeting the SLA, not just the cheapest config").

Two levels, matching how the paper talks about latency targets:

  * :func:`select` — per-query: the cheapest simulator-confirmed frontier
    point whose simulated latency meets the target (``pred_ok`` records
    whether the model's prediction agreed). An infeasible target returns
    the latency-optimal point flagged ``feasible=False`` instead of
    crashing (planner edge case).
  * :func:`select_for_workload` — workload-level p99: candidates are run
    through a caller-supplied workload evaluation (normally a
    ``WorkloadDriver`` over the retuned TPC-H mix) cheapest-first; the
    first whose latency p99 meets the target wins. This is the
    ``workload/driver.py`` + ``workload/pricing.py`` plug-in that lets
    ``benchmarks/breakeven.py`` price an SLA-constrained break-even
    frontier next to the unconstrained one (Fig 7 vs Fig 14).

:func:`choice_spec` turns either selection (or a bare ``PlanConfig``)
into an ``engine.run_queries`` spec — per-stage task counts AND plan
options such as a searched §4.2 multi-stage shuffle — and
``workload.mix.retune`` accepts the chosen config directly, so a
multi-stage pick flows into single queries and whole mixes identically.

Inputs here are simulator-confirmed ``SearchResult``s; outputs are frozen
choice records. Determinism: selection is a pure, RNG-free function of
its inputs, so the same frontier always yields the same choice.
"""
from __future__ import annotations

import dataclasses

from repro_torch.planner.model import PlanConfig
from repro_torch.planner.search import SearchResult
from repro_torch.workload.pricing import Frontier, frontier


@dataclasses.dataclass(frozen=True)
class SLAChoice:
    """Per-query selection from a simulator-confirmed frontier."""
    config: PlanConfig
    feasible: bool           # the simulated latency meets the target
    target_s: float
    pred_latency_s: float
    latency_s: float
    cost_usd: float
    pred_ok: bool = True     # the model's prediction also meets it


@dataclasses.dataclass(frozen=True)
class WorkloadSLAChoice:
    """Workload-level selection: cheapest config meeting the p99 target."""
    config: PlanConfig
    feasible: bool
    target_p99_s: float
    latency_p99_s: float
    cost_per_query: float
    evaluated: tuple            # (config, p99, $/query) per candidate run


def select(search: SearchResult, target_s: float) -> SLAChoice:
    """Cheapest frontier point whose SIMULATED latency meets ``target_s``
    — the simulator is the planner's ground truth, so the probe-anchored
    model never vetoes a confirmed-feasible cheaper config; ``pred_ok``
    records whether the model's prediction agreed on the chosen point.
    An infeasible target returns the latency-optimal point flagged
    ``feasible=False`` — never a crash.
    """
    if not search.frontier:
        raise ValueError("empty frontier")
    sim_ok = [p for p in search.frontier if p.sim_latency_s <= target_s]
    if sim_ok:
        pick = min(sim_ok, key=lambda p: (p.sim_cost_usd,
                                          p.sim_latency_s))
        return SLAChoice(pick.config, True, target_s, pick.pred_latency_s,
                         pick.sim_latency_s, pick.sim_cost_usd,
                         pred_ok=pick.pred_latency_s <= target_s)
    pick = min(search.frontier, key=lambda p: (p.sim_latency_s,
                                               p.sim_cost_usd))
    return SLAChoice(pick.config, False, target_s, pick.pred_latency_s,
                     pick.sim_latency_s, pick.sim_cost_usd,
                     pred_ok=False)


def select_for_workload(run_workload, candidates: list[PlanConfig],
                        target_p99_s: float) -> WorkloadSLAChoice:
    """Cheapest candidate whose workload latency p99 meets the target.

    ``run_workload(config)`` must return a ``WorkloadResult`` (the caller
    binds the mix, arrival process, and engine — see
    ``benchmarks/planner.py``). ``candidates`` must be ordered
    cheapest-first (e.g. a frontier's configs by per-query cost): the scan
    stops at the first feasible one, so at most one more workload run than
    necessary happens. Infeasible targets return the lowest-p99 candidate
    flagged ``feasible=False``.
    """
    if not candidates:
        raise ValueError("no candidate configs")
    evaluated = []
    best = None              # (p99, cpq, config) — latency-optimal fallback
    for cfg in candidates:
        wl = run_workload(cfg)
        p99 = wl.summary["latency_s_p99"]
        cpq = wl.cost_per_query
        evaluated.append((cfg, p99, cpq))
        if p99 <= target_p99_s:
            return WorkloadSLAChoice(cfg, True, target_p99_s, p99, cpq,
                                     tuple(evaluated))
        if best is None or p99 < best[0]:
            best = (p99, cpq, cfg)
    p99, cpq, cfg = best
    return WorkloadSLAChoice(cfg, False, target_p99_s, p99, cpq,
                             tuple(evaluated))


def choice_spec(choice, query: str, base_plan_kw: dict | None = None
                ) -> tuple:
    """``(query, ntasks, plan_kw)`` spec for ``engine.run_queries``
    realising a selection — plan options included, so a searched
    multi-stage shuffle pick reaches the coordinator for single queries
    exactly as it did for the simulator confirmation. ``choice`` is an
    :class:`SLAChoice`, a :class:`WorkloadSLAChoice`, or a bare
    ``PlanConfig``."""
    cfg = getattr(choice, "config", choice)
    return (query, cfg.ntasks_dict, cfg.plan_kwargs(base_plan_kw))


def sla_breakeven(choice: WorkloadSLAChoice, *, interarrivals=None,
                  systems=None) -> Frontier:
    """Fig-7 daily-cost frontier priced at the SLA choice's $/query: the
    break-even threshold of the cheapest configuration that still meets
    the latency target (emitted by ``benchmarks/breakeven.py`` next to the
    unconstrained frontier)."""
    return frontier(choice.cost_per_query, interarrivals=interarrivals,
                    systems=systems)
