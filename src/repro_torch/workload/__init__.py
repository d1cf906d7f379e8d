"""Workload subsystem: whole-workload generation, execution, and pricing.

The layer between the event-driven scheduler (core.coordinator) and the
benchmarks — it answers the paper's headline *economic* question (§6.3,
Figs 7/13/14): at what query rate is a serverless engine cheaper than a
provisioned cluster?

  * :mod:`repro_torch.workload.arrivals` — seeded arrival processes (uniform /
    Poisson / bursty on-off / closed-loop N-stream, Fig 13).
  * :mod:`repro_torch.workload.mix` — weighted query-mix sampling over the TPC-H
    plans with per-class ``ntasks`` presets (Fig 8's query set).
  * :mod:`repro_torch.workload.driver` — ``WorkloadDriver``: feeds a sampled
    workload through ``Coordinator.run_queries`` on ONE shared
    invocation-slot pool and returns per-query records + percentiles.
  * :mod:`repro_torch.workload.pricing` — daily-cost curves vs inter-arrival for
    Starling and every provisioned config, with the Fig-7 break-even
    frontier solver.
  * :mod:`repro_torch.workload.tenancy` — fleet-scale tenant streams: per-tenant
    slot quotas, admission control, priority classes, and the calibrated
    hybrid (event-exact + modeled) execution mode.

Every future scenario layer (SLA studies, autoscaling the slot limit)
plugs in here rather than into the scheduler.
"""
from repro_torch.workload.arrivals import (ClosedLoop, bursty, closed_loop,
                                     poisson, uniform)
from repro_torch.workload.driver import (QueryRecord, WorkloadDriver,
                                   WorkloadResult)
from repro_torch.workload.mix import TPCH_MIX, QueryClass, retune, sample_mix
from repro_torch.workload.pricing import Frontier, frontier, solve_break_even
from repro_torch.workload.tenancy import (FleetResult, TenantSpec, TenantStream,
                                    hybrid_parity, run_fleet)

__all__ = [
    "ClosedLoop", "bursty", "closed_loop", "poisson", "uniform",
    "QueryRecord", "WorkloadDriver", "WorkloadResult",
    "TPCH_MIX", "QueryClass", "retune", "sample_mix",
    "Frontier", "frontier", "solve_break_even",
    "FleetResult", "TenantSpec", "TenantStream", "hybrid_parity",
    "run_fleet",
]
