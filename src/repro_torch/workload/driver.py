"""WorkloadDriver (paper §6.5): a whole workload through ONE slot pool.

Inputs: a list of :class:`~repro_torch.workload.mix.QueryClass` (a sampled mix,
optionally planner-retuned via ``mix.retune`` — per-stage task counts AND
plan options such as a searched §4.2 multi-stage shuffle) and an arrival
process from :mod:`repro_torch.workload.arrivals`. The driver zips them and
runs everything through ``Coordinator.run_queries`` — one shared
invocation-slot pool, so streams contend for the account-level
parallel-invocation limit exactly as in the paper's concurrency
experiment (Fig 13).

Outputs: one :class:`QueryRecord` per query (arrival, queue delay,
latency, cost, backup-slot time, per-request latency attribution) plus
percentile summaries and workload-level aggregates (makespan,
queries/hour, mean $/query) that feed the Fig-7 pricing frontier
(:mod:`repro_torch.workload.pricing`).

Determinism guarantee: with ``compute_scale=0`` engines, records are
bit-identical for any ``executor_workers`` (the coordinator's virtual
clock is a pure function of the seeds), so workload studies are
reproducible byte-for-byte — the property the CI regression gate
(``benchmarks/check_regression.py``, see docs/BENCHMARKS.md) relies on.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.coordinator import Coordinator, QueryResult
from repro_torch.core.cost import QueryCost
from repro_torch.workload.arrivals import ClosedLoop
from repro_torch.workload.mix import QueryClass


@dataclasses.dataclass(frozen=True)
class QueryRecord:
    """Per-query outcome, in plan order (== arrival order for open loop)."""
    index: int
    name: str
    arrival_s: float
    queue_delay_s: float        # arrival -> first task start (slot wait)
    latency_s: float            # arrival -> last task end
    cost: QueryCost
    task_count: int
    backup_count: int
    backup_slot_s: float        # slot-seconds claimed by §5 duplicates
    # per-request latency attribution straight from the scheduler's event
    # stream (queue/invoke/get/put/visibility/compute/dup_saved seconds)
    attribution: dict = dataclasses.field(default_factory=dict)
    # §3.2 pushdown effectiveness: column segments actually fetched
    columns_read: int = 0
    # §3 fault path: a query fails when a retry budget is exhausted; its
    # latency is the time wasted, not a served response — summarize
    # excludes it from latency percentiles and reports a failure rate
    failed: bool = False
    fail_reason: str = ""
    # multi-tenant path (workload.tenancy): owning tenant, and whether
    # admission control rejected the query outright (ran nothing)
    tenant: str = ""
    rejected: bool = False
    # adaptive control plane (planner.adaptive): which active PlanConfig
    # this query was planned under — "" outside adaptive runs. A mid-run
    # config swap is auditable record by record, and ``summarize`` splits
    # the latency percentiles per config id when a run carries several.
    config_id: str = ""

    @property
    def finish_s(self) -> float:
        return self.arrival_s + self.latency_s

    @property
    def dollars(self) -> float:
        return self.cost.total


@dataclasses.dataclass(frozen=True)
class WorkloadResult:
    records: list[QueryRecord]
    makespan_s: float           # first arrival -> last finish
    summary: dict               # percentiles + aggregates (see summarize)

    @property
    def total_cost(self) -> float:
        return sum(r.dollars for r in self.records)

    @property
    def cost_per_query(self) -> float:
        return self.total_cost / max(len(self.records), 1)

    @property
    def queries_per_hour(self) -> float:
        return len(self.records) * 3600.0 / max(self.makespan_s, 1e-9)

    def report(self):
        """Per-query-class rollup of this workload
        (:func:`repro_torch.obs.report.workload_report`)."""
        from repro_torch.obs.report import workload_report
        return workload_report(self)


def summarize(records: list[QueryRecord], makespan_s: float) -> dict:
    """Percentile summaries (p50/p90/p99) of latency and queue delay, plus
    the aggregates the pricing layer consumes.

    Failed queries (exhausted §3 retry budgets) and admission-rejected
    ones are EXCLUDED from the latency/queue-delay percentiles — a
    failure is not a served response time — and surfaced instead as
    ``failed`` / ``rejected`` counts and ``failure_rate`` (failures over
    admitted queries). Cost aggregates keep every record: failed attempts
    still billed their requests."""
    ok = [r for r in records if not r.failed and not r.rejected]
    lat = np.asarray([r.latency_s for r in ok], np.float64)
    qd = np.asarray([r.queue_delay_s for r in ok], np.float64)
    total = float(sum(r.dollars for r in records))
    n = max(len(records), 1)
    failed = sum(r.failed for r in records)
    rejected = sum(r.rejected for r in records)
    out = {"queries": len(records), "makespan_s": float(makespan_s),
           "total_cost": total, "cost_per_query": total / n,
           "queries_per_hour": len(records) * 3600.0 / max(makespan_s,
                                                           1e-9),
           "backup_count": int(sum(r.backup_count for r in records)),
           "backup_slot_s": float(sum(r.backup_slot_s for r in records)),
           "failed": int(failed), "rejected": int(rejected),
           "failure_rate": failed / max(len(records) - rejected, 1)}
    for name, xs in (("latency_s", lat), ("queue_delay_s", qd)):
        if len(xs):
            out[f"{name}_mean"] = float(xs.mean())
            for q in (50, 90, 99):
                out[f"{name}_p{q}"] = float(np.percentile(xs, q))
    # SLA attribution (§3.3.1/§5): mean per-query seconds per component,
    # so a p99 regression can be blamed on queueing vs visibility vs
    # GET/PUT time vs lost duplicate savings (gated in check_regression)
    comps = sorted({k for r in records for k in r.attribution})
    for comp in comps:
        xs = [r.attribution.get(comp, 0.0) for r in records]
        out[f"attr_{comp}_mean"] = float(np.mean(xs))
        out[f"attr_{comp}_total"] = float(np.sum(xs))
    # §3.2 pushdown rollup: column segments fetched across the workload
    out["columns_read_total"] = int(sum(r.columns_read for r in records))
    out["columns_read_mean"] = out["columns_read_total"] / n
    # adaptive control plane: a run that swapped configs mid-flight
    # carries >1 config_id — split the served-latency percentiles and the
    # cost per config so pre-swap vs post-swap regimes are separable
    # (failed/rejected queries stay excluded, exactly as above)
    cids = sorted({r.config_id for r in records if r.config_id})
    if len(cids) > 1:
        by = {}
        for cid in cids:
            sub = [r for r in records if r.config_id == cid]
            sub_ok = [r for r in sub if not r.failed and not r.rejected]
            xs = np.asarray([r.latency_s for r in sub_ok], np.float64)
            entry = {"queries": len(sub),
                     "total_cost": float(sum(r.dollars for r in sub)),
                     "failed": int(sum(r.failed for r in sub)),
                     "rejected": int(sum(r.rejected for r in sub))}
            entry["cost_per_query"] = entry["total_cost"] / max(len(sub),
                                                                1)
            if len(xs):
                entry["latency_s_mean"] = float(xs.mean())
                for q in (50, 90, 99):
                    entry[f"latency_s_p{q}"] = float(np.percentile(xs, q))
            by[cid] = entry
        out["by_config"] = by
    return out


class WorkloadDriver:
    """Runs (classes, arrivals) on a coordinator's shared slot pool."""

    def __init__(self, coord: Coordinator):
        self.coord = coord

    def run(self, classes: list[QueryClass],
            arrivals: list[float] | ClosedLoop, *,
            config_id: str = "",
            max_parallel: int | None = None) -> WorkloadResult:
        """``arrivals`` is either absolute arrival times (open loop, same
        length as ``classes``) or a :class:`ClosedLoop` spec whose
        ``streams * queries_per_stream`` must equal ``len(classes)``
        (stream-major order).

        ``config_id`` labels every record of this call with the active
        planner config (adaptive runs stitch several labelled calls into
        one result); ``max_parallel`` forwards the per-call slot-pool
        override (planner-driven autoscaling). The defaults leave both
        paths exactly as before."""
        if isinstance(arrivals, ClosedLoop):
            if arrivals.total != len(classes):
                raise ValueError(f"{len(classes)} classes but closed loop "
                                 f"describes {arrivals.total} queries")
            arrival_times, after = arrivals.lower()
        else:
            if len(arrivals) != len(classes):
                raise ValueError(f"{len(classes)} classes but "
                                 f"{len(arrivals)} arrival times")
            arrival_times, after = list(arrivals), None
        plans = [c.build_plan() for c in classes]
        results = self.coord.run_queries(plans, arrival_times, after=after,
                                         max_parallel=max_parallel)
        records = [self._record(i, res, config_id)
                   for i, res in enumerate(results)]
        makespan = 0.0 if not records else \
            max(r.finish_s for r in records) - min(r.arrival_s
                                                   for r in records)
        return WorkloadResult(records, makespan,
                              summarize(records, makespan))

    @staticmethod
    def _record(i: int, res: QueryResult,
                config_id: str = "") -> QueryRecord:
        return QueryRecord(i, res.name, res.arrival_s, res.queue_delay_s,
                           res.latency_s, res.cost, res.task_count,
                           res.backup_count, res.backup_slot_s,
                           dict(res.attribution),
                           columns_read=res.columns_read,
                           failed=res.failed,
                           fail_reason=res.fail_reason, tenant=res.tenant,
                           rejected=res.rejected, config_id=config_id)
