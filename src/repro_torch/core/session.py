"""Unified Session API: the front door for running queries on the port.

  * :class:`QuerySpec` — the single typed description of one query
    submission: name, tuning (any form ``planner.model.coerce_config``
    accepts), arrival time, closed-loop dependency, owning tenant.
  * :class:`Session` — owns one engine (store + coordinator + tables) on
    one torch device and exposes ``submit`` (one query), ``run`` (a batch
    on ONE shared slot pool, open- or closed-loop), ``swap_config`` and
    ``run_mix`` (a workload through ``WorkloadDriver``), ``run_fleet``
    (tenant streams, ``workload.tenancy``), ``swap_config``, ``spawn``
    and ``run_with_failover`` (§3 coordinator kill + journaled replay) —
    all building plans through the same ``QuerySpec.build_plan`` path.

Every coordinator a session builds or spawns runs its workers on the
session's device.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.coordinator import Coordinator, QueryResult
from repro_torch.planner.model import coerce_config
from repro_torch.relational.tpch import QUERIES


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """One query submission, in the Session API's canonical form."""
    query: str                      # key into relational.tpch.QUERIES
    tuning: object = None           # PlanConfig | ntasks dict |
    #                                 {"ntasks", "plan_kw"} | None
    plan_kw: dict | None = None     # extra builder kwargs (e.g. shuffle)
    arrival_s: float = 0.0          # open-loop virtual arrival offset
    after: tuple[int, float] | None = None   # (spec index, think_s)
    tenant: object = None           # duck-typed tenant spec

    def __post_init__(self):
        if self.query not in QUERIES:
            raise ValueError(f"unknown query {self.query!r}; have "
                             f"{sorted(QUERIES)}")

    @classmethod
    def coerce(cls, spec) -> "QuerySpec":
        """Accept the legacy spec spellings: a name, ``(name,)``,
        ``(name, tuning)`` or ``(name, tuning, plan_kw)``."""
        if isinstance(spec, QuerySpec):
            return spec
        if isinstance(spec, str):
            return cls(spec)
        if isinstance(spec, (tuple, list)) and spec \
                and isinstance(spec[0], str):
            if len(spec) > 3:
                raise ValueError(f"spec tuple too long: {spec!r}")
            return cls(spec[0], spec[1] if len(spec) > 1 else None,
                       spec[2] if len(spec) > 2 else None)
        raise TypeError(f"cannot coerce {spec!r} into a QuerySpec")

    def build_plan(self) -> dict:
        """The one canonical plan-building path (every tuning form
        normalized through ``planner.model.coerce_config``). The config's
        §3.2 ``pushdown`` toggle lands on the plan itself (a coordinator
        key, not a builder kwarg)."""
        cfg, kw = coerce_config(self.tuning, self.plan_kw)
        pushdown = kw.pop("pushdown", getattr(cfg, "pushdown", True))
        plan = QUERIES[self.query](cfg.ntasks_dict or None, **kw)
        plan["pushdown"] = bool(pushdown)
        return plan


class Session:
    """One simulated engine behind one API.

    ``Session(**engine_opts)`` builds a fresh engine (same options as
    ``engine.make_engine``, including ``device``: ``None`` means
    ``"cuda"``); ``Session.from_coordinator(coord)`` wraps an existing one
    (``tables`` is then None).

    ``trace=True`` attaches a :class:`repro_torch.obs.trace.Tracer`
    (``session.tracer``): every run records a causal span tree (query ->
    stage -> task -> request), exportable to Chrome/Perfetto via
    ``session.tracer.to_chrome(path)``. ``metrics=True`` attaches a
    :class:`repro_torch.obs.metrics.MetricsObserver` (``session.metrics``).
    Both are read-only observers of popped events: results are the same
    with them on or off.
    """

    def __init__(self, *, trace: bool = False, metrics: bool = False,
                 **engine_opts):
        from repro_torch.core.engine import make_engine
        self.engine_opts = dict(engine_opts)
        self.coord, self.tables = make_engine(**engine_opts)
        self.tracer = None
        self.metrics = None
        if trace:
            from repro_torch.obs.trace import Tracer
            self.tracer = Tracer()
            self.coord.attach_observer(self.tracer)
        if metrics:
            from repro_torch.obs.metrics import MetricsObserver
            self.metrics = MetricsObserver()
            self.coord.attach_observer(self.metrics)

    @classmethod
    def from_coordinator(cls, coord: Coordinator) -> "Session":
        sess = cls.__new__(cls)
        sess.engine_opts = {}
        sess.coord = coord
        sess.tables = None
        sess.tracer = None
        sess.metrics = None
        return sess

    # ------------------------------------------------------------ running
    def submit(self, spec) -> QueryResult:
        """Run ONE query (name / tuple / QuerySpec) to completion."""
        spec = QuerySpec.coerce(spec)
        return self.coord.run_query(spec.build_plan(), t0=spec.arrival_s)

    def run(self, specs) -> list[QueryResult]:
        """Run a batch of specs against ONE shared invocation-slot pool
        (paper §6.5). Each spec's ``arrival_s`` / ``after`` / ``tenant``
        flows straight into ``Coordinator.run_queries``."""
        qspecs = [QuerySpec.coerce(s) for s in specs]
        return self.coord.run_queries(
            [s.build_plan() for s in qspecs],
            [s.arrival_s for s in qspecs],
            after=[s.after for s in qspecs],
            tenants=[s.tenant for s in qspecs])

    def run_mix(self, classes, arrivals):
        """A sampled workload mix through ``WorkloadDriver`` (records +
        percentile summaries instead of raw QueryResults)."""
        from repro_torch.workload.driver import WorkloadDriver
        return WorkloadDriver(self.coord).run(classes, arrivals)

    def run_fleet(self, streams, *, mode: str = "exact", **kw):
        """Multi-tenant tenant streams (``workload.tenancy.run_fleet``):
        quotas, admission control, and the calibrated hybrid mode."""
        from repro_torch.workload.tenancy import run_fleet
        return run_fleet(self, streams, mode=mode, **kw)

    # ------------------------------------------------------- adaptivity
    def swap_config(self, config):
        """Swap the live engine's I/O policy to ``config``'s (a planner
        ``PlanConfig``) for every SUBSEQUENT run on this session. Returns
        the previous policy so a caller can restore it."""
        old = self.coord.policy
        self.coord.policy = config.policy(old)
        return old

    # ----------------------------------------------------------- failover
    def spawn(self, journal=None, *, record_events: bool | None = None
              ) -> Coordinator:
        """A fresh coordinator over this session's SAME store and base
        splits, on the same device. Scheduling options are copied from the
        current coordinator, so the replacement replays bit-identically.
        ``journal`` (a ``faults.journal.Journal``) makes it a failover
        replacement; ``record_events`` overrides the copied
        event-recording flag."""
        c = self.coord
        return Coordinator(
            c.store, c.base_splits, c.policy, seed=c.seed,
            max_parallel=c.max_parallel, compute_scale=c.compute_scale,
            executor_workers=c.executor_workers,
            record_events=c.event_log is not None
            if record_events is None else record_events,
            max_events=c.max_events, faults=c.faults,
            coldstart=c.coldstart, retry=c.retry, journal=journal,
            device=c.device)

    @staticmethod
    def failover(make_coordinator, plan: dict, *, kill_after: int,
                 checkpoint_every: int = 64):
        """Kill a coordinator after ``kill_after`` event pops, fail over
        to a fresh one built by ``make_coordinator(journal)``, and replay
        under ``store.verify_replay`` (§3.2 immutability audit). Returns
        ``(result, journal)``."""
        from repro_torch.faults.journal import CoordinatorKilled, Journal
        journal = Journal(checkpoint_every)
        coord = make_coordinator(journal)
        journal.arm_kill(kill_after)
        try:
            coord.run_query(plan)
        except CoordinatorKilled:
            pass
        else:
            raise ValueError(f"kill_after={kill_after} exceeds the "
                             "query's event count — nothing was killed")
        journal.resume()
        coord2 = make_coordinator(journal)
        coord2.store.verify_replay = True
        try:
            result = coord2.run_query(plan)
        finally:
            coord2.store.verify_replay = False
        return result, journal

    def run_with_failover(self, spec, *, kill_after: int,
                          checkpoint_every: int = 64):
        """The instance form: kill THIS session's style of coordinator
        mid-query and fail over onto the same store via ``spawn``."""
        plan = QuerySpec.coerce(spec).build_plan()
        return self.failover(self.spawn, plan, kill_after=kill_after,
                             checkpoint_every=checkpoint_every)
