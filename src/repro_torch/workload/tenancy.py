"""Fleet-scale multi-tenancy: tenant streams, quotas, admission control,
and the calibrated hybrid execution mode (ROADMAP item 1; paper §6.5 at
*account* scale).

Starling's economics argument is about an account — many concurrent
queries contending for one invocation-slot pool — not eight queries on a
quiet simulator. This module scales the workload layer to that regime:

  * :class:`TenantSpec` — one tenant's isolation contract: a slot quota
    drawn from the shared account pool, an admission cap with a
    queue-or-reject policy, a foreground/background priority class, and
    an optional per-task read-lane cap. The coordinator enforces all of
    it event-exactly (``Coordinator.run_queries(tenants=...)``).
  * :class:`TenantStream` — one tenant's arrival stream over a query
    mix: open-loop (Poisson/uniform) or closed-loop (think time).
  * :func:`run_fleet` — run many streams through ONE
    ``Coordinator.run_queries`` call, so every tenant contends for the
    same slot pool, and return per-tenant interference percentiles.

Hybrid execution (``mode="hybrid"``): event-exact simulation of every
request is O(requests) — honest but heavy at thousands of streams.
Background-priority tenants instead run **modeled plans**: each stage
becomes a ``"modeled"`` stage whose tasks claim REAL slots from the
shared pool for a calibrated duration (slot-occupancy coupling — a noisy
background neighbour still starves foreground queries) but skip
per-request GET/PUT events. Calibration (:class:`_ModelBank`): one probe
run per distinct background query class feeds the planner's structural
model (``planner.model.QueryModel``); its per-stage spans — wave-free,
probed at huge ``max_parallel`` so contention re-emerges from the shared
pool, never double-counted — become per-task durations, then an
uncontended re-run anchors them to the probe engine's measured latency.
:func:`hybrid_parity` is the parity gate: on small fleets hybrid
per-tenant p50/p99 must track event-exact within a few percent
(benchmarks/tenancy.py asserts <= 5%).
"""
from __future__ import annotations

import copy
import dataclasses
import json

from repro_torch.core.plan import expand_combiners, resolved_tasks
from repro_torch.workload.arrivals import poisson, uniform
from repro_torch.workload.driver import QueryRecord, WorkloadDriver, summarize
from repro_torch.workload.mix import QueryClass, sample_mix

_SCALE_CLAMP = (0.2, 5.0)      # empirical rescale bounds (= latency_bias)


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's isolation contract (duck-typed by the coordinator's
    ``_TenantState``; entries sharing a ``name`` share one state)."""
    name: str
    slot_quota: int | None = None    # max slots held at once (None = all)
    priority: str = "foreground"     # "foreground" | "background"
    max_inflight: int | None = None  # admission cap (None = unlimited)
    admission: str = "queue"         # over cap: "queue" | "reject"
    read_lanes: int | None = None    # per-task parallel-read lane cap

    def __post_init__(self):
        if self.priority not in ("foreground", "background"):
            raise ValueError(f"priority {self.priority!r}")
        if self.admission not in ("queue", "reject"):
            raise ValueError(f"admission {self.admission!r}")
        for f in ("slot_quota", "max_inflight", "read_lanes"):
            v = getattr(self, f)
            if v is not None and v < 1:
                raise ValueError(f"{f} must be >= 1, got {v}")


@dataclasses.dataclass(frozen=True)
class TenantStream:
    """One tenant's query stream: classes + arrivals, open or closed loop.

    ``think_s`` set makes the stream closed-loop: query i+1 arrives
    ``think_s`` virtual seconds after query i finishes (``arrivals``
    then only positions the FIRST query).
    """
    tenant: TenantSpec
    classes: tuple
    arrivals: tuple
    think_s: float | None = None

    def __post_init__(self):
        if len(self.classes) != len(self.arrivals):
            raise ValueError(f"{len(self.classes)} classes but "
                             f"{len(self.arrivals)} arrivals")

    @staticmethod
    def open_loop(tenant: TenantSpec, mix, n: int, *,
                  mean_interarrival_s: float, seed: int = 0,
                  start: float = 0.0) -> "TenantStream":
        """Poisson arrivals over a seeded sample of ``mix``."""
        return TenantStream(
            tenant, tuple(sample_mix(mix, n, seed=seed)),
            tuple(poisson(n, mean_interarrival_s, seed=seed, start=start)))

    @staticmethod
    def closed_loop(tenant: TenantSpec, mix, n: int, *, think_s: float,
                    seed: int = 0, start: float = 0.0) -> "TenantStream":
        """An N=1 closed loop: each query arrives ``think_s`` after the
        previous one finishes (paper Fig 13's per-stream shape)."""
        return TenantStream(
            tenant, tuple(sample_mix(mix, n, seed=seed)),
            tuple(uniform(n, 0.0, start=start)), think_s=think_s)


@dataclasses.dataclass(frozen=True)
class FleetResult:
    """One fleet run: flat records plus per-tenant interference views."""
    mode: str                       # "exact" | "hybrid"
    records: list
    makespan_s: float
    summary: dict                   # whole-fleet summarize()
    tenants: dict                   # tenant -> summarize() of its records
    quota_max_held: dict            # tenant -> peak slots held at once
    slot_seconds: dict              # tenant -> billed slot-seconds
    rejected: int                   # admission-rejected query count
    event_pops: int                 # scheduler pops (events/sec numerator)

    @property
    def total_slot_seconds(self) -> float:
        return float(sum(self.slot_seconds.values()))

    def report(self, *, registry=None):
        """Per-tenant / per-query-class rollup of this fleet run
        (:func:`repro_torch.obs.report.fleet_report`); ``registry`` merges a
        :class:`repro_torch.obs.metrics.MetricsRegistry` snapshot in."""
        from repro_torch.obs.report import fleet_report
        return fleet_report(self, registry=registry)


# ---------------------------------------------------------------------------
# hybrid mode: probe-calibrated modeled plans
# ---------------------------------------------------------------------------

class _ModelBank:
    """Instance-aligned calibrated modeled plans, one set per distinct
    background query class.

    Per class (cached), on a fresh single-query probe engine
    (``record_events=True``, huge ``max_parallel`` so every stage runs in
    one wave), run ``probe_runs`` event-exact probes. Probe run k becomes
    modeled-plan **variant k**: the REAL expanded plan's stage/dependency
    graph (so parallel scans stay parallel), with each task's duration
    set to run k's OBSERVED per-task event window divided by that task's
    §5 slowdown draw. Everything is keyed for common random numbers: the
    modeled plan keeps the exact plan's name, and the coordinator
    namespaces the k-th instance of a name identically in any fleet — so
    when variant k is deployed as the k-th instance, the scheduler
    re-draws the SAME slowdown factors the probe divided out, and the
    uncontended task durations reproduce the event-exact ones almost
    request-for-request. Instances beyond ``probe_runs`` cycle variants
    (distributionally matched, no longer draw-for-draw). GET/PUT counts
    are apportioned from the probe's per-stage totals, so billed cost
    tracks too. A final fixed-point anchor nudges residual error
    (window-vs-slot-occupancy edges) onto the probe's measured latency.
    """

    def __init__(self, probe_opts: dict, *, probe_runs: int = 3):
        self.probe_opts = dict(probe_opts)
        self.probe_runs = max(int(probe_runs), 1)
        self._cache: dict[tuple, list[dict]] = {}

    @staticmethod
    def _key(c: QueryClass) -> tuple:
        return (c.query, tuple(sorted((c.ntasks or {}).items())),
                json.dumps(c.plan_kw, sort_keys=True))

    def modeled_plan(self, c: QueryClass, instance: int = 0) -> dict:
        """The modeled plan for the ``instance``-th occurrence of this
        class's query name in the fleet's submission order."""
        key = self._key(c)
        if key not in self._cache:
            self._cache[key] = self._build(c)
        variants = self._cache[key]
        return copy.deepcopy(variants[instance % len(variants)])

    @staticmethod
    def _task_windows(event_log, store_name: str) -> dict:
        """stage -> {tidx: last-event minus first-event seconds} of one
        run's event log (the observed per-task busy window)."""
        win: dict[str, dict[int, list[float]]] = {}
        for (t, _kind, q, s, tidx, _rq, _info) in event_log or ():
            if q != store_name or tidx < 0:
                continue
            w = win.setdefault(s, {}).setdefault(tidx, [t, t])
            w[0], w[1] = min(w[0], t), max(w[1], t)
        return {s: {ti: hi - lo for ti, (lo, hi) in d.items()}
                for s, d in win.items()}

    def _slow(self, coord, uname: str, sidx: int, tidx: int) -> float:
        """Recompute the scheduler's per-task §5 slowdown draw (a pure
        function of seed, run name, and indices)."""
        import types
        run = types.SimpleNamespace(name=uname)
        return coord._slowdown(coord._task_rng(run, sidx, tidx, 1))

    def _build(self, c: QueryClass) -> list[dict]:
        from repro_torch.core.coordinator import Coordinator
        from repro_torch.core.engine import make_engine
        opts = {**self.probe_opts, "record_events": True,
                "compute_scale": 0.0, "max_parallel": 1_000_000}
        coord, _ = make_engine(**opts)
        plan = c.build_plan()
        probes = [coord.run_query(c.build_plan())
                  for _ in range(self.probe_runs)]
        splits = {t: len(ks) for t, ks in coord.base_splits.items()}
        expanded = expand_combiners(plan, plan["name"], splits)
        counts = resolved_tasks(expanded, splits)

        variants = []
        for k, res in enumerate(probes):
            win = self._task_windows(coord.event_log, res.store_name)
            summary = coord.event_summary(query=res.store_name)
            profs = {s: p for (_q, s), p in summary["stages"].items()}
            stages = []
            for sidx, st in enumerate(expanded["stages"]):
                name, T = st["name"], counts[st["name"]]
                durs = win.get(name, {})
                task_s = [durs.get(ti, 0.0)
                          / self._slow(coord, res.store_name, sidx, ti)
                          for ti in range(T)]
                prof = profs.get(name, {})
                stages.append({
                    "name": name, "kind": "modeled", "tasks": T,
                    "deps": list(st["deps"]), "task_s": task_s,
                    "task_gets": _apportion(prof.get("gets", 0), T),
                    "task_puts": _apportion(prof.get("puts", 0), T)})
            # pushdown off: modeled stages read no base tables, the
            # schema-inference pass has nothing to annotate. The plan
            # KEEPS the exact plan's name (the CRN alignment above)
            modeled = {"name": plan["name"], "pushdown": False,
                       "stages": stages}
            self._anchor(coord, modeled, k, res.latency_s)
            variants.append(modeled)
        return variants

    def _anchor(self, coord, modeled: dict, instance: int,
                l_exact: float):
        """Fixed-point nudge of a variant's durations onto its probe
        run's measured latency. Measured on a fresh coordinator over the
        same store with the name counter pre-advanced to ``instance`` —
        so the anchor run draws the very slowdown factors the variant
        was normalized by."""
        from repro_torch.core.coordinator import Coordinator
        for _ in range(3):
            c2 = Coordinator(coord.store, coord.base_splits, coord.policy,
                             seed=coord.seed,
                             max_parallel=coord.max_parallel,
                             compute_scale=0.0,
                             executor_workers=coord.executor_workers,
                             device=coord.device)
            c2._name_counts[modeled["name"]] = instance
            l0 = c2.run_query(copy.deepcopy(modeled)).latency_s
            if l0 <= 0.0 or l_exact <= 0.0:
                return
            scale = min(max(l_exact / l0, _SCALE_CLAMP[0]),
                        _SCALE_CLAMP[1])
            for st in modeled["stages"]:
                st["task_s"] = [s * scale for s in _as_list(
                    st["task_s"], st["tasks"])]
            if abs(scale - 1.0) < 0.01:
                return


def _apportion(total: int, tasks: int) -> list[int]:
    """Split ``total`` requests across ``tasks`` with exact sum."""
    base, rem = divmod(int(total), max(tasks, 1))
    return [base + (1 if i < rem else 0) for i in range(max(tasks, 1))]


def _as_list(v, n: int) -> list:
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


# ---------------------------------------------------------------------------
# fleet execution
# ---------------------------------------------------------------------------

def run_fleet(session, streams, *, mode: str = "exact",
              probe_opts: dict | None = None,
              probe_runs: int = 3) -> FleetResult:
    """Run tenant streams through ONE shared slot pool.

    ``mode="exact"``: every query event-exact. ``mode="hybrid"``:
    background-priority tenants run calibrated modeled plans (slot
    occupancy still event-exact in the shared pool); foreground tenants
    stay fully event-exact. ``probe_opts`` seeds the hybrid model bank's
    probe engines (defaults to the session's own engine options).
    """
    if mode not in ("exact", "hybrid"):
        raise ValueError(f"mode {mode!r}")
    streams = list(streams)
    if not streams:
        raise ValueError("empty fleet")
    bank = None
    if mode == "hybrid":
        opts = probe_opts if probe_opts is not None \
            else getattr(session, "engine_opts", {}) or {}
        # probe engines run on the session's device unless named
        opts = {"device": session.coord.device, **opts}
        bank = _ModelBank(opts, probe_runs=probe_runs)

    plans: list[dict] = []
    arrivals: list[float] = []
    afters: list = []
    tenants: list = []
    ninst: dict[str, int] = {}      # plan name -> occurrences so far
    for stream in streams:
        base = len(plans)
        modeled = bank is not None \
            and stream.tenant.priority == "background"
        for i, (c, arr) in enumerate(zip(stream.classes,
                                         stream.arrivals)):
            k = ninst.get(c.query, 0)
            ninst[c.query] = k + 1
            plans.append(bank.modeled_plan(c, k) if modeled
                         else c.build_plan())
            closed = stream.think_s is not None and i > 0
            arrivals.append(0.0 if closed else float(arr))
            afters.append((base + i - 1, stream.think_s) if closed
                          else None)
            tenants.append(stream.tenant)

    coord = session.coord
    results = coord.run_queries(plans, arrivals, after=afters,
                                tenants=tenants)
    records = [WorkloadDriver._record(i, r) for i, r in
               enumerate(results)]
    served = [r for r in records if not r.rejected]
    makespan = 0.0 if not served else \
        max(r.finish_s for r in served) - min(r.arrival_s for r in served)

    by_tenant: dict[str, list[QueryRecord]] = {}
    slot_s: dict[str, float] = {}
    for rec, res in zip(records, results):
        by_tenant.setdefault(rec.tenant, []).append(rec)
        slot_s[rec.tenant] = slot_s.get(rec.tenant, 0.0) \
            + res.task_seconds
    return FleetResult(
        mode=mode, records=records, makespan_s=makespan,
        summary=summarize(records, makespan),
        tenants={t: summarize(rs, makespan)
                 for t, rs in sorted(by_tenant.items())},
        quota_max_held={name: st.max_held for name, st in
                        sorted(coord.tenant_states.items())},
        slot_seconds=slot_s,
        rejected=sum(r.rejected for r in records),
        event_pops=coord.last_event_pops)


def hybrid_parity(exact: FleetResult, hybrid: FleetResult,
                  *, pcts=(50, 99)) -> dict:
    """The parity gate's numbers: relative drift of fleet-wide and
    per-tenant latency percentiles, hybrid vs event-exact.

    Returns ``{"latency_s_p50": drift, ..., "tenants": {name: {...}}}``
    with drift = |hybrid - exact| / exact (0 when both are 0).
    """
    def drift(a: dict, b: dict) -> dict:
        out = {}
        for q in pcts:
            k = f"latency_s_p{q}"
            ea, eb = a.get(k, 0.0), b.get(k, 0.0)
            out[k] = abs(eb - ea) / ea if ea > 0 else \
                (0.0 if eb == 0 else float("inf"))
        return out

    out = drift(exact.summary, hybrid.summary)
    out["tenants"] = {
        t: drift(exact.tenants[t], hybrid.tenants[t])
        for t in exact.tenants if t in hybrid.tenants}
    return out
