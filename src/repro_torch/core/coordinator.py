"""Coordinator (paper §2.3, §3.3, §4.3, §4.4, §5): event-driven scheduler
down to the *individual store request*.

A single discrete-event loop drives every query: a priority queue of
``(virtual_time, kind, run, stage, task, request)`` entries. Task-level
events schedule work; request-level events advance each task's recorded
I/O timeline, so straggler mitigation happens where the paper does it —
per GET/PUT, preempting mid-request — not by composing latencies privately
inside the worker.

Event taxonomy (tie-break priority order at equal virtual times):

  * ``STAGE_READY`` — fired when every dependency has completed its
    pipelining quota (§4.4: ``pipeline_fraction`` of the producer's tasks).
    Claims invocation slots and dispatches the stage's tasks onto a thread
    pool; tasks beyond the slot limit queue FIFO.
  * ``TASK_DONE`` — a task's effective completion (min over the original
    timeline and any §5 backup duplicate); frees its slot, advances
    pipelining quotas, wakes reads parked on this producer's output, arms
    backup timers, finishes stages and queries.
  * ``BACKUP_FIRE`` — §5 straggler mitigation at task granularity: once a
    quorum of a stage's tasks has finished, the coordinator estimates the
    stage median and arms a timer per straggling task; the duplicate
    claims a real slot from the shared pool and races the original.
  * ``VISIBLE_AT`` — §3.3.1 as an event: a GET that would arrive before
    its object is visible is re-targeted to whichever doublewrite twin
    becomes visible first, with the 404 polls in between billed as GETs;
    the read issues at the first poll that finds the object, instead of
    the task spinning in a poll loop.
  * ``GET_ISSUE`` / ``GET_DONE`` — one read request occupying one
    parallel-read lane; ``GET_ISSUE`` samples the request's latency from a
    key-derived per-request RNG and, when it exceeds the §5.1 RSM timer,
    arms a ``DUP_FIRE``.
  * ``PUT_ISSUE`` / ``PUT_DONE`` — one write request (the doublewrite twin
    is a second request issued in parallel); ``PUT_ISSUE`` samples the
    send/post-send phases and arms the §5.2 WSM dual-timer ``DUP_FIRE``.
  * ``DUP_FIRE`` — a duplicate GET/PUT is issued mid-request: completion
    becomes first-of-two-wins (the loser is cancelled but billed, and
    itemized in ``QueryResult.dup_gets``/``dup_puts``).
  * ``INVOKE_FAIL`` / ``RETRY_FIRE`` — the §3 fault path (repro_torch.faults):
    an injected failure (invoke API error, whole-worker loss, dropped
    GET/PUT) is detected, then retried after an exponential backoff.
    Worker-loss retries *replay* the recorded timeline without
    re-executing the worker — §3.2 immutable objects make replays safe
    (``ObjectStore.verify_replay`` asserts identical bytes). A retry
    budget (``faults.RetryPolicy.max_attempts``) bounds attempts; an
    exhausted budget fails the query (``QUERY_FAIL`` in the log,
    ``QueryResult.failed``). Cold starts (``faults.ColdStartConfig``)
    ride slot acquisition: a slot claimed after sitting idle past the
    keep-alive window (or never used) pays a sampled cold extra
    (``COLD_START`` in the log). With no injector, no cold-start model
    and no journal, every code path below is bit-identical to the
    fault-free engine — the subsystem is a strict superset.

Parallel-read lanes (§3.3) are a schedulable per-task resource: each task
owns a bounded pool of ``StragglerConfig.parallel_reads`` lanes and the
scheduler fills free lanes with the task's queued reads (work-conserving,
not round-robin); a read holds its lane from placement — including any
availability/visibility wait — until its GET_DONE. Batches within a task
(header reads -> body reads -> compute -> PUT) stay barriered because the
later phase needs the earlier phase's real bytes.

A read whose producer has not yet *finished in virtual time* parks on that
producer task and is re-placed by the producer's TASK_DONE — that is how a
consumer dispatched early by pipelining still pays the §4.4 wait, without
the worker ever seeing a latency.

Invocation limiting (§4.3) is an O(log n) free-slot heap shared by every
concurrently running query — ``run_queries`` models the paper's §6.5
multi-tenant workload: one slot pool, per-query arrival times, and
optional closed-loop ``after=`` stream dependencies.

Real task work (``Worker.run_*``) executes on a ``ThreadPoolExecutor`` so
wall-clock scales with cores, while *virtual* time stays deterministic:
the worker moves real bytes and returns its request timeline; every
latency is then sampled from an RNG keyed on (seed, query, stage, task,
request, attempt), never from a shared sequential stream, so results,
request counts and virtual latency are identical for any executor width.
Determinism invariants:

  * the loop pops an event only once no in-flight task could still produce
    an earlier one (event time <= the minimum virtual start among
    unresolved tasks), and event keys carry (run, stage, task, request)
    indices so equal-time ordering is stable;
  * the slot heap mutates only at event pops (claim at STAGE_READY /
    queued dispatch, release at TASK_DONE / timeline completion), never at
    wall-clock future resolution;
  * a parked read re-placed by its producer's TASK_DONE computes exactly
    what direct placement would have computed, so wall-clock resolution
    order never leaks into virtual time.

Multi-stage shuffles (§4.2) are expanded statically: combiner stages are
spliced into a private working copy of the plan (and into the join's deps),
never into the caller's object, so a plan dict can be re-run any number of
times.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import os
import threading
import zlib
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import numpy as np

from repro_torch.core.cost import WORKER_MEM_GB, QueryCost
from repro_torch.core.events import EventQueue
from repro_torch.core.plan import (combine_name, expand_combiners, infer_pushdown,
                             stage_by_name, validate_plan)
from repro_torch.core.stragglers import StragglerConfig
from repro_torch.core.worker import PartInput, TaskResult, Worker
from repro_torch.faults.coldstart import ColdStartConfig
from repro_torch.faults.inject import FaultConfig, FaultInjector
from repro_torch.faults.retry import RetryPolicy
from repro_torch.objectstore.client import RequestTimeline
from repro_torch.objectstore.latency import poll_until_visible, visible_twin
from repro_torch.objectstore.store import ObjectStore
from repro_torch.relational.table import Table, decode_object, object_meta

INVOKE_OVERHEAD_S = 0.030            # Lambda invoke + runtime startup
COLD_STRAGGLER_PROB = 0.01           # slow-worker tail (backup-task target)
_COLD_SALT = 0xC01D0001              # cold-start RNG key-space salt

# event kinds, in tie-break priority order at equal virtual times.
# _ADMIT / _RELEASE exist only on the multi-tenant path (tenants= passed
# to run_queries): ADMIT is a query arriving at its tenant's admission
# controller, RELEASE returns a future-free slot to its tenant's quota.
(_READY, _DONE, _BACKUP, _VISIBLE, _GET_ISSUE, _PUT_ISSUE, _DUP,
 _GET_DONE, _PUT_DONE, _INVOKE_FAIL, _RETRY, _ADMIT, _RELEASE) = range(13)
_EPS = 1e-9


@dataclasses.dataclass
class QueryResult:
    name: str
    latency_s: float
    result: Table
    cost: QueryCost
    task_count: int
    backup_count: int
    stage_times: dict
    task_seconds: float
    arrival_s: float = 0.0       # virtual arrival (t0, or closed-loop start)
    queue_delay_s: float = 0.0   # arrival -> first task start (slot wait)
    backup_slot_s: float = 0.0   # slot-seconds claimed by backup duplicates
    dup_gets: int = 0            # §5.1 RSM duplicate GETs (in cost.gets)
    dup_puts: int = 0            # §5.2 WSM duplicate PUTs (in cost.puts)
    poll_gets: int = 0           # §3.3.1 404 visibility polls (in cost.gets)
    columns_read: int = 0        # column segments decoded across all tasks
    # per-request latency attribution, accumulated at event pops (virtual
    # order -> bit-identical across executor widths): queue_s (slot wait),
    # invoke_s, get_s / put_s (issue->effective completion, task-parallel
    # aggregate seconds), visibility_s (§3.3.1 poll windows), compute_s,
    # dup_saved_s (request seconds cut by winning §5 duplicates)
    attribution: dict = dataclasses.field(default_factory=dict)
    # the run's unique store/event-log namespace: equals ``name`` unless
    # the coordinator disambiguated a re-run as ``name@N`` — pass this to
    # ``Coordinator.event_summary(query=...)`` to scope a probe's fits
    store_name: str = ""
    # §3 fault path (repro_torch.faults): a query fails when a retry budget is
    # exhausted; the naive client then re-runs it from scratch. Retries
    # and cold starts are itemized so their cost/latency overhead is
    # attributable (the billed requests stay in ``cost``).
    failed: bool = False
    fail_reason: str = ""        # "invoke" | "worker_loss" | "get" | "put"
    retries: int = 0             # RETRY_FIRE count (task + request level)
    cold_starts: int = 0         # cold invokes (faults.ColdStartConfig)
    # multi-tenant path (run_queries(tenants=...)): the owning tenant's
    # name, and whether admission control rejected the query outright
    # (a rejected query runs nothing, bills nothing, latency 0)
    tenant: str = ""
    rejected: bool = False

    @property
    def dollars(self) -> float:
        return self.cost.total

    @property
    def finish_s(self) -> float:
        return self.arrival_s + self.latency_s


class _Req:
    """One scheduled store request of a task's timeline."""
    __slots__ = ("spec", "put", "end", "done", "issue_t", "polls", "dup",
                 "target", "tries")

    def __init__(self, spec, put: bool):
        self.spec = spec
        self.put = put
        self.end = math.inf      # authoritative completion (min with dup)
        self.done = False
        self.issue_t = 0.0
        self.polls = 0
        self.dup = False         # a DUP_FIRE issued a duplicate request
        self.target = None       # key actually read (visibility re-target)
        self.tries = 0           # failed tries so far (§3 request retries)


class _TaskIO:
    """Request-level state machine for one task, advanced by heap events."""
    __slots__ = ("phases", "slow", "pi", "reqs", "queue", "pending",
                 "phase_end", "conc", "nlanes")

    def __init__(self, phases: list, slow: float, nlanes: int):
        self.phases = phases
        self.slow = slow             # per-task worker slowdown factor
        self.pi = -1                 # current phase index
        self.reqs: list[_Req] = []   # flattened, request-index addressed
        self.queue: deque[int] = deque()   # reads waiting for a lane
        self.pending = 0             # unfinished requests in current phase
        self.phase_end = 0.0
        self.conc = 1                # lanes used by the current read batch
        self.nlanes = nlanes


@dataclasses.dataclass
class _Task:
    start: float = 0.0           # virtual start (slot claimed + overhead)
    dur: float = 0.0             # original timeline duration (slot busy)
    end: float = math.inf        # effective completion (min with backup dup)
    dispatched: bool = False     # submitted to the executor
    resolved: bool = False       # real bytes moved, timeline known
    io_done: bool = False        # timeline fully advanced, dur known
    done: bool = False           # TASK_DONE processed
    result: TaskResult | None = None
    io: _TaskIO | None = None
    backup_cap: float = math.inf   # completion candidate of a §5 duplicate
    backup_dup: float | None = None   # dup duration awaiting billing settle
    sid: int = -1                # invocation slot id (warm-pool identity)
    attempt: int = 0             # dispatch attempt index (0 = first)
    failures: int = 0            # failed attempts so far (backoff level)
    retrying: bool = False       # awaiting a RETRY_FIRE re-dispatch
    retry_reason: str = ""       # "invoke" | "worker_loss"
    # request events carry rq + req_base; a worker loss moves req_base
    # past the lost attempt's requests, so that events of that attempt
    # still in the queue are told apart from the next attempt's
    req_base: int = 0


class _Stage:
    def __init__(self, st: dict, sidx: int):
        self.st = st
        self.sidx = sidx
        self.n = 0
        self.tasks: list[_Task] = []
        self.done = 0
        self.undispatched = 0
        self.ready_pushed = False
        self.dispatched = False
        self.ready_t = 0.0
        self.backup_armed = False
        self.median = 0.0


class _TenantState:
    """Per-tenant quota/admission accounting for one ``run_queries`` call.

    Built from a duck-typed tenant spec (``workload.tenancy.TenantSpec``
    or anything with the same attributes) so the core never imports the
    workload layer. ``held`` counts slots the tenant currently occupies
    or has reserved (claim until the slot's free time — a backup
    duplicate's slot counts until its duplicate run ends); ``inflight``
    counts admitted-but-unfinished queries.
    """
    __slots__ = ("name", "slot_quota", "priority", "max_inflight",
                 "admission", "read_lanes", "held", "max_held", "inflight",
                 "queue", "rejects")

    def __init__(self, spec):
        self.name = spec.name
        self.slot_quota = getattr(spec, "slot_quota", None)
        self.priority = getattr(spec, "priority", "foreground")
        self.max_inflight = getattr(spec, "max_inflight", None)
        self.admission = getattr(spec, "admission", "queue")
        self.read_lanes = getattr(spec, "read_lanes", None)
        if self.priority not in ("foreground", "background"):
            raise ValueError(f"tenant {self.name}: priority "
                             f"{self.priority!r}")
        if self.admission not in ("queue", "reject"):
            raise ValueError(f"tenant {self.name}: admission "
                             f"{self.admission!r}")
        self.held = 0          # slots claimed/reserved right now
        self.max_held = 0      # high-water mark (quota-enforcement proof)
        self.inflight = 0      # admitted, unfinished queries
        self.queue: deque[int] = deque()   # ridx waiting for admission
        self.rejects = 0


class _Run:
    """Mutable per-query scheduling state."""

    def __init__(self, ridx: int, plan: dict, display_name: str, t0: float):
        self.ridx = ridx
        self.plan = plan                       # private expanded copy
        self.name = plan["name"]               # unique store namespace
        self.display_name = display_name
        self.t0 = t0
        self.stages = [_Stage(st, i) for i, st in enumerate(plan["stages"])]
        self.by_name = {s.st["name"]: s for s in self.stages}
        self.keys: dict[str, list] = {}
        self.ends: dict[str, list[float]] = {}
        self.nparts: dict[str, int] = {}
        self.outcols: dict[str, list[int]] = {}   # per-task output columns
        self.columns_read = 0
        self.gets = self.puts = self.invocations = self.backups = 0
        self.dup_gets = self.dup_puts = self.poll_gets = 0
        self.retries = self.cold_starts = 0        # §3 fault path
        self.failed = False
        self.fail_reason = ""
        self.tenant: _TenantState | None = None
        self.rejected = False
        # external arrival time: == t0 except for admission-queued runs,
        # whose t0 (activation) is later — latency and queue delay are
        # measured from arrival_t so admission wait counts as queueing
        self.arrival_t = t0
        self.task_seconds = 0.0
        self.final_result = None
        self.stage_windows: dict[str, tuple[float, float]] = {}
        self.finish_t = t0
        self.first_start = math.inf    # earliest task start (sans overhead)
        self.backup_slot_s = 0.0       # slot-seconds held by §5 duplicates
        # latency attribution components (QueryResult.attribution); floats
        # are accumulated only at event pops, in virtual-event order
        self.attr = {"invoke_s": 0.0, "get_s": 0.0, "put_s": 0.0,
                     "visibility_s": 0.0, "compute_s": 0.0,
                     "dup_saved_s": 0.0}
        # reads parked on a producer task's virtual end, woken by its
        # TASK_DONE: (producer stage name, task) -> [(sidx, tidx, rq, lane_t)]
        self.waiters: dict[tuple[str, int], list[tuple]] = {}

    def consumers_of(self, name: str) -> list[_Stage]:
        return [s for s in self.stages if name in s.st["deps"]]


@dataclasses.dataclass
class _Ctx:
    """The event loop's shared mutable state, threaded through handlers."""
    runs: list
    events: EventQueue
    slots: list
    pending: deque
    outstanding: dict
    pool: ThreadPoolExecutor
    deps_map: dict
    virgin: set = dataclasses.field(default_factory=set)  # never-used sids
    # multi-tenant path: background-priority tasks queue separately and
    # are drained only after every foreground task got a chance
    pending_bg: deque = dataclasses.field(default_factory=deque)
    tenancy: bool = False


class Coordinator:
    # zero-arg callables producing an observer for EVERY new coordinator —
    # how `benchmarks/run.py --trace` traces existing benchmarks without
    # touching them (see repro_torch.obs.trace.install_global_tracer)
    observer_factories: list = []

    def __init__(self, store: ObjectStore, base_splits: dict[str, list[str]],
                 policy: StragglerConfig | None = None, *, seed: int = 0,
                 max_parallel: int = 1000, compute_scale: float = 1.0,
                 executor_workers: int | None = None,
                 record_events: bool = False,
                 max_events: int | None = None,
                 faults: FaultInjector | FaultConfig | None = None,
                 coldstart: ColdStartConfig | None = None,
                 retry: RetryPolicy | None = None,
                 journal=None, device: str = "cuda"):
        self.device = device    # torch device the Workers compute on
        self.store = store
        self.base_splits = base_splits
        self.policy = policy or StragglerConfig()
        self.seed = seed
        self.max_parallel = max_parallel
        self.compute_scale = compute_scale
        self.executor_workers = executor_workers or min(8, os.cpu_count()
                                                        or 1)
        # §3 fault path (repro_torch.faults): all None/disabled by default, in
        # which case every scheduling code path is bit-identical to the
        # fault-free engine (strict-superset contract)
        if isinstance(faults, FaultConfig):
            faults = FaultInjector(faults, seed)
        if faults is not None and not faults.config.enabled:
            faults = None
        self.faults = faults
        if coldstart is not None and not coldstart.enabled:
            coldstart = None
        self.coldstart = coldstart
        self.retry = retry or RetryPolicy()
        self.journal = journal
        # request-level event log: (t, kind, query, stage, task, req, info).
        # ``max_events`` caps the list on fleet-scale runs (the drop count
        # is surfaced on event_summary); observers (repro_torch.obs) stream the
        # same tuples uncapped without storing them.
        self.event_log: list[tuple] | None = [] if record_events else None
        self.max_events = max_events
        self.dropped_events = 0
        # read-only observers (repro_torch.obs tracers/metrics/drift): each gets
        # every logged tuple PLUS lifecycle kinds (QUERY_START, STAGE_READY,
        # STAGE_END, TASK_START, TASK_END, QUERY_DONE) that never enter
        # event_log — event_summary's task windows and the tenancy model
        # bank parse the legacy stream, whose shape stays frozen. Observers
        # only read popped state, so attaching one cannot perturb virtual
        # time (the no-perturbation contract gated by benchmarks/obs.py).
        self.observers: list = [f() for f in self.observer_factories]
        self._small_cache: dict[str, Table] = {}
        self._cache_lock = threading.Lock()
        self._name_counts: dict[str, int] = {}
        self._schema_cache: dict[str, dict | None] = {}
        # introspection from the last run_queries call: total event pops
        # (the tenancy benchmark's events/sec numerator) and per-tenant
        # quota/admission state (tests assert max_held <= slot_quota)
        self.last_event_pops = 0
        self.last_event_depth_hwm = 0
        self.tenant_states: dict[str, _TenantState] = {}

    # ------------------------------------------------------------ helpers
    def _base_reader(self, worker: Worker):
        """Broadcast-read a small base table (charged as GETs; see DESIGN)."""
        def read(table: str) -> Table:
            with self._cache_lock:
                cached = self._small_cache.get(table)
            if cached is None:
                tabs = [decode_object(self.store.get(k), key=k,
                                      device=self.device)
                        for k in self.base_splits[table]]
                cached = Table.concat(tabs)
                with self._cache_lock:
                    self._small_cache[table] = cached
            worker.client.gets += len(self.base_splits[table])
            return cached
        return read

    def _base_schema(self, table: str) -> dict | None:
        """Column name -> kind ("num" | "dict") of a base table, sniffed
        lazily from its first split's header (None when the splits are
        plain serialize_table blobs — micro-test fixtures — in which case
        scans of that table fall back to whole-object reads)."""
        if table not in self._schema_cache:
            keys = self.base_splits.get(table)
            meta = object_meta(self.store.get(keys[0]), key=keys[0]) \
                if keys else None
            self._schema_cache[table] = None if meta is None else {
                n: meta["kinds"][n] for n in meta["columns"]}
        return self._schema_cache[table]

    def _task_rng(self, run: _Run, sidx: int, tidx: int, stream: int
                  ) -> np.random.Generator:
        """Deterministic per-(query, stage, task, stream) RNG: virtual timing
        never depends on thread interleaving or executor width."""
        return np.random.default_rng(
            [self.seed, zlib.crc32(run.name.encode()), sidx, tidx, stream])

    def _req_rng(self, run: _Run, sidx: int, tidx: int, rq: int,
                 attempt: int) -> np.random.Generator:
        """Per-(request, attempt) RNG — stream 3 of the task key space, so
        request latencies are a pure function of indices (width-invariant,
        and independent of the heap's processing order)."""
        return np.random.default_rng(
            [self.seed, zlib.crc32(run.name.encode()), sidx, tidx, 3, rq,
             attempt])

    def _slowdown(self, rng: np.random.Generator) -> float:
        f = float(rng.lognormal(0.0, 0.06))
        if rng.random() < COLD_STRAGGLER_PROB:
            f *= 2.0 + float(rng.pareto(1.5))
        return f

    def _consumer_tasks(self, plan, st) -> int:
        """Partition fan-out of a producing stage = consumer's task count.
        0 = no join consumes this stage (readers take the output whole, so
        the worker must NOT write the partitioned format — even a 1-task
        join consumer, by contrast, needs it)."""
        for other in plan["stages"]:
            if other.get("kind") in ("join",) and \
                    st["name"] in (other.get("left"), other.get("right")):
                return self._ntasks(plan, other)
        return 0

    def _ntasks(self, plan, st) -> int:
        if st["kind"] == "scan":
            return st["tasks"] or len(self.base_splits[st["table"]])
        return max(st.get("tasks", 1), 1)

    def attach_observer(self, ob) -> None:
        """Attach a read-only event observer (repro_torch.obs). ``ob.on_event``
        receives every logged tuple ``(t, kind, query, stage, tidx, rq,
        info)`` plus the lifecycle kinds — streamed at the pop, never
        stored here, regardless of ``record_events``."""
        self.observers.append(ob)

    def detach_observer(self, ob) -> None:
        self.observers.remove(ob)

    def _log(self, t: float, name: str, run: _Run, stage: _Stage,
             tidx: int, rq: int, **info):
        if self.event_log is not None:
            if self.max_events is not None and \
                    len(self.event_log) >= self.max_events:
                self.dropped_events += 1
            else:
                self.event_log.append((t, name, run.name, stage.st["name"],
                                       tidx, rq, info))
        for ob in self.observers:
            ob.on_event(t, name, run.name, stage.st["name"], tidx, rq, info)

    def _notify(self, t: float, name: str, run: _Run, stage_name: str,
                tidx: int, **info):
        """Lifecycle kinds for observers ONLY: the legacy event_log shape
        (and everything parsing it) must not change."""
        for ob in self.observers:
            ob.on_event(t, name, run.name, stage_name, tidx, -1, info)

    # ---------------------------------------------------- plan preparation
    def _expand_plan(self, plan: dict, unique_name: str) -> dict:
        """Working copy with combiner stages spliced in for every multi-stage
        shuffle join (shared with the planner's structural model, so the two
        can never disagree on the (p, f) work assignment), then annotated
        with the projection/predicate pushdown pass (also shared with the
        model, so priced bytes match fetched bytes). Pushdown defaults ON;
        a plan sets ``"pushdown": false`` to read whole partitions — the
        planner search exposes this as a plan axis."""
        expanded = expand_combiners(
            plan, unique_name,
            {t: len(ks) for t, ks in self.base_splits.items()})
        if plan.get("pushdown", True):
            schemas: dict[str, dict] = {}
            for st in expanded["stages"]:
                tables = [st["table"]] if st["kind"] == "scan" else []
                tables += [op["table"] for op in st.get("ops", [])
                           if op.get("op") == "broadcast_join"]
                for tb in tables:
                    sch = self._base_schema(tb)
                    if sch is not None:
                        schemas[tb] = sch
            infer_pushdown(expanded, schemas)
        return expanded

    # ------------------------------------------------------------ run API
    def run_query(self, plan: dict, t0: float = 0.0) -> QueryResult:
        return self.run_queries([plan], arrival_times=[t0])[0]

    def run_queries(self, plans: list[dict],
                    arrival_times: list[float] | None = None,
                    after: list[tuple[int, float] | None] | None = None,
                    tenants: list | None = None,
                    max_parallel: int | None = None,
                    ) -> list[QueryResult]:
        """Run several queries against ONE shared invocation-slot pool.

        ``arrival_times[i]`` offsets query i's root stages in virtual time
        (paper §6.5: concurrent streams contend for the account-level
        parallel-invocation limit). Results keep the order of ``plans``.

        ``max_parallel`` overrides the account-level invocation limit for
        THIS call only (planner-driven autoscaling: the adaptive control
        plane requests per-burst concurrency from the slot-queueing wave
        model — ``planner.adaptive``). ``None`` keeps the constructor's
        limit, bit-identical to earlier engines.

        ``after[i] = (j, think_s)`` makes query i *closed-loop*: it arrives
        exactly ``think_s`` virtual seconds after query j finishes (j < i),
        inside the same event loop — so paper-Fig-13-style N-stream
        closed-loop workloads contend for the one slot pool with no
        cross-wave approximation. ``arrival_times[i]`` is ignored for such
        entries; the realised arrival is reported in
        ``QueryResult.arrival_s``.

        ``tenants[i]`` (optional) attributes query i to a tenant: any
        object with a ``name`` and optionally ``slot_quota`` (max slots
        held at once, drawn from this pool), ``max_inflight`` +
        ``admission`` ("queue" | "reject"), ``priority`` ("foreground" |
        "background" — background tasks wait until no foreground task is
        slot-starved), and ``read_lanes`` (caps §3.3 per-task parallel
        reads). Entries sharing a name share one quota/admission state.
        With ``tenants=None`` (or all-None) every tenancy code path is
        skipped and scheduling is bit-identical to earlier engines.
        """
        if not plans:
            return []
        arrivals = list(arrival_times or [0.0] * len(plans))
        if len(arrivals) != len(plans):
            raise ValueError(f"{len(plans)} plans but {len(arrivals)} "
                             "arrival times")
        afters = list(after or [None] * len(plans))
        if len(afters) != len(plans):
            raise ValueError(f"{len(plans)} plans but {len(afters)} "
                             "after entries")
        deps_map: dict[int, list[tuple[int, float]]] = {}
        for i, dep in enumerate(afters):
            if dep is None:
                continue
            j, think = dep
            if not 0 <= j < i:
                raise ValueError(f"after[{i}]={dep!r}: must reference an "
                                 "earlier plan index")
            if think < 0:
                raise ValueError(f"after[{i}]: negative think time {think}")
            deps_map.setdefault(j, []).append((i, float(think)))
        tenant_list = list(tenants or [None] * len(plans))
        if len(tenant_list) != len(plans):
            raise ValueError(f"{len(plans)} plans but {len(tenant_list)} "
                             "tenant entries")
        tstates: dict[str, _TenantState] = {}
        runs: list[_Run] = []
        for ridx, (plan, arr) in enumerate(zip(plans, arrivals)):
            if afters[ridx] is not None:
                arr = math.nan          # set when the upstream run finishes
            validate_plan(plan)
            seen = self._name_counts.get(plan["name"], 0)
            self._name_counts[plan["name"]] = seen + 1
            uname = plan["name"] if seen == 0 else f"{plan['name']}@{seen}"
            expanded = self._expand_plan(plan, uname)
            validate_plan(expanded)
            run = _Run(ridx, expanded, plan["name"], arr)
            spec = tenant_list[ridx]
            if spec is not None:
                if spec.name not in tstates:
                    tstates[spec.name] = _TenantState(spec)
                run.tenant = tstates[spec.name]
            for stage in run.stages:
                stage.n = self._ntasks(expanded, stage.st)
                stage.undispatched = stage.n
                stage.tasks = [_Task() for _ in range(stage.n)]
                run.keys[stage.st["name"]] = [None] * stage.n
                run.ends[stage.st["name"]] = [0.0] * stage.n
                run.outcols[stage.st["name"]] = [0] * stage.n
            runs.append(run)

        n_slots = self.max_parallel if max_parallel is None \
            else max(int(max_parallel), 1)
        open_loop = [a for a, dep in zip(arrivals, afters) if dep is None]
        # slot = (free_t, sid); the sid gives each slot a warm-pool identity
        # without changing which free time is popped (bit-identical multiset)
        slots = [(min(open_loop), i) for i in range(n_slots)]
        heapq.heapify(slots)
        virgin = set(range(n_slots)) if self.coldstart else set()
        events = EventQueue()           # (t, kind, ridx, sidx, tidx, rq)
        pending: deque[tuple[int, int, int]] = deque()   # tasks w/o a slot
        outstanding: dict = {}                # future -> (run, stage, tidx)

        with ThreadPoolExecutor(max_workers=self.executor_workers) as pool:
            ctx = _Ctx(runs, events, slots, pending, outstanding, pool,
                       deps_map, virgin, tenancy=bool(tstates))
            self.tenant_states = tstates
            for run in runs:
                if not math.isnan(run.t0):
                    self._arrive(ctx, run, run.t0)
            while events or outstanding:
                while outstanding and not self._can_pop(events, outstanding):
                    self._await_some(ctx)
                if not events:
                    continue
                t, kind, ridx, sidx, tidx, rq = events.pop()
                run, stage = runs[ridx], runs[ridx].stages[sidx]
                if kind == _READY:
                    if run.failed:
                        continue        # §3: an exhausted budget failed it
                    if not stage.dispatched and \
                            not self._deps_resolved(run, stage):
                        # a late-dispatched producer hasn't executed yet;
                        # wall-clock wait only, virtual state is unchanged.
                        # Defer past the heap top when nothing is in flight
                        # (a fault-path retry may be what re-runs the dep)
                        if outstanding:
                            events.push(t, kind, ridx, sidx, tidx, rq)
                            self._await_some(ctx)
                        else:
                            events.push(events.peek_t() + _EPS,
                                        kind, ridx, sidx, tidx, rq)
                        continue
                    # journal AFTER the re-push guard: re-pops depend on
                    # wall clock, consumed events are width-invariant
                    if self.journal is not None:
                        self.journal.observe((t, kind, ridx, sidx, tidx, rq))
                    self._on_ready(ctx, run, stage, t)
                    continue
                if self.journal is not None:
                    self.journal.observe((t, kind, ridx, sidx, tidx, rq))
                if rq >= 0:
                    base = stage.tasks[tidx].req_base
                    if rq < base:
                        continue    # of an attempt a worker loss discarded
                    rq -= base
                if kind == _DONE:
                    self._on_done(ctx, run, stage, tidx, t)
                elif kind == _BACKUP:
                    self._on_backup(ctx, run, stage, tidx, t)
                elif kind in (_GET_ISSUE, _VISIBLE):
                    self._on_get_issue(ctx, run, stage, tidx, rq, t,
                                       retargeted=(kind == _VISIBLE))
                elif kind == _PUT_ISSUE:
                    self._on_put_issue(ctx, run, stage, tidx, rq, t)
                elif kind == _DUP:
                    self._on_dup(ctx, run, stage, tidx, rq, t)
                elif kind == _INVOKE_FAIL:
                    self._on_invoke_fail(ctx, run, stage, tidx, rq, t)
                elif kind == _RETRY:
                    self._on_retry(ctx, run, stage, tidx, rq, t)
                elif kind == _ADMIT:
                    self._on_admit(ctx, run, t)
                elif kind == _RELEASE:
                    self._on_release(ctx, run, t)
                else:                   # _GET_DONE / _PUT_DONE
                    self._on_req_done(ctx, run, stage, tidx, rq, t,
                                      is_put=(kind == _PUT_DONE))

        self.last_event_pops = events.popped
        self.last_event_depth_hwm = events.depth_hwm
        return [self._finish(run) for run in runs]

    # ----------------------------------------------------- loop plumbing
    @staticmethod
    def _can_pop(events, outstanding) -> bool:
        """An event may fire only if no unresolved task could still produce
        one at or before it (all of a task's timeline events are >= its
        start). STRICTLY before the bound: an unresolved task may push an
        event at exactly its start, and popping across that tie would let
        wall-clock resolution order pick the tie-winner — the heap's tuple
        order must, or the failover journal (repro_torch.faults) isn't
        replayable."""
        if not events:
            return False
        if not outstanding:
            return True
        bound = min(stage.tasks[tidx].start
                    for (_r, stage, tidx) in outstanding.values())
        return events.peek_t() < bound - _EPS

    def _await_some(self, ctx: _Ctx):
        """Block until >=1 real execution finishes; adopt its timeline.
        Only deterministic state is touched, in deterministic per-task ways,
        so wall-clock completion order never leaks into virtual time."""
        done, _ = wait(list(ctx.outstanding), return_when=FIRST_COMPLETED)
        for f in done:
            run, stage, tidx = ctx.outstanding.pop(f)
            self._resolve(ctx, run, stage, tidx, f.result())

    def _activate(self, run: _Run, t0: float, events: EventQueue):
        """Arm a run's root stages at virtual time t0 (query start)."""
        run.t0 = t0
        run.finish_t = t0
        if math.isnan(run.arrival_t):
            run.arrival_t = t0
        if self.observers:
            self._notify(t0, "QUERY_START", run, "", -1,
                         display=run.display_name, arrival=run.arrival_t,
                         tenant=run.tenant.name if run.tenant is not None
                         else "")
        for stage in run.stages:
            if not stage.st["deps"]:
                stage.ready_pushed = True
                events.push(t0, _READY, run.ridx, stage.sidx, 0, -1)

    def _arrive(self, ctx: _Ctx, run: _Run, t: float):
        """A query arrives (open-loop t0 or closed-loop finish+think).
        Tenant-owned queries route through admission control; everything
        else activates directly — the pre-tenancy code path, unchanged."""
        if run.tenant is None:
            self._activate(run, t, ctx.events)
            return
        if math.isnan(run.arrival_t):
            run.arrival_t = t
        ctx.events.push(t, _ADMIT, run.ridx, 0, 0, -1)

    # --------------------------------------------------- tenancy events
    def _on_admit(self, ctx: _Ctx, run: _Run, t: float):
        """ADMIT: the tenant's admission controller sees the arrival.
        Under the inflight cap the query starts now; over it, policy
        "queue" parks it (admitted FIFO as earlier queries finish, the
        wait counted as queue delay) and "reject" drops it outright."""
        st = run.tenant
        if st.max_inflight is None or st.inflight < st.max_inflight:
            st.inflight += 1
            self._log(t, "ADMIT", run, run.stages[0], -1, -1,
                      tenant=st.name, queued=False)
            self._activate(run, t, ctx.events)
        elif st.admission == "reject":
            run.rejected = True
            run.t0 = t
            run.arrival_t = t
            run.finish_t = t
            st.rejects += 1
            self._log(t, "ADMIT_REJECT", run, run.stages[0], -1, -1,
                      tenant=st.name, inflight=st.inflight)
            # the stream is not wedged: closed-loop dependents still
            # arrive (the client saw the rejection immediately)
            for di, think in ctx.deps_map.get(run.ridx, ()):
                self._arrive(ctx, ctx.runs[di], t + think)
        else:
            st.queue.append(run.ridx)
            self._log(t, "ADMIT_QUEUE", run, run.stages[0], -1, -1,
                      tenant=st.name, depth=len(st.queue))

    def _on_release(self, ctx: _Ctx, run: _Run, t: float):
        """RELEASE: a slot reserved by this tenant reached its free time;
        the quota headroom may unblock queued tasks."""
        st = run.tenant
        st.held -= 1
        self._log(t, "SLOT_RELEASE", run, run.stages[0], -1, -1,
                  tenant=st.name, held=st.held)
        self._drain_pending(ctx, t)

    def _query_finished(self, ctx: _Ctx, run: _Run, t: float):
        """A tenant query finished (or failed): free its inflight token
        and admit the tenant's longest-waiting queued query, if any."""
        st = run.tenant
        if st is None:
            return
        st.inflight -= 1
        while st.queue:
            nxt = ctx.runs[st.queue.popleft()]
            if nxt.failed or nxt.rejected:
                continue
            st.inflight += 1
            self._log(t, "ADMIT", nxt, nxt.stages[0], -1, -1,
                      tenant=st.name, queued=True)
            self._activate(nxt, t, ctx.events)
            break

    def _quota_blocked(self, run: _Run) -> bool:
        st = run.tenant
        return st is not None and st.slot_quota is not None \
            and st.held >= st.slot_quota

    def _note_claim(self, run: _Run, stage: _Stage, tidx: int,
                    t_claim: float, sid: int):
        st = run.tenant
        if st is None:
            return
        st.held += 1
        if st.held > st.max_held:
            st.max_held = st.held
        self._log(t_claim, "SLOT_CLAIM", run, stage, tidx, -1,
                  tenant=st.name, sid=sid, held=st.held)

    def _return_slot(self, ctx: _Ctx, run: _Run, free_t: float, sid: int,
                     now: float):
        """Return a slot to the shared pool; for tenant runs, also return
        it to the tenant's quota — at ``free_t``, not at this pop, so a
        slot pushed back with a future free time (backup duplicates, the
        invoke-fail error window) stays counted against the quota while
        it is actually occupied."""
        heapq.heappush(ctx.slots, (free_t, sid))
        st = run.tenant
        if st is None:
            return
        if free_t <= now + _EPS:
            st.held -= 1
            self._log(now, "SLOT_RELEASE", run, run.stages[0], -1, -1,
                      tenant=st.name, held=st.held)
        else:
            ctx.events.push(free_t, _RELEASE, run.ridx, 0, 0, -1)

    def _task_lanes(self, run: _Run) -> int:
        """§3.3 parallel-read lanes for one of this run's tasks; a tenant
        ``read_lanes`` cap throttles I/O concurrency, not just slots."""
        lanes = self.policy.parallel_reads
        st = run.tenant
        if st is not None and st.read_lanes is not None:
            lanes = min(lanes, st.read_lanes)
        return max(lanes, 1)

    def _queue_task(self, ctx: _Ctx, run: _Run, sidx: int, tidx: int):
        """Park a slotless (or quota-blocked) task on the right pending
        queue: background tenants wait behind every foreground task."""
        st = run.tenant
        if st is not None and st.priority == "background":
            ctx.pending_bg.append((run.ridx, sidx, tidx))
        else:
            ctx.pending.append((run.ridx, sidx, tidx))

    @staticmethod
    def _deps_resolved(run: _Run, stage: _Stage) -> bool:
        return all(tk.resolved for dep in stage.st["deps"]
                   for tk in run.by_name[dep].tasks)

    @staticmethod
    def _claim_slot(ctx: _Ctx, *floors: float):
        """Pop the earliest-free slot and floor its claim time. Returns
        ``(t_claim, free_t, sid, virgin)`` — the caller decides whether a
        container actually launches (a failed invoke keeps the slot
        virgin, so ``ctx.virgin`` is only mutated at real launches)."""
        free_t, sid = heapq.heappop(ctx.slots)
        t_claim = free_t
        for f in floors:
            if f > t_claim:
                t_claim = f
        return t_claim, free_t, sid, sid in ctx.virgin

    def _invoke_overhead(self, run: _Run, stage: _Stage, tidx: int,
                         attempt: int, t_claim: float, free_t: float,
                         virgin: bool, stream: int = 0):
        """Invoke overhead for a slot claim: ``(overhead_s, cold_extra_s)``.
        Cold iff the warm-pool model is on and the slot is virgin or sat
        idle past the keep-alive window; the extra is sampled from an RNG
        keyed on indices only (width-invariant)."""
        cs = self.coldstart
        if cs is None:
            return INVOKE_OVERHEAD_S, 0.0
        idle = t_claim - free_t
        if not virgin and idle <= cs.keepalive_s:
            return cs.warm_overhead_s, 0.0
        rng = np.random.default_rng(
            [self.seed, _COLD_SALT, zlib.crc32(run.name.encode()),
             stage.sidx, tidx, attempt, stream])
        extra = cs.sample_cold_s(rng)
        return cs.warm_overhead_s + extra, extra

    def _dispatch(self, ctx: _Ctx, run: _Run, stage: _Stage, tidx: int,
                  t_claim: float, free_t: float, sid: int, virgin: bool):
        """Dispatch (or re-dispatch) one task attempt on a claimed slot.

        The fault path forks here: a failed invoke releases the slot at the
        error-response time without launching a container; a worker-loss
        retry *replays* the recorded timeline (fresh ``_TaskIO``) instead of
        re-submitting the worker — §3.2 immutability makes the replay safe
        and keeps real execution exactly-once per task."""
        task = stage.tasks[tidx]
        run.invocations += 1        # every attempt is a billed invoke call
        inj = self.faults
        if inj is not None and inj.invoke_fails(run.name, stage.sidx, tidx,
                                                task.attempt):
            detect = t_claim + inj.config.fail_detect_s
            # slot free at detect, stays virgin
            self._return_slot(ctx, run, detect, sid, t_claim)
            task.failures += 1
            task.retrying = True
            task.retry_reason = "invoke"
            self._log(t_claim, "INVOKE_FAIL", run, stage, tidx, -1,
                      reason="invoke", attempt=task.attempt,
                      detect=detect)
            ctx.events.push(detect, _INVOKE_FAIL, run.ridx,
                            stage.sidx, tidx, -1)
            return
        ctx.virgin.discard(sid)
        overhead, cold_extra = self._invoke_overhead(
            run, stage, tidx, task.attempt, t_claim, free_t, virgin)
        start = t_claim + overhead
        if cold_extra > 0.0:
            run.cold_starts += 1
            run.attr["cold_s"] = run.attr.get("cold_s", 0.0) + cold_extra
            self._log(t_claim, "COLD_START", run, stage, tidx, -1,
                      extra_s=cold_extra, idle_s=t_claim - free_t,
                      attempt=task.attempt)
        task.start = start
        task.sid = sid
        task.retrying = False
        run.attr["invoke_s"] += overhead
        if self.observers:
            self._notify(t_claim, "TASK_START", run, stage.st["name"], tidx,
                         start=start, sid=sid, attempt=task.attempt)
        if task.result is not None:
            # worker-loss replay: real bytes already moved and the timeline
            # is known — re-bill the attempt's requests and re-advance a
            # fresh request state machine from the new start
            run.gets += task.result.gets
            run.puts += task.result.puts
            slow = self._slowdown(self._task_rng(run, stage.sidx, tidx,
                                                 64 + task.attempt))
            task.io = _TaskIO(task.result.timeline.phases, slow,
                              self._task_lanes(run))
            self._io_advance(ctx, run, stage, tidx, start)
            return
        if not task.dispatched:
            task.dispatched = True
            stage.undispatched -= 1
        if stage.st["kind"] == "modeled":
            # hybrid mode (workload.tenancy): no worker runs — the task's
            # timeline is a single calibrated compute phase, resolved at
            # this pop. The event loop never blocks on the thread pool for
            # modeled stages, which is what makes 1000-stream fleets cheap
            # while the slot claim above still couples into §6.5 contention.
            self._resolve(ctx, run, stage, tidx,
                          self._modeled_result(stage.st, tidx))
            return
        worker = Worker(self.store, self.policy,
                        self._task_rng(run, stage.sidx, tidx, 0),
                        self.compute_scale, device=self.device)
        call = self._build_task(run, stage.st, tidx, worker, start)
        ctx.outstanding[ctx.pool.submit(call)] = (run, stage, tidx)

    def _modeled_result(self, st: dict, tidx: int) -> TaskResult:
        """Synthetic TaskResult for a "modeled" stage task: a single
        compute phase of the stage's calibrated per-task duration (the
        per-task §5 slowdown multiplies it at _io_advance, so modeled
        stages keep an emergent straggler spread), plus billed request
        counts apportioned by workload.tenancy's model bank."""
        def _at(v, default=0):
            if isinstance(v, (list, tuple)):
                return v[tidx]
            return default if v is None else v
        tl = RequestTimeline()
        tl.record_compute(float(_at(st.get("task_s"), 0.0)))
        return TaskResult(key=None, gets=int(_at(st.get("task_gets"))),
                          puts=int(_at(st.get("task_puts"))),
                          compute_s=float(_at(st.get("task_s"), 0.0)),
                          out_bytes=0, timeline=tl)

    def _drain_pending(self, ctx: _Ctx, now: float):
        """Give freed slots to queued tasks, FIFO — foreground queue
        first, background tenants only after it is empty. Called only at
        event pops, so assignment order is a function of virtual time
        alone. Tasks whose tenant is at its slot quota are skipped in
        place (order preserved) until a RELEASE restores headroom."""
        for q in (ctx.pending, ctx.pending_bg):
            deferred = []
            while q and ctx.slots:
                ridx, sidx, tidx = q.popleft()
                run, stage = ctx.runs[ridx], ctx.runs[ridx].stages[sidx]
                if run.failed:
                    continue
                if self._quota_blocked(run):
                    deferred.append((ridx, sidx, tidx))
                    continue
                t_claim, free_t, sid, virgin = self._claim_slot(
                    ctx, stage.ready_t, now)
                self._note_claim(run, stage, tidx, t_claim, sid)
                run.first_start = min(run.first_start, t_claim)
                self._dispatch(ctx, run, stage, tidx, t_claim, free_t, sid,
                               virgin)
                # the stage's backup timers were armed before this task
                # even started: arm its own straggler timer now (stale-
                # checked at the pop if the task finishes in time)
                task = stage.tasks[tidx]
                if stage.backup_armed and stage.median > 0 and \
                        not task.retrying:
                    detect = task.start + self.policy.backup_factor * \
                        stage.median
                    ctx.events.push(detect, _BACKUP, ridx, sidx, tidx, -1)
            for item in reversed(deferred):
                q.appendleft(item)

    # ------------------------------------------------------- task events
    def _on_ready(self, ctx: _Ctx, run: _Run, stage: _Stage, t: float):
        if stage.dispatched or run.failed:
            return
        stage.dispatched = True
        stage.ready_t = t
        if self.observers:
            self._notify(t, "STAGE_READY", run, stage.st["name"], -1,
                         tasks=stage.n, kind=stage.st["kind"])
        for ti in range(stage.n):
            if not ctx.slots or self._quota_blocked(run):
                self._queue_task(ctx, run, stage.sidx, ti)
                continue
            t_claim, free_t, sid, virgin = self._claim_slot(ctx, t)
            self._note_claim(run, stage, ti, t_claim, sid)
            run.first_start = min(run.first_start, t_claim)
            self._dispatch(ctx, run, stage, ti, t_claim, free_t, sid,
                           virgin)

    def _resolve(self, ctx: _Ctx, run: _Run, stage: _Stage, tidx: int,
                 r: TaskResult):
        """A real execution finished: adopt its request timeline. Virtual
        timing is decided by the event heap from here on."""
        task = stage.tasks[tidx]
        task.resolved = True
        task.result = r
        run.keys[stage.st["name"]][tidx] = r.key
        run.outcols[stage.st["name"]][tidx] = r.out_ncols
        run.columns_read += r.columns_read
        run.gets += r.gets
        run.puts += r.puts
        if r.result is not None:
            run.final_result = r.result
        slow = self._slowdown(self._task_rng(run, stage.sidx, tidx, 1))
        task.io = _TaskIO(r.timeline.phases, slow, self._task_lanes(run))
        self._io_advance(ctx, run, stage, tidx, task.start)

    def _on_done(self, ctx: _Ctx, run: _Run, stage: _Stage, tidx: int,
                 t: float):
        task = stage.tasks[tidx]
        if task.done or abs(t - task.end) > _EPS:
            return                        # stale event (end superseded)
        task.done = True
        stage.done += 1
        if self.observers:
            self._notify(t, "TASK_END", run, stage.st["name"], tidx,
                         end=t, mid_flight=not task.io_done)
        if task.io_done:
            # the slot stays busy for the ORIGINAL duration even when a
            # backup duplicate finished the task's work earlier
            self._return_slot(ctx, run, task.start + task.dur, task.sid, t)
            self._drain_pending(ctx, t)
        # else: a mid-flight backup duplicate won; the slot is released
        # (and billing settled) when the original's timeline completes

        # wake reads parked on this producer's virtual end: re-placement
        # at this pop (t == task.end) keeps all pushed events >= now.
        # When a §5 backup duplicate shortened this end (mid-flight win:
        # the original's timeline is still advancing), the parked consumer
        # reads are speculatively re-placed against the duplicate's earlier
        # conditional PUT — logged so tests can pin the re-read semantics.
        for (csidx, ctidx, rq, lane_t) in run.waiters.pop(
                (stage.st["name"], tidx), []):
            if task.backup_cap < math.inf:
                self._log(t, "READ_REPLACED", run, run.stages[csidx],
                          ctidx, rq, producer=stage.st["name"],
                          producer_task=tidx, end=t,
                          mid_flight=not task.io_done)
            self._io_place_get(ctx, run, run.stages[csidx], ctidx, rq,
                               lane_t)

        # arm backup timers once the stage median is estimable (§5)
        pol = self.policy
        if pol.backup_tasks and not stage.backup_armed and stage.n > 1 and \
                stage.done >= max(math.ceil(pol.backup_quorum * stage.n), 1):
            stage.backup_armed = True
            stage.median = float(np.median(
                [tk.end - tk.start for tk in stage.tasks if tk.done]))
            if stage.median > 0:
                for ti, tk in enumerate(stage.tasks):
                    detect = tk.start + pol.backup_factor * stage.median
                    if tk.dispatched and not tk.done and \
                            not tk.retrying and tk.end > detect + _EPS:
                        ctx.events.push(detect, _BACKUP, run.ridx,
                                        stage.sidx, ti, -1)

        if stage.done == stage.n:
            self._finish_stage(run, stage)
            if stage.st is run.plan["stages"][-1]:
                # closed-loop streams: the next query in the stream arrives
                # think_s after this one finishes
                for di, think in ctx.deps_map.get(run.ridx, ()):
                    self._arrive(ctx, ctx.runs[di], run.finish_t + think)
                self._query_finished(ctx, run, t)
                if self.observers:
                    self._notify(t, "QUERY_DONE", run, "", -1,
                                 finish=run.finish_t, failed=False)
        self._check_consumers(run, stage.st["name"], ctx.events, t)

    def _on_backup(self, ctx: _Ctx, run: _Run, stage: _Stage, tidx: int,
                   t: float):
        """BACKUP_FIRE: duplicate a straggling task; completion is the min
        of original and duplicate (first conditional PUT wins).

        The duplicate is a real invocation: it must claim a slot from the
        shared free-slot heap, so §6.5 contention includes mitigation
        overhead. If the account is at its invocation limit (no free slot —
        the heap is drained whenever tasks are queued) the coordinator
        skips the duplicate rather than queueing mitigation behind fresh
        work. A claimed slot stays busy for the duplicate's full run even
        when the original wins (Lambda invocations cannot be cancelled);
        billing (task_seconds) stops at the losing writer's conditional
        PUT, which is why slot-seconds are tracked separately in
        ``backup_slot_s``. When the duplicate beats an original whose
        timeline is still advancing, the min is applied (and billing
        settled) at the original's timeline completion.
        """
        task = stage.tasks[tidx]
        if task.done or task.retrying or run.failed or \
                task.end <= t + _EPS:
            return
        if not ctx.slots:
            return                          # at the invocation limit
        if self._quota_blocked(run):
            return      # §6.5: mitigation never bursts past the quota
        dup = stage.median * self._slowdown(
            self._task_rng(run, stage.sidx, tidx, 2))
        t_claim, free_t, sid, virgin = self._claim_slot(ctx, t)
        self._note_claim(run, stage, tidx, t_claim, sid)
        ctx.virgin.discard(sid)
        overhead, cold_extra = self._invoke_overhead(
            run, stage, tidx, task.attempt, t_claim, free_t, virgin,
            stream=1)
        if cold_extra > 0.0:
            run.cold_starts += 1
            run.attr["cold_s"] = run.attr.get("cold_s", 0.0) + cold_extra
            self._log(t_claim, "COLD_START", run, stage, tidx, -1,
                      extra_s=cold_extra, idle_s=t_claim - free_t,
                      attempt=task.attempt, backup=True)
        start = t_claim + overhead
        self._return_slot(ctx, run, start + dup, sid, t)
        run.attr["invoke_s"] += overhead
        run.backups += 1
        run.invocations += 1
        run.gets += task.result.gets        # duplicate re-reads its inputs
        run.puts += task.result.puts
        run.backup_slot_s += dup
        cand = start + dup
        self._log(t, "BACKUP_FIRE", run, stage, tidx, -1, dup_s=dup,
                  cand=cand)
        if task.io_done:
            run.task_seconds += min(dup, task.dur)
            if cand < task.end - _EPS:
                task.end = cand             # original DONE event goes stale
                run.ends[stage.st["name"]][tidx] = cand
                ctx.events.push(cand, _DONE, run.ridx,
                                stage.sidx, tidx, -1)
        else:
            # the original's duration is not known yet: remember the
            # duplicate and settle at timeline completion
            task.backup_dup = dup
            if cand < task.backup_cap:
                task.backup_cap = cand
                task.end = cand
                run.ends[stage.st["name"]][tidx] = cand
                ctx.events.push(cand, _DONE, run.ridx,
                                stage.sidx, tidx, -1)

    # ---------------------------------------------------- request events
    @staticmethod
    def _push_req(ctx: _Ctx, t: float, kind: int, run: _Run,
                  stage: _Stage, tidx: int, rq: int):
        """Push an event of request ``rq`` of the task's current attempt,
        tagged with the attempt by the task's ``req_base``."""
        ctx.events.push(t, kind, run.ridx, stage.sidx, tidx,
                        stage.tasks[tidx].req_base + rq)

    def _io_advance(self, ctx: _Ctx, run: _Run, stage: _Stage, tidx: int,
                    t: float):
        """Advance a task's timeline to the next phase that needs heap
        events (read batch or write), folding compute phases into ``t``."""
        task = stage.tasks[tidx]
        io = task.io
        while True:
            io.pi += 1
            if io.pi >= len(io.phases):
                self._io_complete(ctx, run, stage, tidx, t)
                return
            phase = io.phases[io.pi]
            if phase[0] == "compute":
                comp = phase[1] * io.slow
                run.attr["compute_s"] += comp
                self._log(t, "COMPUTE", run, stage, tidx, -1, seconds=comp)
                t += comp
                continue
            if phase[0] == "gets":
                _, specs, conc = phase
                io.conc = conc
                io.pending = len(specs)
                io.phase_end = t
                base = len(io.reqs)
                io.reqs.extend(_Req(s, False) for s in specs)
                io.queue.extend(range(base, base + len(specs)))
                for _ in range(min(io.nlanes, len(io.queue))):
                    self._io_place_get(ctx, run, stage, tidx,
                                       io.queue.popleft(), t)
                return
            # "puts": primary + optional doublewrite twin, in parallel
            _, specs = phase
            io.pending = len(specs)
            io.phase_end = t
            for s in specs:
                rq = len(io.reqs)
                io.reqs.append(_Req(s, True))
                self._push_req(ctx, t, _PUT_ISSUE, run, stage, tidx, rq)
            return

    def _io_place_get(self, ctx: _Ctx, run: _Run, stage: _Stage, tidx: int,
                      rq: int, lane_t: float):
        """Place one read on its lane: resolve the producer's virtual end
        (or park on it), pick the doublewrite twin that becomes visible
        first, bill the 404 polls, and push the issue event."""
        io = stage.tasks[tidx].io
        req = io.reqs[rq]
        spec = req.spec
        if spec.src is not None:
            dep = run.by_name[spec.src[0]].tasks[spec.src[1]]
            if not dep.done and not run.failed:
                run.waiters.setdefault(spec.src, []).append(
                    (stage.sidx, tidx, rq, lane_t))
                return
            # a failed run drains its in-flight timelines without the
            # producer ever finishing (QUERY_FAIL woke this read)
            avail = dep.end if dep.done else lane_t
        else:
            avail = spec.avail
        target, lag = visible_twin(spec.key, spec.alt_key,
                                   self.store.config.seed)
        req.target = target
        polls, tt = poll_until_visible(lane_t, avail, lag)
        run.attr["visibility_s"] += tt - max(lane_t, avail)
        if polls:
            req.polls = polls
            run.gets += polls
            run.poll_gets += polls
            self._log(tt, "VISIBLE_AT", run, stage, tidx, rq, target=target,
                      polls=polls, avail=avail, lag=lag)
            self._push_req(ctx, tt, _VISIBLE, run, stage, tidx, rq)
        else:
            # tt == max(lane_t, avail): issue as soon as the lane and the
            # producer allow
            self._push_req(ctx, tt, _GET_ISSUE, run, stage, tidx, rq)

    @staticmethod
    def _req_stream(task: _Task, req: _Req) -> int:
        """RNG stream for a request's current (attempt, try): equals 0 at
        the fault-free (0, 0) case so the zero-rate path is bit-identical;
        the §5 duplicate of the same try uses ``stream + 1``."""
        return task.attempt * 1024 + req.tries * 2

    def _on_get_issue(self, ctx: _Ctx, run: _Run, stage: _Stage, tidx: int,
                      rq: int, t: float, retargeted: bool = False):
        task = stage.tasks[tidx]
        io = task.io
        req = io.reqs[rq]
        req.issue_t = t
        stream = self._req_stream(task, req)
        rng = self._req_rng(run, stage.sidx, tidx, rq, stream)
        # io.conc lanes share the invocation's NIC: past the Fig-3
        # saturation point the streaming term slows to the fair share
        t1 = self.store.config.get_model.sample(req.spec.nbytes, rng,
                                                io.conc) * io.slow
        inj = self.faults
        if inj is not None and inj.request_fails(
                run.name, stage.sidx, tidx, rq, task.attempt, req.tries,
                put=False):
            # the connection dies at the try's would-be completion time
            self._log(t, "GET_ISSUE", run, stage, tidx, rq, key=req.target,
                      nbytes=req.spec.nbytes, conc=io.conc,
                      retargeted=retargeted, failed=True, tries=req.tries)
            self._push_req(ctx, t + t1, _INVOKE_FAIL, run, stage, tidx, rq)
            return
        req.end = t + t1
        pol = self.policy.rsm
        if pol.enabled:
            timeout = pol.timeout_s(req.spec.nbytes, io.conc)
            if t1 > timeout:
                self._push_req(ctx, t + timeout, _DUP, run, stage, tidx,
                               rq)
        self._log(t, "GET_ISSUE", run, stage, tidx, rq, key=req.target,
                  nbytes=req.spec.nbytes, conc=io.conc,
                  retargeted=retargeted)
        self._push_req(ctx, req.end, _GET_DONE, run, stage, tidx, rq)

    def _on_put_issue(self, ctx: _Ctx, run: _Run, stage: _Stage, tidx: int,
                      rq: int, t: float):
        task = stage.tasks[tidx]
        io = task.io
        req = io.reqs[rq]
        req.issue_t = t
        stream = self._req_stream(task, req)
        rng = self._req_rng(run, stage.sidx, tidx, rq, stream)
        send1, post1 = self.store.config.put_model.sample_phases(
            req.spec.nbytes, rng)
        send1 *= io.slow
        post1 *= io.slow
        t1 = send1 + post1
        inj = self.faults
        if inj is not None and inj.request_fails(
                run.name, stage.sidx, tidx, rq, task.attempt, req.tries,
                put=True):
            self._log(t, "PUT_ISSUE", run, stage, tidx, rq,
                      key=req.spec.key, nbytes=req.spec.nbytes,
                      failed=True, tries=req.tries)
            self._push_req(ctx, t + t1, _INVOKE_FAIL, run, stage, tidx, rq)
            return
        req.end = t + t1
        pol = self.policy.wsm
        if pol.enabled:
            start2 = pol.dup_start_s(send1, req.spec.nbytes)
            if t1 > start2:
                self._push_req(ctx, t + start2, _DUP, run, stage, tidx,
                               rq)
        self._log(t, "PUT_ISSUE", run, stage, tidx, rq, key=req.spec.key,
                  nbytes=req.spec.nbytes)
        self._push_req(ctx, req.end, _PUT_DONE, run, stage, tidx, rq)

    def _on_dup(self, ctx: _Ctx, run: _Run, stage: _Stage, tidx: int,
                rq: int, t: float):
        """DUP_FIRE: the §5 per-request timer expired — issue a duplicate
        GET/PUT mid-request; completion is first-of-two-wins and the loser
        is cancelled but billed (itemized in dup_gets/dup_puts)."""
        task = stage.tasks[tidx]
        io = task.io
        if io is None:
            return                  # attempt discarded (§3 worker loss)
        req = io.reqs[rq]
        if req.done or req.end <= t + _EPS:
            return                          # completed before the timer
        rng = self._req_rng(run, stage.sidx, tidx, rq,
                            self._req_stream(task, req) + 1)
        if req.put:
            send2, post2 = self.store.config.put_model.sample_phases(
                req.spec.nbytes, rng)
            t2 = (send2 + post2) * io.slow
            run.puts += 1
            run.dup_puts += 1
        else:
            t2 = self.store.config.get_model.sample(req.spec.nbytes, rng,
                                                    io.conc) * io.slow
            run.gets += 1
            run.dup_gets += 1
        req.dup = True
        new_end = min(req.end, t + t2)
        self._log(t, "DUP_FIRE", run, stage, tidx, rq,
                  kind="put" if req.put else "get", nbytes=req.spec.nbytes,
                  won=new_end < req.end - _EPS)
        if new_end < req.end - _EPS:
            run.attr["dup_saved_s"] += req.end - new_end
            req.end = new_end               # original DONE event goes stale
            self._push_req(ctx, new_end,
                           _PUT_DONE if req.put else _GET_DONE, run, stage,
                           tidx, rq)

    def _on_req_done(self, ctx: _Ctx, run: _Run, stage: _Stage, tidx: int,
                     rq: int, t: float, is_put: bool):
        io = stage.tasks[tidx].io
        if io is None:
            return                  # attempt discarded (§3 worker loss)
        req = io.reqs[rq]
        if req.done or abs(t - req.end) > _EPS:
            return                          # superseded by the duplicate
        req.done = True
        io.pending -= 1
        io.phase_end = max(io.phase_end, t)
        run.attr["put_s" if is_put else "get_s"] += t - req.issue_t
        self._log(t, "PUT_DONE" if is_put else "GET_DONE", run, stage,
                  tidx, rq, nbytes=req.spec.nbytes, dur=t - req.issue_t,
                  dup=req.dup,
                  key=req.spec.key if is_put else req.target)
        if not is_put and io.queue:
            # the freed lane immediately serves the next queued read
            self._io_place_get(ctx, run, stage, tidx, io.queue.popleft(), t)
        if io.pending == 0 and not io.queue:
            self._io_advance(ctx, run, stage, tidx, io.phase_end)

    def _io_complete(self, ctx: _Ctx, run: _Run, stage: _Stage, tidx: int,
                     t: float):
        """The task's timeline is fully advanced: fix its original duration,
        settle deferred backup billing, and fire (or reconcile) TASK_DONE."""
        task = stage.tasks[tidx]
        task.io_done = True
        task.dur = t - task.start
        # float accumulation happens at event pops, in virtual-event order,
        # so the sum is bit-identical for every executor width
        run.task_seconds += task.dur
        if task.backup_dup is not None:
            # §5 duplicate raced a mid-flight original: billing stops at
            # the losing writer's conditional PUT
            run.task_seconds += min(task.backup_dup, task.dur)
            task.backup_dup = None
        inj = self.faults
        if inj is not None and inj.worker_lost(run.name, stage.sidx, tidx,
                                               task.attempt):
            # the worker dies before its final conditional PUT lands: the
            # whole attempt is billed (above) but produced nothing
            self._on_worker_lost(ctx, run, stage, tidx, t)
            return
        if task.done:
            # a backup duplicate already finished this task (its DONE
            # popped at backup_cap); release the slot now that the
            # original's full duration is known
            self._return_slot(ctx, run, task.start + task.dur, task.sid, t)
            self._drain_pending(ctx, t)
            return
        end = min(t, task.backup_cap)
        task.end = end
        run.ends[stage.st["name"]][tidx] = end
        ctx.events.push(end, _DONE, run.ridx, stage.sidx, tidx, -1)

    # ------------------------------------------------------- fault events
    def _on_worker_lost(self, ctx: _Ctx, run: _Run, stage: _Stage,
                        tidx: int, t: float):
        """An attempt's worker died pre-final-PUT. If a §5 backup duplicate
        is racing (or already won), its conditional PUT rescues the task and
        no retry is needed; otherwise the task re-dispatches as a timeline
        replay after backoff — or fails the query on an exhausted budget."""
        task = stage.tasks[tidx]
        rescued = task.done or task.backup_cap < math.inf
        self._log(t, "INVOKE_FAIL", run, stage, tidx, -1,
                  reason="worker_loss", attempt=task.attempt,
                  rescued=rescued)
        if rescued:
            if task.done:
                # DONE already popped at the duplicate's completion;
                # release the original's slot now that its dur is known
                self._return_slot(ctx, run, task.start + task.dur,
                                  task.sid, t)
                self._drain_pending(ctx, t)
            # else: _on_done pops at backup_cap and releases the slot
            return
        self._return_slot(ctx, run, t, task.sid, t)
        self._drain_pending(ctx, t)
        if run.failed:
            return
        task.failures += 1
        task.retrying = True
        task.retry_reason = "worker_loss"
        task.req_base += len(task.io.reqs)
        task.io = None
        task.io_done = False
        task.end = math.inf
        if task.failures >= self.retry.max_attempts:
            self._fail_run(ctx, run, stage, tidx, t, "worker_loss")
            return
        back = self.retry.backoff_s(task.failures)
        run.attr["retry_s"] = run.attr.get("retry_s", 0.0) + back
        ctx.events.push(t + back, _RETRY, run.ridx, stage.sidx, tidx, -1)

    def _on_invoke_fail(self, ctx: _Ctx, run: _Run, stage: _Stage,
                        tidx: int, rq: int, t: float):
        """INVOKE_FAIL detected: a failed invoke API call (``rq == -1``,
        logged at dispatch) or a dropped GET/PUT (``rq >= 0``). Schedule the
        retry, or fail the query when the budget is exhausted."""
        task = stage.tasks[tidx]
        if run.failed:
            self._abandon_req(ctx, run, stage, tidx, rq, t)
            return
        if rq >= 0:
            req = task.io.reqs[rq]
            req.tries += 1
            kind = "put" if req.put else "get"
            self._log(t, "INVOKE_FAIL", run, stage, tidx, rq, reason=kind,
                      tries=req.tries, attempt=task.attempt)
            run.attr["retry_s"] = run.attr.get("retry_s", 0.0) + \
                (t - req.issue_t)
            if req.tries >= self.retry.max_attempts:
                self._fail_run(ctx, run, stage, tidx, t, kind)
                self._abandon_req(ctx, run, stage, tidx, rq, t)
                return
            back = self.retry.backoff_s(req.tries)
            run.attr["retry_s"] = run.attr.get("retry_s", 0.0) + back
            self._push_req(ctx, t + back, _RETRY, run, stage, tidx, rq)
            return
        # rq == -1: the invoke API call itself failed (detected now)
        if task.failures >= self.retry.max_attempts:
            self._fail_run(ctx, run, stage, tidx, t, "invoke")
            return
        back = self.retry.backoff_s(task.failures)
        run.attr["retry_s"] = run.attr.get("retry_s", 0.0) + back
        ctx.events.push(t + back, _RETRY, run.ridx, stage.sidx, tidx, -1)

    def _on_retry(self, ctx: _Ctx, run: _Run, stage: _Stage, tidx: int,
                  rq: int, t: float):
        """RETRY_FIRE: the backoff elapsed — re-issue the failed unit of
        work (one request, or a whole task attempt)."""
        if run.failed:
            self._abandon_req(ctx, run, stage, tidx, rq, t)
            return
        task = stage.tasks[tidx]
        run.retries += 1
        if rq >= 0:
            # retry one request on its existing lane; each extra try is a
            # billed store request
            req = task.io.reqs[rq]
            self._log(t, "RETRY_FIRE", run, stage, tidx, rq,
                      kind="put" if req.put else "get", tries=req.tries)
            if req.put:
                run.puts += 1
                self._on_put_issue(ctx, run, stage, tidx, rq, t)
            else:
                run.gets += 1
                self._on_get_issue(ctx, run, stage, tidx, rq, t)
            return
        # whole-task re-dispatch (failed invoke, or worker-loss replay)
        self._log(t, "RETRY_FIRE", run, stage, tidx, -1,
                  reason=task.retry_reason, attempt=task.attempt + 1)
        task.attempt += 1
        if not ctx.slots or self._quota_blocked(run):
            self._queue_task(ctx, run, stage.sidx, tidx)
            return
        t_claim, free_t, sid, virgin = self._claim_slot(ctx, t)
        self._note_claim(run, stage, tidx, t_claim, sid)
        self._dispatch(ctx, run, stage, tidx, t_claim, free_t, sid, virgin)

    def _abandon_req(self, ctx: _Ctx, run: _Run, stage: _Stage, tidx: int,
                     rq: int, t: float):
        """A failed query abandons a request mid-retry: complete it now so
        the holding task's timeline drains and its slot is released."""
        if rq < 0:
            return                  # invoke-level: the slot was never held
        io = stage.tasks[tidx].io
        if io is None or io.reqs[rq].done:
            return
        io.reqs[rq].end = t
        self._on_req_done(ctx, run, stage, tidx, rq, t,
                          is_put=io.reqs[rq].put)

    def _fail_run(self, ctx: _Ctx, run: _Run, stage: _Stage, tidx: int,
                  t: float, reason: str):
        """A retry budget is exhausted: fail the query (§3). In-flight
        timelines drain (parked reads are woken so their tasks complete and
        release slots), no new stage dispatches, and closed-loop dependents
        still activate — a failed query's client re-submits, it does not
        wedge the stream."""
        if run.failed:
            return
        run.failed = True
        run.fail_reason = reason
        run.finish_t = t
        self._log(t, "QUERY_FAIL", run, stage, tidx, -1, reason=reason,
                  failures=stage.tasks[tidx].failures)
        for src in list(run.waiters):
            for (csidx, ctidx, rq, lane_t) in run.waiters.pop(src, []):
                self._io_place_get(ctx, run, run.stages[csidx], ctidx, rq,
                                   max(lane_t, t))
        for di, think in ctx.deps_map.get(run.ridx, ()):
            self._arrive(ctx, ctx.runs[di], run.finish_t + think)
        self._query_finished(ctx, run, t)
        if self.observers:
            self._notify(t, "QUERY_DONE", run, "", -1,
                         finish=run.finish_t, failed=True, reason=reason)

    # ------------------------------------------------------- completions
    def _finish_stage(self, run: _Run, stage: _Stage):
        name = stage.st["name"]
        run.stage_windows[name] = (min(tk.start for tk in stage.tasks),
                                   max(tk.end for tk in stage.tasks))
        if self.observers:
            self._notify(max(tk.end for tk in stage.tasks), "STAGE_END",
                         run, name, -1,
                         start=min(tk.start for tk in stage.tasks))
        if stage.st is run.plan["stages"][-1]:
            run.finish_t = max(tk.end for tk in stage.tasks)

    def _check_consumers(self, run: _Run, producer: str, events,
                         now: float):
        """Push STAGE_READY for consumers whose pipelining quota (§4.4) is
        now met by every dependency."""
        if run.failed:
            return              # §3: no new stages for a failed query
        frac = self.policy.pipeline_fraction if self.policy.pipelining \
            else 1.0
        for cons in run.consumers_of(producer):
            if cons.ready_pushed:
                continue
            ready, ok = run.t0, True
            for dep in cons.st["deps"]:
                d = run.by_name[dep]
                k = min(math.ceil(frac * d.n), d.n)
                # real data: every dep task must at least be dispatched
                if d.done < max(k, 1) or d.undispatched > 0:
                    ok = False
                    break
                done_ends = sorted(tk.end for tk in d.tasks if tk.done)
                ready = max(ready, done_ends[k - 1])
            if ok:
                cons.ready_pushed = True
                events.push(max(ready, now), _READY, run.ridx,
                            cons.sidx, 0, -1)

    def _finish(self, run: _Run) -> QueryResult:
        cost = QueryCost(run.task_seconds * WORKER_MEM_GB, run.invocations,
                         run.gets, run.puts)
        # arrival_t == t0 except for admission-queued runs, where the
        # admission wait lands in latency AND queue delay (the client
        # submitted at arrival_t, the engine started the run at t0)
        queue_delay = 0.0 if math.isinf(run.first_start) \
            else max(0.0, run.first_start - run.arrival_t)
        return QueryResult(
            run.display_name, run.finish_t - run.arrival_t,
            run.final_result, cost,
            run.invocations - run.backups, run.backups,
            {k: (round(a - run.t0, 3), round(b - run.t0, 3))
             for k, (a, b) in run.stage_windows.items()},
            run.task_seconds, run.arrival_t, queue_delay,
            run.backup_slot_s,
            run.dup_gets, run.dup_puts, run.poll_gets, run.columns_read,
            {"queue_s": queue_delay, **run.attr}, run.name,
            failed=run.failed, fail_reason=run.fail_reason,
            retries=run.retries, cold_starts=run.cold_starts,
            tenant=run.tenant.name if run.tenant is not None else "",
            rejected=run.rejected)

    # ------------------------------------------------- calibration hooks
    def event_summary(self, query: str | None = None) -> dict:
        """Aggregate the request-level event log for planner calibration
        (§4.3): per-request GET/PUT latency samples and per-(query, stage)
        I/O profiles. ``query`` restricts the aggregation to one run's
        (namespaced) name, so a probe on a shared coordinator never mixes
        another query's requests into its fits. Returns empty collections
        when events were not recorded (``record_events=False``) — the
        planner then falls back to the analytic latency-model constants.

        Profile keys per (query, stage): ``tasks`` (observed task count),
        ``gets``/``puts`` (effective completions), ``get_bytes``/
        ``put_bytes`` (modeled request sizes), ``out_bytes`` (primary PUT
        payloads, doublewrite twins excluded), ``get_s``/``put_s``
        (issue->completion seconds), ``compute_s``, ``polls``,
        ``dup_gets``/``dup_puts``, ``retries``/``invoke_fails``/
        ``cold_starts`` (§3 fault-path counters), and ``task_durs``
        (per-task first-event -> last-event spans, the straggler-spread
        input).

        §3 fault aggregates (zero with no injector): ``invoke_fails``/
        ``worker_losses``/``get_fails``/``put_fails`` (INVOKE_FAIL events
        by reason), ``retries`` (RETRY_FIRE count), ``task_retries``
        (task-level re-dispatches only), ``retry_reasons`` (reason ->
        count), ``request_tries`` (try index -> issue count — per-attempt
        counts for calibration), ``cold_starts``/``cold_s`` (COLD_START
        count and summed extra), ``query_fails``.

        ``dropped_events`` reports how many log appends the ``max_events``
        cap swallowed — nonzero means the samples here are a prefix of the
        run, so fits from them cover only the run's start.
        """
        gets: list[tuple[int, float]] = []
        puts: list[tuple[int, float]] = []
        get_issues = put_issues = dup_gets = dup_puts = polls = 0
        invoke_fails = worker_losses = get_fails = put_fails = 0
        retries = task_retries = cold_starts = query_fails = 0
        cold_s = 0.0
        retry_reasons: dict[str, int] = {}
        request_tries: dict[int, int] = {}
        stages: dict[tuple[str, str], dict] = {}
        windows: dict[tuple[str, str, int], list[float]] = {}
        for (t, kind, q, s, tidx, rq, info) in self.event_log or ():
            if query is not None and q != query:
                continue
            st = stages.setdefault((q, s), {
                "gets": 0, "get_bytes": 0, "get_s": 0.0, "puts": 0,
                "put_bytes": 0, "put_s": 0.0, "out_bytes": 0,
                "compute_s": 0.0, "polls": 0, "dup_gets": 0, "dup_puts": 0,
                "retries": 0, "invoke_fails": 0, "cold_starts": 0,
                "tasks": 0})
            if tidx >= 0:
                w = windows.setdefault((q, s, tidx), [t, t])
                w[0], w[1] = min(w[0], t), max(w[1], t)
            if kind == "GET_DONE":
                gets.append((info["nbytes"], info["dur"]))
                st["gets"] += 1
                st["get_bytes"] += info["nbytes"]
                st["get_s"] += info["dur"]
            elif kind == "PUT_DONE":
                puts.append((info["nbytes"], info["dur"]))
                st["puts"] += 1
                st["put_bytes"] += info["nbytes"]
                st["put_s"] += info["dur"]
                if not info["key"].endswith(".dw"):
                    st["out_bytes"] += info["nbytes"]
            elif kind == "COMPUTE":
                st["compute_s"] += info["seconds"]
            elif kind == "GET_ISSUE":
                get_issues += 1
                tries = info.get("tries", 0)
                request_tries[tries] = request_tries.get(tries, 0) + 1
            elif kind == "PUT_ISSUE":
                put_issues += 1
                tries = info.get("tries", 0)
                request_tries[tries] = request_tries.get(tries, 0) + 1
            elif kind == "VISIBLE_AT":
                st["polls"] += info["polls"]
                polls += info["polls"]
            elif kind == "DUP_FIRE":
                if info["kind"] == "get":
                    st["dup_gets"] += 1
                    dup_gets += 1
                else:
                    st["dup_puts"] += 1
                    dup_puts += 1
            elif kind == "INVOKE_FAIL":
                st["invoke_fails"] += 1
                reason = info["reason"]
                if reason == "invoke":
                    invoke_fails += 1
                elif reason == "worker_loss":
                    worker_losses += 1
                elif reason == "get":
                    get_fails += 1
                else:
                    put_fails += 1
            elif kind == "RETRY_FIRE":
                st["retries"] += 1
                retries += 1
                reason = info.get("reason") or info.get("kind", "")
                retry_reasons[reason] = retry_reasons.get(reason, 0) + 1
                if rq < 0:
                    task_retries += 1
            elif kind == "COLD_START":
                st["cold_starts"] += 1
                cold_starts += 1
                cold_s += info["extra_s"]
            elif kind == "QUERY_FAIL":
                query_fails += 1
        for (q, s, tidx), (lo, hi) in windows.items():
            prof = stages[(q, s)]
            prof["tasks"] += 1
            prof.setdefault("task_durs", []).append(hi - lo)
        return {"get_samples": gets, "put_samples": puts,
                "get_issues": get_issues, "put_issues": put_issues,
                "dup_gets": dup_gets, "dup_puts": dup_puts, "polls": polls,
                "invoke_fails": invoke_fails,
                "worker_losses": worker_losses,
                "get_fails": get_fails, "put_fails": put_fails,
                "retries": retries, "task_retries": task_retries,
                "retry_reasons": retry_reasons,
                "request_tries": request_tries,
                "cold_starts": cold_starts, "cold_s": cold_s,
                "query_fails": query_fails, "stages": stages,
                "dropped_events": self.dropped_events}

    # ---------------------------------------------------------- task build
    def _build_task(self, run: _Run, st, ti, w: Worker, start):
        """Bind a task's inputs NOW (event thread, deterministic state) and
        return a zero-arg callable for the executor."""
        query = run.name
        kind = st["kind"]
        base_reader = self._base_reader(w)
        plan = run.plan
        if kind == "scan":
            n_out = self._consumer_tasks(plan, st)
            run.nparts[st["name"]] = n_out
            split = self.base_splits[st["table"]][
                ti % len(self.base_splits[st["table"]])]
            return lambda: w.run_scan(query, st, ti, split, 0.0, start,
                                      n_out, base_reader)
        if kind == "join":
            n_out = self._consumer_tasks(plan, st)
            run.nparts[st["name"]] = n_out
            left = self._side_inputs(run, st, "left", ti)
            right = self._side_inputs(run, st, "right", ti)
            return lambda: w.run_join(query, st, ti, left, right, start,
                                      n_out, base_reader)
        if kind == "combine":
            spec = st["assign"][ti]
            src = st["source"]
            inputs = [PartInput(run.keys[src][fi], 0.0,
                                run.nparts[src], spec["partitions"][0],
                                spec["partitions"][1] - 1, src=(src, fi),
                                n_cols=run.outcols[src][fi])
                      for fi in range(*spec["files"])]
            return lambda: w.run_combine(query, st, ti, inputs, start)
        if kind == "final_agg":
            dep = st["deps"][0]
            inputs = [(k, 0.0, (dep, fi))
                      for fi, k in enumerate(run.keys[dep])]
            return lambda: w.run_final(query, st, inputs, start)
        raise ValueError(kind)

    def _side_inputs(self, run: _Run, st, side: str, ti) -> list[PartInput]:
        """Which objects + partition ranges feed join task ti from the
        ``side`` role ("left" | "right").

        Single-stage: every producer object, partition ti (2sr reads total).
        Multi-stage: only the combiners covering partition ti (the 1/f
        file-splits of the one partition-run holding ti — 2r/f reads
        total). Regression note: this used to look the combiner stage up
        under the producer's *stage name* instead of its side role, so
        joins silently re-read the producers and multi-stage shuffles
        never saved a request.
        """
        comb = combine_name(st["name"], side)
        src = st[side]
        rc = (st.get("_read_cols") or {}).get(side)
        if comb in run.keys:                   # combined side
            cst = stage_by_name(run.plan, comb)
            out = []
            for ci, spec in enumerate(cst["assign"]):
                lo, hi = spec["partitions"]
                if lo <= ti < hi:
                    out.append(PartInput(run.keys[comb][ci], 0.0,
                                         hi - lo, ti - lo, ti - lo,
                                         src=(comb, ci),
                                         n_cols=run.outcols[comb][ci],
                                         read_cols=rc))
            return out
        return [PartInput(k, 0.0, run.nparts[src], ti, ti, src=(src, fi),
                          n_cols=run.outcols[src][fi], read_cols=rc)
                for fi, k in enumerate(run.keys[src])]
