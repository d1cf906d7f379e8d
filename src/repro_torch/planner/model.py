"""Analytic latency/cost predictor (§4.3, Fig 14) over plan configurations.

:class:`QueryModel` predicts ``latency_s`` and ``cost.total`` for ANY
per-stage ``ntasks`` / ``parallel_reads`` / shuffle-strategy / mitigation
assignment (:class:`PlanConfig`) without running the simulator.

Inputs: one plan builder (a name in ``relational.tpch.QUERIES`` or any
callable ``(ntasks, **plan_kw) -> plan dict``), a probe
:class:`~repro_torch.planner.calibrate.Calibration` (per-request latencies),
and the probe's per-stage byte/compute profiles from
``Coordinator.event_summary()``. Output: a :class:`Prediction` —
``latency_s``, a ``core.cost.QueryCost``, and per-stage spans.

The request *counts* are structural — they mirror the worker's exact
read/write pattern (§3.2: header + body range-GETs per producer object,
one partitioned PUT plus the doublewrite twin) — while the per-stage data
volumes / compute seconds come from the probe (they are invariant under
re-partitioning: the same rows flow through the stage regardless of the
task count). Multi-stage shuffles (§4.2) are modeled from the SAME plan
expansion the coordinator schedules (``core.plan.expand_combiners``):
with (p, f) clamped to (a, b) = (partition-splits, file-splits), each
side's combiner stage runs ``a*b`` tasks that issue ``2*a*s`` GETs
(header + body per covered file) and one combined partitioned PUT each,
and every join task then reads ``b`` combined objects per side instead of
``s`` producer objects — the paper's request-wall escape. See
``docs/ARCHITECTURE.md`` for the full derivation.

The latency model composes, per stage: invocation overhead, read batches
scheduled in waves over ``parallel_reads`` lanes (NIC aggregate cap past
the Fig-3 saturation point), compute scaled 1/T, the output PUT
(``out_bytes_floor`` respected), a straggler order-statistic pad that
grows ~sqrt(2 ln T) with the task count, and §4.3 slot-queueing waves
when T exceeds the invocation limit. Stage spans chain along plan
dependencies (pipelining overlap is deliberately ignored — the model
ranks candidates; the simulator confirms frontier points).

Dollar cost is emitted as a ``core.cost.QueryCost`` with *expected*
(fractional) request counts, so the model can never disagree with the
repo's closed-form pricing: ``Prediction.cost.total`` IS the closed form
evaluated at the predicted counts.

Determinism guarantee: ``predict`` is a pure function of the calibration,
the probe profiles, and the plan structure — no RNG, no wall clock — so
the same probe always yields bit-identical predictions at any executor
width.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.cost import WORKER_MEM_GB, QueryCost
from repro_torch.core.format import header_size
from repro_torch.core.plan import (combine_name, expand_combiners, infer_pushdown,
                             resolved_tasks, stage_by_name)
from repro_torch.core.stragglers import StragglerConfig
from repro_torch.planner.calibrate import Calibration, calibrate
from repro_torch.relational.table import object_meta
from repro_torch.relational.tpch import QUERIES


def _norm_shuffle(sh) -> tuple | None:
    """Canonical hashable shuffle spec: ``None`` (keep the builder's
    default), ``("single",)``, or ``("multi", a, b)`` with integer
    partition-/file-splits a = round(1/p), b = round(1/f)."""
    if sh is None:
        return None
    if isinstance(sh, str):
        sh = {"strategy": sh}
    if isinstance(sh, dict):
        if sh.get("strategy", "single") != "multi":
            return ("single",)
        # defaults mirror core.plan.expand_combiners (p = f = 1/4)
        a = max(1, int(round(1.0 / sh.get("p", 1 / 4))))
        b = max(1, int(round(1.0 / sh.get("f", 1 / 4))))
        return ("multi", a, b)
    t = tuple(sh)
    if t[0] == "single":
        return ("single",)
    return ("multi", int(t[1]), int(t[2]))


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """One point of the planner's search space: per-stage degree of
    parallelism (the plan builder's ``ntasks`` keys) + the per-task read
    lane count + the §4.2 shuffle strategy with its (p, f) split + the
    §5/§3.3.1 mitigation assignment. Frozen and hashable so search results
    dedup and cache by config."""
    ntasks: tuple[tuple[str, int], ...] = ()
    parallel_reads: int = 16
    rsm: bool = True
    wsm: bool = True
    backup_tasks: bool = True
    doublewrite: bool = True
    # None = builder default; ("single",) | ("multi", a, b) with a = 1/p
    # partition-splits and b = 1/f file-splits (see _norm_shuffle)
    shuffle: tuple | None = None
    # §3.2 columnar projection/zone-map pushdown: reads cost one extra
    # header GET per scan split but fetch only the covering column range
    # (GETs are priced per request, transfer is free — so pushdown trades
    # dollars for latency and is a genuine Pareto axis)
    pushdown: bool = True
    # §3 retry budget (faults.RetryPolicy.max_attempts): attempts allowed
    # per task/request before the QUERY fails and the client re-runs it
    # whole. Small budgets are cheap per run but pay the expected-rerun
    # multiplier under injected faults; the model prices both sides, so
    # this is a searchable axis (SCALAR_AXES)
    retry_budget: int = 4

    @staticmethod
    def make(ntasks: dict | None = None, **kw) -> "PlanConfig":
        if "shuffle" in kw:
            kw["shuffle"] = _norm_shuffle(kw["shuffle"])
        return PlanConfig(tuple(sorted((ntasks or {}).items())), **kw)

    @property
    def ntasks_dict(self) -> dict:
        return dict(self.ntasks)

    @property
    def shuffle_dict(self) -> dict | None:
        """The plan-builder ``shuffle=`` kwarg realising this config."""
        if self.shuffle is None:
            return None
        if self.shuffle[0] == "single":
            return {"strategy": "single"}
        _, a, b = self.shuffle
        return {"strategy": "multi", "p": 1.0 / a, "f": 1.0 / b}

    def plan_kwargs(self, base: dict | None = None) -> dict:
        """``base`` plan_kw with this config's shuffle override merged in
        — what :class:`QueryModel` and ``QueryEvaluator`` hand the plan
        builder (builders without a ``shuffle`` option fail loudly)."""
        kw = dict(base or {})
        if self.shuffle is not None:
            kw["shuffle"] = self.shuffle_dict
        return kw

    def replace(self, **kw) -> "PlanConfig":
        if "ntasks" in kw and isinstance(kw["ntasks"], dict):
            kw["ntasks"] = tuple(sorted(kw["ntasks"].items()))
        if "shuffle" in kw:
            kw["shuffle"] = _norm_shuffle(kw["shuffle"])
        return dataclasses.replace(self, **kw)

    def policy(self, base: StragglerConfig) -> StragglerConfig:
        """The coordinator StragglerConfig realising this assignment."""
        return dataclasses.replace(
            base, parallel_reads=self.parallel_reads,
            rsm=dataclasses.replace(base.rsm, enabled=self.rsm),
            wsm=dataclasses.replace(base.wsm, enabled=self.wsm),
            backup_tasks=self.backup_tasks, doublewrite=self.doublewrite)


def coerce_config(tuning=None, plan_kw: dict | None = None
                  ) -> tuple[PlanConfig, dict]:
    """THE canonical tuning normalizer: every accepted tuning form becomes
    one ``(PlanConfig, plan_kwargs)`` pair at the API boundary.

    ``tuning`` may be

      * ``None`` — builder defaults;
      * a :class:`PlanConfig` (or anything duck-typing ``ntasks_dict`` /
        ``plan_kwargs``) — the planner's native form;
      * a plain per-stage ntasks dict (e.g. ``{"join": 16}``);
      * the explicit two-part form ``{"ntasks": ..., "plan_kw": ...}``.

    ``plan_kw`` is extra builder kwargs from the call site; a searched
    shuffle pick on the config overrides any ``shuffle`` in it (via
    ``PlanConfig.plan_kwargs``). ``engine.build_plan``, ``workload.mix
    .retune`` and ``core.session.QuerySpec`` all route through here, so
    the dict forms are exactly equivalent to the config form everywhere.
    """
    base = dict(plan_kw or {})
    if tuning is None:
        cfg = PlanConfig()
    elif hasattr(tuning, "ntasks_dict") and hasattr(tuning, "plan_kwargs"):
        cfg = tuning
    elif isinstance(tuning, dict) and ("ntasks" in tuning
                                       or "plan_kw" in tuning):
        extra = set(tuning) - {"ntasks", "plan_kw"}
        if extra:
            raise ValueError(
                f"two-part tuning dict has unknown keys {sorted(extra)}; "
                "expected only 'ntasks' / 'plan_kw'")
        base = {**dict(tuning.get("plan_kw") or {}), **base}
        cfg = PlanConfig.make(dict(tuning.get("ntasks") or {}))
    elif isinstance(tuning, dict):
        cfg = PlanConfig.make(tuning)
    else:
        raise TypeError(f"cannot coerce {type(tuning).__name__!r} into a "
                        "PlanConfig (want PlanConfig | ntasks dict | "
                        "{'ntasks', 'plan_kw'} | None)")
    return cfg, cfg.plan_kwargs(base)


@dataclasses.dataclass(frozen=True)
class Prediction:
    latency_s: float
    cost: QueryCost          # expected counts -> closed-form dollars
    stages: tuple            # (name, tasks, span_s) per stage

    @property
    def cost_usd(self) -> float:
        return self.cost.total


class QueryModel:
    """Predicts (latency, cost) for one query's plan configurations."""

    def __init__(self, query, calibration: Calibration, profiles: dict,
                 split_bytes: dict, *, max_parallel: int = 1000,
                 plan_kw: dict | None = None, latency_bias: float = 1.0,
                 base_meta: dict | None = None):
        # ``query`` is a name in relational.tpch.QUERIES or any plan
        # builder callable (ntasks, **plan_kw) -> plan dict
        self.builder = QUERIES[query] if isinstance(query, str) else query
        self.query = query if isinstance(query, str) else \
            getattr(query, "__name__", "custom")
        self.calib = calibration
        self.profiles = profiles          # stage name -> probe profile
        self.split_bytes = split_bytes    # table -> [split sizes]
        self.max_parallel = max(max_parallel, 1)
        self.plan_kw = dict(plan_kw or {})
        # table -> [per-split object_meta dicts] (columns, kinds, col_bytes,
        # zone maps). Present when the probe harvested columnar base splits;
        # enables EXACT projected-scan byte pricing. Without it, scans are
        # priced as 1 whole-object GET (the pushdown-off read pattern).
        self.base_meta = dict(base_meta or {})
        # probe-anchored multiplicative correction: the analytic model is
        # built to RANK configs; anchoring it to the one measured run puts
        # predicted latencies on the simulator's absolute scale too
        self.latency_bias = latency_bias

    # ------------------------------------------------------------- probe
    @classmethod
    def from_probe(cls, coord, query, ntasks: dict | None = None, *,
                   plan_kw: dict | None = None):
        """Run one cheap probe of ``query`` on ``coord`` (which must record
        events), calibrate from its event log, and return
        ``(model, probe_result)``. §4.3: one measured run prices the whole
        configuration space."""
        builder = QUERIES[query] if isinstance(query, str) else query
        plan = builder(ntasks, **(plan_kw or {}))
        res = coord.run_query(plan)
        # the coordinator namespaces re-runs of the same plan name
        # (QueryResult.store_name); both the fits and the profiles
        # aggregate THIS run's rows only
        summary = coord.event_summary(query=res.store_name)
        profiles = {s: prof for (_q, s), prof in summary["stages"].items()}
        if coord.event_log is not None and not profiles:
            raise ValueError(
                f"probe run {res.store_name!r} left no rows in the event "
                "log — cannot profile stages")
        calib = calibrate(summary, probe_rsm=coord.policy.rsm.enabled,
                          probe_wsm=coord.policy.wsm.enabled)
        split_bytes = {t: [coord.store.size(k) for k in ks]
                       for t, ks in coord.base_splits.items()}
        base_meta = {}
        for t, ks in coord.base_splits.items():
            metas = [object_meta(coord.store.get(k), key=k) for k in ks]
            if metas and all(m is not None for m in metas):
                base_meta[t] = metas
        model = cls(query, calib, profiles, split_bytes,
                    max_parallel=coord.max_parallel, plan_kw=plan_kw,
                    base_meta=base_meta)
        probe_cfg = PlanConfig.make(
            ntasks, parallel_reads=coord.policy.parallel_reads,
            rsm=coord.policy.rsm.enabled, wsm=coord.policy.wsm.enabled,
            backup_tasks=coord.policy.backup_tasks,
            doublewrite=coord.policy.doublewrite,
            retry_budget=coord.retry.max_attempts)
        try:
            raw = model.predict(probe_cfg).latency_s
            model.latency_bias = min(max(res.latency_s / raw, 0.2), 5.0) \
                if raw > 0 else 1.0
        except ValueError:
            pass          # un-modeled plan shape (multi-stage shuffle)
        return model, res

    # ----------------------------------------------------------- helpers
    @property
    def _split_counts(self) -> dict:
        return {t: len(b) for t, b in self.split_bytes.items()}

    def _batch_s(self, n_req: int, nbytes: float, lanes: int,
                 tail_s: float) -> float:
        """One barriered read batch: n requests over `lanes` lanes, served
        in waves; active lanes share the NIC aggregate read cap (the
        per-request composition is the calibration's ``expected_s``)."""
        if n_req <= 0:
            return 0.0
        conc = min(n_req, max(lanes, 1))
        per = self.calib.get.expected_s(nbytes, conc, tail_s=tail_s)
        return math.ceil(n_req / max(lanes, 1)) * per

    @staticmethod
    def _broadcast_gets(st: dict, split_bytes: dict) -> int:
        return sum(len(split_bytes[op["table"]])
                   for op in st.get("ops", [])
                   if op["op"] == "broadcast_join")

    def _base_schemas(self) -> dict:
        """table -> {column: kind} in storage order, from harvested split
        headers — the infer_pushdown input (same pass the coordinator runs,
        so model and simulator agree on every read's column set)."""
        return {t: {n: m[0]["kinds"][n] for n in m[0]["columns"]}
                for t, m in self.base_meta.items()}

    @staticmethod
    def _covering_bytes(meta: dict, read_cols, bounds) -> float:
        """Exact §3.2 body-GET size of one split under pushdown: zero when
        the split's zone maps prune it, else the contiguous covering range
        over the projected columns (interior unneeded columns included —
        the two-range-GET contract allows ONE body range)."""
        idx = {n: i for i, n in enumerate(meta["columns"])}
        sel = sorted(idx[n] for n in read_cols if n in idx)
        if not sel:
            return 0.0
        for n, b in (bounds or {}).items():
            if n in idx:
                slo, shi = meta["stats"][n]
                if shi < b[0] or slo > b[1]:
                    return 0.0
        names = meta["columns"]
        return float(sum(meta["col_bytes"][names[i]]
                         for i in range(sel[0], sel[-1] + 1)))

    def _sigma_rel(self, prof: dict) -> float:
        durs = prof.get("task_durs", [])
        if len(durs) < 2:
            return 0.0
        mean = sum(durs) / len(durs)
        if mean <= 0:
            return 0.0
        var = sum((d - mean) ** 2 for d in durs) / len(durs)
        return min(math.sqrt(var) / mean, 1.0)

    # ----------------------------------------------------------- predict
    def predict(self, config: PlanConfig) -> Prediction:
        """Latency + expected cost of ``config``; pure function of the
        calibration, the probe profiles, and the plan structure."""
        plan = self.builder(config.ntasks_dict or None,
                            **config.plan_kwargs(self.plan_kw))
        # splice in §4.2 combiner stages exactly as the coordinator will
        # schedule them — the structural counts below read the very same
        # (p, f) work assignment the simulator executes, and task counts
        # resolve through the same shared core.plan helpers
        plan = expand_combiners(plan, plan.get("name", self.query),
                                self._split_counts)
        # annotate the model's private copy with the SAME pushdown pass the
        # coordinator runs: _read_cols/_read_bounds price scan bytes, and
        # _out_ncols sizes every header GET (header_size grows with
        # n_partitions x n_columns). Annotations are computed even when
        # config.pushdown is off — producers write all columns either way,
        # so header sizes do not depend on the pushdown setting.
        schemas = self._base_schemas()
        if schemas:
            infer_pushdown(plan, schemas)
        pushdown = config.pushdown
        ntasks = resolved_tasks(plan, self._split_counts)
        calib = self.calib
        lanes = max(config.parallel_reads, 1)
        get_tail = calib.get_tail_s(config.rsm)
        put_tail = calib.put_tail_s(config.wsm)
        dup_get = calib.dup_get_rate if config.rsm else 0.0
        dup_put = calib.dup_put_rate if config.wsm else 0.0
        n_put_keys = 2 if config.doublewrite else 1

        # §3 fault pricing (every term vanishes at zero fitted rates, so a
        # fault-free probe prices bit-identically to the pre-fault model).
        # p_att = P(one task attempt is wasted); a budget of k attempts
        # yields E[attempts] = (1 - p^k)/(1 - p) (truncated geometric) and
        # P(task fails outright) = p^k — the whole query then re-runs.
        k = max(int(config.retry_budget), 1)
        p_att = min(calib.invoke_fail_rate + calib.worker_loss_rate, 0.95)
        e_att = (1.0 - p_att ** k) / (1.0 - p_att) if p_att > 0.0 else 1.0
        get_retry = 1.0 / (1.0 - min(calib.get_fail_rate, 0.9)) \
            if calib.get_fail_rate > 0.0 else 1.0
        put_retry = 1.0 / (1.0 - min(calib.put_fail_rate, 0.9)) \
            if calib.put_fail_rate > 0.0 else 1.0
        # a lost worker re-runs (and re-bills) its whole timeline
        work_mult = 1.0 + calib.worker_loss_rate * e_att \
            if calib.worker_loss_rate > 0.0 else 1.0

        finish: dict[str, float] = {}
        spans = []
        gets = puts = 0.0
        invocations = 0
        task_seconds = 0.0
        for st in plan["stages"]:
            name, kind = st["name"], st["kind"]
            T = ntasks[name]
            prof = self.profiles.get(name, {})
            out_total = prof.get("out_bytes", 0)
            io_s = 0.0
            n_reads = 0          # store reads per task (timeline-visible)
            if kind == "scan":
                sizes = self.split_bytes[st["table"]]
                metas = self.base_meta.get(st["table"])
                rc = st.get("_read_cols")
                if pushdown and metas and rc is not None \
                        and st.get("_n_base_cols"):
                    # header GET + covering body GET per split; the body is
                    # priced exactly from the harvested per-split column
                    # byte counts and zone maps (pruned split -> 0 bytes,
                    # its GET is still issued — structural parity)
                    bodies = [self._covering_bytes(
                        m, rc, st.get("_read_bounds")) for m in metas]
                    io_s = self._batch_s(
                        1, header_size(1, st["_n_base_cols"]), lanes,
                        get_tail)
                    io_s += self._batch_s(1, sum(bodies) / len(bodies),
                                          lanes, get_tail)
                    n_reads = 2
                else:
                    # pushdown off (or plain-blob splits): one whole-object
                    # GET, all bytes
                    io_s = self._batch_s(1, sum(sizes) / len(sizes), lanes,
                                         get_tail)
                    n_reads = 1
            elif kind == "combine":
                # §4.2 combiner: T = a*b tasks; the stage as a whole reads
                # every producer file a times (one header + one body range
                # per covered file => 2*a*s GETs), moving ALL the source's
                # bytes exactly once; each task writes one combined
                # partitioned object. Counts come from the expansion's own
                # work assignment, so remainders are exact.
                src = st["source"]
                src_bytes = self.profiles.get(src, {}).get("out_bytes", 0)
                file_reads = sum(sp["files"][1] - sp["files"][0]
                                 for sp in st["assign"])
                per_task = file_reads / T          # ~s/b files per combiner
                # combine output columns == source columns (_out_ncols)
                io_s = self._batch_s(per_task,
                                     header_size(st["source_parts"],
                                                 st.get("_out_ncols", 1)),
                                     lanes, get_tail)
                io_s += self._batch_s(per_task,
                                      src_bytes / max(file_reads, 1),
                                      lanes, get_tail)
                n_reads = 2.0 * per_task
                if not out_total:
                    # probes normally run single-stage, so there is no
                    # combiner profile — structurally, every source byte
                    # passes through the combiners
                    out_total = src_bytes
            elif kind == "join":
                combined = [side for side in ("left", "right")
                            if combine_name(st["name"], side) in ntasks]
                if not combined:      # single-stage: read every producer
                    s_l, s_r = ntasks[st["left"]], ntasks[st["right"]]
                    n_src = s_l + s_r
                    body_total = (self.profiles.get(st["left"], {})
                                  .get("out_bytes", 0)
                                  + self.profiles.get(st["right"], {})
                                  .get("out_bytes", 0))
                    # per-side header sizes (each side's producer writes
                    # its own column count), blended over the read batch
                    hdr = sum(
                        ntasks[st[side]] * header_size(
                            T, stage_by_name(plan, st[side])
                            .get("_out_ncols", 1))
                        for side in ("left", "right")) / n_src
                    io_s = self._batch_s(n_src, hdr, lanes, get_tail)
                    io_s += self._batch_s(n_src, body_total / (T * n_src),
                                          lanes, get_tail)
                    n_reads = 2 * n_src
                else:                 # §4.2: read b combined objects/side
                    n_reads = 0.0
                    for side in ("left", "right"):
                        cst = stage_by_name(plan,
                                            combine_name(st["name"], side))
                        a, b = cst["splits"]
                        side_bytes = self.profiles.get(st[side], {}) \
                            .get("out_bytes", 0)
                        # a combined object holds one partition run of
                        # ceil(T/a) partitions; its header scales with that
                        # times the side's column count
                        io_s += self._batch_s(
                            b, header_size(math.ceil(T / a),
                                           cst.get("_out_ncols", 1)),
                            lanes, get_tail)
                        io_s += self._batch_s(b, side_bytes / (T * b),
                                              lanes, get_tail)
                        n_reads += 2 * b
            elif kind == "final_agg":
                dep = st["deps"][0]
                s_d = ntasks[dep]
                dep_bytes = self.profiles.get(dep, {}).get("out_bytes", 0)
                io_s = self._batch_s(s_d, dep_bytes / s_d, lanes, get_tail)
                n_reads = s_d
            else:
                raise ValueError(
                    f"stage kind {kind!r} is not analytically modeled — "
                    "confirm such configs with the simulator evaluator "
                    "(planner.QueryEvaluator) instead; the modeled plan "
                    "shapes (scan / join / combine / final_agg) are "
                    "documented in docs/ARCHITECTURE.md, 'The planner "
                    "pipeline'")
            compute_s = prof.get("compute_s", 0.0) / T
            out_per_task = out_total / T
            floor = st.get("out_bytes_floor") or 0
            billed_out = max(out_per_task, floor)
            put_s = calib.put.expected_s(billed_out, tail_s=put_tail)
            span_io = io_s + compute_s + put_s
            # straggler order statistic: the stage ends at its slowest task
            pad = self._sigma_rel(prof) * span_io \
                * math.sqrt(2.0 * math.log(T)) if T >= 2 else 0.0
            slot_waves = math.ceil(T / self.max_parallel)
            span = calib.invoke_overhead_s + slot_waves * (span_io + pad)
            if p_att > 0.0:
                # the stage's critical path pays ~one extra attempt span
                # whenever ANY of its T tasks retries
                span += (1.0 - (1.0 - p_att) ** T) \
                    * (span_io + calib.retry_backoff_s)
            if calib.cold_rate > 0.0:
                span += calib.cold_rate * calib.cold_overhead_s
            ready = max((finish[d] for d in st["deps"]), default=0.0)
            finish[name] = ready + span
            spans.append((name, T, span))

            issued_gets = T * n_reads
            g = issued_gets * (1.0 + dup_get + calib.polls_per_get) \
                + T * self._broadcast_gets(st, self.split_bytes)
            p = T * n_put_keys * (1.0 + dup_put)
            if get_retry != 1.0:
                g *= get_retry
            if put_retry != 1.0:
                p *= put_retry
            if work_mult != 1.0:
                g *= work_mult
                p *= work_mult
            gets += g
            puts += p
            invocations += T * e_att if p_att > 0.0 else T
            task_seconds += T * span_io * work_mult if work_mult != 1.0 \
                else T * span_io

        latency = max(finish.values())
        if p_att > 0.0:
            # a task that exhausts its budget fails the WHOLE query; the
            # naive client re-runs it from scratch (expected-rerun
            # multiplier on both latency and every billed count)
            total_tasks = sum(ntasks[st["name"]] for st in plan["stages"])
            rerun = 1.0 / max((1.0 - p_att ** k) ** total_tasks, 0.05)
            latency *= rerun
            invocations *= rerun
            gets *= rerun
            puts *= rerun
            task_seconds *= rerun
        cost = QueryCost(task_seconds * WORKER_MEM_GB, invocations,
                         gets, puts)
        return Prediction(latency * self.latency_bias, cost, tuple(spans))
