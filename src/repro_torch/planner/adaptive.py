"""Adaptive control plane (ROADMAP item 2): the planner goes online.

Everything before this module is an *offline* planner: probe once,
calibrate once, search once, freeze the chosen :class:`PlanConfig`
forever. The drift detector (``repro_torch.obs.drift``) already notices when
the object store leaves the calibrated regime — this module closes the
loop and ACTS on it:

    detect -> re-probe -> refit -> re-search -> swap

:class:`AdaptiveController` wraps a live :class:`~repro_torch.core.session
.Session` and drives a workload exactly like ``WorkloadDriver`` does,
but in *segments* cut at deterministic quiet points of the arrival
schedule (:func:`segment_indices` — a cut wherever the inter-arrival gap
exceeds ``gap_s``, so cuts land in the off periods of a bursty on-off
process). Between segments — never inside one — it may:

  * **re-probe** (bounded by ``probe_budget``): one cheap probe query on
    a spawned coordinator over the SAME (possibly shifted) store,
    refitting the :class:`~repro_torch.planner.calibrate.Calibration`;
  * **re-search**: the model-pruned Pareto search over a local re-grid
    of the active config (``regrid``), simulator-confirmed by a
    :class:`~repro_torch.planner.search.QueryEvaluator`, with the active
    config always in ``must_confirm`` so the comparison is honest;
  * **swap**: if the SLA-constrained pick (:func:`~repro_torch.planner.sla
    .select` at the active config's own confirmed latency times
    ``1 + sla_slack``) is strictly cheaper, subsequent segments run it —
    task counts and plan options through ``workload.mix.retune``, the
    I/O policy through ``Session.swap_config``, and every record is
    labelled with the active ``config_id`` so ``summarize`` can split
    pre-swap vs post-swap percentiles.

In-flight queries are NEVER re-planned: a segment that was submitted
under config A finishes under config A; the swap point is the first
record index of the next segment — a pure function of the arrival
schedule and the seeds, so it is deterministic and testable.

**No-op parity contract** (proven test-first in tests/test_adaptive.py
and gated in benchmarks/adaptive.py): with no detector and no autoscale
policy the controller is ONE ``WorkloadDriver.run`` call — trivially
bit-identical to the frozen path; with a detector attached but the null
in force (no shift, nothing flagged), the segmented run must STILL be
bit-identical to the unsegmented one at executor widths {1, 8}. That
holds because (a) per-query RNG streams key off the coordinator's
persistent name counter, not the batch, and (b) at a drained cut every
slot is free, so task starts degenerate to arrival times in both runs —
``SegmentInfo.quiet`` records that each cut actually drained. Cold-start
simulation is refused (the virgin-slot set is per-``run_queries`` call,
so segmentation would change which invocations run cold).

Planner-driven autoscaling (ROADMAP 2c): :class:`AutoscalePolicy`
derives a per-segment ``max_parallel`` from the slot-queueing wave model
(:func:`plan_max_parallel`): the peak windowed arrival count times tasks
per query is the burst's slot demand; dividing by ``target_waves`` and
clamping gives the smallest pool that serves the burst in at most that
many waves. The trace is recorded per segment — serverless billing does
not charge idle slots, so the win is stated against the
provisioned-equivalent capacity (``workload.pricing``).

Adaptive (p, f) gridding (ROADMAP 2d): :func:`adaptive_shuffle_menu`
replaces fixed multi-stage shuffle menus with the cost-argmin
neighbourhood of ``core.shuffle.choose_strategy``'s divisor search — for
each candidate combiner count the request-cost-ranked divisor pairs,
keeping the argmin plus ``radius`` runners-up. The menu provably
contains the exhaustive grid's request-cost argmin (hypothesis-tested).
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np

from repro_torch.core.shuffle import multi_stage
from repro_torch.planner.model import PlanConfig, QueryModel, coerce_config
from repro_torch.planner.search import QueryEvaluator, pareto_search
from repro_torch.planner.sla import select

# ------------------------------------------------------------ segmentation

#: auto gap: this many times the median positive inter-arrival gap
GAP_FACTOR = 5.0


def segment_indices(arrivals: list[float], gap_s: float) -> list[int]:
    """Deterministic segment cut points: index 0 plus every index whose
    gap to the previous arrival exceeds ``gap_s``. A pure function of the
    arrival schedule — the config-swap points depend on nothing that the
    run itself produces, which is what makes the swap index testable."""
    if not arrivals:
        return []
    cuts = [0]
    for i in range(1, len(arrivals)):
        if arrivals[i] - arrivals[i - 1] > gap_s:
            cuts.append(i)
    return cuts


def auto_gap_s(arrivals: list[float]) -> float:
    """Default segmentation gap: :data:`GAP_FACTOR` x the median positive
    inter-arrival gap (1.0 when the schedule has no positive gaps) — wide
    enough that cuts land only in genuine off periods of a bursty
    process, not between queries of one burst."""
    diffs = [b - a for a, b in zip(arrivals, arrivals[1:]) if b > a]
    if not diffs:
        return 1.0
    return GAP_FACTOR * float(np.median(diffs))


# ------------------------------------------------------------- autoscaling

def plan_max_parallel(arrivals: list[float], tasks_per_query: float, *,
                      window_s: float = 4.0, target_waves: int = 2,
                      floor: int = 1, cap: int = 1000) -> int:
    """Slot pool size from the slot-queueing wave model (the same
    ``ceil(T / max_parallel)`` waves term ``QueryModel.predict`` prices):
    the peak number of arrivals in any ``window_s`` window times
    ``tasks_per_query`` is the burst's slot demand ``D``; a pool of
    ``ceil(D / target_waves)`` slots serves it in at most ``target_waves``
    waves (since ``ceil(D / ceil(D/w)) <= w``). Clamped to
    ``[floor, cap]``. Closed form, no simulation — the autoscaling trace
    is checkable against this function exactly."""
    floor = max(int(floor), 1)
    if not arrivals:
        return floor
    arr = sorted(float(a) for a in arrivals)
    peak, hi = 0, 0
    for lo in range(len(arr)):
        if hi < lo:
            hi = lo
        while hi < len(arr) and arr[hi] < arr[lo] + window_s:
            hi += 1
        peak = max(peak, hi - lo)
    demand = peak * max(float(tasks_per_query), 1.0)
    m = math.ceil(demand / max(int(target_waves), 1))
    return int(min(max(m, floor), cap))


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Planner-driven autoscaling knobs: per segment, the controller sets
    ``max_parallel`` to :func:`plan_max_parallel` over that segment's
    arrivals. ``tasks_per_query=None`` derives the demand from the
    segment's classes (mean over classes of the summed per-stage task
    counts) — deterministic, no simulation."""
    window_s: float = 4.0
    target_waves: int = 2
    floor: int = 8
    cap: int = 1000
    tasks_per_query: float | None = None

    def demand_per_query(self, classes) -> float:
        if self.tasks_per_query is not None:
            return float(self.tasks_per_query)
        per = [sum((c.ntasks or {}).values()) or 1 for c in classes]
        return float(np.mean(per)) if per else 1.0

    def max_parallel_for(self, arrivals, classes) -> int:
        return plan_max_parallel(
            arrivals, self.demand_per_query(classes),
            window_s=self.window_s, target_waves=self.target_waves,
            floor=self.floor, cap=self.cap)


# ------------------------------------------------- adaptive (p, f) gridding

def shuffle_divisor_pairs(c: int, s: int, r: int) -> list[tuple[int, int]]:
    """All feasible §4.2 splits ``(a, b)`` with ``a * b == c`` combiners,
    ``a <= r`` partition-splits and ``b <= s`` file-splits — the exact
    grid ``core.shuffle.choose_strategy`` searches for one combiner
    count."""
    out = []
    for a in range(1, c + 1):
        if c % a:
            continue
        b = c // a
        if a <= r and b <= s:
            out.append((a, b))
    return out


def adaptive_shuffle_menu(s: int, r: int, *,
                          combiners: tuple[int, ...] | None = None,
                          radius: int = 1,
                          doublewrite: bool = True) -> tuple[tuple, ...]:
    """Candidate shuffle strategies derived from ``choose_strategy``'s
    cost-argmin neighbourhood instead of a hand-fixed menu.

    For each combiner count ``c`` (default ``{r // 2, r}`` — the paper's
    "combiners == consumers" anchor plus one halving), rank the feasible
    divisor pairs by :meth:`~repro_torch.core.shuffle.ShufflePlan.request_cost`
    and keep the argmin plus ``radius`` runners-up. ``("single",)`` is
    always first. By construction the menu contains the request-cost
    argmin of the exhaustive divisor grid over the same combiner counts
    (the per-``c`` argmin of the cheapest ``c`` IS that argmin) — the
    hypothesis-tested containment property."""
    if combiners is None:
        combiners = tuple(sorted({max(r // 2, 1), max(r, 1)}))
    menu: list[tuple] = [("single",)]
    for c in combiners:
        pairs = shuffle_divisor_pairs(c, s, r)
        ranked = sorted(pairs, key=lambda ab: (
            multi_stage(s, r, 1.0 / ab[0], 1.0 / ab[1])
            .request_cost(doublewrite), ab))
        for a, b in ranked[:max(radius, 0) + 1]:
            if ("multi", a, b) not in menu:
                menu.append(("multi", a, b))
    return tuple(menu)


# ----------------------------------------------------------------- re-grid

def default_regrid(cfg: PlanConfig) -> list[PlanConfig]:
    """Local re-grid around the active config: each per-stage task count
    at {v//2, v, 2v} crossed with the §3.2 pushdown toggle. Small by
    design — a mid-run re-plan confirms a handful of candidates, not a
    fresh sweep (the probe-anchored model prunes the rest)."""
    nts = cfg.ntasks_dict
    keys = sorted(nts)
    lattices = [sorted({max(1, nts[k] // 2), nts[k], nts[k] * 2})
                for k in keys]
    out: list[PlanConfig] = []
    for combo in itertools.product(*lattices) if keys else [()]:
        for pd in (True, False):
            cand = cfg.replace(ntasks=dict(zip(keys, combo)), pushdown=pd)
            if cand not in out:
                out.append(cand)
    return out


# ----------------------------------------------------------------- results

@dataclasses.dataclass(frozen=True)
class SegmentInfo:
    """One driver segment: records ``[start, stop)`` ran under
    ``config_id`` with slot pool ``max_parallel`` (None = account
    default). ``quiet`` is the post-hoc drain check backing the no-op
    parity argument: every query of this segment finished before the
    next segment's first arrival."""
    index: int
    start: int
    stop: int
    t0: float
    config_id: str
    max_parallel: int | None
    quiet: bool


@dataclasses.dataclass(frozen=True)
class SwapEvent:
    """One acted-upon re-plan: the config swap took effect at global
    record index ``at_query`` (the first query of the following
    segment). Old/new numbers are the simulator-confirmed single-query
    (latency, cost) from the re-search, ``probe_cost_usd`` +
    ``search_cost_usd`` the control-plane spend that bought the swap."""
    at_query: int
    t: float
    from_id: str
    to_id: str
    from_config: PlanConfig
    to_config: PlanConfig
    target_s: float
    old_latency_s: float
    old_cost_usd: float
    new_latency_s: float
    new_cost_usd: float
    probe_cost_usd: float
    search_cost_usd: float
    search_evals: int


@dataclasses.dataclass(frozen=True)
class AdaptiveResult:
    """``WorkloadResult``-shaped outcome plus the control plane's audit
    trail. ``control_cost_usd`` (probes + search confirmations) is NOT in
    ``total_cost`` — the benchmark gate charges it explicitly via
    ``total_cost_with_control`` so the adaptive win is net of what it
    cost to find."""
    records: list
    makespan_s: float
    summary: dict
    segments: tuple[SegmentInfo, ...]
    swaps: tuple[SwapEvent, ...]
    replans: int
    probes_used: int
    control_cost_usd: float
    reports: tuple
    configs: dict

    @property
    def total_cost(self) -> float:
        return sum(r.dollars for r in self.records)

    @property
    def total_cost_with_control(self) -> float:
        return self.total_cost + self.control_cost_usd

    @property
    def cost_per_query(self) -> float:
        return self.total_cost / max(len(self.records), 1)

    @property
    def max_parallel_trace(self) -> tuple:
        return tuple(s.max_parallel for s in self.segments)


# -------------------------------------------------------------- controller

class AdaptiveController:
    """Drives a workload on a live Session, re-planning at segment
    boundaries when the drift detector flags (see module docstring).

    Parameters
    ----------
    session : Session
        The serving engine. Its coordinator's policy/limits are what the
        re-search confirms against.
    base_config : PlanConfig | None
        The config the incoming classes are ALREADY tuned to (config id
        ``cfg0``); it seeds the re-grid and is always ``must_confirm``-ed
        so a swap needs a strictly cheaper confirmed point. Defaults to
        ``PlanConfig()``.
    target_query : str | None
        The query class the re-plan probes and re-tunes (the adaptive
        loop is per-query-class, like the offline planner). Required when
        a detector is attached.
    detector : obs.drift.DriftDetector | None
        Attached as a coordinator observer for the whole run; its
        ``on_report`` hook records the first flagged report. None
        disables adaptation entirely.
    autoscale : AutoscalePolicy | None
        Per-segment ``max_parallel`` from the wave model; None keeps the
        account default (bit-identical path).
    probe_budget / confirm_budget : int
        Max re-probes across the run / max simulator confirmations per
        re-search (``pareto_search``'s ``max_confirm``).
    sla_slack : float
        The re-plan's latency target is the active config's confirmed
        latency x ``(1 + sla_slack)`` — "get cheaper without getting
        meaningfully slower".
    min_gain : float
        Required relative cost improvement before swapping (0 = strictly
        cheaper).
    gap_s : float | None
        Segmentation gap; None derives :func:`auto_gap_s`.
    probe_ntasks / probe_plan_kw : probe plan shape (defaults: the active
        config's task counts, no extra kwargs).
    regrid : callable(PlanConfig) -> list[PlanConfig]
        Candidate generator around the active config
        (:func:`default_regrid`).
    on_segment : callable(k, t0) | None
        Called before each segment is submitted — the benchmark's
        deterministic regime-shift injection point (both twins shift at
        the same segment).
    """

    def __init__(self, session, base_config: PlanConfig | None = None, *,
                 target_query: str | None = None, detector=None,
                 autoscale: AutoscalePolicy | None = None,
                 probe_budget: int = 1, confirm_budget: int = 6,
                 sla_slack: float = 0.10, min_gain: float = 0.0,
                 gap_s: float | None = None,
                 probe_ntasks: dict | None = None,
                 probe_plan_kw: dict | None = None,
                 regrid=default_regrid, on_segment=None):
        if detector is not None and target_query is None:
            raise ValueError("a detector needs target_query: the re-plan "
                             "must know which query class to re-probe")
        self.session = session
        self.base_config = base_config if base_config is not None \
            else PlanConfig()
        self.target_query = target_query
        self.detector = detector
        self.autoscale = autoscale
        self.probe_budget = int(probe_budget)
        self.confirm_budget = int(confirm_budget)
        self.sla_slack = float(sla_slack)
        self.min_gain = float(min_gain)
        self.gap_s = gap_s
        self.probe_ntasks = probe_ntasks
        self.probe_plan_kw = dict(probe_plan_kw or {})
        self.regrid = regrid
        self.on_segment = on_segment
        # live state
        self.configs: dict[str, PlanConfig] = {"cfg0": self.base_config}
        self._active_id = "cfg0"
        self._active_cfg: PlanConfig | None = None    # None = as supplied
        self._trigger = None                          # first flagged report
        self._reports: list = []
        self.replans = 0
        self.probes_used = 0
        self.control_cost_usd = 0.0
        self._swaps: list[SwapEvent] = []

    # ------------------------------------------------------------- driving
    def run(self, classes, arrivals) -> AdaptiveResult:
        """Run (classes, open-loop arrivals) adaptively. With no
        detector, no autoscale policy and no segment hook this is ONE
        ``WorkloadDriver.run`` call — the no-op parity contract."""
        from repro_torch.workload.driver import WorkloadDriver, summarize
        classes = list(classes)
        arrivals = [float(a) for a in arrivals]
        if len(classes) != len(arrivals):
            raise ValueError(f"{len(classes)} classes but "
                             f"{len(arrivals)} arrival times")
        if any(b < a for a, b in zip(arrivals, arrivals[1:])):
            raise ValueError("adaptive runs need sorted open-loop "
                             "arrivals (segmentation cuts the schedule)")
        coord = self.session.coord
        driver = WorkloadDriver(coord)
        plain = (self.detector is None and self.autoscale is None
                 and self.on_segment is None)
        cuts = [0] if plain or not classes else \
            segment_indices(arrivals, self.gap_s if self.gap_s is not None
                            else auto_gap_s(arrivals))
        if self.detector is not None and len(cuts) > 1 \
                and getattr(coord, "coldstart", None):
            raise ValueError(
                "adaptive segmentation is incompatible with cold-start "
                "simulation: the virgin-slot set is per-call, so cutting "
                "the run would change which invocations run cold")
        if self.detector is not None:
            self._arm(self.detector)
        try:
            return self._run_segments(driver, classes, arrivals, cuts,
                                      summarize)
        finally:
            if self.detector is not None:
                self._disarm(self.detector)

    def _run_segments(self, driver, classes, arrivals, cuts, summarize
                      ) -> AdaptiveResult:
        records: list = []
        seg_draft: list[tuple] = []
        bounds = cuts + [len(classes)]
        for k in range(len(cuts)):
            i, j = bounds[k], bounds[k + 1]
            t0 = arrivals[i] if i < j else 0.0
            if self.on_segment is not None:
                self.on_segment(k, t0)
            if k > 0 and self._trigger is not None \
                    and self.probes_used < self.probe_budget:
                self._replan(t0, at_query=i)
            seg_classes = self._apply(classes[i:j])
            mp = None if self.autoscale is None else \
                self.autoscale.max_parallel_for(arrivals[i:j], seg_classes)
            wr = driver.run(seg_classes, arrivals[i:j],
                            config_id=self._active_id, max_parallel=mp)
            records.extend(dataclasses.replace(r, index=i + r.index)
                           for r in wr.records)
            seg_draft.append((k, i, j, t0, self._active_id, mp))
        segments = []
        for k, i, j, t0, cid, mp in seg_draft:
            nxt = seg_draft[k + 1][3] if k + 1 < len(seg_draft) else \
                math.inf
            quiet = all(r.finish_s <= nxt + 1e-9 for r in records[i:j])
            segments.append(SegmentInfo(k, i, j, t0, cid, mp, quiet))
        makespan = 0.0 if not records else \
            max(r.finish_s for r in records) - min(r.arrival_s
                                                   for r in records)
        reports = list(self._reports)      # from detectors retired mid-run
        if self.detector is not None:
            reports.extend(self.detector.reports)
        return AdaptiveResult(
            records, makespan, summarize(records, makespan),
            tuple(segments), tuple(self._swaps), self.replans,
            self.probes_used, self.control_cost_usd,
            tuple(reports), dict(self.configs))

    # ----------------------------------------------------- detector wiring
    def _arm(self, det):
        self._chained = det.on_report
        det.on_report = self._note_report
        self.session.coord.attach_observer(det)

    def _disarm(self, det):
        self.session.coord.detach_observer(det)
        det.on_report = self._chained

    def _note_report(self, rep):
        # runs inside the coordinator's event loop: record only, act at
        # the next segment boundary (see DriftDetector.on_report docs)
        if self._chained is not None:
            self._chained(rep)
        if rep.flagged and self._trigger is None:
            self._trigger = rep

    # ------------------------------------------------------------- re-plan
    def _active_config(self) -> PlanConfig:
        return self._active_cfg if self._active_cfg is not None \
            else self.base_config

    def _replan(self, t: float, at_query: int) -> None:
        """Probe -> refit -> re-search -> (maybe) swap, all OFF the
        serving coordinator's event loop: the probe runs on a spawned
        coordinator over the same (shifted) store, the confirmations on
        fresh per-config coordinators — the serving engine's RNG streams
        and name counters are untouched, so segments after a re-plan that
        decides NOT to swap are bit-identical to never re-planning."""
        from repro_torch.obs.drift import DriftDetector
        self.replans += 1
        self.probes_used += 1
        trigger, self._trigger = self._trigger, None
        coord = self.session.coord
        active = self._active_config()
        probe_coord = self.session.spawn(record_events=True)
        model, probe_res = QueryModel.from_probe(
            probe_coord, self.target_query,
            self.probe_ntasks or active.ntasks_dict or None,
            plan_kw=active.plan_kwargs(self.probe_plan_kw))
        summary = probe_coord.event_summary(query=probe_res.store_name)
        self.control_cost_usd += probe_res.cost.total
        ev = QueryEvaluator(
            coord.store, coord.base_splits, self.target_query,
            seed=coord.seed, base_policy=coord.policy,
            max_parallel=coord.max_parallel,
            executor_workers=coord.executor_workers,
            plan_kw=self.probe_plan_kw, device=coord.device)
        sr = pareto_search(model, ev, self.regrid(active),
                           must_confirm=(active,),
                           max_confirm=self.confirm_budget)
        search_cost = sum(r.cost.total for r in ev.cache.values())
        self.control_cost_usd += search_cost
        active_pt = next(p for p in sr.confirmed if p.config == active)
        if not math.isfinite(active_pt.sim_latency_s):
            return                      # active config fails here: bail
        target = active_pt.sim_latency_s * (1.0 + self.sla_slack)
        choice = select(sr, target)
        better = choice.feasible and choice.cost_usd < \
            active_pt.sim_cost_usd * (1.0 - self.min_gain) - 1e-15
        if not better or choice.config == active:
            return
        new_id = f"cfg{len(self.configs)}"
        self.configs[new_id] = choice.config
        self._swaps.append(SwapEvent(
            at_query=at_query, t=t, from_id=self._active_id, to_id=new_id,
            from_config=active, to_config=choice.config, target_s=target,
            old_latency_s=active_pt.sim_latency_s,
            old_cost_usd=active_pt.sim_cost_usd,
            new_latency_s=choice.latency_s, new_cost_usd=choice.cost_usd,
            probe_cost_usd=probe_res.cost.total,
            search_cost_usd=search_cost, search_evals=sr.sim_evals))
        self._active_id = new_id
        self._active_cfg = choice.config
        self.session.swap_config(choice.config)
        # re-anchor the detector to the fresh calibration if the budget
        # allows another round; otherwise detach-for-good semantics are
        # handled by _trigger staying None (old reports are kept)
        if self.detector is not None and \
                self.probes_used < self.probe_budget:
            old = self.detector
            self._disarm(old)
            self._reports.extend(old.reports)
            fresh = DriftDetector.from_summary(
                model.calib, summary, window=old.window,
                margin=old.margin, consecutive=old.consecutive)
            self.detector = fresh
            self._arm(fresh)
        _ = trigger     # consumed: one flagged report buys one re-plan

    # --------------------------------------------------- config application
    def _apply(self, seg_classes):
        """Re-tune a segment's classes to the active config (identity
        before any swap — the supplied classes already encode cfg0)."""
        if self._active_cfg is None:
            return seg_classes
        if not any(c.query == self.target_query for c in seg_classes):
            return list(seg_classes)
        from repro_torch.workload.mix import retune
        return list(retune(tuple(seg_classes),
                           {self.target_query: self._active_cfg}))


def frozen_twin(session, base_config=None, **kw) -> AdaptiveController:
    """The ablation twin: identical segmentation and hooks but a zero
    probe budget, so drift may flag yet nothing ever acts — what the
    benchmark's adaptive-vs-frozen gate compares against (same cuts,
    same injected shift, no adaptation)."""
    kw = dict(kw)
    kw["probe_budget"] = 0
    return AdaptiveController(session, base_config, **kw)
