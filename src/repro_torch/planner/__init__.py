"""Cost-based plan tuner: per-stage parallelism on the cost–latency
Pareto frontier.

Starling ships no optimizer — §4.3 and Fig 14 instead show that per-stage
task counts *trade* latency against cost (more tasks are faster until S3
request costs dominate), and leave picking the operating point to the
operator. This subsystem turns that knob-twiddling into an optimization
problem, following Kassing et al. (*Resource Allocation in Serverless
Query Processing*): predict the frontier from a model, search it, and
confirm only the candidates.

Module map (paper anchors):

  * :mod:`repro_torch.planner.calibrate` — §4.3 / Fig 3: fit per-request
    GET/PUT latency (base + per-byte + straggler surcharge), §5 duplicate
    rates, and §3.3.1 poll rates from ``Coordinator.event_summary()`` of
    one cheap probe run; analytic fallbacks when the log is short.
  * :mod:`repro_torch.planner.model` — §4.3 / Fig 14: structural request-count
    + calibrated-latency predictor for any per-stage ``ntasks`` /
    ``parallel_reads`` / §4.2 shuffle strategy with its (p, f) split /
    mitigation assignment; dollar cost emitted as ``core.cost.QueryCost``
    so it can never drift from the repo's closed forms (§6 pricing).
    Multi-stage combiner stages are counted from the same plan expansion
    the coordinator schedules (``core.plan.expand_combiners``).
  * :mod:`repro_torch.planner.search` — Fig 14: model-pruned Pareto search
    (coordinate descent over per-stage DoP, lanes, shuffle p/f splits and
    mitigation toggles; simulator confirmation of frontier candidates
    only) with an auditable pruned-point log.
  * :mod:`repro_torch.planner.adaptive` — ROADMAP item 2: the ONLINE planner.
    ``AdaptiveController`` closes the detect -> re-probe -> refit ->
    re-search -> swap loop over a live Session: drift flags
    (``obs.drift``) trigger a bounded re-probe and a local re-search, and
    a strictly cheaper SLA-feasible pick swaps in at a deterministic
    segment boundary; planner-driven autoscaling sizes the slot pool per
    burst from the wave model; ``adaptive_shuffle_menu`` derives §4.2
    (p, f) candidates from ``choose_strategy``'s cost-argmin
    neighbourhood. No-op parity contract: with no detector (or under the
    null) the adaptive path is bit-identical to the frozen one.
  * :mod:`repro_torch.planner.sla` — §6 SLA discussion / ROADMAP: cheapest
    config whose simulator-confirmed latency (or workload p99) meets a
    target, with the model's agreement recorded; wires into
    ``workload.pricing`` for the SLA-constrained break-even frontier and
    emits ``choice_spec`` run specs so picks (multi-stage shuffles
    included) flow into single queries and, via ``workload.mix.retune``,
    whole mixes.

Determinism contract (as everywhere in this repo): probes and simulator
confirmations run ``compute_scale=0``, so the same seed produces a
bit-identical frontier for any executor width. See
``docs/ARCHITECTURE.md`` for the calibrate -> model -> search -> sla
pipeline in detail.
"""
from repro_torch.planner.adaptive import (AdaptiveController, AdaptiveResult,
                                    AutoscalePolicy, SegmentInfo, SwapEvent,
                                    adaptive_shuffle_menu, auto_gap_s,
                                    default_regrid, frozen_twin,
                                    plan_max_parallel, segment_indices,
                                    shuffle_divisor_pairs)
from repro_torch.planner.calibrate import Calibration, RequestFit, calibrate
from repro_torch.planner.model import (PlanConfig, Prediction, QueryModel,
                                 coerce_config)
from repro_torch.planner.search import (SCALAR_AXES, FrontierPoint,
                                  QueryEvaluator, SearchResult,
                                  coordinate_descent, pareto_front,
                                  pareto_search)
from repro_torch.planner.sla import (SLAChoice, WorkloadSLAChoice, choice_spec,
                               select, select_for_workload, sla_breakeven)

__all__ = [
    "AdaptiveController", "AdaptiveResult", "AutoscalePolicy",
    "SegmentInfo", "SwapEvent", "adaptive_shuffle_menu", "auto_gap_s",
    "default_regrid", "frozen_twin", "plan_max_parallel",
    "segment_indices", "shuffle_divisor_pairs",
    "Calibration", "RequestFit", "calibrate",
    "PlanConfig", "Prediction", "QueryModel", "coerce_config",
    "FrontierPoint", "QueryEvaluator", "SCALAR_AXES", "SearchResult",
    "coordinate_descent", "pareto_front", "pareto_search",
    "SLAChoice", "WorkloadSLAChoice", "choice_spec", "select",
    "select_for_workload", "sla_breakeven",
]
