"""Model-pruned Pareto search over plan configurations (§4.3, Fig 14).

The exhaustive approach — simulate every grid point — is exactly what the
planner exists to avoid (Kassing et al.: the frontier can be *predicted*
and searched). :func:`pareto_search` therefore:

  1. prices the whole grid with the analytic :class:`QueryModel`
     (microseconds per point),
  2. runs coordinate descent over the per-stage DoP axes, the lane count,
     the §4.2 shuffle strategy with its (p, f) split, and the mitigation
     toggles — for a ladder of cost-vs-latency scalarization weights,
     tracing the model's frontier,
  3. confirms ONLY the resulting candidate set in the simulator
     (``must_confirm`` forces extra points, e.g. a hand sweep to compare
     against), and
  4. returns the simulator-confirmed Pareto frontier plus a log of every
     model-pruned grid point, so "we skipped 75% of the sweep" is
     auditable rather than asserted.

Inputs: a calibrated :class:`QueryModel`, an ``evaluate(config)``
callable (normally :class:`QueryEvaluator`), and a grid of
:class:`PlanConfig` points. Output: a :class:`SearchResult` whose
``frontier`` is latency-sorted and simulator-confirmed.

Determinism contract: the grid order, the descent, and the evaluator are
all pure functions of the seed and the config — the frontier is
bit-identical across executor widths (see docs/ARCHITECTURE.md).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.coordinator import Coordinator
from repro_torch.planner.model import PlanConfig, QueryModel
from repro_torch.relational.tpch import QUERIES

# PlanConfig fields searchable as whole-config axes (everything except the
# per-stage ntasks keys, which address into the ntasks mapping instead)
SCALAR_AXES = ("parallel_reads", "shuffle", "rsm", "wsm", "backup_tasks",
               "doublewrite", "pushdown", "retry_budget")


@dataclasses.dataclass(frozen=True)
class FrontierPoint:
    config: PlanConfig
    pred_latency_s: float
    pred_cost_usd: float
    sim_latency_s: float
    sim_cost_usd: float


@dataclasses.dataclass
class SearchResult:
    frontier: list[FrontierPoint]      # sim-confirmed Pareto, latency-sorted
    confirmed: list[FrontierPoint]     # every simulated candidate
    pruned: list[tuple[PlanConfig, float, float]]   # skipped grid points
    grid_size: int
    off_grid: int = 0       # confirmed candidates outside the grid (e.g.
    #                         must_confirm extras): pruned + (sim_evals -
    #                         off_grid) == grid_size always holds

    @property
    def sim_evals(self) -> int:
        return len(self.confirmed)

    @property
    def sim_fraction(self) -> float:
        return self.sim_evals / max(self.grid_size, 1)

    def dominates_or_matches(self, latency_s: float, cost_usd: float,
                             rel_tol: float = 1e-9) -> bool:
        """True iff some frontier point is <= the given (latency, cost)
        (within a relative tolerance) — the Fig-14 acceptance check
        against a hand sweep."""
        for p in self.frontier:
            if p.sim_latency_s <= latency_s * (1 + rel_tol) + 1e-12 and \
                    p.sim_cost_usd <= cost_usd * (1 + rel_tol) + 1e-12:
                return True
        return False


def pareto_front(points: list[tuple[float, float]]) -> list[int]:
    """Indices of the Pareto-minimal (latency, cost) points, sorted by
    latency ascending. Ties keep the first occurrence (stable)."""
    order = sorted(range(len(points)), key=lambda i: (points[i][0],
                                                      points[i][1], i))
    out: list[int] = []
    best_cost = math.inf
    for i in order:
        lat, cost = points[i]
        if cost < best_cost - 1e-15:
            out.append(i)
            best_cost = cost
    return out


def coordinate_descent(model: QueryModel, start: PlanConfig,
                       axes: dict[str, list], weight: float,
                       max_rounds: int = 8,
                       cache: dict | None = None) -> PlanConfig:
    """Minimize ``cost + weight * latency`` by per-coordinate line search
    over ``axes`` (a stage's ntasks key, or any :data:`SCALAR_AXES` field
    — lanes, shuffle strategy/split, mitigation toggles). Purely
    model-driven — never touches the simulator. ``cache`` memoizes
    predictions across descents (every visited config is an axis
    cross-product member, so pareto_search's grid predictions are reused
    for free)."""
    memo = cache if cache is not None else {}

    def score(cfg: PlanConfig) -> float:
        p = memo.get(cfg)
        if p is None:
            p = memo[cfg] = model.predict(cfg)
        return p.cost_usd + weight * p.latency_s

    cur, cur_score = start, score(start)
    for _ in range(max_rounds):
        improved = False
        for key, values in axes.items():
            for v in values:
                if key in SCALAR_AXES:
                    if getattr(cur, key) == v:
                        continue
                    cand = cur.replace(**{key: v})
                else:
                    nt = cur.ntasks_dict
                    if nt.get(key) == v:
                        continue
                    nt[key] = v
                    cand = cur.replace(ntasks=nt)
                s = score(cand)
                if s < cur_score - 1e-15:
                    cur, cur_score, improved = cand, s, True
        if not improved:
            break
    return cur


def pareto_search(model: QueryModel, evaluate, grid: list[PlanConfig], *,
                  must_confirm: tuple[PlanConfig, ...] = (),
                  n_weights: int = 8,
                  max_confirm: int | None = None) -> SearchResult:
    """Search ``grid`` for the cost–latency frontier.

    ``evaluate(config) -> (latency_s, cost_usd)`` is the simulator
    confirmation (see :class:`QueryEvaluator`); it is called ONLY for the
    model's frontier candidates, the coordinate-descent optima, and any
    ``must_confirm`` configs. ``max_confirm`` caps the total simulator
    budget (must_confirm is always kept; model candidates are dropped
    latency-frontier-last beyond the cap).
    """
    preds = {cfg: model.predict(cfg) for cfg in grid}
    pts = [(preds[c].latency_s, preds[c].cost_usd) for c in grid]
    model_front = [grid[i] for i in pareto_front(pts)]

    # scalarization ladder spanning the model's own cost/latency scales
    lats = [p[0] for p in pts]
    costs = [p[1] for p in pts]
    lat_span = max(max(lats) - min(lats), 1e-12)
    cost_span = max(max(costs) - min(costs), 1e-12)
    axes: dict[str, list] = {}
    for cfg in grid:
        for k, v in cfg.ntasks:
            axes.setdefault(k, [])
            if v not in axes[k]:
                axes[k].append(v)
        for k in SCALAR_AXES:
            v = getattr(cfg, k)
            axes.setdefault(k, [])
            if v not in axes[k]:
                axes[k].append(v)
    for vs in axes.values():
        try:
            vs.sort()                 # numeric / boolean axes
        except TypeError:             # shuffle axis mixes None and tuples
            vs.sort(key=lambda v: (v is not None, str(v)))
    start = grid[0]
    descent = []
    memo = dict(preds)        # descents revisit grid members — no re-predict
    for i in range(n_weights):
        # weights sweep the trade-off from ~pure-cost to ~pure-latency
        frac = i / max(n_weights - 1, 1)
        weight = (cost_span / lat_span) * (10.0 ** (4.0 * frac - 2.0))
        descent.append(coordinate_descent(model, start, axes, weight,
                                          cache=memo))

    candidates: list[PlanConfig] = []
    for cfg in [*must_confirm, *model_front, *descent]:
        if cfg not in candidates:
            candidates.append(cfg)
    if max_confirm is not None and len(candidates) > max_confirm:
        keep = list(must_confirm)       # always simulated, even over-budget
        for cfg in candidates:
            if len(keep) >= max_confirm:
                break
            if cfg not in keep:
                keep.append(cfg)
        candidates = keep

    confirmed = []
    grid_set = set(grid)
    off_grid = 0
    for cfg in candidates:
        sim_lat, sim_cost = evaluate(cfg)
        pred = preds.get(cfg) or model.predict(cfg)
        confirmed.append(FrontierPoint(cfg, pred.latency_s, pred.cost_usd,
                                       sim_lat, sim_cost))
        if cfg not in grid_set:
            off_grid += 1
    front_idx = pareto_front([(p.sim_latency_s, p.sim_cost_usd)
                              for p in confirmed])
    frontier = [confirmed[i] for i in front_idx]
    pruned = [(c, preds[c].latency_s, preds[c].cost_usd)
              for c in grid if c not in candidates]
    return SearchResult(frontier, confirmed, pruned, len(grid), off_grid)


class QueryEvaluator:
    """Simulator confirmation: one fresh ``Coordinator`` per candidate over
    a SHARED store + base splits (the dataset is loaded once; candidate
    runs overwrite each other's intermediates, which is safe because every
    run reads only keys it wrote itself).

    ``compute_scale=0`` keeps every confirmation a pure function of the
    seed and the config — bit-identical across executor widths — which is
    the planner's determinism contract. Results are cached per config so
    re-confirming a config is free and cannot re-randomize.
    """

    def __init__(self, store, base_splits, query, *, seed: int = 0,
                 base_policy=None, max_parallel: int = 1000,
                 executor_workers: int | None = None,
                 plan_kw: dict | None = None,
                 faults=None, coldstart=None, retry=None,
                 device: str = "cuda"):
        from repro_torch.core.stragglers import StragglerConfig
        self.device = device    # torch device confirmations run on
        self.store = store
        self.base_splits = base_splits
        self.builder = QUERIES[query] if isinstance(query, str) else query
        self.seed = seed
        self.base_policy = base_policy or StragglerConfig()
        self.max_parallel = max_parallel
        self.executor_workers = executor_workers
        self.plan_kw = dict(plan_kw or {})
        # §3 fault environment shared by every confirmation (repro_torch.faults):
        # the config's retry_budget overrides the policy's max_attempts, so
        # the budget axis is confirmable in the simulator
        self.faults = faults
        self.coldstart = coldstart
        self.retry = retry
        self.cache: dict[PlanConfig, object] = {}

    def result(self, config: PlanConfig):
        """Full QueryResult for a config (cached)."""
        if config not in self.cache:
            retry = self.retry
            if self.faults is not None or retry is not None:
                from repro_torch.faults.retry import RetryPolicy
                retry = dataclasses.replace(
                    retry or RetryPolicy(),
                    max_attempts=max(int(config.retry_budget), 1))
            coord = Coordinator(
                self.store, self.base_splits,
                config.policy(self.base_policy), seed=self.seed,
                max_parallel=self.max_parallel, compute_scale=0.0,
                executor_workers=self.executor_workers,
                faults=self.faults, coldstart=self.coldstart, retry=retry,
                device=self.device)
            plan = self.builder(config.ntasks_dict or None,
                                **config.plan_kwargs(self.plan_kw))
            # pushdown is a coordinator-level plan key, not a builder kwarg
            plan["pushdown"] = config.pushdown
            self.cache[config] = coord.run_query(plan)
        return self.cache[config]

    def __call__(self, config: PlanConfig) -> tuple[float, float]:
        res = self.result(config)
        if getattr(res, "failed", False):
            # an exhausted retry budget: a failed query must never look
            # cheap or fast to the search
            return math.inf, math.inf
        return res.latency_s, res.cost.total
