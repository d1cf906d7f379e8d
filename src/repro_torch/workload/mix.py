"""Query-mix sampling (paper §6.2, Fig 8's query set).

A :class:`QueryClass` names one plan builder from ``relational.tpch.QUERIES``
plus the per-class ``ntasks`` preset (the paper tunes worker counts per
query, Fig 11) and any extra plan options (e.g. Q12's multi-stage shuffle).
:data:`TPCH_MIX` is the default scaled-down mix: scan-heavy queries weighted
like an interactive dashboard workload, join-heavy ones rarer.
:func:`sample_mix` draws a seeded, weighted sample — the per-query classes
of a whole workload — which ``WorkloadDriver`` zips with an arrival process.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.relational.tpch import QUERIES


@dataclasses.dataclass(frozen=True)
class QueryClass:
    """One workload class: a TPC-H plan + its tuned task-count preset."""
    query: str                          # key into relational.tpch.QUERIES
    weight: float = 1.0
    ntasks: dict | None = None          # per-stage task counts (Fig 11)
    plan_kw: dict | None = None         # extra plan options (e.g. shuffle)

    def __post_init__(self):
        if self.query not in QUERIES:
            raise ValueError(f"unknown query {self.query!r}; have "
                             f"{sorted(QUERIES)}")
        if self.weight < 0:
            raise ValueError("weight must be non-negative")

    def build_plan(self) -> dict:
        """Build this class's plan. ``plan_kw`` may carry one reserved
        key, ``"pushdown"`` — a coordinator plan flag (§3.2), not a
        builder kwarg — which lands on the plan dict itself so a planner
        pick that disables pushdown flows through the workload path
        (``retune`` injects it from a ``PlanConfig``)."""
        kw = dict(self.plan_kw or {})
        pushdown = kw.pop("pushdown", None)
        plan = QUERIES[self.query](self.ntasks, **kw)
        if pushdown is not None:
            plan["pushdown"] = bool(pushdown)
        return plan


# Scaled-down default: Q1/Q6 dominate (cheap scan-aggregates, the bulk of
# dashboard traffic), the 2-join queries are occasional, the multi-join
# reports rare — weights sum to 10 for easy reading.
TPCH_MIX = (
    QueryClass("q1", 2.0, {"scan": 4}),
    QueryClass("q6", 3.0, {"scan": 4}),
    QueryClass("q12", 2.0, {"join": 8}),
    QueryClass("q14", 2.0, {"join": 4}),
    QueryClass("q3", 0.5, {"join_co": 4, "join_l": 8}),
    QueryClass("q5", 0.5, {"join_co": 4, "join_l": 8}),
)


def retune(mix, overrides: dict) -> tuple[QueryClass, ...]:
    """Apply planner-chosen tunings to a mix's classes.

    ``overrides`` maps query name -> tuning; values take any form
    ``planner.model.coerce_config`` accepts — a plain ntasks dict, a
    planner ``PlanConfig`` (so a
    searched ``shuffle={"strategy": "multi", ...}`` pick flows into the
    mix), or the explicit two-part ``{"ntasks": ..., "plan_kw": ...}``
    dict — all normalized through the one canonical
    ``PlanConfig.plan_kwargs`` path shared with ``engine.build_plan``
    and ``core.session.QuerySpec``.

    Classes of other queries pass through untouched. Unknown query names
    raise (a typo'd override must not silently tune nothing).
    """
    from repro_torch.planner.model import coerce_config
    known = {c.query for c in mix}
    unknown = set(overrides) - known
    if unknown:
        raise ValueError(f"overrides for queries not in mix: "
                         f"{sorted(unknown)}")
    out = []
    for c in mix:
        if c.query not in overrides:
            out.append(c)
            continue
        cfg, kw = coerce_config(overrides[c.query])
        if not getattr(cfg, "pushdown", True):
            # only inject when OFF: default-True mixes stay byte-identical
            kw = {**kw, "pushdown": False}
        nt = cfg.ntasks_dict
        out.append(dataclasses.replace(
            c, ntasks={**(c.ntasks or {}), **nt},
            plan_kw={**(c.plan_kw or {}), **kw} or None))
    return tuple(out)


def sample_mix(mix, n: int, *, seed: int = 0) -> list[QueryClass]:
    """Draw n classes i.i.d. proportionally to their weights (seeded)."""
    classes = list(mix)
    if not classes:
        raise ValueError("empty mix")
    w = np.asarray([c.weight for c in classes], np.float64)
    if w.sum() <= 0:
        raise ValueError("mix weights sum to zero")
    rng = np.random.default_rng([seed, 0x4D4958])          # "MIX"
    idx = rng.choice(len(classes), size=n, p=w / w.sum())
    return [classes[i] for i in idx]
