"""The planner's configuration point and tuning normalizer.

This slice of the port carries only what ``core.session`` needs:
``PlanConfig`` (one point of the planner's search space) and
``coerce_config`` (the one canonical tuning normalizer), with the
shuffle-spec canonicalizer they share. The analytic ``QueryModel`` and
the rest of the planner wait for a later slice.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.stragglers import StragglerConfig


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
