"""Calibration (§4.3): fit the analytic per-request model from one probe.

One cheap probe run with ``record_events=True`` yields the coordinator's
request-level event log; :func:`calibrate` turns its
``Coordinator.event_summary()`` into a :class:`Calibration` — per-request
GET/PUT fits (base latency + per-byte streaming + mean straggler
surcharge + residual spread), §5 duplicate rates, §3.3.1 poll rates, and
the invocation overhead. The fits are robust to the heavy straggler tail
(median-based slope/intercept, quantile-based spread) and fully
deterministic: the same event log always produces the same calibration.

When the log is empty or too short (fewer than :data:`MIN_SAMPLES`
effective completions) the calibration falls back to the analytic
latency-model constants (``objectstore.latency``) and flags itself with
``from_defaults=True`` — a planner edge case exercised by the tests.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.coordinator import INVOKE_OVERHEAD_S
from repro_torch.objectstore.latency import (S3_GET_MODEL, S3_PUT_MODEL,
                                       LatencyModel, lane_throughput_Bps)

MIN_SAMPLES = 8          # below this, fall back to the analytic constants

# a §5 duplicate truncates the straggler surcharge roughly to its timer;
# used to scale the fitted tail when a config toggles mitigation away from
# the probe's policy (the probe normally runs with RSM/WSM enabled)
RSM_TAIL_CUT = 3.0
WSM_TAIL_CUT = 2.5


@dataclasses.dataclass(frozen=True)
class RequestFit:
    """dur ~= base_s + nbytes / throughput_Bps + tail_s (mean surcharge).

    (Per-task duration spread — the straggler order-statistic input — is
    fitted per stage from the probe profiles, not here.)"""
    base_s: float
    throughput_Bps: float
    tail_s: float            # mean straggler surcharge per request
    samples: int

    def expected_s(self, nbytes: float, concurrency: int = 1,
                   tail_s: float | None = None) -> float:
        """Mean request duration at ``concurrency`` active lanes (the NIC
        aggregate cap of Fig 3 applies past the saturation point);
        ``tail_s`` overrides the fitted surcharge (mitigation toggles)."""
        bw = lane_throughput_Bps(self.throughput_Bps, concurrency)
        return self.base_s + nbytes / bw \
            + (self.tail_s if tail_s is None else tail_s)


@dataclasses.dataclass(frozen=True)
class Calibration:
    get: RequestFit
    put: RequestFit
    dup_get_rate: float      # §5.1 duplicates per issued GET
    dup_put_rate: float      # §5.2 duplicates per issued PUT
    polls_per_get: float     # §3.3.1 404 polls per issued GET
    invoke_overhead_s: float
    probe_rsm: bool          # mitigation state the fits were measured under
    probe_wsm: bool
    from_defaults: bool
    # §3 fault-path fits (repro_torch.faults): rates observed in the probe's
    # event log, zero when the probe ran fault-free — in which case every
    # fault term in the model vanishes and predictions are bit-identical
    # to the pre-fault planner
    invoke_fail_rate: float = 0.0    # invoke API failures / task attempt
    worker_loss_rate: float = 0.0    # worker losses / task attempt
    get_fail_rate: float = 0.0       # dropped GETs / issued GET
    put_fail_rate: float = 0.0       # dropped PUTs / issued PUT
    cold_rate: float = 0.0           # cold starts / task attempt
    cold_overhead_s: float = 0.0     # mean cold-start extra
    retry_backoff_s: float = 0.05    # first-retry backoff (RetryPolicy)

    def get_tail_s(self, rsm: bool) -> float:
        """Fitted GET surcharge, re-scaled when a candidate config toggles
        RSM away from the probe's policy."""
        if rsm == self.probe_rsm:
            return self.get.tail_s
        return self.get.tail_s * (RSM_TAIL_CUT if self.probe_rsm
                                  else 1.0 / RSM_TAIL_CUT)

    def put_tail_s(self, wsm: bool) -> float:
        if wsm == self.probe_wsm:
            return self.put.tail_s
        return self.put.tail_s * (WSM_TAIL_CUT if self.probe_wsm
                                  else 1.0 / WSM_TAIL_CUT)


def _default_fit(model: LatencyModel) -> RequestFit:
    """Analytic fallback: moments of the latency model itself."""
    # Pareto(alpha) mean = 1/(alpha-1); surcharge = scale * (1 + mean)
    alpha = model.straggler_alpha
    stall = model.straggler_scale_s * (1.0 + 1.0 / max(alpha - 1.0, 0.1))
    base = model.base_median_s * math.exp(model.base_sigma ** 2 / 2.0)
    return RequestFit(base_s=base, throughput_Bps=model.throughput_Bps,
                      tail_s=model.straggler_prob * stall, samples=0)


def _fit_requests(samples: list[tuple[int, float]], default: RequestFit
                  ) -> RequestFit:
    """Median-based linear fit of (nbytes, duration) pairs."""
    if len(samples) < MIN_SAMPLES:
        return default
    b = np.asarray([s[0] for s in samples], np.float64)
    d = np.asarray([s[1] for s in samples], np.float64)
    cut = float(np.median(b))
    lo, hi = b <= cut, b > cut
    spread = float(b[hi].mean() - b[lo].mean()) if hi.any() and lo.any() \
        else 0.0
    if spread > 1024.0:
        slope = (float(np.median(d[hi])) - float(np.median(d[lo]))) / spread
        slope = min(max(slope, 1e-12), 1e-3)    # [1 KB/s, 1 TB/s]
    else:
        slope = 1.0 / default.throughput_Bps    # sizes too uniform to fit
    resid = d - b * slope
    base = max(float(np.median(resid)), 1e-6)
    # winsorize the surcharge at p95 so one multi-second Pareto stall in a
    # short probe cannot dominate the fitted mean
    surcharge = np.minimum(resid - base, np.percentile(resid - base, 95.0))
    tail = max(float(surcharge.mean()), 0.0)
    return RequestFit(base_s=base, throughput_Bps=1.0 / slope, tail_s=tail,
                      samples=len(samples))


def fit_request_samples(samples: list[tuple[int, float]],
                        model: LatencyModel) -> RequestFit:
    """Public fitting entry point: the same median-based robust fit the
    probe calibration uses, over any (nbytes, duration) sample list, with
    ``model`` supplying the analytic fallback below :data:`MIN_SAMPLES`.
    The live drift detector (``repro_torch.obs.drift``) refits rolling windows
    through this, so a drift verdict compares like with like — identical
    estimator on both sides of the reference."""
    return _fit_requests(list(samples), _default_fit(model))


def calibrate(summary: dict, *, probe_rsm: bool = True,
              probe_wsm: bool = True) -> Calibration:
    """Fit a :class:`Calibration` from ``Coordinator.event_summary()``.

    ``probe_rsm`` / ``probe_wsm`` record the straggler policy the probe ran
    under, so the model can re-scale the fitted tail for configs that
    toggle mitigation. Short or empty logs fall back to the analytic
    constants (``from_defaults=True``) rather than crashing.
    """
    gets = summary.get("get_samples", [])
    puts = summary.get("put_samples", [])
    get_default = _default_fit(S3_GET_MODEL)
    put_default = _default_fit(S3_PUT_MODEL)
    get_fit = _fit_requests(gets, get_default)
    put_fit = _fit_requests(puts, put_default)
    n_get = max(summary.get("get_issues", 0), 1)
    n_put = max(summary.get("put_issues", 0), 1)
    # §3 fault-path rates: attempts = observed tasks + task-level retries
    # (every re-dispatch is one more attempt at an invoke / worker run)
    tasks = sum(prof.get("tasks", 0)
                for prof in summary.get("stages", {}).values())
    attempts = max(tasks + summary.get("task_retries", 0), 1)
    cold_starts = summary.get("cold_starts", 0)
    return Calibration(
        get=get_fit, put=put_fit,
        dup_get_rate=summary.get("dup_gets", 0) / n_get,
        dup_put_rate=summary.get("dup_puts", 0) / n_put,
        polls_per_get=summary.get("polls", 0) / n_get,
        invoke_overhead_s=INVOKE_OVERHEAD_S,
        probe_rsm=probe_rsm, probe_wsm=probe_wsm,
        # ANY un-fitted side means the calibration is partly analytic;
        # per-side provenance is in get.samples / put.samples
        from_defaults=(get_fit.samples == 0 or put_fit.samples == 0),
        invoke_fail_rate=min(summary.get("invoke_fails", 0) / attempts,
                             0.9),
        worker_loss_rate=min(summary.get("worker_losses", 0) / attempts,
                             0.9),
        get_fail_rate=min(summary.get("get_fails", 0) / n_get, 0.9),
        put_fail_rate=min(summary.get("put_fails", 0) / n_put, 0.9),
        cold_rate=min(cold_starts / attempts, 1.0),
        cold_overhead_s=summary.get("cold_s", 0.0) / max(cold_starts, 1))
