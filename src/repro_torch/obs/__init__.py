"""Observability over the event engine (tracing, metrics, drift, reports).

The coordinator exposes a read-only observer hook: every logged event
tuple plus lifecycle kinds (QUERY_START .. QUERY_DONE) stream to
attached observers at the event pop, and observers never feed anything
back — so results are bit-identical with observability on or off (the
no-perturbation contract, gated by ``benchmarks/obs.py``). Four
consumers of that stream live here:

  * :mod:`repro_torch.obs.trace` — causal span trees (query -> stage -> task
    -> request attempt) with Chrome ``trace_event`` export for
    chrome://tracing / Perfetto;
  * :mod:`repro_torch.obs.metrics` — streaming counters/gauges and mergeable
    log-scale histograms (percentiles without stored samples), memory-
    bounded at fleet scale where the legacy ``event_log`` list is not;
  * :mod:`repro_torch.obs.drift` — rolling-window refits of the GET/PUT
    latency params against a ``planner.calibrate.Calibration``
    reference, flagging regime shifts for the adaptive control plane
    (ROADMAP item 2a);
  * :mod:`repro_torch.obs.report` — per-tenant / per-query-class rollups of
    workload and fleet runs, as text or JSON.
"""
from repro_torch.obs.drift import DriftDetector, DriftReport
from repro_torch.obs.metrics import (Counter, Gauge, LogHistogram,
                               MetricsObserver, MetricsRegistry)
from repro_torch.obs.report import Report, fleet_report, workload_report
from repro_torch.obs.trace import (Span, Tracer, from_chrome,
                             install_global_tracer)

__all__ = [
    "Counter", "DriftDetector", "DriftReport", "Gauge", "LogHistogram",
    "MetricsObserver", "MetricsRegistry", "Report", "Span", "Tracer",
    "fleet_report", "from_chrome", "install_global_tracer",
    "workload_report",
]
