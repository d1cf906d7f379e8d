"""Live drift detection on the fitted request-latency parameters.

The planner calibrates once (``planner.calibrate``) and then trusts that
:class:`~repro_torch.planner.calibrate.Calibration` forever — but a real object
store's latency regime moves (throttling, hot partitions, network
weather). :class:`DriftDetector` is a coordinator observer that keeps a
rolling window of completed GET/PUT ``(nbytes, dur)`` samples, refits
them with the *same* robust estimator the probe used
(``planner.calibrate.fit_request_samples``), and compares the refit
against the reference fit at the window's own median request size:

    stat = |fit_win.expected_s(b) - fit_ref.expected_s(b)|
           / fit_ref.expected_s(b)

A drift is flagged only after ``consecutive`` evaluations exceed the
threshold — one straggler-heavy window is weather, several in a row is a
regime. Thresholds are *seeded* from the reference's own sampling noise:
:meth:`DriftDetector.from_summary` chunks the probe's sample list into
window-sized pieces, measures the null spread of the statistic, and sets
``threshold = margin x max_null_stat`` (floored) — so the false-positive
rate is calibrated to the very probe that produced the reference, not to
a magic constant. ``benchmarks/obs.py`` gates both directions: a mid-run
2x GET base-latency shift must flag within a bounded number of queries,
and the unshifted twin run must stay silent.

Every evaluation appends a :class:`DriftReport` to ``detector.reports``
(flagged or not) — the adaptive control plane (ROADMAP item 2a) consumes
the flagged ones as recalibration triggers.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.objectstore.latency import S3_GET_MODEL, S3_PUT_MODEL
from repro_torch.planner.calibrate import (MIN_SAMPLES, Calibration, RequestFit,
                                     fit_request_samples)

#: fallback threshold when the reference has too few samples to seed one
DEFAULT_THRESHOLD = 0.25
#: no seeded threshold may sit below this (guards degenerate null spreads)
THRESHOLD_FLOOR = 0.08

_MODELS = {"get": S3_GET_MODEL, "put": S3_PUT_MODEL}


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """One rolling-window evaluation (flagged or not)."""
    side: str                   # "get" | "put"
    t: float                    # virtual time of the evaluation
    queries_seen: int           # QUERY_DONEs observed so far
    window: int                 # samples in the refit
    stat: float                 # relative drift statistic
    threshold: float
    flagged: bool               # stat exceeded threshold `consecutive`x
    fit: RequestFit             # the window's refit
    reference: RequestFit       # what it was compared against


def drift_stat(fit: RequestFit, ref: RequestFit, nbytes: float) -> float:
    """Relative change of the expected request duration at size
    ``nbytes`` — one scalar folding base, per-byte and tail drift into
    the quantity the planner actually consumes."""
    denom = ref.expected_s(nbytes)
    if denom <= 0:
        return math.inf
    return abs(fit.expected_s(nbytes) - denom) / denom


class DriftDetector:
    """Observer: rolling-window refit of GET/PUT params vs a reference.

    Evaluation cadence is per completed query (QUERY_DONE), once the
    window is full — so ``queries_seen`` in a report directly measures
    detection lag in queries, the unit the fleet operator thinks in.
    Memory is O(window).
    """

    def __init__(self, reference: Calibration, *, window: int = 192,
                 thresholds: dict[str, float] | None = None,
                 margin: float = 3.0, consecutive: int = 2,
                 on_report=None):
        if window < MIN_SAMPLES:
            raise ValueError(f"window {window} < MIN_SAMPLES "
                             f"{MIN_SAMPLES}")
        self.reference = reference
        self.window = window
        self.margin = margin
        self.consecutive = consecutive
        self.thresholds = {"get": DEFAULT_THRESHOLD,
                           "put": DEFAULT_THRESHOLD,
                           **(thresholds or {})}
        # report -> action hook (the adaptive control plane,
        # planner.adaptive): called with every DriftReport as it is
        # appended, flagged or not. The callback runs inside the
        # coordinator's event loop, so it must only RECORD state — never
        # run queries or otherwise perturb virtual time; act on what it
        # recorded after the run returns (see AdaptiveController).
        self.on_report = on_report
        self.queries_seen = 0
        self.reports: list[DriftReport] = []
        self._buf = {"get": [], "put": []}      # rolling (nbytes, dur)
        self._over = {"get": 0, "put": 0}       # consecutive exceedances
        self._flagged = {"get": False, "put": False}

    # ------------------------------------------------------- construction
    @classmethod
    def from_summary(cls, reference: Calibration, summary: dict, *,
                     window: int = 192, margin: float = 3.0,
                     consecutive: int = 2) -> "DriftDetector":
        """Seed per-side thresholds from the probe's own event summary:
        the max drift statistic over window-sized chunks of the probe's
        sample list is what sampling noise alone produces under the null;
        ``margin`` times that (floored) separates weather from regime."""
        thresholds = {}
        for side, key in (("get", "get_samples"), ("put", "put_samples")):
            samples = list(summary.get(key, []))
            ref = getattr(reference, side)
            null = []
            for i in range(0, len(samples) - window + 1, window):
                chunk = samples[i:i + window]
                fit = fit_request_samples(chunk, _MODELS[side])
                b = float(np.median([s[0] for s in chunk]))
                null.append(drift_stat(fit, ref, b))
            if null:
                thresholds[side] = max(margin * max(null),
                                       THRESHOLD_FLOOR)
        return cls(reference, window=window, thresholds=thresholds,
                   margin=margin, consecutive=consecutive)

    # ------------------------------------------------------ observer hook
    def on_event(self, t: float, kind: str, q: str, s: str, tidx: int,
                 rq: int, info: dict):
        if kind == "GET_DONE":
            self._push("get", info)
        elif kind == "PUT_DONE":
            self._push("put", info)
        elif kind == "QUERY_DONE":
            self.queries_seen += 1
            self._evaluate(t)

    def _push(self, side: str, info: dict):
        buf = self._buf[side]
        buf.append((info["nbytes"], info["dur"]))
        if len(buf) > self.window:
            del buf[:len(buf) - self.window]

    # ------------------------------------------------------- evaluation
    def _evaluate(self, t: float):
        for side in ("get", "put"):
            buf = self._buf[side]
            if len(buf) < self.window:
                continue
            ref = getattr(self.reference, side)
            fit = fit_request_samples(buf, _MODELS[side])
            b = float(np.median([s[0] for s in buf]))
            stat = drift_stat(fit, ref, b)
            thr = self.thresholds[side]
            self._over[side] = self._over[side] + 1 if stat > thr else 0
            flagged = self._over[side] >= self.consecutive
            self._flagged[side] = self._flagged[side] or flagged
            report = DriftReport(
                side=side, t=t, queries_seen=self.queries_seen,
                window=len(buf), stat=stat, threshold=thr,
                flagged=flagged, fit=fit, reference=ref)
            self.reports.append(report)
            if self.on_report is not None:
                self.on_report(report)

    # --------------------------------------------------------- verdicts
    def flagged(self, side: str | None = None) -> bool:
        if side is not None:
            return self._flagged[side]
        return any(self._flagged.values())

    def first_flag(self, side: str) -> DriftReport | None:
        """Earliest flagged report for ``side`` (None when never
        flagged) — ``.queries_seen`` is the detection point."""
        for rep in self.reports:
            if rep.side == side and rep.flagged:
                return rep
        return None
