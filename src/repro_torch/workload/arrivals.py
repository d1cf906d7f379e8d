"""Arrival processes (paper §6.3/§6.5, Figs 7, 13, 14).

The paper's cost comparison sweeps the *inter-arrival time* of an open-loop
query stream (Fig 7: one query every N seconds), while its concurrency
experiment (Fig 13) runs N *closed-loop* streams that each issue the next
query as soon as the previous one returns. This module generates both:

  * open-loop generators (:func:`uniform`, :func:`poisson`, :func:`bursty`)
    return absolute arrival times in virtual seconds — ready for
    ``Coordinator.run_queries(arrival_times=...)``;
  * :func:`closed_loop` returns a :class:`ClosedLoop` spec that
    ``WorkloadDriver`` lowers onto ``run_queries``'s ``after=`` stream
    dependencies, so arrivals react to completions inside one event loop.

All randomness comes from ``np.random.default_rng`` seeded per call:
identical seeds give bit-identical workloads on any machine.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def uniform(n: int, interarrival_s: float, *, start: float = 0.0
            ) -> list[float]:
    """One query every ``interarrival_s`` seconds (Fig 7's x-axis)."""
    if n < 0 or interarrival_s < 0:
        raise ValueError("n and interarrival_s must be non-negative")
    return [start + i * interarrival_s for i in range(n)]


def poisson(n: int, mean_interarrival_s: float, *, seed: int = 0,
            start: float = 0.0) -> list[float]:
    """Poisson process: exponential gaps with the given mean (ROADMAP's
    "multi-query benchmarks beyond uniform arrival")."""
    if n < 0 or mean_interarrival_s <= 0:
        raise ValueError("need n >= 0 and mean_interarrival_s > 0")
    rng = np.random.default_rng([seed, 0x504F49])         # "POI"
    gaps = rng.exponential(mean_interarrival_s, size=n)
    return (start + np.cumsum(gaps)).tolist()


def bursty(n: int, mean_interarrival_s: float, *, on_fraction: float = 0.2,
           mean_on_s: float | None = None, seed: int = 0,
           start: float = 0.0) -> list[float]:
    """On-off modulated Poisson: bursts at rate ``1/(mean_interarrival_s *
    on_fraction)`` separated by silent periods, preserving the long-run
    mean inter-arrival. ``mean_on_s`` is the expected burst length
    (default: 8 burst arrivals' worth); on/off period lengths are
    exponential. Models the diurnal/bursty analytics traffic for which the
    paper argues serverless pricing shines."""
    if n < 0 or mean_interarrival_s <= 0 or not 0 < on_fraction <= 1:
        raise ValueError("need mean_interarrival_s > 0, 0 < on_fraction <= 1")
    rng = np.random.default_rng([seed, 0x425253])         # "BRS"
    gap_on = mean_interarrival_s * on_fraction            # gap inside bursts
    mean_on = 8.0 * gap_on if mean_on_s is None else float(mean_on_s)
    mean_off = mean_on * (1.0 - on_fraction) / on_fraction
    out: list[float] = []
    t = start
    while len(out) < n:
        on_end = t + rng.exponential(mean_on)
        while len(out) < n:
            t += rng.exponential(gap_on)
            if t > on_end:
                break
            out.append(t)
        t = on_end + rng.exponential(mean_off)
    return out


@dataclasses.dataclass(frozen=True)
class ClosedLoop:
    """N-stream closed loop (Fig 13): each stream issues its next query
    ``think_time_s`` after the previous one finishes; stream k's first
    query arrives at ``k * stagger_s``."""
    streams: int
    queries_per_stream: int
    think_time_s: float = 0.0
    stagger_s: float = 0.0

    def __post_init__(self):
        if self.streams < 1 or self.queries_per_stream < 1:
            raise ValueError("need >= 1 stream and >= 1 query per stream")
        if self.think_time_s < 0 or self.stagger_s < 0:
            raise ValueError("think/stagger times must be non-negative")

    @property
    def total(self) -> int:
        return self.streams * self.queries_per_stream

    def lower(self) -> tuple[list[float], list[tuple[int, float] | None]]:
        """(arrival_times, after) for ``Coordinator.run_queries``, laid out
        stream-major: query k of stream s is plan ``s * queries_per_stream
        + k``."""
        arrivals: list[float] = []
        after: list[tuple[int, float] | None] = []
        for s in range(self.streams):
            for k in range(self.queries_per_stream):
                i = s * self.queries_per_stream + k
                if k == 0:
                    arrivals.append(s * self.stagger_s)
                    after.append(None)
                else:
                    arrivals.append(0.0)        # ignored for after entries
                    after.append((i - 1, self.think_time_s))
        return arrivals, after


def closed_loop(streams: int, queries_per_stream: int,
                think_time_s: float = 0.0, stagger_s: float = 0.0
                ) -> ClosedLoop:
    return ClosedLoop(streams, queries_per_stream, think_time_s, stagger_s)
