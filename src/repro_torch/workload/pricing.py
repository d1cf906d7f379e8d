"""Break-even pricing frontier (paper §6.3, Figs 7 and 14).

The paper's headline claim is economic: Starling is cheaper than the best
provisioned configurations "when queries arrive one minute apart or more".
This module turns a measured workload (mean $/query from
``WorkloadDriver``) into that figure: daily-cost curves vs inter-arrival
time for Starling and every ``PROVISIONED`` config, per-system break-even
points (bisection on the same ``core.cost.daily_cost`` curves the plots
use — cross-checked in tests against the closed form
``core.cost.break_even_interarrival``), and the overall frontier
threshold: the inter-arrival time above which Starling undercuts *every*
provisioned config.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.cost import PROVISIONED, STARLING, daily_cost

DEFAULT_INTERARRIVALS = tuple(float(x) for x in
                              np.geomspace(1.0, 7200.0, 49))


@dataclasses.dataclass(frozen=True)
class Frontier:
    """Fig-7-style frontier: curves + break-even points."""
    cost_per_query: float
    interarrivals: tuple[float, ...]
    curves: dict                  # system -> daily-$ list ("starling" too)
    break_even_s: dict            # provisioned system -> inter-arrival
    threshold_s: float            # Starling cheapest beyond this
    scan_tb: float = 0.0          # per-query scan volume (Spectrum/Athena)

    def daily(self, system: str, interarrival_s: float) -> float:
        return daily_cost(system, interarrival_s,
                          cost_per_query=self.cost_per_query,
                          scan_tb=self.scan_tb)

    def cheapest_at(self, interarrival_s: float) -> str:
        return min(self.curves,
                   key=lambda s: self.daily(s, interarrival_s))


def solve_break_even(system: str, cost_per_query: float, *,
                     scan_tb: float = 0.0, tol: float = 1e-9) -> float:
    """Numeric break-even: the inter-arrival where Starling's daily cost
    crosses ``system``'s, by bisection on ``daily_cost`` (the difference is
    monotone in 1/interarrival). Returns 0.0 / inf when there is no
    crossing (Starling always / never cheaper)."""
    def gap(ia: float) -> float:
        return daily_cost(STARLING, ia, cost_per_query=cost_per_query) \
            - daily_cost(system, ia, scan_tb=scan_tb)

    lo = 1e-6
    if gap(lo) <= 0:
        return 0.0
    hi = 1.0
    while gap(hi) > 0:
        hi *= 2.0
        if hi > 1e12:
            return math.inf
    while hi - lo > tol * max(hi, 1.0):
        mid = 0.5 * (lo + hi)
        if gap(mid) > 0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def frontier(cost_per_query: float, *, interarrivals=None,
             scan_tb: float = 0.0, systems=None) -> Frontier:
    """Daily-cost curves + break-even points for a measured $/query."""
    ias = tuple(interarrivals) if interarrivals is not None \
        else DEFAULT_INTERARRIVALS
    if any(b <= a for a, b in zip(ias, ias[1:])):
        raise ValueError("interarrivals must be strictly increasing")
    systems = list(PROVISIONED) if systems is None else list(systems)
    curves = {STARLING: [daily_cost(STARLING, ia,
                                    cost_per_query=cost_per_query)
                         for ia in ias]}
    for s in systems:
        curves[s] = [daily_cost(s, ia, scan_tb=scan_tb) for ia in ias]
    be = {s: solve_break_even(s, cost_per_query, scan_tb=scan_tb)
          for s in systems}
    return Frontier(cost_per_query, ias, curves, be,
                    max(be.values()) if be else 0.0, scan_tb)
