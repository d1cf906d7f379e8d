"""Dollar-cost model (paper §6, July-2019 prices).

Lambda: $0.0000166667 per GB-second + $0.20 per 1M invocations; Starling
workers are ~3GB / 2 vCPU. S3: GET $0.0004/1k, PUT $0.005/1k (store.py).
Coordinator: one small VM, $8/day. Provisioned comparisons (Fig 7/10):
on-demand hourly rates for the paper's configurations.
"""
from __future__ import annotations

import dataclasses

LAMBDA_GB_S = 0.0000166667
LAMBDA_PER_REQ = 0.20 / 1e6
WORKER_MEM_GB = 3.0
COORDINATOR_PER_DAY = 8.0

# provisioned systems (paper §6.1): $/hr, node count
PROVISIONED = {
    "redshift-dc-dk": {"rate": 4.80, "nodes": 4},
    "redshift-dc-dd": {"rate": 4.80, "nodes": 4},
    "redshift-ds-dk": {"rate": 6.80, "nodes": 4},
    "redshift-ds-dd": {"rate": 6.80, "nodes": 4},
    "spectrum": {"rate": 4.80, "nodes": 4, "scan_per_tb": 5.0},
    "presto-4": {"rate": 2.128, "nodes": 5},
    "presto-16": {"rate": 2.128, "nodes": 17},
}
ATHENA_PER_TB = 5.0


@dataclasses.dataclass
class QueryCost:
    lambda_gb_s: float
    invocations: int
    gets: int
    puts: int

    @property
    def lambda_cost(self) -> float:
        return (self.lambda_gb_s * LAMBDA_GB_S
                + self.invocations * LAMBDA_PER_REQ)

    @property
    def s3_cost(self) -> float:
        from repro_torch.objectstore.store import GET_PRICE, PUT_PRICE
        return self.gets * GET_PRICE + self.puts * PUT_PRICE

    @property
    def total(self) -> float:
        return self.lambda_cost + self.s3_cost


# ---------------------------------------------------------------------------
# daily-cost curves (Figs 7/10/14): ONE API for Starling and every
# provisioned config, parameterized by the workload's inter-arrival time.
# The workload subsystem (repro_torch.workload.pricing) builds its frontier on
# these; keep closed forms here so tests can cross-check numeric solvers.
# ---------------------------------------------------------------------------

STARLING = "starling"


def queries_per_day(interarrival_s: float) -> float:
    return 86400.0 / max(interarrival_s, 1e-9)


def daily_cost(system: str, interarrival_s: float, *,
               cost_per_query: float = 0.0, scan_tb: float = 0.0) -> float:
    """$/day to serve one query every ``interarrival_s`` seconds.

    ``system`` is ``"starling"`` or a ``PROVISIONED`` key. Starling pays
    the coordinator VM plus a purely per-query cost (``cost_per_query``,
    measured by the engine); a provisioned cluster bills flat while idle,
    plus any per-TB scan charge (Spectrum/Athena-style) per query.
    """
    qpd = queries_per_day(interarrival_s)
    if system == STARLING:
        return COORDINATOR_PER_DAY + cost_per_query * qpd
    p = PROVISIONED[system]
    return p["rate"] * p["nodes"] * 24.0 \
        + p.get("scan_per_tb", 0.0) * scan_tb * qpd


def daily_cost_curve(system: str, interarrivals, *,
                     cost_per_query: float = 0.0, scan_tb: float = 0.0
                     ) -> list[float]:
    return [daily_cost(system, ia, cost_per_query=cost_per_query,
                       scan_tb=scan_tb) for ia in interarrivals]


def break_even_interarrival(system: str, cost_per_query: float,
                            scan_tb: float = 0.0) -> float:
    """Closed form: the inter-arrival time above which Starling's daily
    cost drops below ``system``'s (Fig 7's crossover). 0.0 means Starling
    is always cheaper; ``inf`` means never (coordinator VM alone exceeds
    the cluster)."""
    p = PROVISIONED[system]
    flat = p["rate"] * p["nodes"] * 24.0 - COORDINATOR_PER_DAY
    marginal = cost_per_query - p.get("scan_per_tb", 0.0) * scan_tb
    if marginal <= 0:
        return 0.0
    if flat <= 0:
        return float("inf")
    return 86400.0 * marginal / flat


def starling_daily_cost(cost_per_query: float, queries_per_hour: float
                        ) -> float:
    return daily_cost(STARLING, 3600.0 / max(queries_per_hour, 1e-9),
                      cost_per_query=cost_per_query)


def provisioned_daily_cost(system: str) -> float:
    return daily_cost(system, float("inf"))


def provisioned_cost_per_query(system: str, interarrival_s: float,
                               scan_tb: float = 0.0) -> float:
    """Cost attributed to one query when queries arrive every
    `interarrival_s` seconds (the cluster bills while idle too)."""
    return daily_cost(system, interarrival_s, scan_tb=scan_tb) \
        / queries_per_day(interarrival_s)


def max_queries_per_hour(latency_s: float) -> float:
    """Back-to-back ceiling (the line-length in Fig 7)."""
    return 3600.0 / max(latency_s, 1e-9)
