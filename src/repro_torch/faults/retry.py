"""Exponential-backoff retry budgets (paper §3).

One :class:`RetryPolicy` governs every retried unit of work — invoke
attempts, lost workers, dropped GET/PUTs. ``max_attempts`` is the *retry
budget*: a task (or request) may be attempted at most that many times
before the whole query fails (``QueryResult.failed``, the naive client
then re-runs the query from scratch — the expensive path the planner's
``PlanConfig.retry_budget`` axis exists to avoid).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 4        # total attempts per task/request
    base_backoff_s: float = 0.05  # wait before the first retry
    backoff_factor: float = 2.0   # exponential growth per failure
    max_backoff_s: float = 2.0    # cap (jitter is deliberately absent:
    #                               backoffs must be width-invariant)

    def backoff_s(self, n_failures: int) -> float:
        """Virtual seconds to wait after the ``n_failures``-th failure
        (1-indexed) before re-dispatching."""
        return min(self.base_backoff_s
                   * self.backoff_factor ** max(n_failures - 1, 0),
                   self.max_backoff_s)
