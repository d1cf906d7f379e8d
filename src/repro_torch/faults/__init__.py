"""Fault & cold-start subsystem (paper §3, ROADMAP item 4).

The paper's fault-tolerance story is structural: workers are stateless
and intermediates are immutable §3.2 partitioned objects, so ANY failed
unit of work — an invoke API call, a single GET/PUT, a whole worker —
can simply be retried, and a replay can never corrupt state (a re-run
writes the same bytes; ``ObjectStore.verify_replay`` asserts exactly
that). This package turns that story into schedulable, priced events:

  * :mod:`repro_torch.faults.inject` — seeded, width-invariant fault injector:
    configurable rates become deterministic per-(request, attempt)
    outcomes, surfaced to the coordinator as ``INVOKE_FAIL`` /
    ``RETRY_FIRE`` heap events;
  * :mod:`repro_torch.faults.retry` — exponential-backoff retry budgets (the
    planner's ``PlanConfig.retry_budget`` axis maps onto
    ``RetryPolicy.max_attempts``);
  * :mod:`repro_torch.faults.coldstart` — bimodal invoke latency from a
    warm-pool state machine keyed on slot-reuse recency, so bursty
    arrivals pay cold-start waves;
  * :mod:`repro_torch.faults.journal` — journaled coordinator failover: the
    scheduler checkpoints its event-log frontier and a mid-query kill
    resumes to a bit-identical final event log and ``QueryCost``.

The planner prices all of it: ``planner.calibrate`` fits the rates from
``Coordinator.event_summary()`` and ``planner.model`` prices expected
retries and cold-start pad the way it prices RSM/WSM.
"""
from repro_torch.faults.coldstart import ColdStartConfig
from repro_torch.faults.inject import FaultConfig, FaultInjector
from repro_torch.faults.journal import (CoordinatorKilled, Journal,
                                  JournalDivergence, run_with_failover)
from repro_torch.faults.retry import RetryPolicy

__all__ = ["ColdStartConfig", "CoordinatorKilled", "FaultConfig",
           "FaultInjector", "Journal", "JournalDivergence", "RetryPolicy",
           "run_with_failover"]
