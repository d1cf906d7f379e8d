"""Fault & cold-start subsystem (paper §3): seeded fault injection
(:mod:`repro_torch.faults.inject`), retry budgets
(:mod:`repro_torch.faults.retry`) and cold starts
(:mod:`repro_torch.faults.coldstart`). Journaled coordinator failover
(``faults/journal.py``) waits for a later slice of the port."""
from repro_torch.faults.coldstart import ColdStartConfig
from repro_torch.faults.inject import FaultConfig, FaultInjector
from repro_torch.faults.retry import RetryPolicy

__all__ = ["ColdStartConfig", "FaultConfig", "FaultInjector", "RetryPolicy"]
