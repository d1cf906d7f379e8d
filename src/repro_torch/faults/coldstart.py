"""Warm-pool cold-start model (Lambada/Müller et al.; ROADMAP item 4).

Invoke latency on FaaS is bimodal: a *warm* slot (container reused
within the platform's keep-alive window) starts in tens of
milliseconds; a *cold* one pays container + runtime startup — hundreds
of milliseconds, heavy-tailed. The coordinator models the warm pool as
a state machine over its invocation slots: each slot remembers when it
was last released, and a claim is COLD iff the slot was never used
before or sat idle past ``keepalive_s``. Bursty arrivals therefore pay
cold-start *waves* — the first wave of a burst after an idle gap is
cold, the rest of the burst reuses warm slots.

Cold extras are sampled from an RNG keyed on (seed, query, stage, task,
attempt) — never on wall clock or slot-claim order — so cold waves are
bit-identical across executor widths.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ColdStartConfig:
    enabled: bool = True
    keepalive_s: float = 300.0       # platform keep-alive window
    # warm-path invoke overhead; defaults to the coordinator's
    # INVOKE_OVERHEAD_S so disabling cold starts is a strict no-op
    warm_overhead_s: float = 0.030
    cold_median_s: float = 0.25      # median cold-start extra
    cold_sigma: float = 0.6          # lognormal spread of the extra

    def sample_cold_s(self, rng: np.random.Generator) -> float:
        """Cold-start extra (added on top of ``warm_overhead_s``)."""
        return self.cold_median_s * float(rng.lognormal(0.0,
                                                        self.cold_sigma))
