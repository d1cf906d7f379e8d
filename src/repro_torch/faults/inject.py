"""Seeded, width-invariant fault injection (paper §3).

A :class:`FaultInjector` turns configured *rates* into deterministic
per-(request, attempt) *outcomes*: every decision is one draw from an RNG
keyed on ``(seed, salt, query, stage, task[, request], attempt[, try])``
— never from a shared sequential stream — so the same seed produces the
same failures at any executor width, and re-asking the same question
always returns the same answer (the coordinator may probe an outcome from
more than one code path).

Three failure classes, matching the units of work the coordinator
schedules:

  * **invoke failures** — the invoke API call itself fails (throttle /
    5xx); the worker never starts, the slot is released at the detect
    time, and the attempt costs an invocation request but no runtime;
  * **worker loss** — the worker runs its full timeline but dies before
    its final conditional PUT lands; the whole attempt is billed and the
    task re-runs (a *virtual replay* of the recorded timeline — §3.2
    immutability makes the replay safe);
  * **request failures** — one GET/PUT drops mid-flight; the connection
    dies at the request's would-be completion time and only that request
    is retried.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

# key-space salts: each failure class draws from its own keyed stream so
# e.g. "does the invoke fail" never correlates with "is the worker lost"
_INVOKE_SALT = 0xFA110001
_LOSS_SALT = 0xFA110002
_REQ_SALT = 0xFA110003


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Failure rates, all per attempt/try (0.0 = that class never fires)."""
    invoke_fail_rate: float = 0.0    # P(invoke API call fails) per attempt
    worker_loss_rate: float = 0.0    # P(worker dies pre-final-PUT) / attempt
    get_fail_rate: float = 0.0       # P(one GET drops) per try
    put_fail_rate: float = 0.0       # P(one PUT drops) per try
    fail_detect_s: float = 0.010     # invoke failure: error-response time

    @property
    def enabled(self) -> bool:
        return (self.invoke_fail_rate > 0.0 or self.worker_loss_rate > 0.0
                or self.get_fail_rate > 0.0 or self.put_fail_rate > 0.0)


class FaultInjector:
    """Deterministic outcomes from :class:`FaultConfig` rates.

    Stateless by construction: outcomes are pure functions of the indices,
    so injection can never leak wall-clock scheduling order into virtual
    time (the coordinator's width-invariance contract).
    """

    def __init__(self, config: FaultConfig, seed: int = 0):
        self.config = config
        self.seed = seed

    def _draw(self, rate: float, key: list[int]) -> bool:
        if rate <= 0.0:
            return False
        return float(np.random.default_rng(key).random()) < rate

    def invoke_fails(self, run_name: str, sidx: int, tidx: int,
                     attempt: int) -> bool:
        """Does attempt ``attempt`` of task (sidx, tidx) fail to invoke?"""
        return self._draw(self.config.invoke_fail_rate,
                          [self.seed, _INVOKE_SALT,
                           zlib.crc32(run_name.encode()), sidx, tidx,
                           attempt])

    def worker_lost(self, run_name: str, sidx: int, tidx: int,
                    attempt: int) -> bool:
        """Does the worker die before its final PUT lands?"""
        return self._draw(self.config.worker_loss_rate,
                          [self.seed, _LOSS_SALT,
                           zlib.crc32(run_name.encode()), sidx, tidx,
                           attempt])

    def request_fails(self, run_name: str, sidx: int, tidx: int, rq: int,
                      attempt: int, tries: int, put: bool) -> bool:
        """Does try ``tries`` of request ``rq`` (attempt ``attempt`` of its
        task) drop mid-flight?"""
        rate = self.config.put_fail_rate if put else \
            self.config.get_fail_rate
        return self._draw(rate,
                          [self.seed, _REQ_SALT,
                           zlib.crc32(run_name.encode()), sidx, tidx, rq,
                           attempt, tries, int(put)])
