"""Journaled coordinator failover (paper §3; ROADMAP item 4).

Starling's coordinator is a single process; if it dies mid-query the
query need not restart from scratch, because every *output* of the
computation already lives in the immutable object store — only the
scheduler's decisions must be reproducible. This module makes that
concrete with the cheapest possible journal: the coordinator's event
loop is a pure function of the seed, so the journal records only the
**event-log frontier** — a running CRC over the popped heap events,
checkpointed every ``checkpoint_every`` pops — rather than the events
themselves.

Failover = re-run the scheduler from the top and *verify* it walks the
exact same event sequence through every checkpoint recorded before the
kill. Re-executed workers overwrite their §3.2 objects with identical
bytes (``ObjectStore.verify_replay`` asserts this — immutability is what
makes the replay safe), and the resumed run's final event log and
``QueryCost`` are bit-identical to an uninterrupted run's. Divergence —
a different store, seed, or plan — raises :class:`JournalDivergence` at
the first mismatched checkpoint instead of silently producing a
different answer.
"""
from __future__ import annotations

import zlib


class CoordinatorKilled(RuntimeError):
    """Injected coordinator death (``Journal.arm_kill``)."""


class JournalDivergence(AssertionError):
    """A failover replay walked a different event sequence than the
    journal recorded — the resumed coordinator is NOT equivalent."""


class Journal:
    """Checkpointed event-log frontier for coordinator failover.

    ``observe(ev)`` is called by the coordinator at every *consumed* heap
    event pop (wall-clock-only re-pops are excluded — the journal must be
    width-invariant). Lifecycle: record during the first run; after a
    kill, ``resume()`` switches to verify mode and a fresh coordinator
    replays against the recorded checkpoints, appending new ones past the
    kill frontier.
    """

    def __init__(self, checkpoint_every: int = 64):
        self.checkpoint_every = max(int(checkpoint_every), 1)
        self.entries: list[tuple[int, int, float]] = []  # (count, crc, t)
        self.count = 0
        self.crc = 0
        self.kill_at: int | None = None
        self.replaying = False
        self._vi = 0                 # next checkpoint index to verify

    @property
    def frontier(self) -> tuple[int, int]:
        """(pops observed, running CRC) — the journal's position."""
        return self.count, self.crc

    def arm_kill(self, at_pops: int):
        """Kill the coordinator (raise :class:`CoordinatorKilled`) at the
        ``at_pops``-th observed event pop."""
        self.kill_at = int(at_pops)

    def observe(self, ev: tuple):
        self.crc = zlib.crc32(repr(ev).encode(), self.crc)
        self.count += 1
        if self.count % self.checkpoint_every == 0:
            entry = (self.count, self.crc, float(ev[0]))
            if self._vi < len(self.entries):
                if self.entries[self._vi] != entry:
                    raise JournalDivergence(
                        f"checkpoint {self._vi} mismatch at pop "
                        f"{self.count}: recorded "
                        f"{self.entries[self._vi]}, replay produced "
                        f"{entry} — the resumed coordinator diverged")
                self._vi += 1
            else:
                self.entries.append(entry)
                self._vi += 1
        if self.kill_at is not None and self.count >= self.kill_at:
            raise CoordinatorKilled(
                f"coordinator killed after {self.count} event pops "
                f"(crc {self.crc:#010x})")

    def resume(self):
        """Fail over: reset the frontier and verify the recorded
        checkpoints against a fresh coordinator's replay."""
        self.kill_at = None
        self.replaying = True
        self.count = 0
        self.crc = 0
        self._vi = 0


def run_with_failover(make_coordinator, plan: dict, *, kill_after: int,
                      checkpoint_every: int = 64):
    """Deprecated shim — the body moved to ``core.session.Session
    .failover`` (the unified Session API; ``Session.run_with_failover``
    is the instance form that spawns replacements over the session's own
    store). Kept for callers holding a coordinator factory; returns the
    same ``(result, journal)`` bit-identically."""
    from repro_torch.core.session import Session
    return Session.failover(make_coordinator, plan, kill_after=kill_after,
                            checkpoint_every=checkpoint_every)
