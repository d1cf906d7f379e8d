"""Virtual-time store client: real bytes, simulated request timing.

Workers exchange REAL data through the ObjectStore, but request *timing* is
tracked in virtual seconds, so end-to-end query runs are exact in structure
and cost yet fast in wall-clock. The client has two modes:

  * **Recording mode** (``timeline`` set — how ``core.worker`` runs): every
    GET/PUT moves its real bytes immediately and is appended to a
    :class:`RequestTimeline` instead of being timed here. The coordinator's
    discrete-event scheduler (core/coordinator) replays that timeline as
    first-class heap events — GET_ISSUE/GET_DONE/PUT_ISSUE/PUT_DONE — so
    RSM/WSM duplicates preempt mid-request, §3.3 parallel-read lanes are a
    schedulable resource, and §3.3.1 visibility lag becomes a VISIBLE_AT
    event rather than an in-task poll loop.
  * **Sampling mode** (``timeline`` None — runtime/* checkpoint + data
    loaders): the legacy self-contained path; latencies are sampled here and
    composed into a completion time, with parallel reads scheduled onto
    ``parallel_reads`` lanes and visibility polls billed inline.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.stragglers import StragglerConfig
from repro_torch.objectstore.latency import poll_until_visible, visible_twin
from repro_torch.objectstore.store import ObjectStore


@dataclasses.dataclass
class ReadReq:
    key: str
    start: int | None = None
    end: int | None = None
    available_at: float = 0.0        # producer virtual end time
    alt_key: str | None = None       # doublewrite fallback
    src: tuple[str, int] | None = None   # (producer stage, task): resolve
    #                                      available_at from that task's
    #                                      scheduled end (recording mode)


@dataclasses.dataclass
class GetSpec:
    """One recorded GET: bytes already moved, timing decided by the
    scheduler. ``src`` defers the availability time to the producer task's
    virtual end (known only once the event heap advances past it)."""
    key: str
    alt_key: str | None
    nbytes: int
    avail: float
    src: tuple[str, int] | None = None


@dataclasses.dataclass
class PutSpec:
    """One recorded PUT. ``nbytes`` is the billed/modeled size — at least
    the real payload, optionally floored higher (``out_bytes_floor`` stage
    option) so scaled-down datasets still exercise the paper's 100MB-class
    write tails."""
    key: str
    nbytes: int


class RequestTimeline:
    """Ordered I/O phases of one task, consumed by the event scheduler.

    Phases (barriered: phase k+1 issues only once phase k completed —
    body reads need header bytes, the PUT needs the computed output):
      ``("gets", [GetSpec, ...], concurrency)`` — one batch of reads,
      scheduled onto the per-task lane pool;
      ``("compute", seconds)`` — measured operator time;
      ``("puts", [PutSpec, ...])`` — output write (+ doublewrite twin,
      issued in parallel).
    """

    def __init__(self):
        self.phases: list[tuple] = []

    def record_gets(self, specs: list[GetSpec], concurrency: int):
        if specs:
            self.phases.append(("gets", specs, concurrency))

    def record_compute(self, seconds: float):
        if seconds > 0.0:
            self.phases.append(("compute", seconds))

    def record_puts(self, specs: list[PutSpec]):
        if specs:
            self.phases.append(("puts", specs))


class StoreClient:
    """One per worker-task; accumulates request counts and either records
    (timeline mode) or samples (legacy mode) virtual request timing."""

    def __init__(self, store: ObjectStore, policy: StragglerConfig,
                 rng: np.random.Generator,
                 timeline: RequestTimeline | None = None):
        self.store = store
        self.policy = policy
        self.rng = rng
        self.timeline = timeline
        self.gets = 0
        self.puts = 0
        # column segments decoded by this client's task (recording mode):
        # worker._read_partitions bumps it so projection pushdown is
        # observable per task — a one-column aggregate reads exactly 1
        self.columns_read = 0

    # ------------------------------------------------------------------ read
    def _one_get(self, req: ReadReq, t_start: float, concurrency: int
                 ) -> tuple[bytes, float]:
        """Sampling mode only. Returns (data, completion_time)."""
        avail = req.available_at
        # visibility lag is PER OBJECT (all readers of a lagging key stall);
        # doublewrite readers fall back to the twin -> min of the two lags
        _target, lag = visible_twin(req.key, req.alt_key,
                                    self.store.config.seed)
        # poll until visible (polls are GETs that return 404 -> still billed)
        polls, tt = poll_until_visible(t_start, avail, lag)
        nbytes = self.store.size(req.key) if req.start is None \
            else (req.end - (req.start or 0))
        dur, nreq = self.policy.rsm.completion(
            self.store.config.get_model, nbytes, concurrency, self.rng)
        self.gets += nreq + polls
        data = self.store.get(req.key, req.start, req.end)
        return data, tt + dur

    def read_many(self, reqs: list[ReadReq], now: float
                  ) -> tuple[list[bytes], float]:
        """Parallel reads on `parallel_reads` lanes. Returns (datas, end).

        Recording mode: the real bytes move now; the batch is appended to
        the timeline and the returned end time is the placeholder ``now``
        (the scheduler owns timing)."""
        conc = min(len(reqs), max(self.policy.parallel_reads, 1)) or 1
        if self.timeline is not None:
            datas, specs = [], []
            for req in reqs:
                data = self.store.get(req.key, req.start, req.end)
                datas.append(data)
                self.gets += 1
                specs.append(GetSpec(req.key, req.alt_key, len(data),
                                     req.available_at, req.src))
            self.timeline.record_gets(specs, conc)
            return datas, now
        lanes = [now] * max(self.policy.parallel_reads, 1)
        out: list[bytes] = []
        end = now
        for i, req in enumerate(reqs):
            lane = i % len(lanes)
            data, done = self._one_get(req, lanes[lane], conc)
            lanes[lane] = done
            end = max(end, done)
            out.append(data)
        return out, end

    # ----------------------------------------------------------------- write
    def write(self, key: str, data: bytes, now: float, *,
              if_none_match: bool = False,
              bill_nbytes: int | None = None) -> float:
        """PUT with WSM (+doublewrite). Returns completion time.

        Recording mode: writes the real bytes (and the ``.dw`` twin) now,
        records the PUT(s) — modeled at ``max(len(data), bill_nbytes)`` —
        and returns the placeholder ``now``."""
        if self.timeline is not None:
            wrote = self.store.put(key, data, if_none_match=if_none_match)
            self.puts += 1
            nbytes = max(len(data), bill_nbytes or 0)
            specs = [PutSpec(key, nbytes)]
            if self.policy.doublewrite and wrote:
                self.store.put(key + ".dw", data,
                               if_none_match=if_none_match)
                self.puts += 1
                specs.append(PutSpec(key + ".dw", nbytes))
            self.timeline.record_puts(specs)
            return now
        dur, nreq = self.policy.wsm.completion(
            self.store.config.put_model, len(data), self.rng)
        self.puts += nreq
        wrote = self.store.put(key, data, if_none_match=if_none_match)
        end = now + dur
        if self.policy.doublewrite and wrote:
            dur2, nreq2 = self.policy.wsm.completion(
                self.store.config.put_model, len(data), self.rng)
            self.puts += nreq2
            self.store.put(key + ".dw", data, if_none_match=if_none_match)
            end = max(end, now + dur2)                   # both in parallel
        return end

    def stats(self) -> dict:
        return {"gets": self.gets, "puts": self.puts,
                "columns_read": self.columns_read}
