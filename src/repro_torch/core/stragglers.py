"""Straggler mitigation (paper §5): model-driven duplicate requests.

Expected response time model (§5.1):  r = l + b / (t * c)
with l = 15 ms, t = 150 MB/s for Lambda<->S3, c = concurrent readers.

RSM (reads): if a GET exceeds ``factor * r``, open a second connection and
take whichever finishes first (power of two choices).

WSM (writes, §5.2): same duplicate strategy but with TWO timers — the
overall model above, plus a *post-send* timer with its own (much faster)
parameters, because most write stragglers happen after the body reached S3.

Doublewrite (§3.3.1): write the object under two keys; readers fall back to
the second key, cutting the visibility-lag tail.

These are pure functions over sampled latencies so the same policy code
drives both the microbenchmarks (Figs 5/6) and the virtual-time query
executor.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.objectstore.latency import LatencyModel


@dataclasses.dataclass(frozen=True)
class RSMPolicy:
    enabled: bool = True
    factor: float = 4.0              # duplicate when t > factor * expected
    latency_s: float = 0.015         # l: measured in the paper
    throughput_Bps: float = 150e6    # t

    def expected(self, nbytes: int, concurrency: int = 1) -> float:
        return self.latency_s + nbytes / (self.throughput_Bps
                                          * max(concurrency, 1))

    def timeout_s(self, nbytes: int, concurrency: int = 1) -> float:
        """Virtual time after issue at which the duplicate GET fires: the
        coordinator arms a DUP_FIRE heap event at issue + this."""
        return self.factor * self.expected(nbytes, concurrency)

    def completion(self, model: LatencyModel, nbytes: int, concurrency: int,
                   rng: np.random.Generator) -> tuple[float, int]:
        """(completion time, number of GET requests). ``concurrency`` both
        relaxes the §5.1 timeout and (past the NIC saturation point, Fig 3)
        slows the sampled streaming term via the aggregate read cap."""
        t1 = model.sample(nbytes, rng, concurrency)
        if not self.enabled:
            return t1, 1
        timeout = self.timeout_s(nbytes, concurrency)
        if t1 <= timeout:
            return t1, 1
        t2 = model.sample(nbytes, rng, concurrency)
        return min(t1, timeout + t2), 2


@dataclasses.dataclass(frozen=True)
class WSMPolicy:
    enabled: bool = True
    post_send_timer: bool = True     # the second (post-send) model of §5.2
    factor: float = 3.0
    latency_s: float = 0.030
    throughput_Bps: float = 150e6    # client->S3 streaming
    post_latency_s: float = 0.050    # S3-internal processing expectation
    post_factor: float = 3.0

    def expected(self, nbytes: int) -> float:
        return self.latency_s + nbytes / self.throughput_Bps

    def dup_start_s(self, send_s: float, nbytes: int) -> float:
        """Virtual time after issue at which the duplicate PUT fires (§5.2):
        the min of the overall response-time timer and the post-send timer
        (armed when the body finished streaming at ``send_s``). This is the
        coordinator's DUP_FIRE heap-event offset for writes."""
        start2 = self.factor * self.expected(nbytes)
        if self.post_send_timer:
            start2 = min(start2,
                         send_s + self.post_factor * self.post_latency_s)
        return start2

    def completion(self, model: LatencyModel, nbytes: int,
                   rng: np.random.Generator) -> tuple[float, int]:
        """(completion time, number of PUT requests)."""
        send1, post1 = model.sample_phases(nbytes, rng)
        t1 = send1 + post1
        if not self.enabled:
            return t1, 1
        start2 = self.dup_start_s(send1, nbytes)
        if t1 <= start2:
            return t1, 1
        send2, post2 = model.sample_phases(nbytes, rng)
        return min(t1, start2 + send2 + post2), 2


@dataclasses.dataclass(frozen=True)
class StragglerConfig:
    rsm: RSMPolicy = RSMPolicy()
    wsm: WSMPolicy = WSMPolicy()
    doublewrite: bool = True
    parallel_reads: int = 16
    pipeline_fraction: float = 0.8   # start consumers at this producer frac
    pipelining: bool = True
    # task-level backup (power of two choices on whole workers)
    backup_tasks: bool = True
    backup_factor: float = 2.5       # duplicate tasks slower than f x median
    backup_quorum: float = 0.5       # stage fraction done before the
    #                                  coordinator estimates the median and
    #                                  arms BACKUP_FIRE timers (event loop)

    @staticmethod
    def all_off() -> "StragglerConfig":
        return StragglerConfig(rsm=RSMPolicy(enabled=False),
                               wsm=WSMPolicy(enabled=False),
                               doublewrite=False, parallel_reads=1,
                               pipelining=False, backup_tasks=False)
