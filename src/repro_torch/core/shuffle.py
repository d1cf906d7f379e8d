"""Shuffle planning + request-cost model (paper §4.2, Fig 4).

Single-stage: every consumer reads from every producer object:
    reads = 2 * s * r                  (two GETs per (producer, consumer))

Multi-stage: a COMBINING stage between producers and consumers. Each
combiner reads a contiguous subset of partitions (fraction p) from a subset
of the input objects (fraction f), writing one combined partitioned object:
    reads    = 2 * (s/p + r/f)
    combiners = 1 / (p * f)
    extra writes = combiners * (2 with doublewrite)

The paper's example: s=5120, r=1280, p=1/20, f=1/64 -> $0.073 vs >$5
single-stage. ``choose_strategy`` picks the cheaper plan under the paper's
S3 prices; benchmarks/shuffle_cost.py reproduces the §4.2 arithmetic.
"""
from __future__ import annotations

import dataclasses

from repro_torch.objectstore.store import GET_PRICE, PUT_PRICE


@dataclasses.dataclass(frozen=True)
class ShufflePlan:
    strategy: str                   # "single" | "multi"
    producers: int
    consumers: int
    p: float = 1.0                  # fraction of partitions per combiner
    f: float = 1.0                  # fraction of input files per combiner

    @property
    def combiners(self) -> int:
        if self.strategy == "single":
            return 0
        return int(round(1.0 / (self.p * self.f)))

    def reads(self) -> int:
        if self.strategy == "single":
            return 2 * self.producers * self.consumers
        return int(round(2 * (self.producers / self.p
                              + self.consumers / self.f)))

    def extra_writes(self, doublewrite: bool = True) -> int:
        return self.combiners * (2 if doublewrite else 1)

    def request_cost(self, doublewrite: bool = True) -> float:
        return (self.reads() * GET_PRICE
                + self.extra_writes(doublewrite) * PUT_PRICE)


def single_stage(s: int, r: int) -> ShufflePlan:
    return ShufflePlan("single", s, r)


def multi_stage(s: int, r: int, p: float, f: float) -> ShufflePlan:
    return ShufflePlan("multi", s, r, p, f)


def choose_strategy(s: int, r: int, *, combiners: int | None = None,
                    doublewrite: bool = True) -> ShufflePlan:
    """Pick single vs multi by request cost.

    The paper typically sets #combiners == #consumers (§4.2). Given c
    combiners we balance p and f to minimize s/p + r/f subject to
    1/(p*f) = c: optimal f/p = sqrt(r*? ) — we search the divisor grid.
    """
    best = single_stage(s, r)
    c = combiners or r
    # search p = 1/a, f = 1/b with a*b = c (a partitions-splits, b file-splits)
    for a in range(1, c + 1):
        if c % a:
            continue
        b = c // a
        if a > r or b > s:
            continue
        plan = multi_stage(s, r, 1.0 / a, 1.0 / b)
        if plan.request_cost(doublewrite) < best.request_cost(doublewrite):
            best = plan
    return best


def clamped_splits(s: int, r: int, p: float, f: float) -> tuple[int, int]:
    """(partition-splits a, file-splits b) for a multi-stage shuffle, with
    degenerate fractions clamped: more partition-splits than consumers (or
    more file-splits than producers) would give zero-width ranges, i.e.
    empty combiners and partitions nobody covers. The single source of
    truth for both plan expansion and the concrete work assignment."""
    a = max(1, min(int(round(1.0 / p)), r))
    b = max(1, min(int(round(1.0 / f)), s))
    return a, b


def combiner_assignment(plan: ShufflePlan) -> list[dict]:
    """Concrete work assignment for each combining task.

    Combiner (i, j) with i in [0, 1/p), j in [0, 1/f): reads partition run
    [i * r*p, (i+1) * r*p) from input files [j * s*f, (j+1) * s*f).
    """
    assert plan.strategy == "multi"
    a, b = clamped_splits(plan.producers, plan.consumers, plan.p, plan.f)
    parts_per = plan.consumers // a
    files_per = plan.producers // b
    out = []
    for i in range(a):
        for j in range(b):
            out.append({
                "combiner": i * b + j,
                "partitions": (i * parts_per,
                               plan.consumers if i == a - 1
                               else (i + 1) * parts_per),
                "files": (j * files_per,
                          plan.producers if j == b - 1
                          else (j + 1) * files_per),
            })
    return out
