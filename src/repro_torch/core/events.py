"""Batched event core: the scheduler's priority queue at fleet scale.

The coordinator's event loop (core.coordinator) was built on a ``heapq``
of Python tuples ``(t, kind, ridx, sidx, tidx, rq)``. That is exact and
fast at 8 concurrent queries, but at fleet scale (ROADMAP item 1:
thousands of tenant streams, ~10^6 events/day) every push/pop pays
O(log n) *tuple* comparisons over a heap of boxed Python objects — the
hot GET/PUT issue/done events dominate that cost.

:class:`EventQueue` replaces the tuple heap with a two-level batched
representation while preserving the EXACT pop order (so every committed
baseline stays bit-identical — see the equivalence property test in
tests/test_tenancy.py):

  * **near** — a small bounded ``heapq`` of tuples that absorbs pushes
    (O(log NEAR_LIMIT), constant-bounded comparisons);
  * **far** — the backlog as two parallel numpy arrays: ``t`` (float64)
    and a single ``u64`` packing ``(kind, ridx, sidx, tidx, rq+1)`` in
    lexicographic bit order. When *near* fills up it is flushed and
    merged into *far* with one vectorized ``np.lexsort`` — amortizing
    the backlog's ordering cost into cache-friendly batch sorts instead
    of per-event pointer chasing. Pops from *far* are O(1) index bumps.

Order equivalence: ``heapq`` pops tuples in ascending lexicographic
order; *far* is sorted by ``(t, packed)`` and the packing is a
monotone bijection of ``(kind, ridx, sidx, tidx, rq)``, so interleaving
``min(near[0], far_head)`` reproduces the single-heap order exactly
(ties between *near* and *far* can only be byte-identical events, for
which either choice is the same event).

Packing layout (64 bits): kind:4 | ridx:22 | sidx:10 | tidx:14 | rq+1:14.
Bounds are asserted on push — a plan exceeding them (e.g. >16383 tasks
per stage) fails loudly rather than silently mis-ordering.
"""
from __future__ import annotations

import heapq

import numpy as np

NEAR_LIMIT = 2048        # near-heap flush threshold (bounds comparisons)

_KIND_BITS, _RIDX_BITS, _SIDX_BITS, _TIDX_BITS, _RQ_BITS = 4, 22, 10, 14, 14
_RIDX_SHIFT = _SIDX_BITS + _TIDX_BITS + _RQ_BITS          # 38
_SIDX_SHIFT = _TIDX_BITS + _RQ_BITS                       # 24 + 14 = 28
_TIDX_SHIFT = _RQ_BITS                                    # 14
_KIND_SHIFT = _RIDX_SHIFT + _RIDX_BITS                    # 60
_MASK = {"kind": (1 << _KIND_BITS) - 1, "ridx": (1 << _RIDX_BITS) - 1,
         "sidx": (1 << _SIDX_BITS) - 1, "tidx": (1 << _TIDX_BITS) - 1,
         "rq": (1 << _RQ_BITS) - 1}


class EventQueue:
    """Drop-in replacement for the coordinator's tuple heap.

    API: ``push(t, kind, ridx, sidx, tidx, rq)``, ``pop() -> tuple``,
    ``peek_t() -> float``, ``__len__``/``__bool__``; ``popped`` counts
    total pops (the tenancy benchmark's events/sec numerator) and
    ``depth_hwm`` the high-water queue depth (the obs layer's backlog
    gauge — how deep the scheduler's future ever got).
    """

    __slots__ = ("_near", "_far_t", "_far_pk", "_lo", "_fhead", "popped",
                 "depth_hwm")

    def __init__(self):
        self._near: list[tuple] = []          # heapq of event tuples
        self._far_t = np.empty(0, np.float64)  # sorted backlog: times
        self._far_pk = np.empty(0, np.uint64)  # sorted backlog: packed ids
        self._lo = 0                           # backlog consume index
        self._fhead: tuple | None = None       # cached backlog head tuple
        self.popped = 0
        self.depth_hwm = 0

    # ------------------------------------------------------------- sizing
    def __len__(self) -> int:
        return len(self._near) + (len(self._far_t) - self._lo)

    def __bool__(self) -> bool:
        return bool(self._near) or self._lo < len(self._far_t)

    # -------------------------------------------------------------- push
    def push(self, t: float, kind: int, ridx: int, sidx: int, tidx: int,
             rq: int):
        if not (0 <= kind <= _MASK["kind"] and 0 <= ridx <= _MASK["ridx"]
                and 0 <= sidx <= _MASK["sidx"]
                and 0 <= tidx <= _MASK["tidx"]
                and -1 <= rq < _MASK["rq"]):
            raise ValueError(
                f"event field out of packed range: kind={kind} ridx={ridx} "
                f"sidx={sidx} tidx={tidx} rq={rq} (see events.py layout)")
        heapq.heappush(self._near, (t, kind, ridx, sidx, tidx, rq))
        depth = len(self._near) + (len(self._far_t) - self._lo)
        if depth > self.depth_hwm:
            self.depth_hwm = depth
        if len(self._near) >= NEAR_LIMIT:
            self._flush()

    # ------------------------------------------------------------ batching
    def _flush(self):
        """Merge the whole near heap into the far backlog with one
        vectorized lexsort (the numpy batch path)."""
        near = self._near
        self._near = []
        n = len(near)
        t = np.fromiter((e[0] for e in near), np.float64, count=n)
        pk = np.fromiter(
            ((e[1] << _KIND_SHIFT) | (e[2] << _RIDX_SHIFT)
             | (e[3] << _SIDX_SHIFT) | (e[4] << _TIDX_SHIFT) | (e[5] + 1)
             for e in near), np.uint64, count=n)
        if self._lo < len(self._far_t):
            t = np.concatenate([self._far_t[self._lo:], t])
            pk = np.concatenate([self._far_pk[self._lo:], pk])
        order = np.lexsort((pk, t))
        self._far_t = t[order]
        self._far_pk = pk[order]
        self._lo = 0
        self._cache_head()

    def _cache_head(self):
        if self._lo < len(self._far_t):
            pk = int(self._far_pk[self._lo])
            self._fhead = (float(self._far_t[self._lo]),
                           pk >> _KIND_SHIFT,
                           (pk >> _RIDX_SHIFT) & _MASK["ridx"],
                           (pk >> _SIDX_SHIFT) & _MASK["sidx"],
                           (pk >> _TIDX_SHIFT) & _MASK["tidx"],
                           (pk & _MASK["rq"]) - 1)
        else:
            self._fhead = None

    # --------------------------------------------------------------- pop
    def peek_t(self) -> float:
        """Virtual time of the next event (queue must be non-empty)."""
        if self._near:
            if self._fhead is None:
                return self._near[0][0]
            return min(self._near[0][0], self._fhead[0])
        return self._fhead[0]

    def pop(self) -> tuple:
        """Pop the globally smallest event (heap tuple order)."""
        self.popped += 1
        head = self._fhead
        if self._near and (head is None or self._near[0] <= head):
            return heapq.heappop(self._near)
        self._lo += 1
        self._cache_head()
        return head
