"""Streaming metrics: counters, gauges, and log-scale histogram sketches.

The legacy telemetry path (``Coordinator(record_events=True)``) stores one
Python tuple per request event — exact, but unbounded on fleet runs. This
module keeps *aggregates only*: a :class:`LogHistogram` is a fixed array
of geometric bins covering 1 µs .. 10^6 s, so p50/p95/p99/p99.9 come from
cumulative bin counts with bounded relative error (one bin width,
``10**(1/BINS_PER_DECADE)`` ≈ 7.5%) and O(1) memory per stream. Sketches
with identical binning merge by addition — per-tenant histograms roll up
to fleet totals exactly.

:class:`MetricsObserver` adapts the coordinator's observer stream into a
:class:`MetricsRegistry`: GET/PUT latency + bytes, query latency
(per-tenant), in-flight task occupancy, admission queue depth, slot
occupancy, retries, cold starts, duplicates, visibility polls. Memory is
O(tenants × metrics), never O(events) — the 1000-stream fleet benchmark
runs with it attached.
"""
from __future__ import annotations

import math

import numpy as np

#: histogram domain: 1e-6 .. 1e6 (seconds or any positive unit)
LO, HI = 1e-6, 1e6
BINS_PER_DECADE = 32
DECADES = 12
NBINS = BINS_PER_DECADE * DECADES + 2       # + underflow + overflow
_LOG_LO = math.log10(LO)


class Counter:
    """Monotone (or at least additive) scalar."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def add(self, v: float = 1.0):
        self.value += v

    def merge(self, other: "Counter"):
        self.value += other.value


class Gauge:
    """Instantaneous level with a high-water mark."""
    __slots__ = ("value", "hwm")

    def __init__(self):
        self.value = 0.0
        self.hwm = 0.0

    def set(self, v: float):
        self.value = v
        if v > self.hwm:
            self.hwm = v

    def add(self, v: float):
        self.set(self.value + v)

    def merge(self, other: "Gauge"):
        self.value += other.value
        self.hwm = max(self.hwm, other.hwm)


class LogHistogram:
    """Fixed-bin log-scale histogram: quantiles without stored samples.

    ``record`` is O(1); ``quantile(q)`` returns the geometric midpoint of
    the bin holding the q-th count, within one bin width
    (``10**(1/32) - 1`` ≈ 7.5% relative) of the exact sample quantile.
    ``sum``/``count`` are exact. Two histograms merge by bin addition.
    """
    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        self.counts = np.zeros(NBINS, np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    @staticmethod
    def _bin(x: float) -> int:
        if x < LO:
            return 0
        if x >= HI:
            return NBINS - 1
        return 1 + int((math.log10(x) - _LOG_LO) * BINS_PER_DECADE)

    def record(self, x: float, n: int = 1):
        if x < 0 or not math.isfinite(x):
            raise ValueError(f"histogram value {x!r}")
        self.counts[self._bin(x)] += n
        self.count += n
        self.sum += x * n
        self.min = min(self.min, x)
        self.max = max(self.max, x)

    def quantile(self, q: float) -> float:
        """q in [0, 1]; NaN when empty. Clamped to observed min/max so
        p0/p100 are exact and sparse tails cannot overshoot."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q!r}")
        if self.count == 0:
            return math.nan
        rank = q * (self.count - 1)
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, rank, side="right"))
        if b <= 0:
            mid = LO
        elif b >= NBINS - 1:
            mid = HI
        else:
            lo = 10.0 ** (_LOG_LO + (b - 1) / BINS_PER_DECADE)
            mid = lo * 10.0 ** (0.5 / BINS_PER_DECADE)
        return min(max(mid, self.min), self.max)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def merge(self, other: "LogHistogram"):
        self.counts += other.counts
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def summary(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99), "p999": self.quantile(0.999)}


class MetricsRegistry:
    """Named, labeled metrics. ``counter("gets", tenant="a")`` returns the
    one Counter for that (name, labels) pair; ``collect()`` renders
    ``name{k=v,...}`` -> summary dicts; ``merge`` folds another registry
    in (matching metrics merged type-wise, new ones adopted)."""

    _TYPES = {"counter": Counter, "gauge": Gauge, "hist": LogHistogram}

    def __init__(self):
        self._m: dict[tuple, object] = {}

    def _get(self, typ: str, name: str, labels: dict):
        key = (typ, name, tuple(sorted(labels.items())))
        m = self._m.get(key)
        if m is None:
            m = self._m[key] = self._TYPES[typ]()
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> LogHistogram:
        return self._get("hist", name, labels)

    @staticmethod
    def _render(name: str, lbl: tuple) -> str:
        if not lbl:
            return name
        inner = ",".join(f"{k}={v}" for k, v in lbl)
        return f"{name}{{{inner}}}"

    def collect(self) -> dict[str, dict]:
        out = {}
        for (typ, name, lbl), m in sorted(self._m.items(),
                                          key=lambda kv: kv[0][1:]):
            if typ == "counter":
                out[self._render(name, lbl)] = {"value": m.value}
            elif typ == "gauge":
                out[self._render(name, lbl)] = {"value": m.value,
                                                "hwm": m.hwm}
            else:
                out[self._render(name, lbl)] = m.summary()
        return out

    def merge(self, other: "MetricsRegistry"):
        for key, m in other._m.items():
            mine = self._m.get(key)
            if mine is None:
                typ = key[0]
                mine = self._m[key] = self._TYPES[typ]()
            mine.merge(m)


class MetricsObserver:
    """Coordinator observer -> registry. Attach with
    ``coord.attach_observer(MetricsObserver())`` or
    ``Session(metrics=True)``; read ``obs.registry.collect()`` after.

    ``per_tenant=True`` additionally labels the GET/PUT latency/byte
    sketches by tenant (default keeps them global: per-tenant *query*
    latency and counters are always kept, which bounds memory at
    O(tenants) either way).
    """

    def __init__(self, registry: MetricsRegistry | None = None, *,
                 per_tenant: bool = False):
        self.registry = registry or MetricsRegistry()
        self.per_tenant = per_tenant
        self._open: dict[str, tuple[float, str]] = {}  # q -> (arrival, ten)

    def on_event(self, t: float, kind: str, q: str, s: str, tidx: int,
                 rq: int, info: dict):
        r = self.registry
        if kind in ("GET_DONE", "PUT_DONE"):
            op = "get" if kind == "GET_DONE" else "put"
            lbl = {}
            if self.per_tenant:
                lbl["tenant"] = self._open.get(q, (0.0, ""))[1]
            r.histogram(f"{op}_latency_s", **lbl).record(info["dur"])
            r.counter(f"{op}_bytes", **lbl).add(info["nbytes"])
            r.counter(f"{op}s", **lbl).add()
            if info.get("dup"):
                r.counter(f"dup_{op}s", **lbl).add()
        elif kind in ("GET_ISSUE", "PUT_ISSUE"):
            op = "get" if kind == "GET_ISSUE" else "put"
            r.counter(f"{op}_issues").add()
        elif kind == "QUERY_START":
            self._open[q] = (info.get("arrival", t), info.get("tenant", ""))
        elif kind == "QUERY_DONE":
            arrival, tenant = self._open.pop(q, (t, ""))
            lbl = {"tenant": tenant} if tenant else {}
            r.counter("queries", **lbl).add()
            if info.get("failed"):
                r.counter("query_fails", **lbl).add()
            else:
                r.histogram("query_latency_s", **lbl).record(
                    max(info.get("finish", t) - arrival, 0.0))
        elif kind == "TASK_START":
            r.gauge("tasks_inflight").add(1)
        elif kind == "TASK_END":
            r.gauge("tasks_inflight").add(-1)
        elif kind == "COMPUTE":
            r.counter("compute_s").add(info["seconds"])
        elif kind == "VISIBLE_AT":
            r.counter("visibility_polls").add(info["polls"])
        elif kind == "RETRY_FIRE":
            r.counter("retries").add()
        elif kind == "COLD_START":
            r.counter("cold_starts").add()
            r.histogram("cold_extra_s").record(info["extra_s"])
        elif kind == "INVOKE_FAIL":
            r.counter("invoke_fails").add()
        elif kind == "ADMIT_QUEUE":
            r.gauge("admit_queue_depth",
                    tenant=info.get("tenant", "")).set(info["depth"])
        elif kind == "ADMIT_REJECT":
            r.counter("admit_rejects",
                      tenant=info.get("tenant", "")).add()
            self._open.pop(q, None)
        elif kind == "SLOT_CLAIM":
            r.gauge("slots_held",
                    tenant=info.get("tenant", "")).set(info.get("held", 0))
        elif kind == "SLOT_RELEASE":
            r.gauge("slots_held",
                    tenant=info.get("tenant", "")).set(info.get("held", 0))
