"""Device timing from a torch.profiler trace, frozen here so that later
changes to the program do not move the yardstick: the union of the
device's kernel and copy intervals, and the device time of the kernels
whose names start with a prefix."""
from __future__ import annotations

import re

import torch


def device_events(events) -> list:
    """The trace's records of work on the card: kernels, copies, fills
    (not the ranges a ``record_function`` marks on the device)."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation and not e.name.startswith("bench.")]


def host_events(events) -> list:
    return [e for e in events
            if e.device_type != torch.autograd.DeviceType.CUDA]


def union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Overlapping intervals merged, in order."""
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(events, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] (profiler us) in which the card ran anything."""
    spans = [(max(e.time_range.start, lo), min(e.time_range.end, hi))
             for e in device_events(events)]
    return sum(b - a for a, b in union([s for s in spans if s[1] > s[0]])
               ) * 1e-6


def named(key: str, prefix: str) -> bool:
    """Whether a record names a function starting with ``prefix``
    (templates are keyed "void name<T>(...)")."""
    return re.search(rf"(^|\s){prefix}\w*[<(]", key) is not None


def count(events, prefix: str) -> int:
    return sum(1 for e in device_events(events) if named(e.name, prefix))


def kernel_s(events, prefix: str) -> float:
    """Device seconds of the records whose function starts with
    ``prefix``."""
    return sum(e.time_range.elapsed_us() for e in device_events(events)
               if named(e.name, prefix)) * 1e-6


def device_ops(events, top: int = 10) -> list[list]:
    """[name, seconds] of the device functions with the most time."""
    tot: dict[str, float] = {}
    for e in device_events(events):
        tot[e.name] = tot.get(e.name, 0.0) + e.time_range.elapsed_us()
    rows = sorted(tot.items(), key=lambda r: -r[1])[:top]
    return [[n[:120], us * 1e-6] for n, us in rows]


def idle_gaps(events, lo: float, hi: float, top: int = 10) -> list[list]:
    """[what the host was doing, seconds] of the longest spans of [lo, hi]
    in which the card ran nothing; the host's activity is the innermost
    host record open at the gap's start."""
    busy = union([(e.time_range.start, e.time_range.end)
                  for e in device_events(events)])
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    host = host_events(events)
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        open_ = [e for e in host
                 if e.time_range.start <= a < e.time_range.end]
        name = (min(open_, key=lambda e: e.time_range.elapsed_us()).name
                if open_ else "host idle")
        out.append([name[:120], (b - a) * 1e-6])
    return out
