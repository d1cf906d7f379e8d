"""The program's spans in a torch.profiler trace, frozen here so that later
changes to the program do not move the yardstick.

A span is a host range the program marks with ``record_function``; its
name starts with ``model.``. Each device record of the trace
(``timing.device_events``) belongs to the innermost span, on the launching
thread, that contains the host record that launched it: the CUDA runtime
or driver call with the record's own correlation id, else the op its
``linked_correlation_id`` names (a field that some torch releases lack).
A record with no such span is "outside" (None): the harness's argmax and
copy back, say.
"""
from __future__ import annotations

import bisect
import collections
import re

from harness import timing

PREFIX = "model."
PREFILL = "model.prefill"
# CUDA runtime (cudaX) and driver (cuX) calls among the host records
RUNTIME = re.compile(r"^cu(da)?[A-Z]")
LAUNCH = re.compile(r"^cu(da)?LaunchKernel")
GLUE = (".norm", ".rope", ".act")


def is_runtime(e) -> bool:
    return RUNTIME.match(e.name) is not None


def ranges(events, name: str | None = None) -> list:
    """The host records of the program's spans (only those named ``name``
    if given), in order of start."""
    out = [e for e in timing.host_events(events)
           if e.name.startswith(PREFIX) and (name is None or e.name == name)]
    return sorted(out, key=lambda e: e.time_range.start)


class Innermost:
    """The innermost span open at a time, per thread. Spans on a thread
    nest (``record_function`` ranges are opened and closed in order)."""

    def __init__(self, spans):
        self.by_thread = collections.defaultdict(list)
        for s in sorted(spans, key=lambda e: (e.time_range.start,
                                              -e.time_range.end)):
            self.by_thread[s.thread].append(s)
        self.starts = {t: [s.time_range.start for s in ss]
                       for t, ss in self.by_thread.items()}

    def at(self, thread, t: float):
        """The span open at ``t`` with the latest start, or None."""
        ss = self.by_thread.get(thread, [])
        i = bisect.bisect_right(self.starts.get(thread, []), t) - 1
        while i >= 0:
            s = ss[i]
            if t < s.time_range.end:
                return s
            i -= 1
        return None


def launcher(events):
    """-> fn(device record) -> the host record that launched it, or
    None."""
    runtime, ops = {}, {}
    for e in timing.host_events(events):
        (runtime if is_runtime(e) else ops)[e.id] = e

    def of(d):
        h = runtime.get(d.id)
        linked = getattr(d, "linked_correlation_id", 0) or 0
        if h is None and linked > 0:
            h = ops.get(linked)
        return h
    return of


def attribute(events) -> list[tuple]:
    """[(device record, innermost span name or None)] over the trace's
    device records."""
    inner = Innermost(ranges(events))
    of = launcher(events)
    out = []
    for d in timing.device_events(events):
        h = of(d)
        s = inner.at(h.thread, h.time_range.start) if h is not None else None
        out.append((d, s.name if s is not None else None))
    return out


def device_s(events) -> dict:
    """Device seconds by innermost span name (None: outside every
    span)."""
    tot: dict = collections.defaultdict(float)
    for d, name in attribute(events):
        tot[name] += d.time_range.elapsed_us() * 1e-6
    return dict(tot)


def under(name: str | None, parent: str) -> bool:
    """Whether span ``name`` is ``parent`` or one of its children."""
    return name is not None and (name == parent
                                 or name.startswith(parent + "."))


def is_glue(name: str | None) -> bool:
    return name is not None and (name.endswith(GLUE)
                                 or name == "model.cache")


def inside(events, spans, pick) -> list:
    """The host records that ``pick`` selects whose start lies inside one
    of ``spans`` on its thread."""
    by = collections.defaultdict(list)
    for s in spans:
        by[s.thread].append((s.time_range.start, s.time_range.end))
    out = []
    for e in timing.host_events(events):
        if pick(e) and any(a <= e.time_range.start < b
                           for a, b in by.get(e.thread, ())):
            out.append(e)
    return out


def runtime_us(events, span) -> float:
    """Microseconds of ``span`` inside CUDA runtime and driver calls
    made on its thread (launches, syncs, copies), each clipped to it."""
    lo, hi = span.time_range.start, span.time_range.end
    calls = [(max(e.time_range.start, lo), min(e.time_range.end, hi))
             for e in timing.host_events(events)
             if e.thread == span.thread and is_runtime(e)
             and e.time_range.end > lo and e.time_range.start < hi]
    return sum(b - a for a, b in timing.union([c for c in calls
                                               if c[1] > c[0]]))


def prefill_profile(run):
    """The traced turn's records if its trace is whole, on a CUDA device,
    and holds a ``model.prefill`` span for each batch; else None (the
    program marks no span, say)."""
    p = run.profile
    if run.device.type != "cuda" or not p or not p["complete"]:
        return None
    if len(ranges(p["events"], PREFILL)) < len(p["batches"]):
        return None
    return p


def span_ms(run, keep) -> float | None:
    """Device milliseconds of the traced turn whose innermost span
    ``keep`` accepts; None as ``prefill_profile``."""
    p = prefill_profile(run)
    if p is None:
        return None
    return 1e3 * sum(s for name, s in device_s(p["events"]).items()
                     if keep(name))
