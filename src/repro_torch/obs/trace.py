"""Causal span tracing over the coordinator's event stream.

A :class:`Tracer` is a read-only observer (``Coordinator.attach_observer``
or ``Session(trace=True)``): it materializes every popped event into a
span tree —

    query span                 QUERY_START .. QUERY_DONE
      stage span               STAGE_READY .. STAGE_END
        task span (attempt)    TASK_START  .. TASK_END
          request span         GET/PUT_ISSUE .. GET/PUT_DONE

— with point annotations ("marks") for the interesting scheduler moments:
DUP_FIRE preemptions, VISIBLE_AT read re-targets, READ_REPLACED parked-read
re-placement, RETRY_FIRE, BACKUP_FIRE, COLD_START, INVOKE_FAIL, the ADMIT
family, SLOT_CLAIM/RELEASE and COMPUTE. The tracer never feeds anything
back into the scheduler, so traced and untraced runs are bit-identical
(tests/test_obs.py pins this across executor widths).

Export: :meth:`Tracer.to_chrome` writes Chrome ``trace_event`` JSON —
load it at chrome://tracing or https://ui.perfetto.dev. Each query is a
Chrome "process", each task lane a "thread"; spans are complete ("X")
events and marks are instants ("i"). :func:`from_chrome` parses that JSON
back into a span forest (the round-trip test's other half).

Memory: one Python object per span/mark — fine for fleet runs (hybrid
fleets emit few request events), unbounded for event-exact million-request
runs; use :mod:`repro_torch.obs.metrics` when only aggregates are needed.
"""
from __future__ import annotations

import dataclasses
import json

#: span kinds, outermost first — a child's kind must rank strictly deeper
KINDS = ("query", "stage", "task", "request")
_RANK = {k: i for i, k in enumerate(KINDS)}


@dataclasses.dataclass
class Span:
    """One interval in the trace tree (see module docstring taxonomy)."""
    uid: int
    kind: str                       # one of KINDS
    name: str
    start: float
    end: float | None = None        # None while open
    parent: "Span | None" = None
    children: list = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)
    marks: list = dataclasses.field(default_factory=list)  # (t, kind, info)

    @property
    def open(self) -> bool:
        return self.end is None

    def mark(self, t: float, kind: str, info: dict):
        self.marks.append((t, kind, dict(info)))

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


class Tracer:
    """Materializes the observer event stream into query span trees.

    Safe to share across sequential coordinators (the ``--trace`` global
    hook does): a repeated QUERY_START under an already-started name opens
    a fresh root rather than clobbering the finished one.
    """

    def __init__(self):
        self.roots: list[Span] = []         # query spans, start order
        self._uid = 0
        self._last_t = 0.0
        self._open_q: dict[str, Span] = {}          # query -> open root
        self._stages: dict[tuple, Span] = {}        # (quid, stage) -> span
        self._tasks: dict[tuple, Span] = {}         # (quid, stage, tidx)
        self._reqs: dict[tuple, Span] = {}          # + rq -> OPEN req span

    # ------------------------------------------------------------ building
    def _new(self, kind: str, name: str, start: float,
             parent: Span | None) -> Span:
        self._uid += 1
        sp = Span(self._uid, kind, name, start, parent=parent)
        if parent is None:
            self.roots.append(sp)
        else:
            parent.children.append(sp)
        return sp

    def _query_span(self, q: str, t: float) -> Span:
        sp = self._open_q.get(q)
        if sp is None:
            sp = self._new("query", q, t, None)
            self._open_q[q] = sp
        return sp

    def _stage_span(self, quid, qspan: Span, s: str, t: float) -> Span:
        sp = self._stages.get((quid, s))
        if sp is None:
            sp = self._new("stage", s, t, qspan)
            self._stages[(quid, s)] = sp
        return sp

    def _task_span(self, quid, qspan: Span, s: str, tidx: int,
                   t: float) -> Span:
        sp = self._tasks.get((quid, s, tidx))
        if sp is None:
            parent = self._stage_span(quid, qspan, s, t)
            sp = self._new("task", f"{s}[{tidx}]", t, parent)
            self._tasks[(quid, s, tidx)] = sp
        return sp

    # ------------------------------------------------------- observer hook
    def on_event(self, t: float, kind: str, q: str, s: str, tidx: int,
                 rq: int, info: dict):
        self._last_t = max(self._last_t, t)
        if kind == "QUERY_START":
            sp = self._open_q.get(q)
            if sp is not None and sp.meta.get("started"):
                sp = None               # same name, new run (shared tracer)
            if sp is None:
                sp = self._new("query", q, t, None)
                self._open_q[q] = sp
            sp.meta.update(started=True, **info)
            return
        qspan = self._query_span(q, t)
        quid = qspan.uid
        if kind == "QUERY_DONE":
            # the root stays registered: a losing §5 duplicate's PUT_DONE
            # can drain AFTER the query finishes and must attach to this
            # tree, not spawn a skeleton one (finalize widens the parents)
            qspan.end = info.get("finish", t)
            qspan.meta["failed"] = info.get("failed", False)
            return
        if kind == "ADMIT_REJECT":
            qspan.mark(t, kind, info)
            qspan.end = t
            qspan.meta["rejected"] = True
            return
        if kind == "STAGE_READY":
            self._stage_span(quid, qspan, s, t).meta.update(info)
            return
        if kind == "STAGE_END":
            self._stage_span(quid, qspan, s, t).end = t
            return
        if kind == "TASK_START":
            prev = self._tasks.get((quid, s, tidx))
            if prev is not None and info.get("attempt", 0) > \
                    prev.meta.get("attempt", 0):
                if prev.open:
                    prev.end = t        # superseded by the retry attempt
                parent = prev.parent
                sp = self._new("task", f"{s}[{tidx}]", t, parent)
                self._tasks[(quid, s, tidx)] = sp
            else:
                sp = self._task_span(quid, qspan, s, tidx, t)
            sp.meta.update(info)
            return
        if kind == "TASK_END":
            sp = self._task_span(quid, qspan, s, tidx, t)
            if sp.open:
                sp.end = info.get("end", t)
            return
        if kind in ("GET_ISSUE", "PUT_ISSUE"):
            key = (quid, s, tidx, rq)
            prev = self._reqs.get(key)
            if prev is not None and prev.open:
                prev.end = t            # a retry supersedes the dead try
                prev.meta["superseded"] = True
            task = self._task_span(quid, qspan, s, tidx, t)
            op = "GET" if kind == "GET_ISSUE" else "PUT"
            sp = self._new("request", f"{op}#{rq}", t, task)
            sp.meta.update(op=op.lower(), **info)
            self._reqs[key] = sp
            return
        if kind in ("GET_DONE", "PUT_DONE"):
            key = (quid, s, tidx, rq)
            sp = self._reqs.pop(key, None)
            if sp is None:              # attached mid-run: lazy skeleton
                task = self._task_span(quid, qspan, s, tidx, t)
                op = "GET" if kind == "GET_DONE" else "PUT"
                sp = self._new("request", f"{op}#{rq}",
                               t - info.get("dur", 0.0), task)
            sp.end = t
            sp.meta.update(info)
            return
        # everything else is a point annotation on the innermost span
        if rq >= 0 and (quid, s, tidx, rq) in self._reqs:
            self._reqs[(quid, s, tidx, rq)].mark(t, kind, info)
        elif tidx >= 0:
            self._task_span(quid, qspan, s, tidx, t).mark(t, kind, info)
        elif (quid, s) in self._stages:
            self._stages[(quid, s)].mark(t, kind, info)
        else:
            qspan.mark(t, kind, info)

    # ------------------------------------------------------------ querying
    def finalize(self) -> None:
        """Close dangling spans (failed queries never see STAGE_END) and
        widen every parent to cover its children, so intervals strictly
        nest — a request can outlive its task's *effective* end when a
        backup duplicate won mid-flight and the losing timeline drains
        later; the scheduler's effective end stays in ``meta``."""
        for root in self.roots:
            for sp in root.walk():
                if sp.open:
                    sp.end = self._last_t
                    sp.meta["dangling"] = True
            self._widen(root)
        self._open_q.clear()

    def _widen(self, sp: Span) -> float:
        end = sp.end if sp.end is not None else sp.start
        for c in sp.children:
            end = max(end, self._widen(c))
        if sp.end is not None and end > sp.end:
            sp.meta.setdefault("effective_end", sp.end)
            sp.end = end
        return end

    def spans(self, kind: str | None = None):
        for root in self.roots:
            for sp in root.walk():
                if kind is None or sp.kind == kind:
                    yield sp

    def query(self, name: str) -> Span:
        """Latest root span whose query name is ``name``."""
        for root in reversed(self.roots):
            if root.name == name:
                return root
        raise KeyError(name)

    def validate(self) -> None:
        """Raise AssertionError unless the (finalized) forest is
        well-formed: closed spans, live parent links, child kinds strictly
        deeper, child intervals inside the parent's, marks never before
        their span starts (a RETRY_FIRE decision can legitimately trail
        the attempt span it annotates)."""
        for root in self.roots:
            assert root.kind == "query", root
            assert root.parent is None, root
            for sp in root.walk():
                assert sp.end is not None, f"open span {sp.name}"
                assert sp.end >= sp.start - 1e-9, sp
                for (t, _k, _i) in sp.marks:
                    assert t >= sp.start - 1e-9, (sp.name, t)
                for c in sp.children:
                    assert c.parent is sp, c
                    assert _RANK[c.kind] > _RANK[sp.kind], (sp.kind, c.kind)
                    assert c.start >= sp.start - 1e-9, (sp.name, c.name)
                    assert c.end <= sp.end + 1e-9, (sp.name, c.name)

    # ------------------------------------------------------- chrome export
    def to_chrome(self, path: str | None = None) -> list[dict]:
        """Chrome ``trace_event`` JSON (finalizes first). Times are virtual
        seconds rendered as microseconds; each query is a pid with its name
        in process metadata, stage/query spans on tid 0, every task lane on
        its own tid. ``path`` also writes ``{"traceEvents": [...]}``."""
        self.finalize()
        out: list[dict] = []
        for pid, root in enumerate(self.roots):
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0, "args": {"name": root.name}})
            tids: dict[str, int] = {}
            for sp in root.walk():
                if sp.kind in ("query", "stage"):
                    tid = 0
                else:
                    lane = sp.name if sp.kind == "task" else sp.parent.name
                    tid = tids.setdefault(lane, len(tids) + 1)
                # meta rides in its own namespace: a span's meta may
                # legitimately carry keys like "kind" (a STAGE_READY's
                # task kind) that must not clobber the reserved args
                args = {"id": sp.uid, "kind": sp.kind, "meta": sp.meta}
                if sp.parent is not None:
                    args["parent"] = sp.parent.uid
                out.append({"name": sp.name, "cat": sp.kind, "ph": "X",
                            "pid": pid, "tid": tid,
                            "ts": sp.start * 1e6,
                            "dur": max(sp.end - sp.start, 0.0) * 1e6,
                            "args": args})
                for (t, k, info) in sp.marks:
                    out.append({"name": k, "cat": "mark", "ph": "i",
                                "pid": pid, "tid": tid, "ts": t * 1e6,
                                "s": "t",
                                "args": {"span": sp.uid, "info": info}})
        if path is not None:
            with open(path, "w") as f:
                json.dump({"traceEvents": out}, f)
        return out


def from_chrome(data) -> list[Span]:
    """Rebuild a span forest from ``to_chrome`` output (a list of events,
    a ``{"traceEvents": ...}`` dict, or a JSON string) — the export
    round-trip: ids, parent links, kinds, intervals and marks survive."""
    if isinstance(data, str):
        data = json.loads(data)
    if isinstance(data, dict):
        data = data["traceEvents"]
    spans: dict[int, Span] = {}
    parents: dict[int, int] = {}
    marks: list[tuple] = []
    for ev in data:
        if ev.get("ph") == "X":
            args = ev.get("args", {})
            uid = args["id"]
            start = ev["ts"] / 1e6
            spans[uid] = Span(uid, args["kind"], ev["name"], start,
                              end=start + ev["dur"] / 1e6,
                              meta=dict(args.get("meta", {})))
            if args.get("parent") is not None:
                parents[uid] = args["parent"]
        elif ev.get("ph") == "i":
            marks.append((ev["ts"] / 1e6, ev["name"],
                          dict(ev.get("args", {}))))
    roots: list[Span] = []
    for uid, sp in spans.items():
        par = parents.get(uid)
        if par is None:
            roots.append(sp)
        else:
            sp.parent = spans[par]
            spans[par].children.append(sp)
    for (t, k, args) in marks:
        sid = args.get("span")
        if sid in spans:
            spans[sid].marks.append((t, k, dict(args.get("info", {}))))
    roots.sort(key=lambda sp: (sp.start, sp.uid))
    return roots


class GlobalTraceHandle:
    """Handle from :func:`install_global_tracer`: ``.tracer`` accumulates
    spans from every coordinator built while installed; ``.export(path)``
    finalizes + writes Chrome JSON; ``.uninstall()`` detaches the hook."""

    def __init__(self, tracer: Tracer, factory):
        self.tracer = tracer
        self._factory = factory

    def export(self, path: str) -> int:
        n = len(self.tracer.to_chrome(path))
        return n

    def uninstall(self):
        from repro_torch.core.coordinator import Coordinator
        if self._factory in Coordinator.observer_factories:
            Coordinator.observer_factories.remove(self._factory)


def install_global_tracer() -> GlobalTraceHandle:
    """Trace every coordinator created from now on (until uninstalled)
    into ONE shared :class:`Tracer` — how ``benchmarks/run.py --trace``
    dumps a Chrome trace from any existing benchmark without touching it.
    Coordinators run sequentially per process, so a shared tracer sees no
    interleaving; repeated query names across runs open fresh roots."""
    from repro_torch.core.coordinator import Coordinator
    tracer = Tracer()

    def factory() -> Tracer:
        return tracer

    Coordinator.observer_factories.append(factory)
    return GlobalTraceHandle(tracer, factory)
