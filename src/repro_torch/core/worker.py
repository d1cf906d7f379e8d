"""Stateless worker (paper §2.3): one task per (simulated) invocation.

A worker receives ONLY its task parameters, reads inputs from the object
store (base table splits or §3.2 partitioned intermediates), executes its
compiled operator pipeline, writes its output object(s), and exits. No
worker-to-worker communication exists — the store is the only medium.

Timing is *not* decided here: the worker moves real bytes eagerly and
records every store request into a :class:`RequestTimeline`
(objectstore.client recording mode) that it hands back in its
``TaskResult``. The coordinator's event heap replays that timeline —
per-GET/PUT issue/done events, RSM/WSM duplicate timers, visibility-lag
re-targeting — so straggler mitigation preempts mid-request instead of
being composed privately inside the task. Virtual compute is the
measured compute time x ``compute_scale``, measured on the CPU as
per-thread CPU time (``time.thread_time``, not wall-clock, so running
many workers concurrently on the coordinator's thread pool does not
inflate virtual compute when the GIL or the scheduler makes a thread
wait); on CUDA, whose
asynchronous work no thread clock sees, as wall time between two
``torch.cuda.synchronize()`` calls.

Tables go to the worker's device right after decode, the operators run
there, and columns come back to the host only inside serialization.

A Worker instance is used by exactly one task on one executor thread; its
store client and RNG are task-private, so workers need no locking — the
ObjectStore itself is the only shared (and internally locked) state.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import format as FMT
from repro_torch.core.plan import out_key
from repro_torch.core.stragglers import StragglerConfig
from repro_torch.objectstore.client import ReadReq, RequestTimeline, StoreClient
from repro_torch.objectstore.store import ObjectStore
from repro_torch.relational import ops as OPS
from repro_torch.relational.table import (Table, decode_object, deserialize_segment,
                                    deserialize_table, partitions_to_object,
                                    serialize_table)


@dataclasses.dataclass
class PartInput:
    """One partitioned-object input: read partitions [first, last].

    ``src = (producer stage name, task index)`` lets the scheduler resolve
    the object's availability from the producer task's virtual end at read
    time (the end may not exist yet when this task is dispatched — §4.4
    pipelining); ``avail`` is the static fallback for base objects.

    ``n_cols`` sizes the header GET (the producer's column count, known to
    the coordinator from the producer's TaskResult or the base-table
    schema). ``read_cols``/``bounds`` carry the plan's projection and
    zone-map pushdown; they apply on single-partition reads only — a
    contiguous range over a partition-major body spans every column of the
    middle partitions of a run, so combiners read whole runs.
    """
    key: str
    avail: float
    n_parts: int
    first: int
    last: int
    src: tuple[str, int] | None = None
    n_cols: int = 0
    read_cols: list | None = None
    bounds: dict | None = None


@dataclasses.dataclass
class TaskResult:
    key: str | None              # output object (None for inline results)
    gets: int                    # base GETs issued (polls/dups are the
    puts: int                    # scheduler's); puts include the .dw twin
    compute_s: float
    out_bytes: int
    timeline: RequestTimeline
    result: object = None        # final stage only
    out_ncols: int = 0           # columns in the partitioned output header
    columns_read: int = 0        # column segments this task decoded


def _apply_ops(t: Table, ops: list, base_reader) -> Table:
    for op in ops:
        kind = op["op"]
        if kind == "filter":
            t = OPS.op_filter(t, op["pred"])
        elif kind == "project":
            t = OPS.op_project(t, op["columns"])
        elif kind == "compute":
            t = OPS.op_compute(t, op["name"], op["expr"])
        elif kind == "partial_agg":
            t = OPS.op_aggregate(t, op["keys"],
                                 [tuple(a) for a in op["aggs"]])
        elif kind == "broadcast_join":
            small = base_reader(op["table"])
            t = OPS.op_join(t, small, op["lkey"], op["rkey"])
        else:
            raise ValueError(kind)
    return t


class Worker:
    """Executes one task; records its request timeline for the scheduler."""

    def __init__(self, store: ObjectStore, policy: StragglerConfig,
                 rng: np.random.Generator, compute_scale: float = 1.0,
                 device="cuda"):
        self.device = torch.device(device)
        self.store = store
        self.policy = policy
        self.timeline = RequestTimeline()
        self.client = StoreClient(store, policy, rng, timeline=self.timeline)
        self.compute_scale = compute_scale
        self.rng = rng

    def _clock(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return time.perf_counter()
        return time.thread_time()

    # ------------------------------------------------------------------ I/O
    def _alt(self, key: str):
        return key + ".dw" if self.policy.doublewrite else None

    def _read_whole(self, inputs: list[tuple[str, float,
                                             tuple[str, int] | None]],
                    now: float):
        reqs = [ReadReq(k, available_at=a, alt_key=self._alt(k), src=s)
                for k, a, s in inputs]
        return self.client.read_many(reqs, now)

    def _read_partitions(self, inputs: list[PartInput], now: float):
        """Two range-GETs per input object (§3.2): header, then ONE
        contiguous body range. Single-partition reads apply projection
        (``read_cols``) and zone-map pruning (``bounds``) to shrink the
        body range — a pruned partition issues a zero-length body GET so
        request counts stay structural across pushdown settings.

        Returns (per-input list of per-partition Tables, virtual end).
        """
        hdr_reqs = [ReadReq(pi.key, 0,
                            FMT.header_size(pi.n_parts, pi.n_cols),
                            available_at=pi.avail, alt_key=self._alt(pi.key),
                            src=pi.src)
                    for pi in inputs]
        headers, t1 = self.client.read_many(hdr_reqs, now)
        body_reqs = []
        metas = []
        for pi, raw in zip(inputs, headers):
            hdr = FMT.parse_header(raw, pi.n_parts, pi.n_cols, key=pi.key)
            sel = None
            if pi.read_cols is not None and pi.first == pi.last:
                idx = {n: i for i, n in enumerate(hdr.columns)}
                sel = sorted(idx[n] for n in pi.read_cols if n in idx)
                if pi.bounds:
                    zb = {idx[n]: (b[0], b[1])
                          for n, b in pi.bounds.items() if n in idx}
                    if zb and FMT.prune_partition(hdr, pi.first, zb):
                        sel = []
                lo, hi = FMT.covering_range(hdr, pi.first, sel)
            else:
                lo, hi = FMT.partition_range(hdr, pi.first, pi.last)
            metas.append((hdr, sel))
            body_reqs.append(ReadReq(pi.key, lo, hi, available_at=pi.avail,
                                     alt_key=self._alt(pi.key), src=pi.src))
        bodies, t2 = self.client.read_many(body_reqs, t1)
        out: list[list[Table]] = []
        for pi, (hdr, sel), body, req in zip(inputs, metas, bodies,
                                             body_reqs):
            base = req.start
            tabs = []
            for j in range(pi.first, pi.last + 1):
                cis = sel if sel is not None else range(hdr.n_columns)
                cols = {}
                for ci in cis:
                    slo, shi = hdr.seg_bounds(j, ci)
                    cols[hdr.columns[ci]] = deserialize_segment(
                        body[hdr.data_start + slo - base:
                             hdr.data_start + shi - base], self.device)
                self.client.columns_read += len(cols)
                t = Table(cols)
                tabs.append(t if len(t) else Table({}))
            out.append(tabs)
        return out, t2

    # ------------------------------------------------------------ execution
    def run_scan(self, query: str, st: dict, task_id: int, split_key: str,
                 avail: float, now: float, n_out_parts: int,
                 base_reader) -> TaskResult:
        if st.get("_n_base_cols") and st.get("_read_cols") is not None:
            # columnar base split: header GET + covering body range over
            # the projected columns, zone-map pruned (plan.infer_pushdown)
            pi = PartInput(split_key, avail, 1, 0, 0,
                           n_cols=st["_n_base_cols"],
                           read_cols=st["_read_cols"],
                           bounds=st.get("_read_bounds"))
            tabs, t_in = self._read_partitions([pi], now)
            c0 = self._clock()
            t = tabs[0][0]
        else:
            datas, t_in = self._read_whole([(split_key, avail, None)], now)
            c0 = self._clock()
            t = decode_object(datas[0], st.get("columns"), key=split_key,
                              device=self.device)
        # a zone-map-pruned split decodes to a column-less table; its ops
        # are provably no-rows-pass, so skip them (filters would KeyError)
        if t.cols:
            t = _apply_ops(t, st.get("ops", []), base_reader)
        comp = (self._clock() - c0) * self.compute_scale
        return self._emit(query, st, task_id, t, t_in + comp, comp,
                          n_out_parts)

    def run_join(self, query: str, st: dict, task_id: int,
                 left_inputs: list[PartInput], right_inputs: list[PartInput],
                 now: float, n_out_parts: int, base_reader) -> TaskResult:
        """Partitioned hash join on this task's partition of both sides."""
        lt, t1 = self._read_partitions(left_inputs, now)
        rt, t2 = self._read_partitions(right_inputs, t1)
        c0 = self._clock()
        left = Table.concat([t for tabs in lt for t in tabs])
        right = Table.concat([t for tabs in rt for t in tabs])
        if len(left) and len(right):
            t = OPS.op_join(left, right, st["lkey"], st["rkey"])
            t = _apply_ops(t, st.get("ops", []), base_reader)
        else:
            t = Table({})
        comp = (self._clock() - c0) * self.compute_scale
        return self._emit(query, st, task_id, t, t2 + comp, comp,
                          n_out_parts)

    def run_combine(self, query: str, st: dict, task_id: int,
                    inputs: list[PartInput], now: float) -> TaskResult:
        """Multi-stage shuffle combiner (§4.2): merge a contiguous partition
        run from a subset of files into one combined partitioned object."""
        per_file, t_in = self._read_partitions(inputs, now)
        first, last = inputs[0].first, inputs[0].last
        c0 = self._clock()
        parts = [Table.concat([tabs[off] for tabs in per_file])
                 for off in range(last - first + 1)]
        comp = (self._clock() - c0) * self.compute_scale
        payload = partitions_to_object(parts)
        key = out_key(query, st["name"], task_id)
        self.timeline.record_compute(comp)
        self.client.write(key, payload, t_in + comp,
                          bill_nbytes=st.get("out_bytes_floor"))
        return TaskResult(key, self.client.gets, self.client.puts,
                          comp, len(payload), self.timeline,
                          out_ncols=next((len(p.cols) for p in parts
                                          if p.cols), 0),
                          columns_read=self.client.columns_read)

    def run_final(self, query: str, st: dict,
                  inputs: list[tuple[str, float, tuple[str, int] | None]],
                  now: float) -> TaskResult:
        datas, t_in = self._read_whole(inputs, now)
        c0 = self._clock()
        parts = [deserialize_table(d, device=self.device)
                 for d in datas if len(d) > 8]
        t = OPS.merge_partials([p for p in parts if len(p)],
                               st.get("keys", []),
                               [tuple(a) for a in st.get("aggs", [])])
        if st.get("sort") and len(t):
            t = OPS.op_sort_limit(t, [tuple(s) for s in st["sort"]],
                                  st.get("limit"))
        comp = (self._clock() - c0) * self.compute_scale
        key = out_key(query, st["name"], 0)
        payload = serialize_table(t)
        self.timeline.record_compute(comp)
        self.client.write(key, payload, t_in + comp,
                          bill_nbytes=st.get("out_bytes_floor"))
        return TaskResult(key, self.client.gets, self.client.puts,
                          comp, len(payload), self.timeline, result=t,
                          columns_read=self.client.columns_read)

    # ------------------------------------------------------------- output
    def _emit(self, query, st, task_id, t: Table, now, comp,
              n_out_parts: int) -> TaskResult:
        key = out_key(query, st["name"], task_id)
        # a partitioned producer always writes the §3.2 format — including
        # the degenerate 1-consumer fan-out (planner ntasks=1 configs), so
        # consumers can parse the header unconditionally
        ncols = 0
        if st.get("partition") and n_out_parts >= 1:
            parts = OPS.op_partition(t, st["partition"]["key"], n_out_parts) \
                if len(t) else [Table({})] * n_out_parts
            payload = partitions_to_object(parts)
            ncols = next((len(p.cols) for p in parts if p.cols), 0)
        else:
            payload = serialize_table(t)
        self.timeline.record_compute(comp)
        self.client.write(key, payload, now,
                          bill_nbytes=st.get("out_bytes_floor"))
        return TaskResult(key, self.client.gets, self.client.puts,
                          comp, len(payload), self.timeline,
                          out_ncols=ncols,
                          columns_read=self.client.columns_read)
