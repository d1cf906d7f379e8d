"""End-to-end glue: load base tables into the store, run queries, oracle.

``make_engine`` builds the coordinator whose workers run the operators on
``device`` (CUDA unless the caller asks for the CPU). The generated base
tables stay on the CPU; the store holds them as the same bytes the numpy
engine writes.

``oracle`` executes the same logical query single-threaded over the full
tables using the relational ops directly — no store, no shuffle, no
partitioning — giving an independent reference for the distributed engine's
results. It runs wherever its tables are.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.coordinator import Coordinator, QueryResult
from repro_torch.core.stragglers import StragglerConfig
from repro_torch.objectstore.store import ObjectStore, StoreConfig
from repro_torch.relational import ops as OPS
from repro_torch.relational.table import (Table, serialize_table,
                                          table_to_object)
from repro_torch.relational.tpch import QUERIES, generate


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. A CUDA device without a usable card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run on the CPU")
    return dev


def load_base_tables(store: ObjectStore, tables: dict[str, Table],
                     target_bytes: int = 4 << 20) -> dict[str, list[str]]:
    """Write each table as row-sliced COLUMNAR objects (~target_bytes):
    single-partition §3.2 partitioned objects whose headers carry
    per-column offsets + zone maps, so scans can project and prune.

    The paper stores base tables as ORC objects of a few hundred MB; scaled
    down here with the dataset scale.
    """
    splits: dict[str, list[str]] = {}
    for name, t in tables.items():
        n = len(t)
        total = len(serialize_table(t)) if n else 1
        nsplit = max(1, int(round(total / target_bytes)))
        rows = max(1, n // nsplit)
        ks = []
        for i in range(0, max(n, 1), rows):
            idx = torch.arange(i, min(i + rows, n))
            key = f"base/{name}/p{len(ks)}"
            store.put(key, table_to_object(t.take(idx)))
            ks.append(key)
        splits[name] = ks
    return splits


def make_engine(sf: float = 0.002, *, seed: int = 0,
                data_seed: int | None = None,
                policy: StragglerConfig | None = None,
                max_parallel: int = 1000, target_bytes: int = 1 << 20,
                compute_scale: float = 1.0,
                executor_workers: int | None = None,
                record_events: bool = False, max_events: int | None = None,
                faults=None, coldstart=None, retry=None, journal=None,
                device=None):
    """(coordinator, tables) over a fresh simulated store.

    ``device`` is where the workers run the operators: ``None`` means
    ``"cuda"`` and raises ``RuntimeError`` without a card; the tests pass
    ``"cpu"``. ``compute_scale=0`` makes virtual latency independent of
    measured compute (fully deterministic); ``executor_workers`` sizes the
    coordinator's thread pool for real task execution. ``seed`` drives the
    *simulation* randomness (store latencies, stragglers, arrivals);
    ``data_seed`` (default: ``seed``) drives the generated dataset.
    ``record_events=True`` keeps the coordinator's request-level event log
    in ``coord.event_log``; ``max_events`` caps that list.
    ``faults``/``coldstart``/``retry``/``journal`` configure the §3 fault
    path (``repro_torch.faults``); all default off, in which case the
    engine is bit-identical to the fault-free one. The returned tables are
    the generator's, on the CPU.
    """
    dev = resolve_device(device)
    tables = generate(sf, seed=seed if data_seed is None else data_seed)
    store = ObjectStore(StoreConfig(seed=seed, time_scale=0.0,
                                    simulate_visibility_lag=False))
    splits = load_base_tables(store, tables, target_bytes)
    coord = Coordinator(store, splits, policy, seed=seed,
                        max_parallel=max_parallel,
                        compute_scale=compute_scale,
                        executor_workers=executor_workers,
                        record_events=record_events, max_events=max_events,
                        faults=faults, coldstart=coldstart, retry=retry,
                        journal=journal, device=str(dev))
    return coord, tables


def build_plan(name: str, tuning=None, **plan_kw) -> dict:
    """One physical plan with tuning applied. ``tuning`` takes any form
    ``planner.model.coerce_config`` accepts, normalized through the same
    ``QuerySpec.build_plan`` path as every other entry point."""
    from repro_torch.core.session import QuerySpec
    return QuerySpec(name, tuning, plan_kw or None).build_plan()


def run_query(coord: Coordinator, name: str, ntasks=None, **plan_kw
              ) -> QueryResult:
    """Run one query on a bare coordinator (the ``Session.submit`` path)."""
    from repro_torch.core.session import QuerySpec, Session
    return Session.from_coordinator(coord).submit(
        QuerySpec(name, ntasks, plan_kw or None))


def run_queries(coord: Coordinator, specs, arrival_times=None, after=None
                ) -> list[QueryResult]:
    """Run a batch on one coordinator (the ``Session.run`` path).
    ``specs`` entries are a query name or ``(name, tuning)`` /
    ``(name, tuning, plan_kw)``; arrival times and closed-loop ``after``
    edges ride on the coerced QuerySpecs."""
    from repro_torch.core.session import QuerySpec, Session
    qs = [QuerySpec.coerce(s) for s in specs]
    if arrival_times is not None:
        if len(arrival_times) != len(qs):
            raise ValueError(f"{len(qs)} specs but {len(arrival_times)} "
                             "arrival times")
        qs = [dataclasses.replace(q, arrival_s=a)
              for q, a in zip(qs, arrival_times)]
    if after is not None:
        if len(after) != len(qs):
            raise ValueError(f"{len(qs)} specs but {len(after)} after "
                             "entries")
        qs = [dataclasses.replace(q, after=dep)
              for q, dep in zip(qs, after)]
    return Session.from_coordinator(coord).run(qs)


# ---------------------------------------------------------------------------
# single-threaded oracle (independent execution path)
# ---------------------------------------------------------------------------

def oracle(name: str, tables: dict[str, Table]) -> Table:
    plan = QUERIES[name]()
    produced: dict[str, Table] = {}

    def small(tname):
        return tables[tname]

    for st in plan["stages"]:
        if st["kind"] == "scan":
            t = tables[st["table"]].project(st["columns"]) \
                if st.get("columns") else tables[st["table"]]
            t = _ops(t, st.get("ops", []), small)
        elif st["kind"] == "join":
            left = produced[st["left"]]
            right = produced[st["right"]]
            t = OPS.op_join(left, right, st["lkey"], st["rkey"])
            t = _ops(t, st.get("ops", []), small)
        elif st["kind"] == "final_agg":
            t = OPS.merge_partials([produced[st["deps"][0]]],
                                   st.get("keys", []),
                                   [tuple(a) for a in st.get("aggs", [])])
            if st.get("sort"):
                t = OPS.op_sort_limit(t, [tuple(s) for s in st["sort"]],
                                      st.get("limit"))
        else:
            raise ValueError(st["kind"])
        produced[st["name"]] = t
    return produced[plan["stages"][-1]["name"]]


def _ops(t, ops, small):
    from repro_torch.core.worker import _apply_ops
    return _apply_ops(t, ops, small)
