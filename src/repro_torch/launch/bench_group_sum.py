"""The CUDA group sum of ``relational/ops.py`` (``_group_sum``) against the
two ways it replaced, on the card:

  atomics     ``index_add_``: float64 atomics, added in no fixed order
  one_level   ``index_put_(accumulate=True)``: fixed order, one warp a group
  two_level   ``_group_sum``: pieces of at most 256 rows of one group,
              then pieces by group, both fixed-order

  PYTHONPATH=src python -m repro_torch.launch.bench_group_sum [--sf 1]

For each way, ``run_with_failover`` of q12 and q3 at ``compute_scale=0``,
killed halfway, twice: does the replay pass the store's immutability
audit (every re-PUT byte-identical)? Then ``op_aggregate`` of one sum
over 1M rows at 1, 4, 3,000 and 200,000 groups: how many distinct
results five runs give, and its time by CUDA events (mean of 20). Prints
one JSON line a measurement. Runs on CUDA only.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from repro_torch.core.coordinator import Coordinator
from repro_torch.core.engine import make_engine
from repro_torch.core.session import QuerySpec, Session
from repro_torch.faults.journal import Journal
from repro_torch.relational import ops as OPS
from repro_torch.relational.table import Table


def atomics(v, inv, ng):
    return torch.zeros(ng, dtype=torch.float64, device=v.device) \
        .index_add_(0, inv, v)


def one_level(v, inv, ng):
    return torch.zeros(ng, dtype=torch.float64, device=v.device) \
        .index_put_((inv,), v, accumulate=True)


WAYS = {"atomics": atomics, "one_level": one_level,
        "two_level": OPS._group_sum}


@contextlib.contextmanager
def summing_by(fn):
    """op_aggregate's group sum replaced by ``fn`` inside the block."""
    kept = OPS._group_sum
    OPS._group_sum = fn
    try:
        yield
    finally:
        OPS._group_sum = kept


def failover_audits(coord, way: str, trials: int):
    for q in ("q12", "q3"):
        for trial in range(trials):
            c0 = Coordinator(coord.store, coord.base_splits, coord.policy,
                             seed=coord.seed, compute_scale=0.0,
                             executor_workers=1, device=coord.device)
            sess = Session.from_coordinator(c0)
            journal = Journal()
            sess.spawn(journal).run_query(QuerySpec(q).build_plan())
            t0 = time.perf_counter()
            try:
                sess.run_with_failover(q, kill_after=journal.count // 2)
                out = "passed"
            except AssertionError as e:      # the store's replay audit
                out = f"raised: {str(e)[:120]}"
            print(json.dumps({"sum": way, "query": q, "trial": trial,
                              "event_pops": journal.count, "audit": out,
                              "s": time.perf_counter() - t0}), flush=True)


def aggregate_runs(way: str, rows: int, groups: int, seed: int):
    rng = np.random.default_rng(seed)
    t = Table({"k": torch.from_numpy(rng.integers(0, groups, rows)),
               "v": torch.from_numpy(rng.random(rows) * 1e5)}).to("cuda")
    aggs = [("s", "sum", "v")]
    outs = {OPS.op_aggregate(t, ["k"], aggs)["s"].cpu().numpy().tobytes()
            for _ in range(5)}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(20):
        OPS.op_aggregate(t, ["k"], aggs)
    end.record()
    torch.cuda.synchronize()
    print(json.dumps({"sum": way, "rows": rows, "groups": groups,
                      "distinct_results_of_5": len(outs),
                      "op_aggregate_ms": start.elapsed_time(end) / 20}),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--trials", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_group_sum needs an NVIDIA card")
    coord, _ = make_engine(sf=args.sf, seed=args.seed, device="cuda",
                           target_bytes=64 << 20, compute_scale=0.0,
                           executor_workers=1)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "sf": args.sf}), flush=True)
    for way, fn in WAYS.items():
        with summing_by(fn):
            failover_audits(coord, way, args.trials)
            for groups in (1, 4, 3000, 200_000):
                aggregate_runs(way, 1_000_000, groups, args.seed)


if __name__ == "__main__":
    main()
