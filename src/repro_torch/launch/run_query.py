"""Query driver: run TPC-H queries end-to-end through the Starling engine,
with the workers' operators on a torch device.

  PYTHONPATH=src python -m repro_torch.launch.run_query --query q12 \\
      --sf 0.01 [--device cuda|cpu] [--shuffle multi] [--join-tasks 16] \\
      [--no-mitigations]
"""
from __future__ import annotations

import argparse

from repro_torch.core.engine import make_engine, run_query
from repro_torch.core.stragglers import StragglerConfig
from repro_torch.relational.table import DictColumn
from repro_torch.relational.tpch import QUERIES


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--query", default="q12", choices=sorted(QUERIES))
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--join-tasks", type=int, default=8)
    ap.add_argument("--shuffle", default="single",
                    choices=["single", "multi"])
    ap.add_argument("--no-mitigations", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the workers (default: cuda)")
    args = ap.parse_args(argv)

    policy = StragglerConfig.all_off() if args.no_mitigations else None
    coord, tables = make_engine(sf=args.sf, policy=policy,
                                device=args.device)
    kw = {}
    if args.query == "q12" and args.shuffle == "multi":
        kw["shuffle"] = {"strategy": "multi", "p": 1 / 4, "f": 1 / 4}
    res = run_query(coord, args.query, {"join": args.join_tasks}, **kw)

    print(f"{args.query} @ sf={args.sf} on {args.device}: latency "
          f"{res.latency_s:.2f}s (virtual), cost ${res.cost.total:.5f} "
          f"({res.cost.gets} GETs, {res.cost.puts} PUTs, "
          f"{res.task_count} tasks, {res.backup_count} backups)")
    print("stage windows:", res.stage_times)
    t = res.result
    print("result:")
    names = t.column_names()
    print("  " + " | ".join(names))
    for i in range(min(len(t), 10)):
        row = []
        for n in names:
            c = t[n]
            row.append(c.values[int(c.codes[i])].decode() if isinstance(
                c, DictColumn) else f"{float(c[i]):.4g}")
        print("  " + " | ".join(row))


if __name__ == "__main__":
    main()
