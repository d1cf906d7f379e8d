"""End-to-end driver of the PyTorch port: every TPC-H query, single- vs
multi-stage shuffle, with per-stage timing and cost — the paper's Table-1
user story (examples/tpch_query.py on repro_torch).

  PYTHONPATH=src python examples/torch/tpch_query.py [sf] [--device cuda|cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

from repro_torch.core.engine import make_engine, oracle, run_query  # noqa
from repro_torch.relational.tpch import QUERIES  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("sf", nargs="?", type=float, default=0.005)
ap.add_argument("--device", default="cuda",
                help="torch device of the workers (default: cuda)")
args = ap.parse_args()

sf = args.sf
coord, tables = make_engine(sf=sf, device=args.device)
print(f"TPC-H @ sf={sf}: {len(tables['lineitem'])} lineitem rows")
print(f"{'query':6s} {'latency':>9s} {'cost':>10s} {'tasks':>6s} "
      f"{'backups':>7s}  matches_oracle")
for q in sorted(QUERIES):
    res = run_query(coord, q)
    exp = oracle(q, tables)
    ok = len(res.result) == len(exp)
    print(f"{q:6s} {res.latency_s:8.2f}s ${res.cost.total:9.5f} "
          f"{res.task_count:6d} {res.backup_count:7d}  {ok}")

print("\nq12 with the multi-stage shuffle (paper §4.2):")
res = run_query(coord, "q12", {"join": 16},
                shuffle={"strategy": "multi", "p": 1 / 4, "f": 1 / 4})
print(f"  latency {res.latency_s:.2f}s, cost ${res.cost.total:.5f}, "
      f"stages: {list(res.stage_times)}")
